// Host-side batch assembly for the Mixer (native/amss_data.cc's
// amss_batch_fill; its amss_mix, which nothing calls, is left out).
//
// Gathers per-speaker waveform chunks out of memory-mapped float32 shards
// and assembles the [B, S, T] source batch, gain-scaled, without the Python
// per-chunk loop.  Speaker, offset and gain selection stays in numpy
// (data/mixer.py::Mixer.plan keeps the deterministic (seed, step) contract);
// only the memory-bound copy and scale runs here.
//
// A host library, not a CUDA kernel: built with g++ -O3 -shared -fPIC by
// ops/kernels/build.py::build_native, bound with ctypes in data/native.py.
// g * s[i] is one float32 product per sample, as numpy's gain * chunk is, so
// the batch is bit for bit the numpy loop's (data/native.py::batch_fill_ref).

#include <cstdint>

extern "C" {

// Gather B*S chunks into out[B*S*T], scaling by gains.  For chunk j:
//   src  = shards[speaker_idx[j]] + starts[j], length min(T, len - start)
//   tail (if shard shorter than T) wraps around to the shard head (numpy's
//   np.resize tiling).
void amss_batch_fill(float* out, int64_t n_chunks, int64_t T,
                     const float* const* shards, const int64_t* shard_lens,
                     const int32_t* speaker_idx, const int64_t* starts,
                     const float* gains) {
  for (int64_t j = 0; j < n_chunks; ++j) {
    const float* src = shards[speaker_idx[j]];
    const int64_t len = shard_lens[speaker_idx[j]];
    float g = gains[j];
    float* dst = out + j * T;
    if (len <= 0) {  // an empty shard: zero-fill, never read src
      for (int64_t i = 0; i < T; ++i) dst[i] = 0.0f;
      continue;
    }
    int64_t remaining = T;
    // clamp into [0, len): a manifest n_samples that disagrees with the
    // actual .npy must not turn into an out-of-bounds read or negative take
    int64_t pos = starts[j] % len;
    if (pos < 0) pos += len;
    while (remaining > 0) {
      int64_t avail = len - pos;
      int64_t take = avail < remaining ? avail : remaining;
      const float* s = src + pos;
      for (int64_t i = 0; i < take; ++i) dst[i] = g * s[i];
      dst += take;
      remaining -= take;
      pos = 0;  // wrap (short shards tile)
    }
  }
}

}  // extern "C"
