// Clip by the global norm and Adam's update over a whole list of float32
// tensors in two launches: the multi-tensor optimizer step of
// amss_tpu_torch/train/optim.py::Adam.step on a card.
//
// It replaces no TPU kernel: the JAX package leaves optax's clip and Adam to
// XLA, which fuses them.  It was added because the per-tensor PyTorch version
// runs about 22 small kernels a tensor (about 7000 a Conv-TasNet step), each
// launched from Python, and the host's launching, not the card, set the pace
// of a training step.
//
// What bounds it on this card: bytes.  A step reads p, g, m and v and writes
// p, m and v, 28 bytes an element (32 with the norm pass's read of g), against
// about 15 floating-point operations: 8.4 us per million parameters at
// 3.35 TB/s.  The design:
//   * a chunk table, built once on the host for a list of shapes
//     (ops/kernels/multi_adam.py::plan_chunks), splits every tensor into
//     chunks of at most CHUNK elements; a chunk never crosses a tensor and a
//     block takes one chunk, so tensors of any size share one launch;
//   * the norm pass writes one float32 partial sum of g*g a chunk, with no
//     atomics: the sums are the same from run to run;
//   * the update pass first sums all the partials in one fixed order, in
//     float64, in every block, so that every block holds the same norm and
//     no third launch or host round trip is needed (block 0 leaves the norm
//     after the partials, where the tests read it); then it updates its chunk
//     with the plain version's float32 arithmetic, each operation rounded
//     once (no contraction into FMA);
//   * the chunk table stays on the device; the pointers of p, m, v and g
//     come in one small table copied each step, so a tensor that is replaced
//     or moves is always seen.  Nothing waits for the host or reads back;
//   * 16-byte loads and stores where a tensor's four pointers are 16-byte
//     aligned (chunks start at multiples of CHUNK), single floats otherwise;
//     the norm's per-thread order of sums is the same on both paths.
//
// The arithmetic is that of the plain version as PyTorch runs it on a card:
// a float32 tensor divided by a host number is multiplied by the number's
// float32 reciprocal there, so m / bc1 and v / bc2 are products by 1 / bc1
// and 1 / bc2, computed on the host in float32.  A step that does not clip
// is then bit-equal to the plain version on the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The plan (int64): one row (tensor, start, stop) a chunk.  The pointers
// (int64): [0, T) parameters, [T, 2T) first moments, [2T, 3T) second moments,
// [3T, 4T) gradients.
struct Chunk {
  int tensor;
  int64_t start;
  int n;
};

__device__ __forceinline__ Chunk chunk_of(const int64_t* __restrict__ plan) {
  const int64_t* row = plan + 3 * (int64_t)blockIdx.x;
  return Chunk{(int)row[0], row[1], (int)(row[2] - row[1])};
}

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
  // a fixed tree: the same sum whatever the timing
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = lane < WARPS ? shared[lane] : T(0);
  for (int o = WARPS / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // in every lane of every warp
}

__device__ __forceinline__ float sq_sum4(float acc, float4 x) {
  acc = __fmaf_rn(x.x, x.x, acc);
  acc = __fmaf_rn(x.y, x.y, acc);
  acc = __fmaf_rn(x.z, x.z, acc);
  return __fmaf_rn(x.w, x.w, acc);
}

__global__ void __launch_bounds__(THREADS)
multi_adam_norm_kernel(const int64_t* __restrict__ plan, const int64_t* __restrict__ ptrs,
                       float* __restrict__ partials, int n_tensors) {
  __shared__ float shared[WARPS];
  const Chunk c = chunk_of(plan);
  const float* g = reinterpret_cast<const float*>(ptrs[3 * n_tensors + c.tensor]) + c.start;
  const bool quads = reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int nq = c.n / 4;
  // thread i sums quads i, i + THREADS, ... and then the ragged quad, which
  // belongs to the thread that would own quad nq; each quad in element order
  float acc = 0.f;
  for (int q = threadIdx.x; q < nq; q += THREADS) {
    const float4 x = quads ? reinterpret_cast<const float4*>(g)[q]
                           : make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
    acc = sq_sum4(acc, x);
  }
  if (threadIdx.x == nq % THREADS)
    for (int i = 4 * nq; i < c.n; ++i) acc = __fmaf_rn(g[i], g[i], acc);
  const float total = block_sum(acc, shared);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

struct Consts {
  float max_norm, one_minus_b1, b1, one_minus_b2, b2, inv_bc1, inv_bc2, eps, neg_lr;
};

// One element: the plain version's operations in its order, each rounded once.
__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, bool keep,
                                         float norm, const Consts& k) {
  const float gc = keep ? g : __fmul_rn(__fdiv_rn(g, norm), k.max_norm);
  m = __fadd_rn(__fmul_rn(k.one_minus_b1, gc), __fmul_rn(k.b1, m));
  v = __fadd_rn(__fmul_rn(k.one_minus_b2, __fmul_rn(gc, gc)), __fmul_rn(k.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, k.inv_bc2)), k.eps);
  const float u = __fdiv_rn(__fmul_rn(m, k.inv_bc1), den);
  p = __fadd_rn(p, __fmul_rn(u, k.neg_lr));
}

__global__ void __launch_bounds__(THREADS)
multi_adam_update_kernel(const int64_t* __restrict__ plan, const int64_t* __restrict__ ptrs,
                         float* __restrict__ partials, int n_tensors, int n_chunks, Consts k) {
  __shared__ double shared[WARPS];
  __shared__ float norm_s;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_chunks; i += THREADS) acc += (double)partials[i];
  const double total = block_sum(acc, shared);
  if (threadIdx.x == 0) norm_s = __fsqrt_rn((float)total);
  __syncthreads();
  const float norm = norm_s;
  const bool keep = norm < k.max_norm;
  if (blockIdx.x == 0 && threadIdx.x == 0) partials[n_chunks] = norm;  // read by no block

  const Chunk c = chunk_of(plan);
  float* p = reinterpret_cast<float*>(ptrs[c.tensor]) + c.start;
  float* m = reinterpret_cast<float*>(ptrs[n_tensors + c.tensor]) + c.start;
  float* v = reinterpret_cast<float*>(ptrs[2 * n_tensors + c.tensor]) + c.start;
  const float* g = reinterpret_cast<const float*>(ptrs[3 * n_tensors + c.tensor]) + c.start;
  const bool quads = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
                       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) % 16) == 0;
  int first = 0;
  if (quads) {
    const int nq = c.n / 4;
    for (int q = threadIdx.x; q < nq; q += THREADS) {
      float4 pq = reinterpret_cast<float4*>(p)[q];
      const float4 gq = reinterpret_cast<const float4*>(g)[q];
      float4 mq = reinterpret_cast<float4*>(m)[q];
      float4 vq = reinterpret_cast<float4*>(v)[q];
      adam_one(pq.x, gq.x, mq.x, vq.x, keep, norm, k);
      adam_one(pq.y, gq.y, mq.y, vq.y, keep, norm, k);
      adam_one(pq.z, gq.z, mq.z, vq.z, keep, norm, k);
      adam_one(pq.w, gq.w, mq.w, vq.w, keep, norm, k);
      reinterpret_cast<float4*>(p)[q] = pq;
      reinterpret_cast<float4*>(m)[q] = mq;
      reinterpret_cast<float4*>(v)[q] = vq;
    }
    first = 4 * nq;
  }
  for (int i = first + threadIdx.x; i < c.n; i += THREADS) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_one(pi, g[i], mi, vi, keep, norm, k);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" int amss_multi_adam_norm(const int64_t* plan, const int64_t* ptrs, float* partials,
                                    int n_tensors, int n_chunks, void* stream) {
  if (n_chunks <= 0 || n_tensors <= 0) return (int)cudaErrorInvalidValue;
  multi_adam_norm_kernel<<<n_chunks, THREADS, 0, (cudaStream_t)stream>>>(
      plan, ptrs, partials, n_tensors);
  return (int)cudaGetLastError();
}

extern "C" int amss_multi_adam_update(const int64_t* plan, const int64_t* ptrs,
                                      float* partials, int n_tensors, int n_chunks,
                                      float max_norm, float one_minus_b1, float b1,
                                      float one_minus_b2, float b2, float inv_bc1,
                                      float inv_bc2, float eps, float neg_lr, void* stream) {
  if (n_chunks <= 0 || n_tensors <= 0) return (int)cudaErrorInvalidValue;
  const Consts k{max_norm, one_minus_b1, b1, one_minus_b2, b2, inv_bc1, inv_bc2, eps, neg_lr};
  multi_adam_update_kernel<<<n_chunks, THREADS, 0, (cudaStream_t)stream>>>(
      plan, ptrs, partials, n_tensors, n_chunks, k);
  return (int)cudaGetLastError();
}
