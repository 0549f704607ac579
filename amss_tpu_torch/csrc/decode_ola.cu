// Fused synthesis product + overlap-add for Hopper (sm_90a), FP32 on the CUDA
// cores, written as a gather: no scatter and no atomics.
//
//   y[b, c*hop + j] = sum_{i < r} sum_{kk < K} codes[b, c - i, kk] * basis[kk, i*hop + j]
//
// with r = win / hop, frames outside [0, nf) counting as zero, and y trimmed or
// zero-padded to `length` in the store.  Replaces the TPU kernel
// amss_tpu/ops/pallas/ola.py::_decode_ola_kernel (launched by
// _decode_ola_padded, pallas_call at line 72): the iSTFT of the main path
// with the window-folded inverse-DFT basis, and the learned decoder later.
//
// What bounds it on this card: at the iSTFT shape of the main path
// (codes [16, 997, 258], basis [258, 256], hop 64) the product is 2.1 GFLOP
// against 20.8 MB of inputs and output, about 100 FLOP per byte, above the
// FP32 ridge of the H100 (20 FLOP per byte).  So it is bound by FP32
// arithmetic.  The design:
//   * each block owns CB output hop-chunks by JB samples and stages the code
//     rows it needs, [c0 - (r-1), c0 + CB), in KC-column chunks in shared
//     memory, zero outside [0, nf): the frame tensor [B, nf, win] (a
//     win/hop-fold expansion) never exists in device memory;
//   * for each overlap i the matching basis slice [KC, JB] is staged too;
//   * each thread sums a 4x4 tile of outputs in registers, so every value
//     read from shared memory feeds four FMAs, and writes each output once.
// Unlike the TPU kernel it has no limit on hop or on r.  Plain FP32 FMA, no
// TF32, to match Precision.HIGHEST; the COLA divide stays outside.

#include <cuda_runtime.h>

namespace {

constexpr int CB = 64;   // output hop-chunks per block
constexpr int JB = 64;   // samples within a hop-chunk per block
constexpr int KC = 32;   // code columns per shared-memory chunk
constexpr int KCP = KC + 1;  // padded row stride of the code tile (no bank conflicts)
constexpr int TM = 4;    // chunks per thread
constexpr int TN = 4;    // samples per thread
constexpr int THREADS = (CB / TM) * (JB / TN);  // 256

__global__ void __launch_bounds__(THREADS)
decode_ola_kernel(const float* __restrict__ codes, const float* __restrict__ basis,
                  float* __restrict__ out, int nf, int k, int win, int hop, int length) {
  extern __shared__ float smem[];
  const int r = win / hop;
  const int rows = CB + r - 1;
  float* cs = smem;               // [rows][KCP] code rows c0-(r-1) .. c0+CB-1
  float* bsm = smem + rows * KCP; // [KC][JB] basis slice for one overlap

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CB;
  const int j0 = blockIdx.x * JB;
  const int tid = threadIdx.x;
  const int tx = tid % (JB / TN);  // sample group
  const int ty = tid / (JB / TN);  // chunk group
  const float* cb = codes + (long long)b * nf * k;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    __syncthreads();  // previous tiles consumed
    for (int e = tid; e < rows * KC; e += THREADS) {
      const int row = e / KC, kk = e % KC;
      const int f = c0 - (r - 1) + row, kc = k0 + kk;
      cs[row * KCP + kk] = (f >= 0 && f < nf && kc < k) ? cb[(long long)f * k + kc] : 0.0f;
    }
    for (int i = 0; i < r; ++i) {
      if (i > 0) __syncthreads();  // basis slice of overlap i-1 consumed
      for (int e = tid; e < KC * JB; e += THREADS) {
        const int kk = e / JB, jj = e % JB;
        const int kc = k0 + kk, j = j0 + jj;
        bsm[e] = (kc < k && j < hop) ? basis[(long long)kc * win + i * hop + j] : 0.0f;
      }
      __syncthreads();
      // chunk c = c0 + cc reads frame c - i, staged at row cc + (r-1) - i
      const float* crow = cs + (r - 1 - i) * KCP;
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float cv[TM], bv[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) cv[m] = crow[(ty + m * (CB / TM)) * KCP + kk];
#pragma unroll
        for (int n = 0; n < TN; ++n) bv[n] = bsm[kk * JB + tx + n * (JB / TN)];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(cv[m], bv[n], acc[m][n]);
      }
    }
  }

  float* yb = out + (long long)b * length;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const long long c = c0 + ty + m * (CB / TM);
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int j = j0 + tx + n * (JB / TN);
      const long long s = c * hop + j;
      // chunks past the last frame sum only zero rows: that is the zero pad
      if (j < hop && s < length) yb[s] = acc[m][n];
    }
  }
}

}  // namespace

extern "C" int amss_decode_ola(const float* codes, const float* basis, float* out,
                               int batch, int nf, int k, int win, int hop, int length,
                               void* stream) {
  const int r = win / hop;
  const size_t smem = sizeof(float) * ((size_t)(CB + r - 1) * KCP + (size_t)KC * JB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_ola_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_chunks = (length + hop - 1) / hop;
  const dim3 grid((hop + JB - 1) / JB, (n_chunks + CB - 1) / CB, batch);
  decode_ola_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      codes, basis, out, nf, k, win, hop, length);
  return (int)cudaGetLastError();
}
