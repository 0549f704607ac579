// Fused framing + basis product for Hopper (sm_90a), FP32 on the CUDA cores.
//
//   out[b, f, k] = sum_{w < win} x[b, f*hop + w] * basis[w, k]
//
// Replaces the TPU kernel amss_tpu/ops/pallas/framed_matmul.py::_kernel
// (launched by _framed_matmul_padded, pallas_call at line 75): STFT analysis
// with a window-folded DFT basis, and the learned encoder of later recipes.
//
// What bounds it on this card: at the STFT shape of the main path
// (x [8, 64000], basis [256, 258], hop 64) the product is 1.05 GFLOP against
// 10.5 MB of inputs and output, about 100 FLOP per byte, above the FP32 ridge
// of the H100 (67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte).  So it is bound
// by FP32 arithmetic, and the design keeps the operands near the cores:
//   * each block stages its signal span x[b, f0*hop : f0*hop + (FB-1)*hop + win]
//     in shared memory once, so the win/hop-fold frame tensor never exists in
//     device memory (the point of the TPU kernel too);
//   * the basis is read in WC-row chunks into shared memory;
//   * each thread keeps a 4x4 tile of outputs in registers, so every value read
//     from shared memory feeds four FMAs.
// Plain FP32 FMA, no TF32, to match Precision.HIGHEST.  Moving the product to
// the tensor cores (3xTF32) is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int FB = 64;   // frames per block
constexpr int KB = 64;   // basis columns per block
constexpr int WC = 32;   // basis rows per shared-memory chunk
constexpr int TM = 4;    // frames per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (FB / TM) * (KB / TN);  // 256

__global__ void __launch_bounds__(THREADS)
framed_matmul_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                     float* __restrict__ out, int t, int win, int hop, int k, int nf) {
  extern __shared__ float smem[];
  float* bs = smem;             // [WC][KB] basis chunk
  float* xs = smem + WC * KB;   // signal span, (FB-1)*hop + win samples

  const int b = blockIdx.z;
  const int f0 = blockIdx.y * FB;
  const int k0 = blockIdx.x * KB;
  const int tid = threadIdx.x;
  const int tx = tid % (KB / TN);  // column group
  const int ty = tid / (KB / TN);  // frame group

  const long long base = (long long)f0 * hop;
  const int span = (FB - 1) * hop + win;
  const float* xb = x + (long long)b * t;
  for (int s = tid; s < span; s += THREADS) {
    const long long idx = base + s;
    xs[s] = idx < t ? xb[idx] : 0.0f;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int w0 = 0; w0 < win; w0 += WC) {
    __syncthreads();  // previous chunk consumed (and, first time, xs written)
    for (int e = tid; e < WC * KB; e += THREADS) {
      const int ww = e / KB, kk = e % KB;
      const int w = w0 + ww, kc = k0 + kk;
      bs[e] = (w < win && kc < k) ? basis[(long long)w * k + kc] : 0.0f;
    }
    __syncthreads();
    const int wn = min(WC, win - w0);
    for (int ww = 0; ww < wn; ++ww) {
      float xv[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[(ty + i * (FB / TM)) * hop + w0 + ww];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[ww * KB + tx + j * (KB / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int f = f0 + ty + i * (FB / TM);
    if (f >= nf) continue;
    float* row = out + ((long long)b * nf + f) * k;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kc = k0 + tx + j * (KB / TN);
      if (kc < k) row[kc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int amss_framed_matmul(const float* x, const float* basis, float* out,
                                  int batch, int t, int win, int hop, int k, int nf,
                                  void* stream) {
  const size_t smem = sizeof(float) * ((size_t)WC * KB + (size_t)(FB - 1) * hop + win);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        framed_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((k + KB - 1) / KB, (nf + FB - 1) / FB, batch);
  framed_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, basis, out, t, win, hop, k, nf);
  return (int)cudaGetLastError();
}

extern "C" const char* amss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
