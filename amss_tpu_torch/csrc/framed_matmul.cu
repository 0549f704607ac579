// Fused framing + basis product for Hopper (sm_90a), on the tensor cores.
//
//   out[b, f, k] = sum_{w < win} x[b, f*hop + w] * basis[w, k]
//
// Replaces the TPU kernel amss_tpu/ops/pallas/framed_matmul.py::_kernel
// (launched by _framed_matmul_padded, pallas_call at line 75): STFT analysis
// with a window-folded DFT basis, and the learned encoder of later recipes.
//
// What bounds it on this card: at the STFT shape of the main path
// (x [8, 64000], basis [256, 258], hop 64) the product is 1.054 GFLOP against
// 10.5 MB of inputs and output.  In 3xTF32 that is 3.16 GFLOP of TF32 at
// 495 TFLOP/s, 6.39 us, against 3.15 us for the bytes at 3.35 TB/s: bound by
// the tensor cores' operations.  (On the CUDA cores in FP32 it would be
// 15.73 us.)  The design:
//   * the product is a GEMM [frames x win] @ [win x K] whose A operand is a
//     Hankel view: row f of A is x[f*hop : f*hop + win].  mma.sync m16n8k8
//     takes its A fragment from registers that each thread loads from any
//     shared-memory address, so the block stages its signal span
//     x[b, f0*hop : f0*hop + (BM-1)*hop + win] once and feeds the fragments
//     straight from it; no frame tile exists in shared or device memory.
//     (wgmma's shared-memory A descriptor cannot express rows hop floats
//     apart.)
//   * precision: 3xTF32 with FP32 promotion every two k-steps (tf32x3.cuh)
//     keeps Precision.HIGHEST's accuracy.  Operands are split in registers.
//     Splitting each stage once in shared memory for all warps was measured
//     and was no faster: it doubles the shared-memory loads.
//   * bank conflicts: lanes g = 0..7 of an A fragment read frames g apart,
//     hop floats apart, all in one bank when hop = 64.  The span is stored
//     skewed, sample s at s + 4*(s / hop), so the frame stride is hop + 4,
//     which is 4 mod 8 words for any hop % 8 == 0: the 32 lanes hit 32 banks.
//     The basis stage has a row stride of BN + 16 = 104 = 8 mod 32 words, so
//     B-fragment lanes (t, g) hit bank 8t + g.
//   * asynchronous staging: the span and basis chunks of WC rows arrive by
//     cp.async in a two-stage ring; chunk c+1 loads while chunk c's mma run.
//     Basis rows are 4*K bytes (1032 at K = 258), 8-byte but not 16-byte
//     aligned, so they move as 8-byte copies when K is even and as 4-byte
//     copies otherwise; x rows move as 16-byte copies when t % 4 == 0 and
//     as 4-byte copies otherwise.
//   * ragged N: a block covers BN = 88 columns, 11 n8 tiles, so K = 258 pads
//     to 264 (2% waste); columns past K stage as zeros and are not stored.
//     Frames past nf are not stored, samples past t stage as zeros.
//   * occupancy: 64 frames x 88 columns per block of four warps (warp tile
//     16 x 88) gives 8 x 16 x 3 = 384 blocks on the main path.  The launch
//     bounds hold registers to 170 and the launch asks for the largest
//     shared-memory carveout, so three blocks fit on each SM (396 places)
//     and the grid runs in one wave; with the default carveout only two fit
//     and the grid ran in two waves.
//   * the output stores as float2, the (g, 2t) / (g, 2t+1) accumulator pairs,
//     when K is even.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int MT = 1;                 // m16 tiles (frames) per warp
constexpr int NT = 11;                // n8 tiles (columns) per warp
constexpr int WARPS = 4;              // warps stacked along frames
constexpr int BM = 16 * MT * WARPS;   // 64 frames per block
constexpr int BN = 8 * NT;            // 88 columns per block
constexpr int WC = 32;                // basis rows per stage
constexpr int LDB = BN + 16;          // 104 = 8 mod 32: B fragments free of bank conflicts
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS, 3)  // three blocks per SM: the main path in one wave
framed_matmul_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                     float* __restrict__ out, int t, int win, int hop, int k, int nf,
                     bool quads, bool pairs) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                // [2][WC][LDB] basis ring
  float* xs = smem + 2 * WC * LDB; // signal span, sample s at s + 4*(s/hop)

  const int b = blockIdx.z;
  const int f0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int fstride = hop + 4;

  const long long base = (long long)f0 * hop;
  const int span = (BM - 1) * hop + win;
  const float* xb = x + (long long)b * t;
  // the span, VEC samples per copy (4 when t % 4 == 0 and x is 16-byte
  // aligned: a quad never straddles t or a hop boundary, as span and hop are
  // multiples of 8); q = s / hop and rem = s % hop are kept without a division
  auto load_span = [&](auto vec) {
    constexpr int VEC = decltype(vec)::value, STEP = VEC * THREADS;
    int q = VEC * tid / hop, rem = VEC * tid % hop;
    for (int s = VEC * tid; s < span; s += STEP) {
      const long long idx = base + s;
      amss::cp_async<4 * VEC>(xs + s + 4 * q, idx < t ? xb + idx : xb, idx < t);
      q += STEP / hop;
      rem += STEP % hop;
      if (rem >= hop) {
        rem -= hop;
        ++q;
      }
    }
  };
  if (quads) load_span(std::integral_constant<int, 4>());
  else load_span(std::integral_constant<int, 1>());

  auto load_chunk = [&](int w0, float* dst) {
    if (pairs) {  // K even: 8-byte copies
      for (int e = tid; e < WC * (BN / 2); e += THREADS) {
        const int ww = e / (BN / 2), cc = 2 * (e % (BN / 2));
        const int w = w0 + ww, col = n0 + cc;
        const bool ok = w < win && col < k;
        amss::cp_async<8>(dst + ww * LDB + cc, ok ? basis + (long long)w * k + col : basis, ok);
      }
    } else {
      for (int e = tid; e < WC * BN; e += THREADS) {
        const int ww = e / BN, cc = e % BN;
        const int w = w0 + ww, col = n0 + cc;
        const bool ok = w < win && col < k;
        amss::cp_async<4>(dst + ww * LDB + cc, ok ? basis + (long long)w * k + col : basis, ok);
      }
    }
  };

  amss::Acc<MT, NT> acc;
  acc.zero();

  // One k-step: window rows w .. w+7, rows 8ks .. 8ks+7 of the stage at bsc.
  // Frame f, sample w + j sits at f*(hop+4) + ws + j for j < 8, where
  // ws = w + 4*(w/hop); the k-steps walk w, ws and wr = w % hop without a division.
  int ws = 0, wr = 0;
  auto kstep = [&](const float* bsc, int ks) {
    const float* xa = xs + (warp * MT * 16 + g) * fstride + ws + tq;
    amss::Frag<4> a[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* p = xa + m * 16 * fstride;
      a[m].set(0, p[0]);
      a[m].set(1, p[8 * fstride]);
      a[m].set(2, p[4]);
      a[m].set(3, p[8 * fstride + 4]);
    }
    const float* q = bsc + (8 * ks + tq) * LDB + g;
    amss::Frag<2> bf[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      bf[n].set(0, q[8 * n]);
      bf[n].set(1, q[4 * LDB + 8 * n]);
    }
    acc.step(a, bf);
    wr += 8;
    ws += wr == hop ? 12 : 8;
    wr = wr == hop ? 0 : wr;
  };

  load_chunk(0, bs);
  amss::cp_async_commit();  // group 0: the span and basis chunk 0
  const int nchunks = (win + WC - 1) / WC;
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) load_chunk((c + 1) * WC, bs + ((c + 1) & 1) * WC * LDB);
    amss::cp_async_commit();
    amss::cp_async_wait<1>();  // everything but chunk c+1 has landed
    __syncthreads();
    const float* bsc = bs + (c & 1) * WC * LDB;
    const int w0 = c * WC;
    if (w0 + WC <= win) {  // a full stage: unrolled, with no branch between k-steps
#pragma unroll
      for (int ks = 0; ks < WC / 8; ++ks) {
        kstep(bsc, ks);
        if ((ks + 1) % amss::PROMOTE == 0 || ks + 1 == WC / 8) acc.promote();
      }
    } else {  // the window's last rows (win % 8 == 0)
      for (int ks = 0; 8 * ks < win - w0; ++ks) kstep(bsc, ks);
      acc.promote();
    }
    __syncthreads();  // stage c & 1 consumed before chunk c+2 refills it
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
      const int f = f0 + warp * MT * 16 + m * 16 + g + 8 * h;
      if (f >= nf) continue;
      float* row = out + ((long long)b * nf + f) * k;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n0 + 8 * n + 2 * tq;
        const float v0 = acc.acc[m][n][2 * h], v1 = acc.acc[m][n][2 * h + 1];
        if (pairs) {
          if (col < k) *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          if (col < k) row[col] = v0;
          if (col + 1 < k) row[col + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" int amss_framed_matmul(const float* x, const float* basis, float* out,
                                  int batch, int t, int win, int hop, int k, int nf,
                                  void* stream) {
  const int span = (BM - 1) * hop + win;
  const size_t smem = sizeof(float) * ((size_t)2 * WC * LDB + span + 4 * (span / hop + 1));
  if (smem > amss::MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t e = amss::allow_max_shared(framed_matmul_kernel);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies of x need t % 4 == 0 and an aligned base; 8-byte copies of
  // basis rows and float2 stores need K even and aligned bases
  const bool quads = t % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool pairs = k % 2 == 0 && reinterpret_cast<uintptr_t>(basis) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const dim3 grid((k + BN - 1) / BN, (nf + BM - 1) / BM, batch);
  framed_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, basis, out, t, win, hop, k, nf, quads, pairs);
  return (int)cudaGetLastError();
}

extern "C" const char* amss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
