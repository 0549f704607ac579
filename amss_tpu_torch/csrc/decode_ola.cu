// Fused synthesis product + overlap-add for Hopper (sm_90a), on the tensor
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
// (codes [16, 997, 258], basis [258, 256], hop 64) the product is 2.108 GFLOP
// against 20.8 MB of inputs and output.  In 3xTF32 that is 6.32 GFLOP of TF32
// at 495 TFLOP/s, 12.78 us, against 6.22 us for the bytes at 3.35 TB/s: bound
// by the tensor cores' operations.  (On the CUDA cores in FP32 it would be
// 31.45 us.)  The design:
//   * the sum is a GEMM [chunks x (r*K)] @ [(r*K) x hop] whose A operand is a
//     Hankel view: row c, block i of A is codes[c - i].  A block owns BM
//     hop-chunks by BN samples and stages the code rows [c0 - (r-1), c0 + BM)
//     in KC-column chunks; overlap i reads them r-1-i rows down, so mma.sync
//     takes its A fragments straight from the staged rows and the frame
//     tensor [B, nf, win] never exists.
//   * precision: 3xTF32 with FP32 promotion every two k-steps (tf32x3.cuh)
//     keeps Precision.HIGHEST's accuracy.  Operands are split in registers.
//   * bank conflicts: code rows are staged KC + 4 words apart (36, 20 or 12,
//     each 4 mod 8), so the A-fragment lanes (g, t) hit 32 different banks;
//     the basis stage has rows BN + 8 = 72 = 8 mod 32 words apart, so
//     B-fragment lanes hit bank 8t + g.
//   * asynchronous staging: each K chunk (code rows, and the basis slice of
//     every overlap) arrives by cp.async in a two-stage ring; chunk k0+KC
//     loads while chunk k0's mma run.  Code rows are 4*K bytes (1032 at
//     K = 258), 8-byte but not 16-byte aligned, so they move as 8-byte copies
//     when K is even and as 4-byte copies otherwise; basis rows move as
//     16-byte copies when win % 4 == 0.
//   * ragged K: K = 258 is not a multiple of 8.  Columns past K stage as
//     zeros (cp.async with no source bytes), so the last k-step sums zeros.
//   * edges: frames outside [0, nf) stage as zeros; a chunk past the last
//     frame sums zero rows, which is the zero pad; samples at or past
//     `length` are not stored.  Any r works while the ring fits in shared
//     memory: KC shrinks from 32 to 16 or 8 for long windows (r up to 46).
//   * occupancy: 128 chunks x 64 samples per block of eight warps (warp tile
//     32 x 32) gives 16 x 8 = 128 blocks on the main path, one per SM in one
//     wave.  Blocks of 64 chunks (256 blocks, two per SM) and blocks of
//     sixteen warps with 16 x 32 warp tiles were both measured slower.
//   * the output stores as float2, the (g, 2t) / (g, 2t+1) accumulator pairs,
//     when `length` is even.
// The COLA divide stays outside.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int MT = 2;                    // m16 tiles (hop-chunks) per warp
constexpr int NT = 4;                    // n8 tiles (samples) per warp
constexpr int WARPS_M = 4;               // warps along chunks
constexpr int WARPS_N = 2;               // warps along samples
constexpr int BM = 16 * MT * WARPS_M;    // 128 hop-chunks per block
constexpr int BN = 8 * NT * WARPS_N;     // 64 samples per block
constexpr int LDB = BN + 8;              // 72 = 8 mod 32: B fragments free of bank conflicts
constexpr int THREADS = 32 * WARPS_M * WARPS_N;

// floats of one stage: code rows, then the basis slice of every overlap
__host__ __device__ constexpr int stage_floats(int r, int kc) {
  return (BM + r - 1) * (kc + 4) + r * kc * LDB;
}

template <int KC>  // code columns per stage
__global__ void __launch_bounds__(THREADS)
decode_ola_kernel(const float* __restrict__ codes, const float* __restrict__ basis,
                  float* __restrict__ out, int nf, int k, int win, int hop, int length,
                  bool code_pairs, bool basis_quads, bool out_pairs) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldc = KC + 4;
  const int r = win / hop;
  const int rows = BM + r - 1;
  const int stage = stage_floats(r, KC);

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane / 4, tq = lane % 4;
  const float* cb = codes + (long long)b * nf * k;

  // code rows c0-(r-1) .. c0+BM-1, columns k0 .. k0+KC, at cs[row * ldc + col],
  // VEC floats per copy
  auto load_codes = [&](int k0, float* cs, auto vec) {
    constexpr int VEC = decltype(vec)::value, PER_ROW = KC / VEC;
    for (int e = tid; e < rows * PER_ROW; e += THREADS) {
      const int row = e / PER_ROW, cc = VEC * (e % PER_ROW);
      const int f = c0 - (r - 1) + row, col = k0 + cc;
      const bool ok = f >= 0 && f < nf && col < k;  // VEC = 2 only when K is even
      amss::cp_async<4 * VEC>(cs + row * ldc + cc, ok ? cb + (long long)f * k + col : cb, ok);
    }
  };
  // basis[k0 + kk, i*hop + j0 + jj] for every overlap i, at bsm[(i*KC + kk) * LDB + jj]
  auto load_basis = [&](int k0, float* bsm, auto vec) {
    constexpr int VEC = decltype(vec)::value, PER_ROW = BN / VEC;
    for (int e = tid; e < r * KC * PER_ROW; e += THREADS) {
      const int ik = e / PER_ROW, jj = VEC * (e % PER_ROW);  // ik = i * KC + kk
      const int i = ik / KC, kr = k0 + ik % KC, j = j0 + jj;
      const bool ok = kr < k && j < hop;  // hop % 8 == 0: all VEC columns or none
      amss::cp_async<4 * VEC>(bsm + ik * LDB + jj,
                              ok ? basis + (long long)kr * win + i * hop + j : basis, ok);
    }
  };
  auto load_chunk = [&](int k0, float* cs) {
    if (code_pairs) load_codes(k0, cs, std::integral_constant<int, 2>());
    else load_codes(k0, cs, std::integral_constant<int, 1>());
    if (basis_quads) load_basis(k0, cs + rows * ldc, std::integral_constant<int, 4>());
    else load_basis(k0, cs + rows * ldc, std::integral_constant<int, 1>());
  };

  amss::Acc<MT, NT> acc;
  acc.zero();

  // one k-step of overlap i: code columns 8ks .. 8ks+7 of the stage, from the
  // rows at ca, against basis rows 8ks .. 8ks+7 of that overlap at cbs
  auto kstep = [&](const float* ca, const float* cbs, int ks) {
    amss::Frag<4> a[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* p = ca + m * 16 * ldc + 8 * ks;
      a[m].set(0, p[0]);
      a[m].set(1, p[8 * ldc]);
      a[m].set(2, p[4]);
      a[m].set(3, p[8 * ldc + 4]);
    }
    amss::Frag<2> bf[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* q = cbs + 8 * ks * LDB + 8 * n;
      bf[n].set(0, q[0]);
      bf[n].set(1, q[4 * LDB]);
    }
    acc.step(a, bf);
  };

  load_chunk(0, smem);
  amss::cp_async_commit();
  const int nchunks = (k + KC - 1) / KC;
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) load_chunk((c + 1) * KC, smem + ((c + 1) & 1) * stage);
    amss::cp_async_commit();
    amss::cp_async_wait<1>();  // everything but chunk c+1 has landed
    __syncthreads();
    const float* cs = smem + (c & 1) * stage;
    const float* bsm = cs + rows * ldc;
    const int cols = min(KC, k - c * KC);
    for (int i = 0; i < r; ++i) {
      // chunk c0 + m reads frame c0 + m - i, staged at row m + (r-1-i)
      const float* ca = cs + (r - 1 - i + wm * MT * 16 + g) * ldc + tq;
      const float* cbs = bsm + (i * KC + tq) * LDB + wn * NT * 8 + g;
      if (cols == KC) {  // a full stage: unrolled, with no branch between k-steps
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
          kstep(ca, cbs, ks);
          if ((ks + 1) % amss::PROMOTE == 0 || ks + 1 == KC / 8) acc.promote();
        }
      } else {  // K's last columns; the last k-step may sum zero columns
        for (int ks = 0; 8 * ks < cols; ++ks) kstep(ca, cbs, ks);
        acc.promote();
      }
    }
    __syncthreads();  // stage c & 1 consumed before chunk c+2 refills it
  }

  float* yb = out + (long long)b * length;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
      const long long c = c0 + wm * MT * 16 + m * 16 + g + 8 * h;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = j0 + wn * NT * 8 + 8 * n + 2 * tq;  // even, and hop is even
        if (j >= hop) continue;
        const long long s = c * hop + j;
        const float v0 = acc.acc[m][n][2 * h], v1 = acc.acc[m][n][2 * h + 1];
        if (out_pairs) {  // length even, so s < length means s + 1 < length
          if (s < length) *reinterpret_cast<float2*>(yb + s) = make_float2(v0, v1);
        } else {
          if (s < length) yb[s] = v0;
          if (s + 1 < length) yb[s + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" int amss_decode_ola(const float* codes, const float* basis, float* out,
                               int batch, int nf, int k, int win, int hop, int length,
                               void* stream) {
  const int r = win / hop;
  int kc = 32;  // the widest K chunk whose two-stage ring fits
  while (kc > 8 && 2 * sizeof(float) * (size_t)stage_floats(r, kc) > amss::MAX_SMEM) kc /= 2;
  const size_t smem = 2 * sizeof(float) * (size_t)stage_floats(r, kc);
  if (smem > amss::MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = kc == 32 ? decode_ola_kernel<32>
              : kc == 16 ? decode_ola_kernel<16> : decode_ola_kernel<8>;
  const cudaError_t e = amss::allow_max_shared(kernel);
  if (e != cudaSuccess) return (int)e;
  const bool code_pairs = k % 2 == 0 && reinterpret_cast<uintptr_t>(codes) % 8 == 0;
  const bool basis_quads = win % 4 == 0 && reinterpret_cast<uintptr_t>(basis) % 16 == 0;
  const bool out_pairs = length % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const int n_chunks = (length + hop - 1) / hop;
  const dim3 grid((hop + BN - 1) / BN, (n_chunks + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      codes, basis, out, nf, k, win, hop, length, code_pairs, basis_quads, out_pairs);
  return (int)cudaGetLastError();
}
