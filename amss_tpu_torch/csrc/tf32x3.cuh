// FP32-accurate products on Hopper's tensor cores (3xTF32), and the cp.async
// staging both kernels share.
//
// A TF32 operand keeps 10 of FP32's 23 mantissa bits, so one TF32 product is
// about 1e-3 off in relative terms.  3xTF32 splits each FP32 operand in
// registers into big = rna(a) and small = rna(a - big), both exact TF32
// values, and sums three products:
//   a*b ~ small_a*big_b + big_a*small_b + big_a*big_b
// The dropped small_a*small_b term is about 2^-22 of a*b, so the sum keeps
// close to FP32 accuracy (Precision.HIGHEST in the JAX package).
//
// The tensor cores add in FP32 with truncation at the magnitude of the running
// sum, so a long sum kept in one mma accumulator drifts by up to a unit in its
// last place per step, always towards zero.  (On an H100, 3 x 64 steps into one
// accumulator missed the plain version by 4e-4 on outputs of about 90.)  So
// the products of a few k-steps (Acc::step) are summed from zero in a partial
// tile, which Acc::promote then adds to the FP32 accumulator on the CUDA
// cores, which round to nearest.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace amss {

constexpr int PROMOTE = 2;  // k-steps summed on the tensor cores between promotions

// a = big + small, both TF32.  big rounds as cvt.rna.tf32.f32 does (to nearest,
// ties away from zero, low 13 bits cleared), in two integer operations and
// without cvt's guard for NaN; a NaN input still reaches the output through
// small = cvt.rna(a - big), which is NaN.
__device__ __forceinline__ void split_tf32(float a, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(a - __uint_as_float(big)));
}

// One operand fragment of m16n8k8, split: big[0..N) and small[0..N).
template <int N>
struct Frag {
  uint32_t big[N];
  uint32_t small[N];
  __device__ __forceinline__ void set(int i, float a) { split_tf32(a, big[i], small[i]); }
};

// d += a * b on one m16n8k8 tile, TF32 operands, FP32 accumulator.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a[0] (g, t)  a[1] (g+8, t)  a[2] (g, t+4)  a[3] (g+8, t+4)   A is 16 x 8, row-major
//   b[0] (t, g)  b[1] (t+4, g)                                   B is 8 x 8, k by n
//   d[0] (g, 2t) d[1] (g, 2t+1) d[2] (g+8, 2t) d[3] (g+8, 2t+1)  D is 16 x 8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Tiles of one warp: MT m16 tiles by NT n8 tiles, the FP32 accumulator and
// the partial sum of the k-steps since the last promotion.
template <int MT, int NT>
struct Acc {
  float acc[MT][NT][4];
  float part[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = part[m][n][q] = 0.0f;
  }

  // acc += part on the CUDA cores, then part = 0
  __device__ __forceinline__ void promote() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[m][n][q] += part[m][n][q];
          part[m][n][q] = 0.0f;
        }
  }

  // One k-step: part[m][n] += A[m] * B[n] for every pair of tiles, in three
  // passes (small*big, big*small, big*big) so that no two products into one
  // tile issue back to back.
  __device__ __forceinline__ void step(const Frag<4> (&a)[MT], const Frag<2> (&b)[NT]) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(part[m][n], a[m].small, b[n].big);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(part[m][n], a[m].big, b[n].small);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(part[m][n], a[m].big, b[n].big);
  }
};

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory.  When
// `valid` is false nothing is read and the destination is zero-filled (the
// source operand then only has to be some address of the tensor).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(n));
  }
}

// Let a kernel take all of an SM's shared memory (227 KB) and ask for the
// largest shared-memory carveout, so that L1's share does not cap the number
// of resident blocks.
constexpr int MAX_SMEM = 227 * 1024;

template <typename Kernel>
inline cudaError_t allow_max_shared(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace amss
