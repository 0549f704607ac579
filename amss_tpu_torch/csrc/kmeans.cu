// Weighted k-means of the deep-clustering serving path on the card: the
// farthest-point seeding, a fixed number of Lloyd steps and the final
// assignment in one C call (amss_kmeans), and the distance-softmax masks in a
// second (amss_soft_assignments), each step one pass over the embeddings.
// The arithmetic is that of amss_tpu_torch/ops/kmeans.py, the plain version.
//
// It replaces no TPU kernel: the JAX package's k-means is plain jnp, which
// XLA fuses.  It was added because on the card the plain version ran each
// step as several PyTorch kernels, among them a cuBLAS product with N = K = 2
// or 3 columns tiled 32 x 32, about 13 such products a call at ~2% of the
// card's bandwidth, with x read again for its norms and its weighted sums and
// [B, N, K] temporaries written and read between them.
//
// What bounds it on this card: bytes.  x is [B, N, E] float32 (the serving
// cell: [8, 98685, 40], 126 MB, more than the 50 MB L2), and a step needs
// about 2·K·E + E operations a point against 4·E bytes of it: one read of x a
// step at 3.35 TB/s is the bound.  The design:
//   * the pass kernel: a block owns one tile of THREADS consecutive points of
//     one batch row and stages it in shared memory as it lies in device
//     memory, the tile being contiguous, by 16-byte loads, neighbouring
//     threads on neighbouring addresses, where the tile is 16-byte aligned;
//     the centroids and their squared norms sit beside it.  Then a thread
//     takes one point: ||x||² and x·c_j in float32 FMAs in the order of E,
//     d_j = max((||x||² - 2 x·c_j) + ||c_j||², 0) as the plain version
//     writes it, each operation rounded once, and the argmin, the first
//     minimum winning.  What follows depends on the mode:
//       LLOYD    the block's sums of w·x and of w for each cluster, in a
//                fixed order, to per-tile partials [B, K·(E+1), tiles];
//       SEED     the tile's (max, first index) of w·min_j d_j over the
//                seeds so far, or, for the first seed, of the score the
//                wrapper gives: the plain version's own w·||x||², computed by
//                the same PyTorch expression on the same card.  Embeddings
//                of unit norm (deep clustering's) tie there, and only the
//                plain version's rounding picks its first seed;
//       ASSIGN   the int32 assignments;
//       DIST_SUM the tile's sum of d over its points and clusters;
//       SOFT     softmax(-d / (tau·scale)) over the clusters, with scale the
//                mean of d over the row's N·K entries (padded points in)
//                plus 1e-8, which every block forms from the DIST_SUM
//                partials in one fixed order;
//   * the update kernels: one warp an output centroid element sums its
//     partials and its cluster's weight over the tiles in a fixed order and
//     applies the plain version's rule (counts > 1e-8 ? sums / counts : the
//     old centroid); for the seeding, one warp a row takes the first maximum
//     over the tiles' and copies that point.  No float atomics anywhere, so a
//     run repeats bit for bit;
//   * shapes: K (1 to 4) is a template parameter, E (1 to 64) a runtime
//     size.  A tile is staged whole, so its shared memory grows with E:
//     45 KB at E = 40 and K = 2, 71 KB at 64 and 4 (dynamic shared memory
//     above 48 KB);
//   * amss_kmeans issues its 2·K + 2·iters + 1 launches on the caller's
//     stream, waits for nothing and allocates nothing: the wrapper
//     (ops/kernels/kmeans.py) gives it its outputs and scratch.
// Every C entry point returns the first CUDA error of its launches.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;  // points a tile, one a thread
constexpr int WARPS = THREADS / 32;
constexpr int MAX_E = 64;
constexpr int MAX_K = 4;
constexpr float EPS = 1e-8f;
constexpr int DEFAULT_SMEM = 48 * 1024;

enum Mode : int { LLOYD = 0, SEED = 1, ASSIGN = 2, DIST_SUM = 3, SOFT = 4 };

struct Pass {
  const float* x;     // [B, N, E]
  const float* w;     // [B, N]: LLOYD, SEED
  const float* score; // [B, N]: SEED, the first seed's
  const float* cent;  // [B, K, E]
  float* part;        // LLOYD [B, K·(E+1), tiles]; DIST_SUM [B, tiles], read by SOFT
  float* seed_val;    // SEED [B, tiles]
  int* seed_idx;      // SEED [B, tiles]
  int* assign;        // ASSIGN [B, N]
  float* masks;       // SOFT [B, N, K]
  int n, e, tiles;
  int seeds;  // SEED: the centroids chosen so far
  float tau;  // SOFT
};

__host__ __device__ constexpr int pairs_of(int k, int e) { return k * (e + 1); }

// Shared memory of a pass block: the tile, the slots of the Lloyd sums, the
// tile's weights and assignments, the centroids and their norms.
__host__ __device__ inline size_t smem_floats(int k, int e) {
  return (size_t)THREADS * e + 2 * THREADS + 2 * THREADS + (size_t)k * e + k;
}

// a fixed tree: the same sum whatever the timing
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // shared may still be read by a previous call
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = lane < WARPS ? shared[lane] : T(0);
  // a butterfly over the whole warp: a + b == b + a, so every lane ends
  // with the same sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // in every lane of every warp
}

// (value, index) ordered by value, then by the smaller index: the first
// maximum of torch.argmax, whatever the order of the comparisons
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Copy cnt floats, contiguous in device memory, to shared memory: 16 bytes a
// thread where the source is 16-byte aligned.
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                                      int cnt) {
  int first = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int q = cnt >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < q; i += THREADS) d4[i] = __ldg(s4 + i);
    first = 4 * q;
  }
  for (int i = first + threadIdx.x; i < cnt; i += THREADS) dst[i] = __ldg(src + i);
}

// The tile's first maximum of (v, i) over its threads, to seed_val/seed_idx.
__device__ __forceinline__ void seed_reduce(float v, int i, float* red, const Pass& a, int b,
                                            int tile) {
  float* wv = red;                                // [WARPS]
  int* wi = reinterpret_cast<int*>(red + WARPS);  // [WARPS]
  const int t = threadIdx.x;
  warp_argmax(v, i);
  if ((t & 31) == 0) {
    wv[t >> 5] = v;
    wi[t >> 5] = i;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 1; k < WARPS; ++k)
      if (better(wv[k], wi[k], v, i)) {
        v = wv[k];
        i = wi[k];
      }
    a.seed_val[(int64_t)b * a.tiles + tile] = v;
    a.seed_idx[(int64_t)b * a.tiles + tile] = i;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS) kmeans_pass_kernel(Pass a, int mode) {
  extern __shared__ float4 smem4[];
  const int e = a.e;
  // each part 16-byte aligned but cc: THREADS·e is a multiple of 4
  float* xs = reinterpret_cast<float*>(smem4);  // [THREADS, e], the tile as it lies
  float* red = xs + THREADS * e;                // [2·THREADS]: sums, reductions
  float* ws = red + 2 * THREADS;                // [THREADS]
  int* as = reinterpret_cast<int*>(ws + THREADS);  // [THREADS]
  float* cs = reinterpret_cast<float*>(as + THREADS);  // [K, e]
  float* cc = cs + K * e;                              // [K]

  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int p0 = tile * THREADS;
  const int np = min(THREADS, a.n - p0);
  const int64_t row0 = (int64_t)b * a.n + p0;  // the tile's first point

  const int nc = mode == SEED ? a.seeds : K;  // the centroids this pass reads
  if (mode == SEED && nc == 0) {  // the first seed: the score alone
    const float v = t < np ? a.score[row0 + t] : -INFINITY;
    const int i = t < np ? p0 + t : INT_MAX;
    seed_reduce(v, i, red, a, b, tile);
    return;
  }
  stage(xs, a.x + row0 * e, np * e);
  for (int i = t; i < K * e; i += THREADS)
    cs[i] = i < nc * e ? a.cent[(int64_t)b * K * e + i] : 0.f;
  __syncthreads();
  if (t < K) {
    float s = 0.f;
    for (int i = 0; i < e; ++i) s = __fmaf_rn(cs[t * e + i], cs[t * e + i], s);
    cc[t] = s;
  }
  __syncthreads();

  // this thread's point: ||x||², x·c_j, d_j
  float xx = 0.f, d[K];
#pragma unroll
  for (int j = 0; j < K; ++j) d[j] = 0.f;
  if (t < np) {
    float dot[K];
#pragma unroll
    for (int j = 0; j < K; ++j) dot[j] = 0.f;
    const float* row = xs + t * e;
    if (e % 4 == 0) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const float4* c4 = reinterpret_cast<const float4*>(cs);
      const int e4 = e >> 2;
#pragma unroll
      for (int i = 0; i < e4; ++i) {
        const float4 v = row4[i];
        xx = __fmaf_rn(v.x, v.x, xx);
        xx = __fmaf_rn(v.y, v.y, xx);
        xx = __fmaf_rn(v.z, v.z, xx);
        xx = __fmaf_rn(v.w, v.w, xx);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float4 c = c4[j * e4 + i];
          dot[j] = __fmaf_rn(v.x, c.x, dot[j]);
          dot[j] = __fmaf_rn(v.y, c.y, dot[j]);
          dot[j] = __fmaf_rn(v.z, c.z, dot[j]);
          dot[j] = __fmaf_rn(v.w, c.w, dot[j]);
        }
      }
    } else {
      for (int i = 0; i < e; ++i) {
        const float v = row[i];
        xx = __fmaf_rn(v, v, xx);
#pragma unroll
        for (int j = 0; j < K; ++j) dot[j] = __fmaf_rn(v, cs[j * e + i], dot[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      d[j] = fmaxf(__fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, dot[j])), cc[j]), 0.f);
  }
  int best = 0;  // the first minimum
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (d[j] < d[best]) best = j;

  if (mode == ASSIGN) {
    if (t < np) a.assign[row0 + t] = best;
    return;
  }

  if (mode == SEED) {  // the farthest point from the seeds so far
    float v = -INFINITY;
    int i = INT_MAX;
    if (t < np) {
      float m = d[0];
#pragma unroll
      for (int j = 1; j < K; ++j)
        if (j < nc && d[j] < m) m = d[j];
      v = __fmul_rn(m, a.w[row0 + t]);
      i = p0 + t;
    }
    seed_reduce(v, i, red, a, b, tile);
    return;
  }

  if (mode == DIST_SUM) {
    float s = 0.f;
    if (t < np) {
#pragma unroll
      for (int j = 0; j < K; ++j) s = __fadd_rn(s, d[j]);
    }
    s = block_sum(s, red);
    if (t == 0) a.part[(int64_t)b * a.tiles + tile] = s;
    return;
  }

  if (mode == SOFT) {
    double acc = 0.0;  // the row's DIST_SUM partials, in one fixed order
    for (int i = t; i < a.tiles; i += THREADS) acc += (double)a.part[(int64_t)b * a.tiles + i];
    const double total = block_sum(acc, reinterpret_cast<double*>(red));
    const float mean = (float)(total / ((double)a.n * K));
    const float ts = __fmul_rn(a.tau, __fadd_rn(mean, EPS));
    if (t < np) {
      float z[K], top = -INFINITY;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        z[j] = __fdiv_rn(-d[j], ts);
        top = fmaxf(top, z[j]);
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        z[j] = expf(__fsub_rn(z[j], top));
        s = __fadd_rn(s, z[j]);
      }
      float* out = a.masks + (row0 + t) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) out[j] = __fdiv_rn(z[j], s);
    }
    return;
  }

  // LLOYD: the tile's sums of w·x and w by cluster.  Slot s is (pair, group):
  // pair (k, col) sums column col of the points of cluster k (col == e: the
  // weight alone), group g the points g, g + groups, ...; the groups of a
  // pair are added in order.
  ws[t] = t < np ? a.w[row0 + t] : 0.f;
  as[t] = best;
  __syncthreads();
  const int pairs = pairs_of(K, e);
  const int groups = max(1, THREADS / pairs);
  const int slots = pairs * groups;  // at most 2·THREADS: pairs <= 4·65
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = t + r * THREADS;
    if (s < slots) {
      const int pair = s % pairs, g = s / pairs;
      const int k = pair / (e + 1), col = pair % (e + 1);
      float sum = 0.f;
#pragma unroll 8
      for (int p = g; p < np; p += groups) {
        const float wk = as[p] == k ? ws[p] : 0.f;
        sum = __fmaf_rn(wk, col < e ? xs[p * e + col] : 1.f, sum);
      }
      red[s] = sum;
    }
  }
  __syncthreads();
  for (int pair = t; pair < pairs; pair += THREADS) {
    float total = red[pair];
    for (int g = 1; g < groups; ++g) total = __fadd_rn(total, red[g * pairs + pair]);
    a.part[((int64_t)b * pairs + pair) * a.tiles + tile] = total;
  }
}

// One warp an element (b, j, col) of the centroids: its Lloyd sum and its
// cluster's weight over the tiles, lanes over the tiles in a fixed order.
__global__ void __launch_bounds__(THREADS)
kmeans_update_kernel(const float* __restrict__ part, float* __restrict__ cent, int batch, int k,
                     int e, int tiles) {
  const int warp = (int)((blockIdx.x * (int64_t)THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= batch * k * e) return;  // the whole warp
  const int b = warp / (k * e), j = (warp / e) % k, col = warp % e;
  const int pairs = pairs_of(k, e);
  const float* ps = part + ((int64_t)b * pairs + j * (e + 1) + col) * tiles;
  const float* pw = part + ((int64_t)b * pairs + j * (e + 1) + e) * tiles;
  float s = 0.f, c = 0.f;
  for (int i = lane; i < tiles; i += 32) {
    s = __fadd_rn(s, ps[i]);
    c = __fadd_rn(c, pw[i]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, o));
  }
  if (lane == 0 && c > EPS) cent[((int64_t)b * k + j) * e + col] = __fdiv_rn(s, fmaxf(c, EPS));
}

// One warp a row: the first maximum over the tiles' (max, index), and that
// point copied in as centroid m.
__global__ void kmeans_seed_kernel(const float* __restrict__ x, const float* __restrict__ val,
                                   const int* __restrict__ idx, float* __restrict__ cent, int n,
                                   int k, int e, int tiles, int m) {
  const int b = blockIdx.x, lane = threadIdx.x;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int t = lane; t < tiles; t += 32) {
    const float tv = val[(int64_t)b * tiles + t];
    const int ti = idx[(int64_t)b * tiles + t];
    if (better(tv, ti, v, i)) {
      v = tv;
      i = ti;
    }
  }
  warp_argmax(v, i);
  if (i < 0 || i >= n) i = 0;  // no point was comparable (NaN scores)
  const float* src = x + ((int64_t)b * n + i) * e;
  float* dst = cent + ((int64_t)b * k + m) * e;
  for (int c = lane; c < e; c += 32) dst[c] = src[c];
}

template <int K>
cudaError_t launch_pass(const Pass& a, int mode, int batch, cudaStream_t stream) {
  const size_t smem = smem_floats(K, a.e) * sizeof(float);
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kmeans_pass_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kmeans_pass_kernel<K><<<dim3(a.tiles, batch), THREADS, smem, stream>>>(a, mode);
  return cudaGetLastError();
}

cudaError_t pass(const Pass& a, int mode, int k, int batch, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_pass<1>(a, mode, batch, stream);
    case 2: return launch_pass<2>(a, mode, batch, stream);
    case 3: return launch_pass<3>(a, mode, batch, stream);
    case 4: return launch_pass<4>(a, mode, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool sizes_ok(int batch, int n, int e, int k) {
  return batch > 0 && batch <= 65535 && n > 0 && e > 0 && e <= MAX_E && k > 0 && k <= MAX_K;
}

int tiles_of(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// The whole fit: K seeding passes (each followed by its seed's copy), iters
// Lloyd passes (each followed by its update) and the final assignment:
// 2·K + 2·iters + 1 launches.  score [B, N] is the first seed's score, w·||x||²
// as the plain version computes it.  part holds B·K·(E+1)·tiles floats,
// seed_val and seed_idx B·tiles each, tiles = ceil(N / 256).
extern "C" int amss_kmeans(const float* x, const float* w, const float* score, float* cent,
                           int* assign, float* part, float* seed_val, int* seed_idx, int batch,
                           int n, int e, int k, int iters, void* stream) {
  if (!sizes_ok(batch, n, e, k) || iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Pass a{x, w, score, cent, part, seed_val, seed_idx, assign, nullptr, n, e, tiles_of(n), 0, 0.f};
  cudaError_t err;
  for (int m = 0; m < k; ++m) {
    a.seeds = m;
    if ((err = pass(a, SEED, k, batch, st)) != cudaSuccess) return (int)err;
    kmeans_seed_kernel<<<batch, 32, 0, st>>>(x, seed_val, seed_idx, cent, n, k, e, a.tiles, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int update_blocks = (int)(((int64_t)batch * k * e * 32 + THREADS - 1) / THREADS);
  for (int it = 0; it < iters; ++it) {
    if ((err = pass(a, LLOYD, k, batch, st)) != cudaSuccess) return (int)err;
    kmeans_update_kernel<<<update_blocks, THREADS, 0, st>>>(part, cent, batch, k, e, a.tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)pass(a, ASSIGN, k, batch, st);
}

// The soft masks [B, N, K] around cent: the row sums of the distances, then
// the masks (2 launches).  part holds B·tiles floats.
extern "C" int amss_soft_assignments(const float* x, const float* cent, float* masks, float* part,
                                     int batch, int n, int e, int k, float tau, void* stream) {
  if (!sizes_ok(batch, n, e, k)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Pass a{x, nullptr, nullptr, cent, part, nullptr, nullptr, nullptr, masks, n, e, tiles_of(n),
         k, tau};
  cudaError_t err;
  if ((err = pass(a, DIST_SUM, k, batch, st)) != cudaSuccess) return (int)err;
  return (int)pass(a, SOFT, k, batch, st);
}
