// The recurrence of one float32 bidirectional LSTM layer on the card: every
// time step of both directions in one launch (amss_blstm), for the live,
// gradient-free float32 path of amss_tpu_torch/models/blstm.py (``kernel``).
// The wrapper (ops/kernels/blstm.py) computes both directions' input
// projections first, in one float32 GEMM, and hands them in as xproj.
//
// It replaces no TPU kernel: the JAX package's blstm_stack is a lax.scan,
// which XLA compiles into one loop on the chip.  It was added because on this
// card cuDNN's LSTM launched about two kernels a time step, a direction and a
// layer (about 6,100 a deep-clustering call of 8 rows x 765 frames, 2 layers),
// each a few microseconds of work on 8 rows of 300 cells, so the card waited
// on the host between them, and the packed sequences it needs cost a copy of
// the mask to the host every call.
//
// What bounds it on this card: the chain of dependent steps.  A step's
// products are [R, H] x [H, 4H] in each direction, 8·R·H² operations (R 8,
// H 300: 5.8 MFLOP, 86 ns at 67 TFLOP/s), but step t needs every unit's h of
// step t - 1, so a step costs its latency: the products, the cell, and the
// exchange of h between the SMs that hold W_hh.  The design:
//   * one thread-block cluster of 16 blocks (a non-portable size, which
//     Hopper takes) per (direction, tile of rows); the tiles are as many as
//     the clusters that fit the card at once allow, half for each direction,
//     so that most SMs work;
//   * a block owns U = ceil(H / 16) hidden units, all four gates of each, and
//     holds that slice of W_hh (4U columns x H) in registers for the whole
//     launch, read from device memory once (a thread's share, at most
//     MAX_QUADS float4s of two columns, sets the largest H: 304); c and h of
//     its (row, unit) pairs stay in registers; its shared memory is padded
//     past half an SM's, so that a block has its SM to itself;
//   * a step: each thread takes two gate columns (i or f, and g or o, of one
//     unit) and a span of H and sums w·h for every row of the tile in FFMA,
//     float32, in the order of H; the spans' partials meet in shared memory
//     (two buffers, by the step's parity).  Four lanes a (row, unit), one a
//     gate, sum their gate's partials in a fixed order, add the step's
//     projection (prefetched two steps ahead into registers) and apply the
//     gate's activation (precise expf and tanhf; gates i, f, g, o as nn.LSTM
//     stores them); a shuffle brings the four gates to each lane, which
//     applies the cell and the mask (a masked step keeps h and c and outputs
//     0) and sends h to a quarter of the blocks of the cluster with st.async,
//     into their next h buffer, each store counted on that block's mbarrier
//     for the buffer (two buffers, by the step's parity); the first lane
//     writes h to out[b, t, dir·H + j].  Then every thread waits on its own
//     block's mbarrier for the whole next h.  No cluster-wide barrier in the
//     loop (one costs about 0.75 us, against 0.44 for this exchange, on this
//     card), and nothing waits across clusters;
//   * the backward direction walks t = T-1 ... 0.  All T steps run whatever
//     the mask, so any mask is taken and no length is needed on the host.
// No float atomics: a run repeats bit for bit.  amss_blstm issues one launch
// on the caller's stream, waits for nothing and allocates nothing.
//
// Measured on an H100 (clock64 in one block, 8 rows x 765 steps: 7 clusters
// of 16 fit at once, so 3 tiles of 3 rows): about 2.4 us a step, of which
// the products take ~1.0 (shared-memory reads of h: ~0.33 a row), the
// partials' sums and the gates ~0.65, and the 912 st.async a block sends
// ~0.7, counted where the loads and stores queued behind them wait.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int CLUSTER = 16;  // blocks a cluster
constexpr int MAX_TILE_ROWS = 8;  // rows a cluster carries
constexpr int MAX_TILES = 65535;  // the grid's y extent
constexpr int MAX_QUADS = 6;  // float4s along H of W_hh a thread holds in registers
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr size_t ONE_BLOCK_PER_SM = 116 * 1024;  // past half of an SM's 228 KB

// How a block of a cluster splits the work of hidden size h.
struct Layout {
  int units;   // U hidden units a block
  int cols;    // 4U gate columns: i, f, g, o of each unit
  int pairs;   // 2U threads over H's span: columns c and c + 2U each
  int quads;   // ceil(H / 4) float4s along H
  int span;    // quads a thread sums over
  int splits;  // spans of H
};

__host__ __device__ inline Layout layout_of(int h) {
  Layout l;
  l.units = (h + CLUSTER - 1) / CLUSTER;
  l.cols = 4 * l.units;
  l.pairs = 2 * l.units;
  l.quads = (h + 3) / 4;
  int ks = THREADS / l.pairs;
  if (ks < 1) ks = 1;
  if (ks > l.quads) ks = l.quads;
  l.span = (l.quads + ks - 1) / ks;
  l.splits = (l.quads + l.span - 1) / l.span;
  return l;
}

// the two mbarriers (16 bytes), h [2][rows][quads] float4, the partials
// [2][splits][rows][cols] float
__host__ __device__ inline size_t smem_bytes(const Layout& l, int rows) {
  return 16 * (1 + 2 * (size_t)rows * l.quads) + 4 * 2 * (size_t)l.splits * rows * l.cols;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address in block rank's shared memory of what lies at a in this block's
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// v to the peer's shared memory at a, counted on the peer's mbarrier at bar
__device__ __forceinline__ void send(unsigned a, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(a), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float dot4(const float4& w, const float4& v, float a) {
  a = fmaf(w.x, v.x, a);
  a = fmaf(w.y, v.y, a);
  a = fmaf(w.z, v.z, a);
  return fmaf(w.w, v.w, a);
}

// Row g·H + j of W_hh for gate column c = g·U + u (j = j0 + u), null past H.
__device__ __forceinline__ const float* w_row(const float* whh, int c, const Layout& l, int j0,
                                              int h) {
  const int g = c / l.units, j = j0 + c - g * l.units;
  return j < h ? whh + ((size_t)g * h + j) * h : nullptr;
}

// row[k .. k+3], zero past H, or zero where not ok
__device__ __forceinline__ float4 load4(const float* row, int k, int h, bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok && row != nullptr) {
    if (k < h) v.x = __ldg(row + k);
    if (k + 1 < h) v.y = __ldg(row + k + 1);
    if (k + 2 < h) v.z = __ldg(row + k + 2);
    if (k + 3 < h) v.w = __ldg(row + k + 3);
  }
  return v;
}

// grid (CLUSTER, tiles, 2 directions), clusters (CLUSTER, 1, 1); R >= rows, a
// power of 2.  xproj [B, T, 8H] (forward gates, then backward), whh_* [4H, H],
// mask [B, T] or null, out [B, T, 2H].
template <int R>
__global__ void __launch_bounds__(THREADS, 1)
    blstm_kernel(const float* __restrict__ xproj, const float* __restrict__ whh_f,
                 const float* __restrict__ whh_b, const float* __restrict__ mask,
                 float* __restrict__ out, int batch, int t_len, int h, int rows) {
  const int rank = (int)cg::this_cluster().block_rank();
  const int dir = blockIdx.z;
  const int row0 = blockIdx.y * rows;
  const int nrows = min(rows, batch - row0);  // the same in every block of the cluster
  const Layout l = layout_of(h);
  const int tid = threadIdx.x;
  const int j0 = rank * l.units;
  const int hp = 4 * l.quads;
  const unsigned step_bytes = 4u * nrows * h;  // the h of a step that reaches each block

  extern __shared__ float4 smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // [2]
  float4* hbuf = smem + 1;                                                // [2][rows][quads]
  float* part = reinterpret_cast<float*>(hbuf + 2 * (size_t)rows * l.quads);  // [2][splits][rows][cols]

  // the thread of gate columns ca (gates i, f) and cb = ca + 2U (g, o) over
  // the quads [q0, q0 + nq) of H
  const float* whh = dir == 0 ? whh_f : whh_b;
  const int ca = tid % l.pairs, split = tid / l.pairs, cb = ca + l.pairs;
  const bool prod = split < l.splits;
  const int q0 = split * l.span;
  const int nq = prod ? min(l.span, l.quads - q0) : 0;
  float4 wa[MAX_QUADS], wb[MAX_QUADS];
  {
    const float* ra = prod ? w_row(whh, ca, l, j0, h) : nullptr;
    const float* rb = prod ? w_row(whh, cb, l, j0, h) : nullptr;
#pragma unroll
    for (int q = 0; q < MAX_QUADS; ++q) {
      wa[q] = load4(ra, 4 * (q0 + q), h, q < nq);
      wb[q] = load4(rb, 4 * (q0 + q), h, q < nq);
    }
  }
  float* hf = reinterpret_cast<float*>(hbuf);
  for (int i = tid; i < 2 * rows * hp; i += THREADS) hf[i] = 0.f;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect_bytes(smem_addr(&bar[1]), step_bytes);  // step 0 writes buffer 1
  }

  // the thread of gate gl of (row r, unit u): four lanes a (row, unit), the
  // gates in lane order, where tid < 4·U·rows
  const int gl = tid & 3, cell = tid >> 2;
  const int u = cell % l.units, r = cell / l.units;
  const int j = j0 + u, b = row0 + r;
  const bool live = r < nrows && j < h;  // the same in the four lanes
  const int lane0 = (tid & 31) & ~3;
  const unsigned lanes = 0xFu << lane0;
  // this lane's projection, mask and output at step 0, and their moves a step
  const int t0 = dir == 0 ? 0 : t_len - 1;
  const ptrdiff_t way = dir == 0 ? 1 : -1;
  const size_t at0 = (size_t)b * t_len + t0;
  const float* xq = xproj + at0 * 8 * h + (size_t)dir * 4 * h + (size_t)gl * h + j;
  const float* mq = mask == nullptr ? nullptr : mask + at0;
  float* oq = out + at0 * 2 * h + (size_t)dir * h + j;
  const ptrdiff_t xway = way * 8 * (ptrdiff_t)h, oway = way * 2 * (ptrdiff_t)h;
  float x0 = 0.f, x1 = 0.f, m0 = 0.f, m1 = 0.f;
  if (live) {
    x0 = __ldg(xq);
    m0 = mq == nullptr ? 1.f : __ldg(mq);
    if (t_len > 1) {
      x1 = __ldg(xq + xway);
      m1 = mq == nullptr ? 1.f : __ldg(mq + way);
    }
  }
  float c_st = 0.f, h_st = 0.f;
  const unsigned own = smem_addr(hf + (size_t)r * hp + j);  // (r, j) in h buffer 0
  const unsigned buf_bytes = 4u * rows * hp;

  // every block of the cluster runs, with its zeros and mbarriers in place,
  // before anything is sent to it
  __syncwarp();
  cluster_sync();

  for (int s = 0; s < t_len; ++s) {
    const int par = s & 1, nb = par ^ 1;
    if (prod) {
      const float4* hc = hbuf + (size_t)par * rows * l.quads + q0;
      float acc_a[R], acc_b[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc_a[i] = acc_b[i] = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_QUADS; ++q) {
        if (q < nq) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if (i < nrows) {
              const float4 hv = hc[(size_t)i * l.quads + q];
              acc_a[i] = dot4(wa[q], hv, acc_a[i]);
              acc_b[i] = dot4(wb[q], hv, acc_b[i]);
            }
          }
        }
      }
      float* pp = part + ((size_t)par * l.splits + split) * rows * l.cols;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < nrows) {
          pp[(size_t)i * l.cols + ca] = acc_a[i];
          pp[(size_t)i * l.cols + cb] = acc_b[i];
        }
      }
    }
    __syncthreads();
    if (live) {
      // the partials in four running sums, in a fixed order, four loads in
      // flight at once; not unrolled further (unrolled it ran 2.09 against
      // 1.82 ms a layer at the serving shape on this card)
      const float* ps = part + ((size_t)par * l.splits * rows + r) * l.cols + gl * l.units + u;
      const int stride = rows * l.cols;
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;  // splits 4i, 4i + 1, 4i + 2, 4i + 3
      int sp = 0;
#pragma unroll 1
      for (; sp + 4 <= l.splits; sp += 4) {
        d0 += ps[sp * stride];
        d1 += ps[(sp + 1) * stride];
        d2 += ps[(sp + 2) * stride];
        d3 += ps[(sp + 3) * stride];
      }
      if (sp < l.splits) d0 += ps[sp * stride];
      if (sp + 1 < l.splits) d1 += ps[(sp + 1) * stride];
      if (sp + 2 < l.splits) d2 += ps[(sp + 2) * stride];
      const float z = x0 + ((d0 + d1) + (d2 + d3));
      const float act = gl == 2 ? tanhf(z) : sigmoid(z);
      const float ig = __shfl_sync(lanes, act, lane0), fg = __shfl_sync(lanes, act, lane0 + 1);
      const float gg = __shfl_sync(lanes, act, lane0 + 2), og = __shfl_sync(lanes, act, lane0 + 3);
      // the four lanes hold the same c and h
      const float cn = fg * c_st + ig * gg;
      const float hn = og * tanhf(cn);
      float h_out = 0.f;
      if (m0 > 0.f) {
        c_st = cn;
        h_st = h_out = hn;
      }
      // h to every block of the cluster, a quarter of them from each lane: its
      // next buffer, counted on its mbarrier
      const unsigned a = own + nb * buf_bytes, bb = smem_addr(&bar[nb]);
      for (int p = gl; p < CLUSTER; p += 4) send(peer_addr(a, p), h_st, peer_addr(bb, p));
      if (gl == 0) *oq = h_out;
      oq += oway;
      x0 = x1;
      m0 = m1;
      if (s + 2 < t_len) {
        x1 = __ldg(xq + 2 * xway);
        m1 = mq == nullptr ? 1.f : __ldg(mq + 2 * way);
      }
      xq += xway;
      if (mq != nullptr) mq += way;
    }
    // step s's h, from every block, in buffer nb: the mbarrier's (s / 2)-th phase
    wait_phase(smem_addr(&bar[nb]), (s >> 1) & 1);
    // step s + 1 writes buffer par, whose mbarrier finished its phase at s - 1
    if (tid == 0 && s + 1 < t_len) expect_bytes(smem_addr(&bar[par]), step_bytes);
  }
  // no block leaves while a peer may still address it
  __syncwarp();
  cluster_sync();
}

// What a launch takes: the tiles of rows and the rows a tile, and the shared
// memory a block.
struct Plan {
  int tiles, rows;
  size_t smem;
};

template <int R>
cudaError_t set_attributes(size_t smem) {
  const auto kernel = blstm_kernel<R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t config(dim3 grid, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

size_t padded(size_t smem) { return smem > ONE_BLOCK_PER_SM ? smem : ONE_BLOCK_PER_SM; }

// The clusters that fit the card at once, each block with its SM (0 where
// none does, the error cleared); then as many tiles as half of them, and as
// few rows a tile as that allows.  More rows take tiles of the most rows a
// block holds, and the clusters run in waves.
bool make_plan(int batch, int h, Plan& p) {
  const Layout l = layout_of(h);
  if (l.pairs > THREADS || l.span > MAX_QUADS) return false;
  // the most rows a tile whose threads and shared memory a block has
  int most = MAX_TILE_ROWS;
  while (most > 1 && (4 * l.units * most > THREADS || smem_bytes(l, most) > MAX_SMEM)) --most;
  if (4 * l.units * most > THREADS || smem_bytes(l, most) > MAX_SMEM) return false;
  const size_t top = padded(smem_bytes(l, most));
  int active = 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(CLUSTER, 1, 2), top, nullptr, &attr);
  if (set_attributes<MAX_TILE_ROWS>(top) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&active, (const void*)blstm_kernel<MAX_TILE_ROWS>, &cfg) !=
          cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  if (active < 1) return false;
  int tiles = active / 2 < 1 ? 1 : active / 2;
  if (tiles > batch) tiles = batch;
  int rows = (batch + tiles - 1) / tiles;
  if (rows > most) rows = most;
  tiles = (batch + rows - 1) / rows;
  if (tiles > MAX_TILES) return false;
  rows = (batch + tiles - 1) / tiles;
  p = Plan{tiles, rows, padded(smem_bytes(l, rows))};
  return true;
}

// The plans made so far, by (device, batch, h): the occupancy query runs once
// for each.
struct Cached {
  int device, batch, h;
  Plan plan;
};
constexpr int CACHE = 32;
Cached cache[CACHE];
int cached = 0;
std::mutex cache_lock;

bool plan_for(int batch, int h, Plan& p) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return false;
  std::lock_guard<std::mutex> hold(cache_lock);
  for (int i = 0; i < cached && i < CACHE; ++i) {
    if (cache[i].device == device && cache[i].batch == batch && cache[i].h == h) {
      p = cache[i].plan;
      return true;
    }
  }
  if (!make_plan(batch, h, p)) return false;
  cache[cached % CACHE] = Cached{device, batch, h, p};
  ++cached;
  return true;
}

template <int R>
cudaError_t launch(const Plan& p, const float* xproj, const float* whh_f, const float* whh_b,
                   const float* mask, float* out, int batch, int t, int h, cudaStream_t stream) {
  cudaError_t err = set_attributes<R>(p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(CLUSTER, p.tiles, 2), p.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, blstm_kernel<R>, xproj, whh_f, whh_b, mask, out, batch, t, h,
                           p.rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool sizes_ok(int batch, int t, int h) { return batch >= 1 && t >= 1 && h >= 1; }

}  // namespace

// One layer's recurrence, both directions, every step: 1 launch.  xproj
// [batch, t, 8h] holds x·W_ihᵀ + bias of the forward direction's four gates,
// then the backward's; whh_f and whh_b [4h, h] are W_hh as nn.LSTM stores
// them; mask [batch, t] (> 0 valid) or null (all valid); out [batch, t, 2h].
extern "C" int amss_blstm(const float* xproj, const float* whh_f, const float* whh_b,
                          const float* mask, float* out, int batch, int t, int h, void* stream) {
  if (!sizes_ok(batch, t, h)) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_for(batch, h, p)) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.rows <= 1) return (int)launch<1>(p, xproj, whh_f, whh_b, mask, out, batch, t, h, st);
  if (p.rows <= 2) return (int)launch<2>(p, xproj, whh_f, whh_b, mask, out, batch, t, h, st);
  if (p.rows <= 4) return (int)launch<4>(p, xproj, whh_f, whh_b, mask, out, batch, t, h, st);
  return (int)launch<8>(p, xproj, whh_f, whh_b, mask, out, batch, t, h, st);
}
