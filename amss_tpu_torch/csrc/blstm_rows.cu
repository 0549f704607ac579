// The recurrence of one float32 bidirectional LSTM layer over many rows on the
// card: every time step of both directions in one launch (amss_blstm_rows),
// for the live, gradient-free float32 path of amss_tpu_torch/models/blstm.py
// (``kernel``) past ``MAX_ROWS`` rows (ops/kernels/blstm.py), where
// DPRNN-TasNet's paths run thousands of rows of H = 128.  The wrapper computes
// both directions' input projections first, in one float32 GEMM, and hands
// them in as xproj.  csrc/blstm.cu is the design for a few rows.
//
// It replaces no TPU kernel: the JAX package's blstm_stack is a lax.scan.  It
// was added because cuDNN's packed LSTM, which these rows took, enqueued its
// steps one by one (15-18 ms a layer at [3088, 250, 64] and [2000, 396, 64] on
// an H100, the host in the way), and csrc/blstm.cu, whose clusters of 16 carry
// at most 8 rows each, ran there in waves, 4x slower still.
//
// What bounds it on this card: operations.  A step's products are [R, H] x
// [H, 4H] in each direction, 8·R·H² operations; at R 3088, H 128 and 250
// steps a layer's recurrence is 2.0e11 FLOP, 3.0 ms at 67 TFLOP/s of FFMA.  A
// step's work is large enough to fill the card once the rows are cut into
// tiles, so the design is a float32 GEMM per step in every SM, kept in one
// launch:
//   * a cluster of 2 blocks per (direction, tile of rows); the tile is the
//     fewest rows (a multiple of 16, at most 96) that lets the tiles of both
//     directions run in one wave of the clusters that fit the card at once;
//   * a block owns U = ceil(H / 2) hidden units, all four gates of each, and
//     holds that slice of W_hh (4U columns x H, 128 KB at H = 128) in shared
//     memory for the whole launch, read from device memory once, beside two
//     buffers of the tile's h ([H][rows] each);
//   * a thread owns 8 rows x 2 units (8 gate columns) and sums their 64
//     products over H in FFMA, float32, in the order of H, from 16-byte
//     shared-memory loads that a warp's threads share (2 row groups x 16 unit
//     groups a warp); its accumulators start from the step's projection,
//     loaded while the thread waits for the step's h.  It applies the cell
//     itself (precise expf and tanhf; gates i, f, g, o as nn.LSTM stores them)
//     and keeps c in registers.  A masked step keeps h and c (h read back from
//     the buffer it was sent to) and outputs 0;
//   * each thread sends its new h to both blocks of the cluster with st.async
//     (16 bytes at a time) into their next h buffer, each store counted on
//     that block's mbarrier for the buffer (two buffers, by the step's
//     parity), writes h to out[b, t, dir·H + j], and waits on its own block's
//     mbarrier for the next h.  A warp row (16 rows over all of the block's
//     units, two warps) needs the h of its own rows alone, so each warp row
//     has its own pair of mbarriers and runs its steps apart from the others:
//     one warp row's products fill the issue slots while another applies its
//     cells or waits for its h (6.3 -> 5.8 ms a layer at [3088, 250] against
//     one pair a block).  No cluster-wide barrier in the loop, and nothing
//     waits across clusters;
//   * the backward direction walks t = T-1 ... 0.  All T steps run whatever
//     the mask, so any mask is taken and no length is needed on the host.
// No float atomics: a run repeats bit for bit.  amss_blstm_rows issues one
// launch on the caller's stream, waits for nothing and allocates nothing.
//
// Measured on an H100 (153 registers, 0 spills): 5.8 ms at [3088, 250] and
// 7.0 at [2000, 396], 52% and 44% of the FFMA bound.  Without the products a
// launch still took 2.2 and 2.9 ms: the cells' precise expf and tanhf (~0.6
// ms; approximate ones are 1e-5 off), the projections' reads (~0.4-0.6) and
// each step's latency.  An L2 prefetch of the next step's projections, 8-byte
// loads of them, 1 or 4 row groups a warp, unrolling the sum 2 or 8 deep,
// staggered warp rows and plain local stores for the block's own h each ran
// no faster at those shapes.  The input projection stays a GEMM ahead of the kernel: W_ih's
// slice (64 KB at In 64) does not fit beside W_hh's and the h buffers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 2;        // blocks a cluster: a direction's W_hh in two
constexpr int UNIT_GROUPS = 32;   // threads along a block's units, 2 units each
constexpr int GROUP_ROWS = 8;     // rows a thread
constexpr int WARP_GROUPS = 2;    // row groups a warp (x 16 unit groups)
constexpr int MAX_GROUPS = 12;    // row groups a block: 96 rows, 384 threads
constexpr int MAX_WARP_ROWS = MAX_GROUPS / WARP_GROUPS;  // warp rows a block, each its own pipeline
constexpr int THREADS = MAX_GROUPS * UNIT_GROUPS;
constexpr int MAX_HIDDEN = CLUSTER * 2 * UNIT_GROUPS;  // 128
constexpr int MAX_TILES = 65535;  // the grid's y extent
constexpr size_t MAX_SMEM = 227 * 1024;

// the mbarriers [2][MAX_WARP_ROWS] (padded to 128 bytes), W_hh's slice
// [H][2][UNIT_GROUPS] float4, two h buffers [2][H][2][groups] float4
constexpr int BAR_QUADS = 8;
__host__ __device__ constexpr size_t smem_bytes(int h, int groups) {
  return 16 * (BAR_QUADS + (size_t)h * 2 * UNIT_GROUPS + 2 * (size_t)h * 2 * groups);
}
static_assert(smem_bytes(MAX_HIDDEN, MAX_GROUPS) <= MAX_SMEM, "the largest block fits an SM");

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

// v to the peer's shared memory at a (16-byte aligned), counted on the peer's
// mbarrier at bar
__device__ __forceinline__ void send4(unsigned a, const float4& v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
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

// The step's projections (acc[r][4e + gate]) and mask (m[r]) of the thread's
// rows b0 + r and units j0 + e; 0 past the batch or H.
__device__ __forceinline__ void load_step(const float* __restrict__ xproj,
                                          const float* __restrict__ mask, int t, int t_len,
                                          int h, int batch, int b0, int j0, int dir, bool live0,
                                          bool live1, float (&acc)[GROUP_ROWS][8],
                                          float (&m)[GROUP_ROWS]) {
#pragma unroll
  for (int r = 0; r < GROUP_ROWS; ++r) {
    const bool ok = b0 + r < batch;
    const size_t at = (size_t)(ok ? b0 + r : 0) * t_len + t;
    const float* xr = xproj + at * 8 * h + (size_t)dir * 4 * h + j0;
    m[r] = !ok ? 0.f : mask == nullptr ? 1.f : __ldg(mask + at);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      acc[r][g] = ok && live0 ? __ldg(xr + (size_t)g * h) : 0.f;
      acc[r][4 + g] = ok && live1 ? __ldg(xr + (size_t)g * h + 1) : 0.f;
    }
  }
}

// grid (CLUSTER, tiles, 2 directions), clusters (CLUSTER, 1, 1), blocks of
// groups·UNIT_GROUPS threads (groups a multiple of WARP_GROUPS); a tile is
// groups·GROUP_ROWS rows.  xproj [B, T, 8H] (forward gates, then backward),
// whh_* [4H, H], mask [B, T] or null, out [B, T, 2H].
__global__ void __launch_bounds__(THREADS, 1)
    blstm_rows_kernel(const float* __restrict__ xproj, const float* __restrict__ whh_f,
                      const float* __restrict__ whh_b, const float* __restrict__ mask,
                      float* __restrict__ out, int batch, int t_len, int h, int groups) {
  const int rank = (int)cg::this_cluster().block_rank();
  const int dir = blockIdx.z;
  const int rows = groups * GROUP_ROWS;
  const int units = (h + 1) / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = groups * UNIT_GROUPS;
  constexpr int WARP_UNITS = 32 / WARP_GROUPS;  // unit groups a warp
  constexpr int UNIT_WARPS = UNIT_GROUPS / WARP_UNITS;
  // a warp row: WARP_GROUPS row groups over every unit group, UNIT_WARPS
  // warps; it needs the h of its own rows alone, so it runs its steps apart
  // from the other warp rows, on its own mbarriers
  const int wr = warp / UNIT_WARPS, warp_rows = groups / WARP_GROUPS;
  const int ug = (warp % UNIT_WARPS) * WARP_UNITS + lane % WARP_UNITS;
  const int rg = wr * WARP_GROUPS + lane / WARP_UNITS;
  const bool leader = warp % UNIT_WARPS == 0 && lane == 0;  // arms the warp row's mbarriers
  // the h of a step of a warp row's rows that reaches each block
  const unsigned step_bytes = 4u * WARP_GROUPS * GROUP_ROWS * h;

  extern __shared__ float4 smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // [2][MAX_WARP_ROWS]
  float4* ws = smem + BAR_QUADS;                            // [H][2][UNIT_GROUPS]
  float4* hs = ws + (size_t)h * 2 * UNIT_GROUPS;            // [2][H][2][groups]
  const size_t hbuf = (size_t)h * 2 * groups;               // float4s a buffer

  // ws[k][e][g][gate] = W_hh[gate·H + j][k] for the unit j = rank·U + 2g + e,
  // 0 past U or H; read along k
  {
    const float* whh = dir == 0 ? whh_f : whh_b;
    float* wsf = reinterpret_cast<float*>(ws);
    const int cols = 2 * UNIT_GROUPS * 4;
    for (int i = tid; i < h * cols; i += nthreads) {
      const int k = i % h, col = i / h;
      const int gate = col & 3, g = (col >> 2) % UNIT_GROUPS, e = (col >> 2) / UNIT_GROUPS;
      const int lu = 2 * g + e, j = rank * units + lu;
      wsf[(size_t)k * cols + col] =
          lu < units && j < h ? __ldg(whh + ((size_t)gate * h + j) * h + k) : 0.f;
    }
  }
  float* hsf = reinterpret_cast<float*>(hs);
  for (int i = tid; i < 4 * (int)hbuf; i += nthreads) hsf[i] = 0.f;  // h before step 0
  if (tid == 0) {
    for (int i = 0; i < 2 * MAX_WARP_ROWS; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int w = 0; w < warp_rows; ++w)  // step 0 writes buffer 1
      expect_bytes(smem_addr(&bar[MAX_WARP_ROWS + w]), step_bytes);
  }

  // the thread's rows b0 + r (r = 4·half + i) and units j0 + e
  const int b0 = blockIdx.y * rows + rg * GROUP_ROWS;
  const int lu0 = 2 * ug, j0 = rank * units + lu0;
  const bool live0 = lu0 < units && j0 < h, live1 = lu0 + 1 < units && j0 + 1 < h;
  const int t0 = dir == 0 ? 0 : t_len - 1, way = dir == 0 ? 1 : -1;
  float acc[GROUP_ROWS][8], m[GROUP_ROWS], c_st[2][GROUP_ROWS];
#pragma unroll
  for (int r = 0; r < GROUP_ROWS; ++r) c_st[0][r] = c_st[1][r] = 0.f;
  load_step(xproj, mask, t0, t_len, h, batch, b0, j0, dir, live0, live1, acc, m);

  // every block of the cluster runs, with its zeros and mbarriers in place,
  // before anything is sent to it
  __syncwarp();
  cluster_sync();

  const float4* wp0 = ws + ug;
  for (int s = 0, t = t0; s < t_len; ++s, t += way) {
    const int par = s & 1, nb = par ^ 1;
    const float4* hc = hs + par * hbuf;
    {
      const float4* hp = hc + rg;
      const float4* wp = wp0;
#pragma unroll 4
      for (int k = 0; k < h; ++k) {
        const float4 h0 = hp[0], h1 = hp[groups];
        const float4 w0 = wp[0], w1 = wp[UNIT_GROUPS];
        const float hv[GROUP_ROWS] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < GROUP_ROWS; ++r) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(hv[r], wv[q], acc[r][q]);
        }
        hp += 2 * groups;
        wp += 2 * UNIT_GROUPS;
      }
    }
    // the cell, unit by unit; h to both blocks' next buffer
    const unsigned bb = smem_addr(&bar[nb * MAX_WARP_ROWS + wr]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = e == 0 ? live0 : live1;
      if (!live) continue;
      const int j = j0 + e;
      const float4* held = hc + (size_t)j * 2 * groups + rg;  // h of step s - 1
      const float4 p0 = held[0], p1 = held[groups];
      const float prev[GROUP_ROWS] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float hn[GROUP_ROWS];
#pragma unroll
      for (int r = 0; r < GROUP_ROWS; ++r) {
        const float ig = sigmoid(acc[r][4 * e]), fg = sigmoid(acc[r][4 * e + 1]);
        const float gg = tanhf(acc[r][4 * e + 2]), og = sigmoid(acc[r][4 * e + 3]);
        const float cn = fg * c_st[e][r] + ig * gg;
        const float hv = og * tanhf(cn);
        float h_out = 0.f;
        hn[r] = prev[r];
        if (m[r] > 0.f) {
          c_st[e][r] = cn;
          hn[r] = h_out = hv;
        }
        if (b0 + r < batch) out[((size_t)(b0 + r) * t_len + t) * 2 * h + (size_t)dir * h + j] = h_out;
      }
      const float4 v0 = make_float4(hn[0], hn[1], hn[2], hn[3]);
      const float4 v1 = make_float4(hn[4], hn[5], hn[6], hn[7]);
      const unsigned a = smem_addr(hs + nb * hbuf + (size_t)j * 2 * groups + rg);
#pragma unroll
      for (int p = 0; p < CLUSTER; ++p) {
        send4(peer_addr(a, p), v0, peer_addr(bb, p));
        send4(peer_addr(a + 16u * groups, p), v1, peer_addr(bb, p));
      }
    }
    // the next step's projections and mask, in flight while h arrives
    if (s + 1 < t_len)
      load_step(xproj, mask, t + way, t_len, h, batch, b0, j0, dir, live0, live1, acc, m);
    // step s's h of the warp row's rows, from both blocks, in buffer nb: the
    // mbarrier's (s / 2)-th phase
    wait_phase(bb, (s >> 1) & 1);
    // step s + 1 writes buffer par, whose mbarrier finished its phase at s - 1
    if (leader && s + 1 < t_len)
      expect_bytes(smem_addr(&bar[par * MAX_WARP_ROWS + wr]), step_bytes);
  }
  // no block leaves while a peer may still address it
  __syncwarp();
  cluster_sync();
}

// What a launch takes: the tiles of rows, the row groups a tile, and the
// shared memory a block.
struct Plan {
  int tiles, groups;
  size_t smem;
};

cudaError_t set_attributes(size_t smem) {
  const auto kernel = blstm_rows_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaLaunchConfig_t config(dim3 grid, int groups, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(groups * UNIT_GROUPS, 1, 1);
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

// The clusters of the largest block (H = MAX_HIDDEN, MAX_GROUPS row groups)
// that fit the current device at once, asked once a device, where the
// largest block's dynamic shared memory, which every launch fits, is allowed
// too; 0 where the query fails.  The largest block takes an SM by its
// registers alone (384 threads), so the number holds at every H.
constexpr int MAX_DEVICES = 64;
int active_clusters[MAX_DEVICES];  // 0: not asked yet
std::mutex active_lock;

int active_on_device() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= MAX_DEVICES) return 0;
  std::lock_guard<std::mutex> hold(active_lock);
  if (active_clusters[device] > 0) return active_clusters[device];
  const size_t top = smem_bytes(MAX_HIDDEN, MAX_GROUPS);
  int active = 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(CLUSTER, 1, 2), MAX_GROUPS, top, nullptr, &attr);
  if (set_attributes(top) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&active, (const void*)blstm_rows_kernel, &cfg) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  active_clusters[device] = active;
  return active;
}

// The fewest row groups (a multiple of WARP_GROUPS, at most MAX_GROUPS) whose
// tiles of both directions fit the clusters that fit the card at once; more
// rows than that run in waves of the largest tile.
bool make_plan(int batch, int h, Plan& p) {
  if (h < 1 || h > MAX_HIDDEN) return false;
  const int active = active_on_device();
  if (active < 1) return false;
  const int per_dir = active / 2 < 1 ? 1 : active / 2;
  const int rows = (batch + per_dir - 1) / per_dir;
  int groups = (rows + GROUP_ROWS - 1) / GROUP_ROWS;
  groups = (groups + WARP_GROUPS - 1) / WARP_GROUPS * WARP_GROUPS;
  if (groups > MAX_GROUPS) groups = MAX_GROUPS;
  const int tile = groups * GROUP_ROWS;
  const int tiles = (batch + tile - 1) / tile;
  if (tiles > MAX_TILES) return false;
  p = Plan{tiles, groups, smem_bytes(h, groups)};
  return true;
}

}  // namespace

// One layer's recurrence over many rows, both directions, every step: 1
// launch.  xproj [batch, t, 8h] holds x·W_ihᵀ + bias of the forward
// direction's four gates, then the backward's; whh_f and whh_b [4h, h] are
// W_hh as nn.LSTM stores them; mask [batch, t] (> 0 valid) or null (all
// valid); out [batch, t, 2h].  h at most 128.
extern "C" int amss_blstm_rows(const float* xproj, const float* whh_f, const float* whh_b,
                               const float* mask, float* out, int batch, int t, int h,
                               void* stream) {
  if (batch < 1 || t < 1 || h < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(batch, h, p)) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(dim3(CLUSTER, p.tiles, 2), p.groups, p.smem, (cudaStream_t)stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, blstm_rows_kernel, xproj, whh_f, whh_b, mask,
                                             out, batch, t, h, p.groups);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
