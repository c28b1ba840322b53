// K5 lbm_cluster_chunk: up to 512 D2Q9-BGK steps of a small grid held in
// the shared memory of one thread block cluster, whose CTAs hand each
// other their edge rows through distributed shared memory (DSMEM) and step
// in lockstep behind hardware cluster barriers.
//
// Replaces tpulbm/ops/pallas_resident.py:63 _kernel (make_resident_step):
// up to 512 steps of a small grid held whole in VMEM, ping-ponged there.
// That TPU kernel keeps the grid in fast on-chip memory; Hopper's
// counterpart here is the cluster: 16 CTAs on neighbouring SMs write each
// other's shared memory behind cluster barriers. K2 (csrc/resident.cu)
// holds the grid in the shared memory of 128 CTAs instead, handing edges
// between neighbours through global memory, and runs every resident grid.
// The 1-D skew's chunks (tpulbm/ops/pallas_kstep_skew.py:94,
// tpulbm/ops/pallas_kstep.py:79) run on K4 (csrc/kstep_tile.cu): cluster
// tiles of 8 stacked CTAs in this design took 1.29-1.33x K4's time at
// 1024^2 (PERF.md).
//
// The step. A CTA's window holds one shared copy of its rows (nine
// populations and the mask, ten planes) and a halo row on each side where
// a neighbour CTA's edge row belongs. A thread computes its cells from the
// window into registers (lbm_cell.cuh; every load local, at a constant
// offset from the cell); a relaxed cluster arrive marks its reads done, a
// block barrier lets the CTA write its own rows back, the cluster wait
// lets it push its first and last rows into the neighbours' halo rows
// (DSMEM stores), and a cluster barrier publishes the new state. A first
// version read the neighbours' rows through DSMEM at every use, with
// run-time strides, and was slower: ptxas kept each cell's twenty
// addresses in registers and spilled.
//
// The cluster. kCluster = 16 CTAs (non-portable); CTA r owns the band of
// ny / 16 rows (the first ny % 16 bands one row more) in a fixed window of
// 18 x 260 padded cells (halo rows and halo columns, so x wraps inside the
// window; 187,200 B), loaded once and stored once per chunk. Up to 2,048
// cells a CTA run 1,024 threads of 2 cells (64 registers), up to 4,096 run
// 512 threads of 8. Which grids fit, and which instance holds them, is
// ops/cluster.py's rule (resident_cells); the entry point only refuses
// what would overrun the window. Over 8 CTAs a 128^2 chunk took 1.36x the
// time of 16 (PERF.md).
//
// Bound. A chunk's function moves 76 B a cell and does ~94 fp32
// operations a cell update: at 128^2 over 512 steps operations bound it
// (0.012 ms). The design adds the shared-memory traffic of every update
// (ten loads, nine stores) and two cluster barriers a step, and uses 16 of
// the 132 SMs: a step costs about 2.3 us at 1,024 cells a CTA (128^2), and
// the time grows with the cells a CTA: K2 took 0.62x its time at 128^2,
// 0.51x at 128x256, 0.21x at 256^2 (PERF.md), so it is on no route;
// chip_smoke.py holds its state bitwise K2's.
//
// Per-step sums, no float atomics (reruns are bitwise): each CTA writes
// its partial of step s to (k, 16) partials and, after the last barrier,
// CTA r reduces rows r, r + 16, ... in reduce_row's order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPlanes = 10;               // nine populations, mask
constexpr int kMaxDevices = 64;
constexpr int kCluster = 16;              // CTAs of the cluster
constexpr int kMaxK = 512;                // steps of a launch
// A CTA's window: its band of rows with a halo row on each side (padded
// row 0 is global row y0 - 1, row rows + 1 is y0 + rows) and a halo column
// on each side (padded column px is global column px - 1 mod nx), in ten
// planes of kRows x kW floats whatever the grid, so that every load of a
// step is at a constant offset from the cell (run-time strides made ptxas
// keep each cell's twenty addresses in registers, and spill).
constexpr int kW = 260;                   // padded columns: nx <= 258
constexpr int kRows = 18;                 // padded rows: rows <= 16
constexpr int kPlane = kRows * kW;
constexpr int kSmem = kPlanes * kPlane * (int)sizeof(float);
// Bits of a cell's flags above its accelerated-row bits (0-2).
constexpr unsigned kWest = 8, kEast = 16, kSouth = 32, kNorth = 64,
                   kLive = 128;

// Threads of the instance holding kCells cells a thread: 1024 for up to 2
// (64 registers a thread), 512 for up to 8 (128).
__host__ __device__ constexpr int threads_for(int cells) {
  return cells <= 2 ? 1024 : 512;
}
static_assert(threads_for(8) >= tpulbm::kReduceThreads,
              "a CTA's threads reduce a row of partials");

// The old state of a window in this CTA's shared memory around window
// cell c (planes of `plane` floats, rows of w, plane 9 the mask, nonzero =
// blocked; bit dy + 1 of acc set where row y + dy is the accelerated row).
// A window carries its neighbours' edge rows as halo rows, pushed into it
// by the neighbour CTAs through DSMEM, so every load of a step is a local
// shared-memory load at a constant offset from c.
struct WindowSrc {
  const float* buf;
  int plane, w, c;
  unsigned acc;
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return buf[k * plane + c + dy * w + dx];
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return buf[9 * plane + c + dy * w + dx] == 0.0f;
  }
  __device__ __forceinline__ bool accel(int dy) const {
    return (acc >> (dy + 1)) & 1u;
  }
};

__host__ __device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Bits 0, 1, 2: global rows g - 1, g, g + 1 (mod ny) are the accelerated row.
__device__ __forceinline__ unsigned accel_bits(int g,
                                               const tpulbm::LbmArgs& a) {
  return (unsigned)(wrap(g - 1, a.ny) == a.accel_row) |
         (unsigned)(g == a.accel_row) << 1 |
         (unsigned)(wrap(g + 1, a.ny) == a.accel_row) << 2;
}

// Lane 0 gets the warp's sum (a fixed tree).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Stores one cell's nine populations at index i of a window (local or,
// through DSMEM, a neighbour's).
__device__ __forceinline__ void put9(float* buf, int i, const float* v) {
#pragma unroll
  for (int q = 0; q < 9; ++q) buf[q * kPlane + i] = v[q];
}

// First row of rank r's band: ny / 16 rows each, the first ny % 16 one more.
__host__ __device__ __forceinline__ int band_start(int r, int ny) {
  const int q = ny / kCluster, m = ny % kCluster;
  return r * q + (r < m ? r : m);
}

// barrier.cluster in two phases: a relaxed arrive (the loads of a step
// are complete once their values are used) and the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int kCells>
__global__ void __launch_bounds__(threads_for(kCells), 1)
    cluster_resident_kernel(const float* __restrict__ f_in,
                            const float* __restrict__ obst,
                            float* __restrict__ out,
                            float* __restrict__ partials,
                            float* __restrict__ sums, int k_steps,
                            tpulbm::LbmArgs a) {
  constexpr int kNT = threads_for(kCells), kNW = kNT / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sums[kNW];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int nx = a.nx, pw = nx + 2;
  const int y0 = band_start(r, a.ny);
  const int rows = band_start(r + 1, a.ny) - y0;
  const size_t gplane = (size_t)a.ny * nx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The window, once: nine planes and the mask, halos included.
  for (int i = threadIdx.x; i < (rows + 2) * pw; i += kNT) {
    const int pr = i / pw, px = i - pr * pw;
    const size_t g = (size_t)wrap(y0 - 1 + pr, a.ny) * nx +
                     (px == 0 ? nx - 1 : px == pw - 1 ? 0 : px - 1);
    float* d = smem + pr * kW + px;
#pragma unroll
    for (int q = 0; q < 9; ++q) d[q * kPlane] = __ldg(f_in + q * gplane + g);
    d[9 * kPlane] = __ldg(obst + g);
  }
  // Where this CTA's edge rows go: the lower halo row of rank r + 1 (its
  // padded row 0) takes this band's last row, the upper halo row of rank
  // r - 1 (its padded row rows + 1) this band's first row.
  const int rs = (r + kCluster - 1) % kCluster, rn = (r + 1) % kCluster;
  const int rows_s = band_start(rs + 1, a.ny) - band_start(rs, a.ny);
  float* const push_s =
      cluster.map_shared_rank(smem, rs) + (rows_s + 1) * kW;
  float* const push_n = cluster.map_shared_rank(smem, rn);

  // This thread's cells t + j * kNT of the band, fixed for the launch: the
  // padded index and the flags.
  int pc[kCells];
  unsigned fl[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int c = threadIdx.x + j * kNT;
    const int li = c / nx, x = c - li * nx;
    pc[j] = (li + 1) * kW + x + 1;
    fl[j] = c < rows * nx
                ? accel_bits(y0 + li, a) | (x == 0 ? kWest : 0u) |
                      (x == nx - 1 ? kEast : 0u) | (li == 0 ? kSouth : 0u) |
                      (li == rows - 1 ? kNorth : 0u) | kLive
                : 0u;
  }
  __syncthreads();

  for (int s = 0; s < k_steps; ++s) {
    float res[kCells][9];
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (fl[j] & kLive)
        acc += tpulbm::lbm_cell(WindowSrc{smem, kPlane, kW, pc[j], fl[j]},
                                tpulbm::RegDst{res[j]}, a);
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[warp] = acc;
    const bool last = s == k_steps - 1;
    if (!last) cluster_arrive_relaxed();   // this CTA's reads of state s end
    __syncthreads();
    if (warp == 0) {
      const float v = warp_sum(lane < kNW ? warp_sums[lane] : 0.0f);
      if (lane == 0) partials[(size_t)s * kCluster + r] = v;
    }
    if (last) {
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        if (fl[j] & kLive) {
          const int pr = pc[j] / kW, px = pc[j] - pr * kW;
          float* o = out + (size_t)(y0 + pr - 1) * nx + px - 1;
#pragma unroll
          for (int q = 0; q < 9; ++q) o[q * gplane] = res[j][q];
        }
      }
      break;
    }
    // State s + 1: this band and its halo columns; then, once every CTA
    // has read state s, the neighbours' halo rows.
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (!(fl[j] & kLive)) continue;
      put9(smem, pc[j], res[j]);
      if (fl[j] & kWest) put9(smem, pc[j] + nx, res[j]);
      if (fl[j] & kEast) put9(smem, pc[j] - nx, res[j]);
    }
    cluster_wait();
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (!(fl[j] & (kSouth | kNorth))) continue;
      const int px = pc[j] % kW;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (!(fl[j] & (side ? kNorth : kSouth))) continue;
        float* d = side ? push_n : push_s;
        put9(d, px, res[j]);
        if (fl[j] & kWest) put9(d, nx + 1, res[j]);
        if (fl[j] & kEast) put9(d, 0, res[j]);
      }
    }
    cluster.sync();   // state s + 1 is complete in every CTA
  }
  __threadfence();
  cluster.sync();   // every partial is written
  for (int s = r; s < k_steps; s += kCluster)
    tpulbm::reduce_row(partials, sums, s, kCluster, warp_sums);
}

// ------------------------------------------------------------------- host

cudaLaunchConfig_t launch_config(int threads, cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The most clusters of the kCells instance that the current device runs
// at once; its shared-memory limit and its non-portable cluster size are
// set first. Queried once per instance and device.
template <int kCells>
cudaError_t max_clusters(int* n) {
  static int cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    auto* kernel = cluster_resident_kernel<kCells>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config(threads_for(kCells), attr, 0);
    int count = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (count < 1) return cudaErrorLaunchOutOfResources;
    cache[dev] = count;
  }
  *n = cache[dev];
  return cudaSuccess;
}

template <int kCells>
int launch(const float* f, const float* obst, float* out, float* partials,
           float* sums, int k_steps, const tpulbm::LbmArgs& a,
           cudaStream_t stream) {
  int n = 0;
  cudaError_t e = max_clusters<kCells>(&n);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(threads_for(kCells), attr, stream);
  e = cudaLaunchKernelEx(&cfg, cluster_resident_kernel<kCells>, f, obst, out,
                         partials, sums, k_steps, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The window holds a band of the (ny, nx) grid in the kCells instance:
// ops/cluster.py's resident_cells chose it; this refuses what would overrun
// the window or the instance's registers.
bool holds(int ny, int nx, int cells) {
  const int rows = (ny + kCluster - 1) / kCluster;
  return (cells == 2 || cells == 8) && ny >= 2 * kCluster && nx >= 1 &&
         rows + 2 <= kRows && nx + 2 <= kW &&
         rows * nx <= cells * threads_for(cells);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a CTA, bytes (the fixed window).
int lbm_cluster_resident_smem() { return kSmem; }

// The most clusters of the instance of `cells` cells a thread (2 or 8)
// that the current device runs at once (cudaOccupancyMaxActiveClusters,
// queried once per instance and device); a negative CUDA error code where
// it is 0 or the query fails.
int lbm_cluster_resident_clusters(int cells) {
  int n = 0;
  cudaError_t e;
  switch (cells) {
    case 2: e = max_clusters<2>(&n); break;
    case 8: e = max_clusters<8>(&n); break;
    default: e = cudaErrorInvalidValue;
  }
  return e == cudaSuccess ? n : -(int)e;
}

// k_steps (1-512) steps of the (9, ny, nx) grid f_in -> out (distinct) in
// one cluster of 16 CTAs, `cells` cells a thread (2 or 8); obst the (ny,
// nx) float32 mask, nonzero = blocked; partials (k_steps, 16) floats; sums
// the k_steps per-step sums. Returns the launch's error code
// (cudaErrorInvalidValue where the instance does not hold the grid,
// cudaErrorLaunchOutOfResources where the device runs no such cluster).
int lbm_cluster_resident(const float* f_in, const float* obst, float* out,
                         float* partials, float* sums, int ny, int nx,
                         int k_steps, int cells, int accel_row, float omega,
                         float w1, float w2, cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  if (k_steps < 1 || k_steps > kMaxK || !holds(ny, nx, cells))
    return (int)cudaErrorInvalidValue;
  return cells == 2
             ? launch<2>(f_in, obst, out, partials, sums, k_steps, a, stream)
             : launch<8>(f_in, obst, out, partials, sums, k_steps, a, stream);
}

}  // extern "C"
