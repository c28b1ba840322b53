// K4 lbm_kstep_tile: k <= 8 D2Q9-BGK steps in one launch, temporally
// blocked in shared memory, and the chunk's per-step sums of |u| (the last
// CTA to finish reduces the per-tile partials).
//
// Whole-grid mode replaces five TPU kernels that all compute this function,
// k fused steps per pass over device memory with a per-step sum of |u| over
// owned cells:
//   tpulbm/ops/pallas_kstep_skew_fold.py::_kernel (make_fold) and
//     ::_fix_kernel (make_fold_fix): the 2048^2 and 4096^2 decks;
//   tpulbm/ops/pallas_kstep_skew2d.py::_kernel (make_skew2d) with
//     tpulbm/ops/pallas_kstep_skew.py::_fix_tiled_kernel
//     (make_skew_fix_tiled): the 8192^2 deck;
//   tpulbm/ops/pallas_kstep2d.py::_kernel (make_kstep2d): the sub-8-step
//     remainder on those grids.
// On one card the route runs K6's grid kind (ring_p2p.cu::lbm_grid_p2p)
// instead, many chunks a launch with the same window and tile step: whole-
// grid mode, chunk by chunk, is its bitwise reference.
// Ring mode is the per-shard body of the 1-D ring (k steps of one shard
// given the k-row slabs of its two neighbours, and the per-step sum over
// the shard's rows): the function that every ring tier of the JAX package
// computes per device between two slab exchanges:
//   pallas_kstep_skew.py::_kernel with its seam ::_fix_kernel and
//     ::_fix_tiled_kernel (the 1-D and 2-D skew rings);
//   pallas_kstep_skew_fold.py::_kernel and ::_fix_kernel (the fold ring);
//   pallas_kstep_skew2d.py::_kernel; pallas_kstep.py::_kernel and
//     pallas_kstep2d.py::_kernel (the K-step rings and remainders);
//   pallas_kstep_bands.py::_kernel (the bands ring);
//   pallas_step.py::_kernel (k = 1: one step with 1-row halos).
// (The in-kernel exchange of pallas_kstep_rdma.py::_kernel and
// pallas_resident_rdma.py::_kernel is K6, ring_p2p.cu, which steps its
// tiles with this kernel's tile step, tile_step.cuh.)
// Torus mode is the per-block body of the 2-D torus (k steps of one block
// given its neighbours' k-column and corner-carrying k-row slabs, and the
// per-step sum over the block's cells): pallas_kstep.py::_kernel with
// x_halo=True (dist/runner.py::_make_runner_2d_kstep of the JAX package).
// A seam fix's function (a band of rows around a seam, stepped without
// wrapping) is ring mode's on the band cut into lo, shard and hi.
// Every shard takes ring mode and every block torus mode, whatever its
// shape: the TPU tiers' VMEM and alignment predicates (the torus's w >= 128
// and supported_x_halo among them) choose among TPU schedules and have no
// counterpart here.
// The folds, skews and seam fixes exist because a Pallas grid runs its
// programs in order on one core and hands slabs from one to the next; the
// skew leaves a seam band that a second kernel recomputes. Hopper CTAs run
// in no order, so K4 takes the margin recompute of pallas_kstep2d instead,
// which needs no order and leaves no seam: on one card the whole-grid pass
// is the whole function.
//
// Design. The output is cut into 32 x 32 owned tiles. A tile's window is
// its 32 + 2k rows by 32 + 2kx columns, kx = k rounded up to a multiple of
// 4: the nine populations and the mask. Stepped k times in shared memory,
// the window's computed rectangle shrinks by one cell per side and step
// (window-edge values go stale one cell per step; the kx - k columns at each
// side beyond the k-cell margin are loaded and never computed), and the last
// step's rectangle is exactly the owned tile, written straight to the
// output. Tiles past a ragged grid edge mask the cells they do not own, so
// any shape runs.
//   Persistent CTAs: the grid is cudaOccupancyMaxActiveBlocksPerMultiprocessor
//     x the SM count (at most one CTA a tile); CTA b walks tiles b, b + grid,
//     ... Each tile's k partials go to column `tile` of the (k, ntiles)
//     partials, so the sums do not depend on which CTA ran which tile.
//   Two stages: while a CTA steps one tile in one stage, the next tile's
//     window lands in the other by cp.async (async_copy.cuh), 16 B a copy
//     where every 4-column segment of a window row is contiguous and 16-B
//     aligned (nx % 4 == 0 and 16-B aligned tensors: the window's first
//     column 32 bx - kx is a multiple of 4 for every k), else 4 B.
//     Not TMA: a TMA descriptor holds its tensor's address, and every
//     chunk steps new tensors (a new output each chunk, new slabs on the
//     ring), so each launch would encode descriptors on the host through
//     the driver API, and the periodic wrap in x and y and ring mode's
//     three row sources would cut an edge tile's box into up to six. Each
//     thread's row and column wraps are computed once per window row and
//     column segment: no division or modulo per element.
//   State in registers (tile_step.cuh, shared with K6): one shared copy of
//     the window's state. Thread t
//     owns window cells t + j * 768 (j < 3), their coordinates computed once
//     per launch; at each step it computes those of its cells that lie in
//     the step's rectangle into registers, and after a barrier writes them
//     back (then a second barrier, before the next step reads). The last
//     step goes to device memory. A thread adds the |u| of its owned cells
//     into one register per step, warps sum by shuffles and one warp per
//     step sums the warp sums once per tile: no block-wide sum per step.
//   Shared memory: a stage is 10 planes of the window (the mask as float,
//     nonzero = blocked), 92,160 B at k = 8 and 60,800 B at k = 3; two
//     stages, 184,320 B and 121,600 B of dynamic shared memory, so one CTA
//     of 768 threads (24 warps, 80 registers a thread) per SM. At k = 8 a
//     thread's three cells fill the 48 x 48 window exactly; 512 and 640
//     threads measured slower and 1024 spill (PERF.md). A 48 x 48 owned
//     tile would recompute 1.32x where 32 x 32 recomputes 1.51x (12,336
//     updates for 8,192 owned cells at k = 8), but its one stage (147 KB)
//     leaves no room for a second: the load would not overlap (PERF.md).
//   One instance per k (1 to 8) and mode, so that every shared-memory
//     offset is a constant: one instance for any k took 1.14-1.16x the time
//     at k = 8, and a k = 3 instance 0.89x that one's time (PERF.md). The
//     dynamic shared-memory limit and the grid size are set once per
//     instance and device.
//
// Three addressing modes (Mode), template instances of one kernel body:
//   whole grid: src is the (9, ny, nx) grid, out distinct; window rows and
//     columns wrap modulo (ny, nx);
//   ring: the band of h + 2k rows is lo (9, k, nx), the shard mid
//     (9, h, nx) and hi (9, k, nx), in three buffers (a row's buffer is
//     picked once per window row at the load: no copy of the shard into a
//     band); band row 0 is global row row_base; out (9, h, nx) is the shard
//     after k steps. Band rows do not wrap (rows past the band are filled
//     as blocked cells, outside the owned cells' reach); columns wrap
//     modulo nx.
//   torus: the band of h + 2k rows and w + 2kx columns of an (h, w) block
//     (kx = col_margin(k)). Its rows [k, k + h) are three pieces side by
//     side, xlo (9, h, kx) | mid (9, h, w) | xhi (9, h, kx), whose k valid
//     columns sit next to the block (xlo's last k, xhi's first k; the
//     others are padding that no step reads); its first and last k rows
//     are lo and hi (9, k, w + 2kx), the row neighbours' slabs of their
//     x-extended bands, corners included. A column's piece is picked once
//     per column segment at the load, a row's buffer once per window row:
//     no copy of the block into a band. obst is the band's
//     (h + 2k, w + 2kx) mask. Neither rows nor columns wrap: window cells
//     past the band on any side are filled as blocked cells, outside the
//     owned cells' reach. out (9, h, w) is the block after k steps. kx is a
//     multiple of 4, so with w % 4 == 0 every 4-column segment of a window
//     row lies inside one piece, 16-B aligned.
// The inflow acceleration picks a source cell by its GLOBAL row,
// (row_base + source row) mod ny, with the knife-edge guard of lbm_cell.
//
// Bound. The function of a k = 8 chunk moves 76 B per cell: the nine
// populations and the mask in once, the nine populations out once, 9.5 B
// a cell-step. Its ~94 fp32 operations a cell update are less: so the
// bound is bytes, 1.52 ms a chunk (0.19 ms a step) at 8192^2 at 3.35 TB/s.
// The design adds work the function does not need: the 1.51x recompute,
// and about 80 B of shared-memory traffic per update (nine loads, a mask
// load, nine stores). In ring mode the function reads the band (h + 2k
// rows of populations and mask) and writes the h shard rows: bytes again; a
// shard of a small grid is a launch of few CTAs, so on the ring the host's
// launch path, not this bound, sets the pace below the widest decks
// (PERF.md).
//
// Per-step sums: per-tile partials in a fixed order, (k, ntiles) floats,
// reduced by the last CTA (lbm_cell.cuh::last_ticket, reduce_rows); no float
// atomics, so two runs give identical bytes.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "lbm_cell.cuh"
#include "tile_step.cuh"

namespace {

using namespace tpulbm::tile;

constexpr int kMaxDevices = 64;

enum class Mode { kGrid, kRing, kTorus };

// The buffers a window is loaded from: mid alone (whole grid), lo | mid |
// hi in rows (ring), and xlo | mid | xhi in columns between lo and hi
// (torus).
struct Sources {
  const float* lo;
  const float* mid;
  const float* hi;
  const float* xlo;
  const float* xhi;
};

// The output of one launch, (9, out_rows, out_cols). Whole grid: out_rows =
// ny, window row 0 of tile-row ty is grid row 32 ty - k (mod ny). Ring and
// torus: out_rows = h, window row 0 of tile-row ty is band row 32 ty; band
// row sr is lo's row sr (sr < k), mid's row sr - k or hi's row sr - k - h;
// row_base is the global row of band row 0. Whole grid and ring: out_cols =
// nx, window column 0 of tile-column bx is grid column 32 bx - col_margin(k)
// (mod nx). Torus: out_cols = w, window column 0 of tile-column bx is band
// column 32 bx.
struct TileArgs {
  int k;
  int out_rows;
  int out_cols;
  int row_base;
};

template <Mode kMode, int kK>
__global__ void __launch_bounds__(kThreads, 1)
    kstep_tile_kernel(Sources src, const float* __restrict__ obst,
                      float* __restrict__ out, float* __restrict__ partials,
                      float* __restrict__ sums, unsigned int* counter,
                      tpulbm::LbmArgs a, TileArgs t, int vec16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sums[kMaxK][kWarps];
  __shared__ unsigned char acc_rows[2][kMaxW];
  constexpr int k = kK;
  const int kx = col_margin(k);
  const int wh = kTile + 2 * k;    // window rows
  const int w = kTile + 2 * kx;    // window columns
  const int plane = wh * w;
  const int sfloats = stage_floats(k);
  const int tiles_x = (t.out_cols + kTile - 1) / kTile;
  const int ntiles = tiles_x * ((t.out_rows + kTile - 1) / kTile);
  const int band_rows = t.out_rows + 2 * k;        // ring and torus
  const int band_cols = t.out_cols + 2 * kx;       // torus
  const size_t oplane = (size_t)t.out_rows * t.out_cols;

  const Cells<kK> cells;

  // This thread's part of the window load: column segments sl + 16 m of
  // seg_w columns, window rows threadIdx.x / 16 + 32 i.
  const int sl = threadIdx.x & (kSegLanes - 1);
  const int seg_w = vec16 ? 4 : 1;

  // Issues the copy of tile `tile`'s window into stage `st`.
  auto issue = [&](int tile, int st) {
    const int ty = tile / tiles_x;
    const int y0 = ty * kTile, x0 = (tile - ty * tiles_x) * kTile;
    float* stage = smem + st * sfloats;
    // wcol: the segment's first window column; gcol: its grid column
    // (whole grid, ring) or band column (torus)
    int wcol[kMaxSegs], gcol[kMaxSegs];
#pragma unroll
    for (int m = 0; m < kMaxSegs; ++m) {
      wcol[m] = (sl + kSegLanes * m) * seg_w;
      gcol[m] = kMode == Mode::kTorus ? x0 + wcol[m]
                                      : wrap(x0 - kx + wcol[m], a.nx);
    }
    for (int wy = threadIdx.x / kSegLanes; wy < wh; wy += kRowSlots) {
      // sr: the row in the source rows (band or grid); r: its row in buf,
      // a buffer of `rows` rows of row_w columns
      int sr, r, rows, row_w = a.nx;
      const float* buf = src.mid;
      bool mid_row = true;
      if constexpr (kMode == Mode::kGrid) {
        sr = r = wrap(y0 - k + wy, a.ny), rows = a.ny;
      } else {
        sr = y0 + wy;
        r = sr - k, rows = t.out_rows;
        if (r < 0) {
          buf = src.lo, r = sr, rows = k, mid_row = false;
        } else if (r >= t.out_rows) {
          buf = src.hi, r -= t.out_rows, rows = k, mid_row = false;
        }
        if (kMode == Mode::kTorus && !mid_row) row_w = band_cols;
      }
      const bool in = kMode == Mode::kGrid || sr < band_rows;
      if (sl == 0)
        acc_rows[st][wy] =
            in && wrap(t.row_base + sr, a.ny) == a.accel_row;
      const float* mrow =
          obst + (size_t)sr * (kMode == Mode::kTorus ? band_cols : a.nx);
      float* drow = stage + wy * w;
#pragma unroll
      for (int m = 0; m < kMaxSegs; ++m) {
        if (wcol[m] >= w) break;
        float* d = drow + wcol[m];
        // g: the segment's first cell in plane 0 of its buffer, planes
        // bplane floats apart; null where the segment lies past the band.
        // Whole grid and ring rows, and the torus's lo and hi rows, are
        // one buffer; a middle torus row is xlo | mid | xhi.
        const float* g = nullptr;
        size_t bplane = (size_t)rows * row_w;
        const int c = gcol[m];
        if (!in || (kMode == Mode::kTorus && c >= band_cols)) {
        } else if (kMode != Mode::kTorus || !mid_row) {
          g = buf + (size_t)r * row_w + c;
        } else if (c < kx) {
          g = src.xlo + (size_t)r * kx + c;
          bplane = (size_t)t.out_rows * kx;
        } else if (c < kx + t.out_cols) {
          g = src.mid + (size_t)r * t.out_cols + (c - kx);
          bplane = oplane;
        } else {
          g = src.xhi + (size_t)r * kx + (c - kx - t.out_cols);
          bplane = (size_t)t.out_rows * kx;
        }
        if (!g) {
          for (int e = 0; e < seg_w; ++e) {
            for (int q = 0; q < 9; ++q) d[q * plane + e] = 0.0f;
            d[9 * plane + e] = 1.0f;
          }
        } else if (vec16) {
          for (int q = 0; q < 9; ++q)
            tpulbm::cp_async16(d + q * plane, g + q * bplane);
          tpulbm::cp_async16(d + 9 * plane, mrow + c);
        } else {
          for (int q = 0; q < 9; ++q)
            tpulbm::cp_async4(d + q * plane, g + q * bplane);
          tpulbm::cp_async4(d + 9 * plane, mrow + c);
        }
      }
    }
  };

  int st = 0;
  if (blockIdx.x < ntiles) issue(blockIdx.x, 0);
  tpulbm::cp_async_commit();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // The next tile's window flies while this one steps; stage st ^ 1 was
    // released by the barrier that ended the previous tile.
    if (tile + gridDim.x < ntiles) issue(tile + gridDim.x, st ^ 1);
    tpulbm::cp_async_commit();
    tpulbm::cp_async_wait<1>();
    __syncthreads();

    const int ty = tile / tiles_x;
    const int y0 = ty * kTile, x0 = (tile - ty * tiles_x) * kTile;
    step_tile<kK>(
        smem + st * sfloats, acc_rows[st], min(kTile, t.out_rows - y0),
        min(kTile, t.out_cols - x0), cells, warp_sums, a,
        [&](int oy, int ox, const float* res) {
          float* o = out + (size_t)(y0 + oy) * t.out_cols + x0 + ox;
#pragma unroll
          for (int q = 0; q < 9; ++q) o[q * oplane] = res[q];
        },
        [&](int s, float v) { partials[(size_t)s * ntiles + tile] = v; });
    st ^= 1;
  }
  tpulbm::cp_async_wait<0>();
  if (tpulbm::last_ticket(counter))
    tpulbm::reduce_rows(counter, partials, sums, k, ntiles);
}

// Dynamic shared memory of a k-step launch, bytes: two stages.
int smem_bytes(int k) { return 2 * stage_floats(k) * (int)sizeof(float); }

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// The persistent grid of an instance on the current device (CTAs a SM x
// SMs), its shared-memory limit set on first use.
template <Mode kMode, int kK>
cudaError_t configure(int* grid_cap) {
  static int cap[kMaxDevices];   // per device, 0 until configured
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cap[dev]) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kstep_tile_kernel<kMode, kK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(kK));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kstep_tile_kernel<kMode, kK>, kThreads, smem_bytes(kK));
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap[dev] = per_sm * sms;
  }
  *grid_cap = cap[dev];
  return cudaSuccess;
}

// Launches on the current device.
template <Mode kMode, int kK>
int launch(const Sources& src, const float* obst, float* out,
           float* partials, float* sums, unsigned int* counter,
           const tpulbm::LbmArgs& a, const TileArgs& t, cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = configure<kMode, kK>(&cap);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = ((t.out_cols + kTile - 1) / kTile) *
                     ((t.out_rows + kTile - 1) / kTile);
  const int grid = ntiles < cap ? ntiles : cap;
  bool vec16 = t.out_cols % 4 == 0 && aligned16(src.mid) && aligned16(obst);
  if (kMode != Mode::kGrid)
    vec16 = vec16 && aligned16(src.lo) && aligned16(src.hi);
  if (kMode == Mode::kTorus)
    vec16 = vec16 && aligned16(src.xlo) && aligned16(src.xhi);
  kstep_tile_kernel<kMode, kK><<<grid, kThreads, smem_bytes(kK), stream>>>(
      src, obst, out, partials, sums, counter, a, t, vec16 ? 1 : 0);
  return (int)cudaGetLastError();
}

// The instances of a mode, by k - 1.
using LaunchFn = int (*)(const Sources&, const float*, float*, float*,
                         float*, unsigned int*, const tpulbm::LbmArgs&,
                         const TileArgs&, cudaStream_t);
template <Mode kMode>
constexpr LaunchFn kLaunch[kMaxK] = {
    launch<kMode, 1>, launch<kMode, 2>, launch<kMode, 3>, launch<kMode, 4>,
    launch<kMode, 5>, launch<kMode, 6>, launch<kMode, 7>, launch<kMode, 8>};
constexpr cudaError_t (*kConfigure[kMaxK])(int*) = {
    configure<Mode::kGrid, 1>, configure<Mode::kGrid, 2>,
    configure<Mode::kGrid, 3>, configure<Mode::kGrid, 4>,
    configure<Mode::kGrid, 5>, configure<Mode::kGrid, 6>,
    configure<Mode::kGrid, 7>, configure<Mode::kGrid, 8>};

template <Mode kMode>
int launch_k(const Sources& src, const float* obst, float* out,
             float* partials, float* sums, unsigned int* counter,
             const tpulbm::LbmArgs& a, const TileArgs& t,
             cudaStream_t stream) {
  if (t.k < 1 || t.k > kMaxK || t.out_rows < 1 || t.out_cols < 1)
    return (int)cudaErrorInvalidValue;
  return kLaunch<kMode>[t.k - 1](src, obst, out, partials, sums, counter, a,
                                 t, stream);
}

}  // namespace

extern "C" {

// Tiles of a K4 launch whose output has `rows` rows of `cols` columns: the
// row length of its partials.
int lbm_kstep_tile_blocks(int rows, int cols) {
  return ((rows + kTile - 1) / kTile) * ((cols + kTile - 1) / kTile);
}

int lbm_kstep_tile_smem(int k) { return smem_bytes(k); }

// CTAs of a whole-grid k-step launch that one SM of the current device
// holds at once; a negative CUDA error code on failure.
int lbm_kstep_tile_ctas_per_sm(int k) {
  if (k < 1 || k > kMaxK) return -(int)cudaErrorInvalidValue;
  int cap = 0, sms = 0, dev = 0;
  cudaError_t e = kConfigure[k - 1](&cap);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? cap / sms : -(int)e;
}

// k steps (1 <= k <= 8) of the whole grid: src and out (9, ny, nx),
// distinct; obst the (ny, nx) float32 mask, nonzero = blocked; partials
// (k, lbm_kstep_tile_blocks(ny, nx)) floats; sums the k per-step sums;
// counter a zeroed unsigned int of this device, left zeroed. Returns
// cudaGetLastError(), or the error of configuring the kernel. Launches on
// the current device.
int lbm_kstep_tile(const float* src, const float* obst, float* out,
                   float* partials, float* sums, unsigned int* counter, int ny,
                   int nx, int accel_row, float omega, float w1, float w2,
                   int k, cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  const TileArgs t{k, ny, nx, 0};
  const Sources s{nullptr, src, nullptr, nullptr, nullptr};
  return launch_k<Mode::kGrid>(s, obst, out, partials, sums, counter, a, t,
                               stream);
}

// Ring mode: k steps of the (9, h, nx) shard whose band of h + 2k rows is
// lo (9, k, nx), shard, hi (9, k, nx), band row 0 being global row
// row_base; obst is the (h + 2k, nx) float32 mask of the band. Writes out
// (9, h, nx), partials (k, lbm_kstep_tile_blocks(h, nx)) and sums (k).
// Returns as lbm_kstep_tile.
int lbm_kstep_tile_ring(const float* lo, const float* shard, const float* hi,
                        const float* obst, float* out, float* partials,
                        float* sums, unsigned int* counter, int ny, int nx,
                        int accel_row, float omega, float w1, float w2, int k,
                        int h, int row_base, cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  const TileArgs t{k, h, nx, row_base};
  const Sources s{lo, shard, hi, nullptr, nullptr};
  return launch_k<Mode::kRing>(s, obst, out, partials, sums, counter, a, t,
                               stream);
}

// Torus mode: k steps of the (9, h, w) block of the (ny, nx) grid whose
// band of h + 2k rows and w + 2kx columns (kx = col_margin(k)) is lo
// (9, k, w + 2kx) over xlo (9, h, kx) | block | xhi (9, h, kx) over hi
// (9, k, w + 2kx), band row 0 being global row row_base; obst is the band's
// (h + 2k, w + 2kx) float32 mask. xlo's last k and xhi's first k columns
// are the column neighbours' cells; the band's first and last kx - k
// columns are padding that no step reads. Writes out (9, h, w), partials
// (k, lbm_kstep_tile_blocks(h, w)) and sums (k). Returns as lbm_kstep_tile.
int lbm_kstep_tile_torus(const float* lo, const float* xlo,
                         const float* block, const float* xhi,
                         const float* hi, const float* obst, float* out,
                         float* partials, float* sums, unsigned int* counter,
                         int ny, int nx, int accel_row, float omega, float w1,
                         float w2, int k, int h, int w, int row_base,
                         cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  const TileArgs t{k, h, w, row_base};
  const Sources s{lo, block, hi, xlo, xhi};
  return launch_k<Mode::kTorus>(s, obst, out, partials, sums, counter, a, t,
                                stream);
}

}  // extern "C"
