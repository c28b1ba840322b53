// The tile step shared by K4 (kstep_tile.cu) and K6 (ring_p2p.cu): k
// D2Q9-BGK steps of one 32 x 32 owned tile whose window (the tile and a
// k-cell margin, 32 + 2k rows by 32 + 2 col_margin(k) columns) lies in a
// stage of shared memory, and the tile's k per-step partial sums of |u|.
// Both kernels load the window their own way; from the loaded stage on they
// run this one code, so their states and sums are the same bits.
//
// The window's computed rectangle shrinks by one cell per side and step
// (window-edge values go stale one cell per step; the col_margin(k) - k
// columns at each side beyond the k-cell margin are loaded and never
// computed), and the last step's rectangle is exactly the owned tile, handed
// to the caller's store. Thread t owns window cells t + j * kThreads
// (j < kCells); at each step it computes those of its cells that lie in the
// step's rectangle into registers and, after a barrier, writes them back
// (then a second barrier, before the next step reads). The barriers join
// the kThreads stepping threads only: __syncthreads where they are the
// whole block (K4), named barrier kBar where the block holds other warps
// too (K6's producer and copy warps). A thread adds the
// |u| of its owned cells into one register per step, warps sum by shuffles,
// and warp s sums step s's warp sums once per tile, in a fixed order.
#pragma once

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace tpulbm {
namespace tile {

constexpr int kTile = 32;                      // owned tile edge, cells
constexpr int kMaxK = 8;                       // steps per launch
constexpr int kMaxW = kTile + 2 * kMaxK;       // window edge at kMaxK
constexpr int kThreads = 768;                  // 48^2 = 3 x 768
constexpr int kWarps = kThreads / 32;
// Window cells a thread owns: t + j * kThreads, j < kCells
constexpr int kCells = kMaxW * kMaxW / kThreads;
// The load: kSegLanes threads a window row, kRowSlots rows at a time
constexpr int kSegLanes = 16;
constexpr int kRowSlots = kThreads / kSegLanes;
constexpr int kMaxSegs = (kMaxW + kSegLanes - 1) / kSegLanes;  // 4-B mode
constexpr int kPlanes = 10;                    // nine populations, mask
static_assert(kCells * kThreads == kMaxW * kMaxW && kMaxK % 4 == 0,
              "the threads' cells fill the largest window");
static_assert(kMaxK <= kWarps && kMaxK <= kMaxEpilogueRows &&
                  kThreads >= kReduceThreads,
              "one warp per step sums the warp sums");

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// The barrier of the kThreads threads that step a tile (threads 0 ..
// kThreads - 1): __syncthreads for kBar = 0, else named barrier kBar.
template <int kBar>
__device__ __forceinline__ void step_sync() {
  if constexpr (kBar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"n"(kBar), "n"(kThreads) : "memory");
}

// Window columns left and right of the owned tile: k rounded up to a
// multiple of 4, so that a window row starts at a multiple of 4 columns.
__host__ __device__ constexpr int col_margin(int k) { return (k + 3) & ~3; }

// Floats of one stage: 10 planes of (32 + 2k) x (32 + 2 col_margin(k)), a
// multiple of 4.
__host__ __device__ constexpr int stage_floats(int k) {
  return kPlanes * (kTile + 2 * k) * (kTile + 2 * col_margin(k));
}

// The step-s state of a stage around window cell c (planes of `plane`
// floats, rows of w, plane 9 the mask, nonzero = blocked; bit dy + 1 of acc
// set where row wy + dy of the window is the accelerated row).
struct TileSrc {
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

// This thread's window cells of a kK-step window, fixed for a launch; a
// cell past the window gets a row outside every step's rectangle.
template <int kK>
struct Cells {
  int cy[kCells], cx[kCells];
  __device__ __forceinline__ Cells() {
    constexpr int w = kTile + 2 * col_margin(kK);
    constexpr int plane = (kTile + 2 * kK) * w;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const int c = threadIdx.x + j * kThreads;
      cy[j] = c < plane ? c / w : -kMaxW;
      cx[j] = c - (c / w) * w;
    }
  }
};

// kK steps of the window in `stage` (acc_row[wy] nonzero where window row
// wy is the accelerated row) whose owned tile has own_rows x own_cols
// cells. store(oy, ox, res) takes the nine new populations of owned cell
// (oy, ox) of the tile; partial(s, v) takes step s's sum over the owned
// cells (called by lane 0 of warp s). Threads 0 .. kThreads - 1 call
// step_tile, and only they (step_sync<kBar>). Ends with a barrier: the
// stage and warp_sums are free again.
template <int kK, int kBar = 0, class Store, class Partial>
__device__ __forceinline__ void step_tile(float* stage,
                                          const unsigned char* acc_row,
                                          int own_rows, int own_cols,
                                          const Cells<kK>& cells,
                                          float (*warp_sums)[kWarps],
                                          const LbmArgs& a, Store store,
                                          Partial partial) {
  constexpr int k = kK;
  constexpr int kx = col_margin(k);
  constexpr int wh = kTile + 2 * k;    // window rows
  constexpr int w = kTile + 2 * kx;    // window columns
  constexpr int cm = kx - k;           // columns a side that no step computes
  constexpr int plane = wh * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool owned[kCells];
  unsigned acc3[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int oy = cells.cy[j] - k, ox = cells.cx[j] - kx;
    owned[j] = oy >= 0 && oy < own_rows && ox >= 0 && ox < own_cols;
    acc3[j] = cells.cy[j] >= 1 && cells.cy[j] < wh - 1
                  ? acc_row[cells.cy[j] - 1] | acc_row[cells.cy[j]] << 1 |
                        acc_row[cells.cy[j] + 1] << 2
                  : 0u;
  }

#pragma unroll 1
  for (int s = 0; s < k; ++s) {
    // State s + 1 on the rectangle of rows [lo, wh - lo) and columns
    // [cm + lo, w - cm - lo) from state s on the one a cell wider; on the
    // last step it is the owned tile.
    const int lo = s + 1, hi = wh - lo, xlo = cm + lo, xhi = w - xlo;
    float res[kCells][9];
    bool act[kCells];
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      act[j] = cells.cy[j] >= lo && cells.cy[j] < hi && cells.cx[j] >= xlo &&
               cells.cx[j] < xhi;
      if (act[j]) {
        const int c = threadIdx.x + j * kThreads;
        const float speed = lbm_cell(TileSrc{stage, plane, w, c, acc3[j]},
                                     RegDst{res[j]}, a);
        if (owned[j]) acc += speed;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) warp_sums[s][warp] = acc;
    if (s == k - 1) {
#pragma unroll
      for (int j = 0; j < kCells; ++j)
        if (owned[j]) store(cells.cy[j] - k, cells.cx[j] - kx, res[j]);
    } else {
      step_sync<kBar>();   // every read of state s is done
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        if (act[j]) {
          const int c = threadIdx.x + j * kThreads;
#pragma unroll
          for (int q = 0; q < 9; ++q) stage[q * plane + c] = res[j][q];
        }
      }
      step_sync<kBar>();   // state s + 1 is complete
    }
  }

  // The tile's partials: warp s sums step s's warp sums in a fixed order.
  step_sync<kBar>();
  if (warp < k) {
    float v = lane < kWarps ? warp_sums[warp][lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial(warp, v);
  }
  step_sync<kBar>();   // the stage and warp_sums are free
}

}  // namespace tile
}  // namespace tpulbm
