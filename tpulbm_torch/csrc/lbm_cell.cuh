// One D2Q9-BGK lattice update of one cell, shared by the CUDA kernels of
// tpulbm_torch (fused_step.cu, resident.cu, kstep_tile.cu).
//
// Replaces the per-step body that every TPU kernel inlines:
// tpulbm/ops/window_step.py::fused_window_steps with accel_update and
// tpulbm/core/physics.py::collide, in the pair-symmetric equilibrium form
// that the TPU kernels run in production (window_step.py:28).
//
// Per cell and step: pull the nine populations from the neighbours
// (t_k(y, x) = f_k(y - CY[k], x - CX[k]), rows growing northward); apply the
// inflow acceleration to a pulled value whose SOURCE cell lies on the
// accelerated row and is free, with the reference's knife-edge guard
// evaluated on that source cell's f3, f6, f7 (step_jnp.py:43-66); collide,
// or bounce back the pulled values on a blocked cell (physics.py:104-108);
// write the nine results; return |u| (zero on a blocked cell). IEEE
// 1.0f/dens and sqrtf as physics.py:33,112: build without --use_fast_math.
// nvcc's default FMA contraction changes the last bits, so the port compares
// by tolerance.
//
// `lbm_cell` is generic over where the old state comes from and where the
// new one goes. A source `s` answers, for the neighbour at (y+dy, x+dx) of
// the cell being updated (dy, dx in {-1, 0, 1}, constants after inlining):
//   s.f(k, dy, dx)   population k of the old state there;
//   s.fluid(dy, dx)  that cell is not blocked;
//   s.accel(dy)      row y+dy is the accelerated row.
// A sink `d` takes d(k, v): the new population k of the cell.
// `GridSrc`/`GridDst` address a (9, ny, nx) periodic grid in device memory
// (K1, K2); kstep_tile.cu (K4) brings its own shared-memory source;
// `RegDst` keeps the results in registers (K1, K4).
#pragma once

#include <cuda_runtime.h>

namespace tpulbm {

struct LbmArgs {
  int ny, nx, accel_row;
  float omega, w1, w2;
};

// Loads through the read-only cache: valid while the source buffer is not
// written during the kernel (one step per launch).
struct LoadReadOnly {
  __device__ __forceinline__ float operator()(const float* p) const {
    return __ldg(p);
  }
};

// Loads cached in L2 only: for a kernel that rewrites its buffers between
// grid-wide barriers, so no stale L1 line can be read after a barrier.
struct LoadL2 {
  __device__ __forceinline__ float operator()(const float* p) const {
    return __ldcg(p);
  }
};

constexpr float kW0 = 4.0f / 9.0f;
constexpr float kW1 = 1.0f / 9.0f;
constexpr float kW2 = 1.0f / 36.0f;

// True where the source cell at (dy, dx) is accelerated: it is free and
// stays positive in channels 3, 6, 7 after the update (the caller has
// checked that it lies on the accelerated row).
template <class Src>
__device__ __forceinline__ bool accel_guard(const Src& s, int dy, int dx,
                                            const LbmArgs& a) {
  return s.fluid(dy, dx) && (s.f(3, dy, dx) - a.w1 > 0.0f) &&
         (s.f(6, dy, dx) - a.w2 > 0.0f) && (s.f(7, dy, dx) - a.w2 > 0.0f);
}

template <class Src, class Dst>
__device__ __forceinline__ float lbm_cell(const Src& s, const Dst& d,
                                          const LbmArgs& a) {
  // Pull: channel k comes from (y - CY[k], x - CX[k]).
  float t0 = s.f(0, 0, 0);
  float t1 = s.f(1, 0, -1);    // CX=+1
  float t2 = s.f(2, -1, 0);    // CY=+1
  float t3 = s.f(3, 0, +1);    // CX=-1
  float t4 = s.f(4, +1, 0);    // CY=-1
  float t5 = s.f(5, -1, -1);   // (+1,+1)
  float t6 = s.f(6, -1, +1);   // (-1,+1)
  float t7 = s.f(7, +1, +1);   // (-1,-1)
  float t8 = s.f(8, +1, -1);   // (+1,-1)

  // Inflow acceleration on the source cell, before streaming
  // (d2q9-bgk.c:442-478): +w1 on 1, -w1 on 3, +w2 on 5 and 8, -w2 on 6, 7.
  if (s.accel(0)) {
    if (accel_guard(s, 0, -1, a)) t1 = t1 + a.w1;
    if (accel_guard(s, 0, +1, a)) t3 = t3 - a.w1;
  }
  if (s.accel(-1)) {
    if (accel_guard(s, -1, -1, a)) t5 = t5 + a.w2;
    if (accel_guard(s, -1, +1, a)) t6 = t6 - a.w2;
  }
  if (s.accel(+1)) {
    if (accel_guard(s, +1, +1, a)) t7 = t7 - a.w2;
    if (accel_guard(s, +1, -1, a)) t8 = t8 + a.w2;
  }

  if (!s.fluid(0, 0)) {
    // Bounce-back writes the pulled value of the opposite direction.
    d(0, t0);
    d(1, t3);
    d(2, t4);
    d(3, t1);
    d(4, t2);
    d(5, t7);
    d(6, t8);
    d(7, t5);
    d(8, t6);
    return 0.0f;
  }

  // Macroscopics and equilibrium in the float32 order of physics.py.
  const float dens = t0 + t1 + t2 + t3 + t4 + t5 + t6 + t7 + t8;
  const float densinv = 1.0f / dens;
  const float mx = t1 + t5 + t8 - t3 - t6 - t7;
  const float my = t2 + t5 + t6 - t4 - t7 - t8;
  const float usq = mx * mx + my * my;
  const float h3 = 0.5f * densinv * 3.0f;
  const float om = a.omega;

  const float feq0 = kW0 * (dens - h3 * usq);
  d(0, t0 + om * (feq0 - t0));

  // Pair-symmetric: feq_k = wb + wi, feq_opp = wb - wi.
#define TPULBM_PAIR(K, OP, W, MU, TK, TOP)                      \
  {                                                             \
    const float mu = (MU);                                      \
    const float imu = mu * 3.0f;                                \
    const float wb = (W) * (dens + h3 * (imu * mu - usq));      \
    const float wi = (W) * imu;                                 \
    d(K, TK + om * ((wb + wi) - TK));                           \
    d(OP, TOP + om * ((wb - wi) - TOP));                        \
  }
  TPULBM_PAIR(1, 3, kW1, mx, t1, t3)
  TPULBM_PAIR(2, 4, kW1, my, t2, t4)
  TPULBM_PAIR(5, 7, kW2, mx + my, t5, t7)
  TPULBM_PAIR(6, 8, kW2, -mx + my, t6, t8)
#undef TPULBM_PAIR

  return sqrtf(usq) * densinv;
}

// The old state of a (9, ny, nx) periodic grid in device memory around
// cell (y, x); obst is the (ny, nx) float32 mask, nonzero = blocked.
template <class Load>
struct GridSrc {
  const float* __restrict__ src;
  const float* __restrict__ obst;
  size_t plane, r, rS, rN;   // plane size; offsets of rows y, y-1, y+1
  int x, xW, xE;             // columns x, x-1, x+1
  bool acc, accS, accN;      // rows y, y-1, y+1 are the accelerated row
  Load load;

  __device__ __forceinline__ GridSrc(const float* src_, const float* obst_,
                                     int y, int x_, const LbmArgs& a)
      : src(src_), obst(obst_), plane((size_t)a.ny * a.nx), x(x_) {
    const int yS = (y == 0) ? a.ny - 1 : y - 1;
    const int yN = (y == a.ny - 1) ? 0 : y + 1;
    xW = (x == 0) ? a.nx - 1 : x - 1;
    xE = (x == a.nx - 1) ? 0 : x + 1;
    r = (size_t)y * a.nx;
    rS = (size_t)yS * a.nx;
    rN = (size_t)yN * a.nx;
    acc = y == a.accel_row;
    accS = yS == a.accel_row;
    accN = yN == a.accel_row;
  }
  __device__ __forceinline__ size_t at(int dy, int dx) const {
    return (dy < 0 ? rS : dy > 0 ? rN : r) + (dx < 0 ? xW : dx > 0 ? xE : x);
  }
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return load(src + k * plane + at(dy, dx));
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return obst[at(dy, dx)] == 0.0f;
  }
  __device__ __forceinline__ bool accel(int dy) const {
    return dy < 0 ? accS : dy > 0 ? accN : acc;
  }
};

// Writes one cell's nine populations into a (9, rows, nx) buffer: o points
// at the cell in plane 0, plane is rows * nx.
struct GridDst {
  float* o;
  size_t plane;
  __device__ __forceinline__ void operator()(int k, float v) const {
    o[k * plane] = v;
  }
};

// One step of cell (y, x) of the periodic grid, src -> dst (K2).
template <class Load>
__device__ __forceinline__ float grid_cell(const float* __restrict__ src,
                                           const float* __restrict__ obst,
                                           float* __restrict__ dst, int y,
                                           int x, const LbmArgs& a) {
  const GridSrc<Load> s(src, obst, y, x, a);
  return lbm_cell(s, GridDst{dst + (size_t)y * a.nx + x, s.plane}, a);
}

// Sum of v over the block in a fixed order (warp shuffles, then the warp
// sums by one warp): the same inputs give the same bits on every run.
// blockDim.x must be a multiple of 32 and at most 1024. Result valid in
// thread 0. Ends with a barrier, so `warp_sums` may be reused at once.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  return v;
}

// The chunk's per-step sums from its (k, n) per-block partials, in a fixed
// order (the function of tpulbm/ops/window_step.py:384, which sums |u| in
// the stepping kernel's body). Row s is summed by a virtual block of
// kReduceThreads threads, thread i taking j = i, i + kReduceThreads, ...,
// then block_sum; threads at or past kReduceThreads add zeros, which leave
// block_sum's bits alone, so any blockDim.x that is a multiple of 32 and at
// least kReduceThreads gives the same bits (those of the former second-pass
// kernel, K3, which ran 256 threads a row). Partials are read through L2:
// they come from other blocks of this launch or from earlier launches. A
// thread issues kReduceBatch loads before it adds them, in order: added as
// they arrive, each load's latency would be paid one after another.
constexpr int kReduceThreads = 256;
constexpr int kReduceBatch = 4;

__device__ __forceinline__ void reduce_row(const float* partials, float* sums,
                                           int s, int n, float* warp_sums) {
  const float* row = partials + (size_t)s * n;
  float v = 0.0f;
  if (threadIdx.x < kReduceThreads) {
    int j = threadIdx.x;
    for (; j + (kReduceBatch - 1) * kReduceThreads < n;
         j += kReduceBatch * kReduceThreads) {
      float x[kReduceBatch];
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u)
        x[u] = __ldcg(row + j + u * kReduceThreads);
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u) v += x[u];
    }
    for (; j < n; j += kReduceThreads) v += __ldcg(row + j);
  }
  v = block_sum(v, warp_sums);
  if (threadIdx.x == 0) sums[s] = v;
}

// The fused epilogue of a stepping launch: every thread of every block
// calls last_ticket once its block's partials are written; where it returns
// true (one block) the launch's rows are reduced, and the counter is reset.
// No float atomics: reruns give the same bits.
//
// last_ticket: after a barrier one thread of each block fences and draws a
// ticket of `counter` (the release pattern of CUTLASS's semaphore); true in
// every thread of the block that draws the last one, which fences again
// before it reads the other blocks' partials. Ends with a barrier.
// The counter (one zeroed unsigned int per device, ops/_build.py) is shared
// by every launch on the device, so launches that use it must be ordered:
// they are, since every wrapper launches on the device's current stream.
// A launch that faults midway leaves it non-zero and spoils the next
// launch's ticket; the on-card tests and chip_smoke.py read it back.
__device__ __forceinline__ bool last_ticket(unsigned int* counter) {
  __shared__ int is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// reduce_rows, in the last block of a launch of k <= kMaxEpilogueRows steps
// (K4): rows [0, k) of the (k, n) partials into sums[0, k) in reduce_row's
// order, all rows at once (k independent chains of loads), and the counter
// back to 0. blockDim.x must be at least max(kReduceThreads, 32 k) and at
// most 1024.
constexpr int kMaxEpilogueRows = 8;

__device__ __forceinline__ void reduce_rows(unsigned int* counter,
                                            const float* partials,
                                            float* sums, int k, int n) {
  __shared__ float warp_sums[kMaxEpilogueRows][32];
  float v[kMaxEpilogueRows];
#pragma unroll
  for (int s = 0; s < kMaxEpilogueRows; ++s) v[s] = 0.0f;
  if (threadIdx.x < kReduceThreads) {
    int j = threadIdx.x;
    for (; j + (kReduceBatch - 1) * kReduceThreads < n;
         j += kReduceBatch * kReduceThreads) {
      float x[kReduceBatch][kMaxEpilogueRows];
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u)
#pragma unroll
        for (int s = 0; s < kMaxEpilogueRows; ++s)
          x[u][s] = s < k ? __ldcg(partials + (size_t)s * n + j +
                                   u * kReduceThreads)
                          : 0.0f;
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u)
#pragma unroll
        for (int s = 0; s < kMaxEpilogueRows; ++s) v[s] += x[u][s];
    }
    for (; j < n; j += kReduceThreads)
#pragma unroll
      for (int s = 0; s < kMaxEpilogueRows; ++s)
        if (s < k) v[s] += __ldcg(partials + (size_t)s * n + j);
  }
  // block_sum of each row: the warp trees, then warp s sums row s's warp
  // sums (the lanes past the block's warps add zeros, as block_sum's do)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kMaxEpilogueRows; ++s) {
    for (int off = 16; off > 0; off >>= 1)
      v[s] += __shfl_down_sync(0xffffffffu, v[s], off);
    if (lane == 0 && s < k) warp_sums[s][warp] = v[s];
  }
  __syncthreads();
  if (warp < k) {
    float x = lane < (int)(blockDim.x >> 5) ? warp_sums[warp][lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) sums[warp] = x;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// The nine new populations of one cell, into registers.
struct RegDst {
  float* r;
  __device__ __forceinline__ void operator()(int k, float v) const {
    r[k] = v;
  }
};

}  // namespace tpulbm
