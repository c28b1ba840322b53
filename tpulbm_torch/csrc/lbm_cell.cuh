// One D2Q9-BGK lattice update of one cell, shared by the CUDA kernels of
// tpulbm_torch (fused_step.cu, resident.cu).
//
// Replaces the per-step body that every TPU kernel inlines:
// tpulbm/ops/window_step.py::fused_window_steps with accel_update and
// tpulbm/core/physics.py::collide, in the pair-symmetric equilibrium form
// that the TPU kernels run in production (window_step.py:28).
//
// Per cell and step: pull the nine populations from the neighbours
// (t_k(y, x) = f_k(y - CY[k], x - CX[k]), periodic, rows growing northward);
// apply the inflow acceleration to a pulled value whose SOURCE cell lies on
// accel_row and is free, with the reference's knife-edge guard evaluated on
// that source cell's f3, f6, f7 (step_jnp.py:43-66); collide, or bounce back
// the pulled values on a blocked cell (physics.py:104-108); write the nine
// results; return |u| (zero on a blocked cell). IEEE 1.0f/dens and sqrtf as
// physics.py:33,112: build without --use_fast_math. nvcc's default FMA
// contraction changes the last bits, so the port compares by tolerance.
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

// True where the source cell (sy, sx) is accelerated: it lies on accel_row,
// is free, and stays positive in channels 3, 6, 7 after the update.
template <class Load>
__device__ __forceinline__ bool accel_guard(const float* __restrict__ src,
                                            const float* __restrict__ obst,
                                            size_t plane, int sy, int sx,
                                            const LbmArgs& a, Load load) {
  const size_t c = (size_t)sy * a.nx + sx;
  if (obst[c] != 0.0f) return false;
  return (load(src + 3 * plane + c) - a.w1 > 0.0f) &&
         (load(src + 6 * plane + c) - a.w2 > 0.0f) &&
         (load(src + 7 * plane + c) - a.w2 > 0.0f);
}

template <class Load>
__device__ __forceinline__ float lbm_cell(const float* __restrict__ src,
                                          const float* __restrict__ obst,
                                          float* __restrict__ dst, int y,
                                          int x, const LbmArgs& a, Load load) {
  const size_t plane = (size_t)a.ny * a.nx;
  const int yS = (y == 0) ? a.ny - 1 : y - 1;       // row y - 1 (south)
  const int yN = (y == a.ny - 1) ? 0 : y + 1;       // row y + 1 (north)
  const int xW = (x == 0) ? a.nx - 1 : x - 1;       // column x - 1 (west)
  const int xE = (x == a.nx - 1) ? 0 : x + 1;       // column x + 1 (east)
  const size_t r = (size_t)y * a.nx, rS = (size_t)yS * a.nx,
               rN = (size_t)yN * a.nx;

  // Pull: channel k comes from (y - CY[k], x - CX[k]).
  float t0 = load(src + 0 * plane + r + x);
  float t1 = load(src + 1 * plane + r + xW);   // CX=+1
  float t2 = load(src + 2 * plane + rS + x);   // CY=+1
  float t3 = load(src + 3 * plane + r + xE);   // CX=-1
  float t4 = load(src + 4 * plane + rN + x);   // CY=-1
  float t5 = load(src + 5 * plane + rS + xW);  // (+1,+1)
  float t6 = load(src + 6 * plane + rS + xE);  // (-1,+1)
  float t7 = load(src + 7 * plane + rN + xE);  // (-1,-1)
  float t8 = load(src + 8 * plane + rN + xW);  // (+1,-1)

  // Inflow acceleration on the source cell, before streaming
  // (d2q9-bgk.c:442-478): +w1 on 1, -w1 on 3, +w2 on 5 and 8, -w2 on 6, 7.
  if (y == a.accel_row) {
    if (accel_guard(src, obst, plane, y, xW, a, load)) t1 = t1 + a.w1;
    if (accel_guard(src, obst, plane, y, xE, a, load)) t3 = t3 - a.w1;
  }
  if (yS == a.accel_row) {
    if (accel_guard(src, obst, plane, yS, xW, a, load)) t5 = t5 + a.w2;
    if (accel_guard(src, obst, plane, yS, xE, a, load)) t6 = t6 - a.w2;
  }
  if (yN == a.accel_row) {
    if (accel_guard(src, obst, plane, yN, xE, a, load)) t7 = t7 - a.w2;
    if (accel_guard(src, obst, plane, yN, xW, a, load)) t8 = t8 + a.w2;
  }

  float* o = dst + r + x;
  if (obst[r + x] != 0.0f) {
    // Bounce-back writes the pulled value of the opposite direction.
    o[0 * plane] = t0;
    o[1 * plane] = t3;
    o[2 * plane] = t4;
    o[3 * plane] = t1;
    o[4 * plane] = t2;
    o[5 * plane] = t7;
    o[6 * plane] = t8;
    o[7 * plane] = t5;
    o[8 * plane] = t6;
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
  o[0] = t0 + om * (feq0 - t0);

  // Pair-symmetric: feq_k = wb + wi, feq_opp = wb - wi.
#define TPULBM_PAIR(K, OP, W, MU, TK, TOP)                      \
  {                                                             \
    const float mu = (MU);                                      \
    const float imu = mu * 3.0f;                                \
    const float wb = (W) * (dens + h3 * (imu * mu - usq));      \
    const float wi = (W) * imu;                                 \
    o[(K) * plane] = TK + om * ((wb + wi) - TK);                \
    o[(OP) * plane] = TOP + om * ((wb - wi) - TOP);             \
  }
  TPULBM_PAIR(1, 3, kW1, mx, t1, t3)
  TPULBM_PAIR(2, 4, kW1, my, t2, t4)
  TPULBM_PAIR(5, 7, kW2, mx + my, t5, t7)
  TPULBM_PAIR(6, 8, kW2, -mx + my, t6, t8)
#undef TPULBM_PAIR

  return sqrtf(usq) * densinv;
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

}  // namespace tpulbm
