// K1 lbm_fused_step: one D2Q9-BGK step over the whole periodic grid, state
// in global memory in and out, plus the per-block partial |u| sums; the last
// launch of a chunk also reduces the chunk's partials to its per-step sums.
//
// Replaces: tpulbm/ops/pallas_kstep_skew.py::_kernel (make_skew with the
// fused seam fix; the K=8 chunks of the 1024^2 deck) and
// tpulbm/ops/pallas_kstep.py::_kernel (make_kstep; the sub-8-step
// remainder). Those two compute the same function, K fused steps with a
// per-step sum of |u|; their parallelogram skew and recomputed margins exist
// because VMEM cannot hold the grid and Pallas grid programs run in order.
// Here ops/kstep.py launches K1 K times per chunk, ping-ponging two buffers.
//
// Bound: device-memory bytes. Each step reads 9 and writes 9 floats per cell,
// 72 B/cell/step, plus a few extra loads on the three rows around accel_row:
// 75.5 MB a step at 1024^2, whose 72 MB ping-pong does not fit the H100's
// 50 MB L2. One thread per cell along x keeps every load and store
// coalesced; the +/-1 neighbour pulls hit the same or the next 32-byte
// sector. Measured on an H100 80GB HBM3 at a 700 W power limit: 30.9 us a
// step at 1024^2, 2.45 TB/s, 73 % of the 3.35 TB/s peak (PERF.md).
//
// Left on the table: temporal blocking. Each step goes through device memory
// once; K4 (kstep_tile.cu) steps up to 8 per pass over a tile held in shared
// memory and runs the wide grids. One Python launch per step also costs host
// time (a CUDA graph per chunk would remove it).
//
// Per-step sums: each block writes its partial to row `step` of the chunk's
// (k, nblocks) partials. Block 0 of launch s >= 1 first reduces row s - 1,
// which the stream has completed (lbm_cell.cuh::reduce_row); on the chunk's
// last launch the block that draws the last ticket of a per-device counter
// (lbm_cell.cuh::last_ticket) reduces row k - 1. That is the per-step sum
// of the TPU kernels' body (tpulbm/ops/window_step.py:384), with no second
// pass and no float atomics: two runs give identical bytes. All k rows in
// the last block would serialise their reductions behind the last launch's
// tail; spread over the launches, each hides behind the other blocks' work
// (PERF.md).

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    fused_step_kernel(const float* __restrict__ src,
                      const float* __restrict__ obst, float* __restrict__ dst,
                      float* __restrict__ partials, int step, int k,
                      float* __restrict__ sums, unsigned int* counter,
                      tpulbm::LbmArgs a) {
  __shared__ float warp_sums[kThreads / 32];
  const int ncells = a.ny * a.nx;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (step > 0 && blockIdx.x == 0)
    tpulbm::reduce_row(partials, sums, step - 1, gridDim.x, warp_sums);
  float speed = 0.0f, v[9];
  if (i < ncells) {
    const int y = i / a.nx;
    const tpulbm::GridSrc<tpulbm::LoadReadOnly> s(src, obst, y, i - y * a.nx,
                                                  a);
    speed = tpulbm::lbm_cell(s, tpulbm::RegDst{v}, a);
  }
  const float bs = tpulbm::block_sum(speed, warp_sums);
  if (threadIdx.x == 0) partials[(size_t)step * gridDim.x + blockIdx.x] = bs;
  // The ticket before the state's stores: the fence then waits for the
  // partial only.
  const bool last = step == k - 1 && tpulbm::last_ticket(counter);
  if (i < ncells) {
    float* o = dst + i;
    const size_t plane = (size_t)ncells;
#pragma unroll
    for (int q = 0; q < 9; ++q) o[q * plane] = v[q];
  }
  if (last) {
    tpulbm::reduce_row(partials, sums, k - 1, gridDim.x, warp_sums);
    if (threadIdx.x == 0) *counter = 0u;
  }
}

}  // namespace

extern "C" {

// Blocks of one K1 launch over ncells cells: the row length of its partials.
int lbm_fused_step_blocks(int ncells) {
  return (ncells + kThreads - 1) / kThreads;
}

// Step `step` (0 <= step < k) of a k-step chunk, src -> dst, launched in
// order of step on one stream. partials: the chunk's (k,
// lbm_fused_step_blocks) floats, of which this launch writes row `step` and
// reduces row step - 1 into sums[step - 1]; the launch of step k - 1 also
// reduces its own row into sums[k - 1], using `counter` (a zeroed unsigned
// int of this device, left zeroed). obst: (ny, nx) float32, nonzero = blocked. Returns
// cudaGetLastError().
int lbm_fused_step(const float* src, const float* obst, float* dst,
                   float* partials, int step, int k, float* sums,
                   unsigned int* counter, int ny, int nx, int accel_row,
                   float omega, float w1, float w2, cudaStream_t stream) {
  if (step < 0 || step >= k) return (int)cudaErrorInvalidValue;
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  fused_step_kernel<<<lbm_fused_step_blocks(ny * nx), kThreads, 0, stream>>>(
      src, obst, dst, partials, step, k, sums, counter, a);
  return (int)cudaGetLastError();
}

const char* lbm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
