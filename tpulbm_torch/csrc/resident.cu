// K2 lbm_resident_chunk: K D2Q9-BGK steps of a small periodic grid in ONE
// persistent cooperative launch, with a grid-wide barrier between steps.
//
// Replaces: tpulbm/ops/pallas_resident.py::_kernel (make_resident_step),
// which keeps the whole grid in VMEM and ping-pongs it there for up to 512
// steps per call, and ::_kernel_hbm (make_resident_step_hbm), the same for
// 100K-135K cells with the state in HBM between calls. The nearest Hopper
// match is a persistent kernel whose ping-pong pair stays in the H100's
// 50 MB L2: the 128^2, 128x256 and 256^2
// decks hold at most 2 x 9 x 65536 x 4 B = 4.7 MB, so after the first step
// the state traffic is L2 traffic. The grid is sized from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count (capped at
// one cell per thread) and walks the cells with a grid-stride loop; it is
// launched with cudaLaunchCooperativeKernel so that
// cooperative_groups::this_grid().sync() is legal. If the device refuses a
// cooperative launch, the entry point returns the error and the caller
// raises: it never falls back to per-step launches.
//
// Bound: per step, 72 B/cell of L2 traffic and one grid barrier, which
// dominates on these small grids: measured on an H100 80GB HBM3 at a 700 W
// power limit, 3.1 us a step at 128^2 and 3.8 us at 256^2 (PERF.md). State
// loads go through L2 only (__ldcg), so no stale L1 line is read after a
// barrier.
//
// Left on the table: holding the state in shared memory across a cluster
// (DSMEM) with a cluster barrier instead of L2 and a grid barrier. Against
// one K1 launch per step from Python the grid barrier wins about 4x on these
// decks; against K1 in a CUDA graph it is unmeasured (PERF.md).
//
// Per-step sums: each block writes its partial of step s to row s of the
// (k, grid) partials; after the last grid-wide barrier the blocks reduce
// the rows in K3's fixed order (lbm_cell.cuh::reduce_row), row s by block
// s mod grid, into sums[s]. The cooperative launch needs no ticket, and
// spreading the rows over the blocks keeps the 512 rows of a full chunk
// from serialising on one block. No float atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    resident_kernel(const float* __restrict__ f_in,
                    const float* __restrict__ obst, float* out, float* scratch,
                    float* __restrict__ partials, float* __restrict__ sums,
                    int k_steps, tpulbm::LbmArgs a) {
  __shared__ float warp_sums[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int ncells = a.ny * a.nx;
  const int stride = gridDim.x * kThreads;
  const float* src = f_in;
  for (int s = 0; s < k_steps; ++s) {
    // The last step lands in `out`.
    float* dst = ((k_steps - 1 - s) & 1) ? scratch : out;
    float acc = 0.0f;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < ncells; i += stride) {
      const int y = i / a.nx;
      acc += tpulbm::grid_cell<tpulbm::LoadL2>(src, obst, dst, y,
                                               i - y * a.nx, a);
    }
    const float bs = tpulbm::block_sum(acc, warp_sums);
    if (threadIdx.x == 0) partials[(size_t)s * gridDim.x + blockIdx.x] = bs;
    grid.sync();
    src = dst;
  }
  for (int s = blockIdx.x; s < k_steps; s += gridDim.x)
    tpulbm::reduce_row(partials, sums, s, gridDim.x, warp_sums);
}

}  // namespace

extern "C" {

// Grid size of a K2 launch over ncells cells on the current device: the
// co-resident maximum, capped at one cell per thread. Fails with
// cudaErrorNotSupported where the device has no cooperative launch.
int lbm_resident_grid(int ncells, int* grid_out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel,
                                                      kThreads, 0);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e != cudaSuccess) return (int)e;
  const int need = (ncells + kThreads - 1) / kThreads;
  *grid_out = need < per_sm * sms ? need : per_sm * sms;
  return 0;
}

// k_steps steps f_in -> out, using scratch as the other half of the
// ping-pong (all three distinct (9, ny, nx) buffers). partials: (k_steps,
// grid) floats; sums: the k_steps per-step sums. grid must come from
// lbm_resident_grid. Returns the launch's error code.
int lbm_resident_chunk(const float* f_in, const float* obst, float* out,
                       float* scratch, float* partials, float* sums, int grid,
                       int ny, int nx, int k_steps, int accel_row, float omega,
                       float w1, float w2, cudaStream_t stream) {
  tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  void* args[] = {(void*)&f_in,     (void*)&obst,     (void*)&out,
                  (void*)&scratch,  (void*)&partials, (void*)&sums,
                  (void*)&k_steps,  (void*)&a};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)resident_kernel,
                                              dim3(grid), dim3(kThreads), args,
                                              0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
