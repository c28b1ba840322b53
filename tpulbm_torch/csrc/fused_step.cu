// K1 lbm_fused_step: one D2Q9-BGK step over the whole periodic grid, state
// in global memory in and out, plus the per-block partial |u| sums.
// K3 lbm_reduce_partials: the (K, nblocks) partials of a chunk to (K,) sums.
//
// Replaces: tpulbm/ops/pallas_kstep_skew.py::_kernel (make_skew with the
// fused seam fix; the K=8 chunks of the 1024^2 deck) and
// tpulbm/ops/pallas_kstep.py::_kernel (make_kstep; the sub-8-step
// remainder). Those two compute the same function, K fused steps with a
// per-step sum of |u|; their parallelogram skew and recomputed margins exist
// because VMEM cannot hold the grid and Pallas grid programs run in order.
// Here ops/kstep.py launches K1 K times per chunk, ping-ponging two buffers,
// then K3 once.
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
// No float atomics: the per-block partials and K3's sums are fixed-order,
// so two runs give identical bytes.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    fused_step_kernel(const float* __restrict__ src,
                      const float* __restrict__ obst, float* __restrict__ dst,
                      float* __restrict__ partials, tpulbm::LbmArgs a) {
  __shared__ float warp_sums[kThreads / 32];
  const int ncells = a.ny * a.nx;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float speed = 0.0f;
  if (i < ncells) {
    const int y = i / a.nx;
    speed = tpulbm::grid_cell<tpulbm::LoadReadOnly>(src, obst, dst, y,
                                                    i - y * a.nx, a);
  }
  const float s = tpulbm::block_sum(speed, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// One block per step row; each thread sums a fixed stride of the row, then
// a fixed-order block sum.
__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ partials,
                           float* __restrict__ out, int nblocks) {
  __shared__ float warp_sums[kThreads / 32];
  const float* row = partials + (size_t)blockIdx.x * nblocks;
  float v = 0.0f;
  for (int j = threadIdx.x; j < nblocks; j += kThreads) v += row[j];
  v = tpulbm::block_sum(v, warp_sums);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace

extern "C" {

// Blocks of one K1 launch over ncells cells: the row length of its partials.
int lbm_fused_step_blocks(int ncells) {
  return (ncells + kThreads - 1) / kThreads;
}

// One step src -> dst. partials: this step's row of lbm_fused_step_blocks
// floats. obst: (ny, nx) float32, nonzero = blocked. Returns cudaGetLastError().
int lbm_fused_step(const float* src, const float* obst, float* dst,
                   float* partials, int ny, int nx, int accel_row, float omega,
                   float w1, float w2, cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  fused_step_kernel<<<lbm_fused_step_blocks(ny * nx), kThreads, 0, stream>>>(
      src, obst, dst, partials, a);
  return (int)cudaGetLastError();
}

// out[k] = sum over j of partials[k, j], k < k_steps, in a fixed order.
int lbm_reduce_partials(const float* partials, float* out, int k_steps,
                        int nblocks, cudaStream_t stream) {
  reduce_partials_kernel<<<k_steps, kThreads, 0, stream>>>(partials, out,
                                                           nblocks);
  return (int)cudaGetLastError();
}

const char* lbm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
