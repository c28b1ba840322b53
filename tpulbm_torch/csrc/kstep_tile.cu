// K4 lbm_kstep_tile: k <= 8 D2Q9-BGK steps in one launch, temporally
// blocked in shared memory, plus the per-block partial |u| sums of each
// step (reduced by K3, fused_step.cu).
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
//   pallas_step.py::_kernel (k = 1: one step with 1-row halos);
//   pallas_kstep_rdma.py::_kernel and pallas_resident_rdma.py::_kernel,
//     whose slab exchange runs inside the kernel: here the slabs are
//     copied before the launch (dist/runner.py).
// A seam fix's function (a band of rows around a seam, stepped without
// wrapping) is ring mode's on the band cut into lo, shard and hi.
// Every shard takes ring mode, whatever its shape: the TPU tiers' VMEM
// and alignment predicates choose among TPU schedules and have no
// counterpart here.
// The folds, skews and seam fixes exist because a Pallas grid runs its
// programs in order on one core and hands slabs from one to the next; the
// skew leaves a seam band that a second kernel recomputes. Hopper CTAs run
// in no order, so K4 takes the margin recompute of pallas_kstep2d instead,
// which needs no order and leaves no seam: on one card the whole-grid pass
// is the whole function.
//
// Design. Each CTA owns a kTile x kTile tile of the output. It loads the
// tile's window, (kTile + 2k)^2 cells of the nine populations and the mask,
// into dynamic shared memory once; steps it k times there between two
// buffers (every thread reads step s before any writes step s + 1: the
// barrier of the per-step block sum separates them), computing a square
// that shrinks by one cell per side and step, since window-edge values go
// stale one cell per step; and writes the last step, which is exactly the
// owned tile, straight to the output. Tiles past a ragged grid edge mask
// the cells they do not own, so any shape runs.
//
// Two addressing modes, two template instances of one kernel body:
//   whole grid: src is the (9, ny, nx) grid, out distinct; window rows and
//     columns wrap modulo (ny, nx);
//   ring (kRing): the band of h + 2k rows is lo (9, k, nx), the shard mid
//     (9, h, nx) and hi (9, k, nx), in three buffers (a row's pointer is
//     picked at the window load: no copy of the shard into a band); band
//     row 0 is global row row_base; out (9, h, nx) is the shard after k
//     steps. Band rows do not wrap (rows past the band are filled as
//     blocked cells, outside the owned cells' reach); columns wrap modulo
//     nx.
// In the whole-grid instance the per-row buffer choice would cost
// registers and a few per cent of K4's time on the wide decks, hence two
// instances.
// The inflow acceleration picks a source cell by its GLOBAL row,
// (row_base + source row) mod ny, with the knife-edge guard of lbm_cell.
//
// Bound. The function of a k = 8 chunk moves 76 B per cell: the nine
// populations and the mask in once, the nine populations out once, 9.5 B
// a cell-step. Its ~94 fp32 operations a cell update are less: so the
// bound is bytes, 1.52 ms a chunk (0.19 ms a step) at 8192^2 at 3.35 TB/s.
// This design adds work the function does not need: at k = 8 a 32 x 32
// tile computes 12,336 cell updates for 8,192 owned ones (x1.51 recompute
// of the window's margins), and every update moves about 80 B through
// shared memory. Those are the costs a faster version cuts (larger tiles,
// fewer shared-memory round trips), not the bound. This first version
// spends 168 KB of shared memory at k = 8, so one CTA of 512 threads per
// SM, and does not overlap a tile's load with the previous tile's steps;
// measured times against the bound are in PERF.md. In ring mode the
// function reads the band (h + 2k rows of populations and mask) and writes
// the h shard rows: bytes again; a shard of a small grid is a launch of few
// CTAs, so on the ring the host's launch path, not this bound, sets the
// pace below the widest decks (PERF.md).
//
// Per-step sums are per-CTA partials in a fixed order, (k, nblocks) floats,
// reduced by K3; no float atomics, so two runs give identical bytes.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

constexpr int kTile = 32;    // owned tile edge, cells
constexpr int kMaxK = 8;     // steps per launch
constexpr int kThreads = 512;

// Rows of one launch. Whole grid: out_rows = ny, window row 0 of tile-row
// ty is grid row 32 ty - k (mod ny). Ring: out_rows = h, window row 0 of
// tile-row ty is band row 32 ty; band row sr is lo's row sr (sr < k), the
// shard's row sr - k or hi's row sr - k - h; row_base is the global row of
// band row 0.
struct TileArgs {
  int k;
  int out_rows;
  int row_base;
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// The step-s state of the window in shared memory around window cell
// c = wy * w + wx (planes of w * w floats; mask 1 = blocked; acc_rows[wy]
// = 1 where window row wy is the accelerated row).
struct TileSrc {
  const float* buf;
  const unsigned char* mask;
  const unsigned char* acc_rows;
  int plane, w, c, wy;
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return buf[k * plane + c + dy * w + dx];
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return mask[c + dy * w + dx] == 0;
  }
  __device__ __forceinline__ bool accel(int dy) const {
    return acc_rows[wy + dy] != 0;
  }
};

struct TileDst {
  float* o;
  int plane;
  __device__ __forceinline__ void operator()(int k, float v) const {
    o[k * plane] = v;
  }
};

template <bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
    kstep_tile_kernel(const float* __restrict__ src_lo,
                      const float* __restrict__ src_mid,
                      const float* __restrict__ src_hi,
                      const float* __restrict__ obst, float* __restrict__ out,
                      float* __restrict__ partials, tpulbm::LbmArgs a,
                      TileArgs t) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kThreads / 32];
  const int w = kTile + 2 * t.k;   // window edge
  const int plane = w * w;
  float* cur = smem;
  float* nxt = smem + 9 * plane;
  unsigned char* mask = reinterpret_cast<unsigned char*>(smem + 18 * plane);
  unsigned char* acc_rows = mask + plane;

  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int src_rows = kRing ? t.out_rows + 2 * t.k : a.ny;

  for (int i = threadIdx.x; i < plane; i += kThreads) {
    const int wy = i / w, wx = i - wy * w;
    // sr: row of the source rows (band or grid); r: its row in buf
    int sr, r, rows;
    const float* buf = src_mid;
    if constexpr (kRing) {
      sr = y0 + wy;
      r = sr - t.k, rows = t.out_rows;
      if (r < 0) {
        buf = src_lo, r = sr, rows = t.k;
      } else if (r >= t.out_rows) {
        buf = src_hi, r -= t.out_rows, rows = t.k;
      }
    } else {
      sr = r = wrap(y0 - t.k + wy, a.ny), rows = a.ny;
    }
    const bool in = !kRing || sr < src_rows;
    const int col = wrap(x0 - t.k + wx, a.nx);
    const size_t g = (size_t)r * a.nx + col;
    const size_t bplane = (size_t)rows * a.nx;
    for (int q = 0; q < 9; ++q)
      cur[q * plane + i] = in ? __ldg(buf + q * bplane + g) : 0.0f;
    mask[i] = in ? (__ldg(obst + (size_t)sr * a.nx + col) != 0.0f) : 1;
  }
  for (int wy = threadIdx.x; wy < w; wy += kThreads) {
    const int sr = kRing ? y0 + wy : wrap(y0 - t.k + wy, a.ny);
    acc_rows[wy] =
        sr < src_rows && wrap(t.row_base + sr, a.ny) == a.accel_row;
  }
  __syncthreads();

  const int own_rows = min(kTile, t.out_rows - y0);
  const int own_cols = min(kTile, a.nx - x0);
  const size_t oplane = (size_t)t.out_rows * a.nx;
  const int nblocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  for (int s = 0; s < t.k; ++s) {
    // State s+1 on the square [lo, lo + n)^2 from state s on the square one
    // cell wider; on the last step the square is the owned tile.
    const int lo = s + 1, n = w - 2 * lo;
    const bool last = s == t.k - 1;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n * n; i += kThreads) {
      const int ry = i / n;
      const int wy = lo + ry, wx = lo + i - ry * n;
      const int oy = wy - t.k, ox = wx - t.k;   // owned-tile coordinates
      const bool owned = oy >= 0 && oy < own_rows && ox >= 0 && ox < own_cols;
      const TileSrc ts{cur, mask, acc_rows, plane, w, wy * w + wx, wy};
      if (last) {
        if (owned)
          acc += tpulbm::lbm_cell(
              ts,
              tpulbm::GridDst{out + (size_t)(y0 + oy) * a.nx + x0 + ox, oplane},
              a);
      } else {
        const float speed =
            tpulbm::lbm_cell(ts, TileDst{nxt + wy * w + wx, plane}, a);
        if (owned) acc += speed;
      }
    }
    const float bsum = tpulbm::block_sum(acc, warp_sums);
    if (threadIdx.x == 0) partials[(size_t)s * nblocks + block] = bsum;
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// Dynamic shared memory of a k-step launch, bytes.
int smem_bytes(int k) {
  const int w = kTile + 2 * k;
  return 18 * w * w * (int)sizeof(float) + w * w + w;
}

// Launches on the current device.
template <bool kRing>
int launch(const float* src_lo, const float* src_mid, const float* src_hi,
           const float* obst, float* out, float* partials,
           const tpulbm::LbmArgs& a, const TileArgs& t, cudaStream_t stream) {
  if (t.k < 1 || t.k > kMaxK || t.out_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(t.k);
  cudaError_t e = cudaFuncSetAttribute(
      kstep_tile_kernel<kRing>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.nx + kTile - 1) / kTile,
                  (t.out_rows + kTile - 1) / kTile);
  kstep_tile_kernel<kRing><<<grid, kThreads, smem, stream>>>(
      src_lo, src_mid, src_hi, obst, out, partials, a, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// CTAs of a K4 launch whose output has `rows` rows: the row length of its
// partials.
int lbm_kstep_tile_blocks(int rows, int nx) {
  return ((rows + kTile - 1) / kTile) * ((nx + kTile - 1) / kTile);
}

int lbm_kstep_tile_smem(int k) { return smem_bytes(k); }

// k steps (1 <= k <= 8) of the whole grid: src and out (9, ny, nx),
// distinct; obst the (ny, nx) float32 mask, nonzero = blocked; partials
// (k, lbm_kstep_tile_blocks(ny, nx)) floats. Returns cudaGetLastError(),
// or the error of setting the shared memory size. Launches on the current
// device.
int lbm_kstep_tile(const float* src, const float* obst, float* out,
                   float* partials, int ny, int nx, int accel_row,
                   float omega, float w1, float w2, int k,
                   cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  const TileArgs t{k, ny, 0};
  return launch<false>(nullptr, src, nullptr, obst, out, partials, a, t,
                       stream);
}

// Ring mode: k steps of the (9, h, nx) shard whose band of h + 2k rows is
// lo (9, k, nx), shard, hi (9, k, nx), band row 0 being global row
// row_base; obst is the (h + 2k, nx) float32 mask of the band. Writes out
// (9, h, nx) and partials (k, lbm_kstep_tile_blocks(h, nx)). Returns as
// lbm_kstep_tile.
int lbm_kstep_tile_ring(const float* lo, const float* shard, const float* hi,
                        const float* obst, float* out, float* partials,
                        int ny, int nx, int accel_row, float omega, float w1,
                        float w2, int k, int h, int row_base,
                        cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  const TileArgs t{k, h, row_base};
  return launch<true>(lo, shard, hi, obst, out, partials, a, t, stream);
}

}  // extern "C"
