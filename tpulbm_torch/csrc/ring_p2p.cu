// K6 lbm_ring_p2p: up to kMaxOuter chunks of k <= 8 D2Q9-BGK steps of every
// shard of the 1-D ring that lies on one card, in one persistent launch,
// the shards handing their edge rows to each other inside the kernel through
// device memory (shards on this card) and peer memory (shards on another
// card, over NVLink).
//
// Replaces the two TPU kernels whose slab exchange runs inside the kernel:
//   tpulbm/ops/pallas_kstep_rdma.py::_kernel: one chunk of k steps of a
//     (9, h, nx) shard, its 8-row edge slabs sent by remote copies into
//     the ring neighbours' parity-slotted landing buffers (n_outer = 1);
//   tpulbm/ops/pallas_resident_rdma.py::_kernel: n_outer chunks of k steps
//     with the shard held on chip, slabs exchanged every k steps, the
//     landing slots alternating by a parity carried across calls in a
//     base-parity scalar, per-step sums (n_outer k,).
// It computes what K4's ring mode (kstep_tile.cu) computes chunk by chunk
// over every shard with the slabs copied between chunks, the same bits:
// the same 32 x 32 owned tiles, the same tile step (tile_step.cuh), the
// same fixed-order reduction of each chunk's (k, ntiles) partials
// (lbm_cell.cuh::reduce_rows).
//
// Design.
//   Work items (c, shard, tile), chunk-major: item c * items + item0 of the
//     shard + tile, `items` the tiles of one chunk over this launch's shards.
//     A persistent grid (CTAs a SM x SMs, as K4, co-resident by
//     construction: cudaOccupancyMaxActiveBlocksPerMultiprocessor) walks
//     them, CTA b taking items b, b + grid, ... in order.
//   The tile graph. Before a tile of chunk c (epoch e = base + c) loads its
//     window it waits until every tile whose owned cells lie within k cells
//     of its own has finished epoch e - 1: the 3 x 3 neighbourhood, taken
//     as tile columns tx - 2 .. tx + 2 and the tile rows that hold the
//     rows within k (across the shard edges, into the previous shard's last
//     two tile rows and the next shard's first), a superset wherever a
//     ragged last tile row or column is narrower than k. The relation is
//     symmetric, and every tile depends on itself, so it also orders every
//     write after a read: chunk c + 1 writes the buffer chunk c read, and a
//     landing slot is rewritten two epochs later, only after the tiles that
//     read it have finished. No grid-wide barrier and no launch per chunk:
//     chunk c + 1 starts wherever its neighbourhood is done.
//   Flags: one int a tile, on the shard's card, holding the last epoch the
//     tile finished + 1. Never reset: the epoch rises across launches and
//     runner calls (the counterpart of the TPU kernel's base-parity
//     scalar), so no memset races a kernel on another card that reads the
//     flag. A wait reads a flag with ld.acquire.gpu, or ld.acquire.sys
//     across cards; a tile publishes after its stores with st.release at
//     the matching scope, sys where a neighbour shard lies on another card,
//     and then every thread that stored to the other card has fenced at
//     sys scope first (__threadfence_system).
//   Slabs, pushed: a tile that owns one of its shard's last k rows writes
//     it into the next shard's lo landing slot, one of its first k rows into
//     the previous shard's hi slot, the slot of the next epoch's parity; the
//     window load reads lo | shard | hi as K4's ring mode does, from local
//     memory by cp.async, while NVLink carries posted stores. A slot is
//     (9, k, nx) in a (9, 8, nx) buffer. The first chunk of a runner call
//     (pull0) reads the neighbours' input states instead: they hold the
//     call's start state, and no slot does yet.
//   After a tile's first step (tile_step.cuh's hook), the CTA releases the
//     flag of the tile before and polls the next item's neighbourhood once;
//     where it is done, the next window loads under the other k - 1 steps.
//     Otherwise the CTA waits after the tile, its own flag released first,
//     so no CTA waits on an item while it holds one that a wait could need.
//     Loads are cp.async.cg (L2 only: a buffer written earlier in the
//     launch by another SM is never read from a stale L1 line); without
//     16-byte alignment, __ldcg loads.
//   Registers: the step needs the 80 a thread that 768 threads leave, so
//     the stepped tile's output pointers and offsets live in shared memory
//     (`to`), not in registers live across the step loop; held in
//     registers, ptxas spilled 144 B and a chunk took longer (PERF.md).
//   Sums: each tile's k partials go to column `tile` of rows [ck, ck + k)
//     of its shard's (n_outer k, ntiles) partials; the CTA that draws the
//     launch's last ticket (lbm_cell.cuh::last_ticket, one counter a card)
//     reduces each (chunk, shard)'s k rows in reduce_rows's order: K4's
//     bits, chunk by chunk, with no atomic in a tile's path.
//   Every spin is bounded by %globaltimer (kSpinNs, 10 s); when the bound
//     runs out the CTA writes the card's error word and returns, and every
//     spinner of the card gives up once it sees the word. The runner reads
//     the word with the av series and raises: a broken protocol fails, it
//     never hangs.
//   One instance per k (1 to 8), as K4.
//
// Bound. One launch moves the shards' states and masks in once and the
// states out once (76 B a cell, the slabs are a few rows) and does 94 fp32
// operations a cell update, n_outer k updates a cell: operations bound it
// from a few chunks on (0.0118 ms a chunk at 1024^2, 0.75 ms for 64
// chunks). The design adds what K4 adds (the 1.51x recompute, the shared-
// memory traffic of the step loop) and reads and writes each chunk's state
// through L2 and device memory, and the waits.

#include <cuda_runtime.h>

#include <initializer_list>

#include "async_copy.cuh"
#include "lbm_cell.cuh"
#include "tile_step.cuh"

namespace {

using namespace tpulbm::tile;

constexpr int kMaxLocal = 16;       // shards of one launch
constexpr int kMaxOuter = 64;       // chunks of one launch
constexpr int kDepCols = 5;         // tile columns tx - 2 .. tx + 2
constexpr int kDepRows = 6;         // ty - 1 .. ty + 1, two above, one below
constexpr int kMaxDeps = kDepCols * kDepRows;
constexpr long long kSpinNs = 10000000000LL;
constexpr int kErrTimeout = 1;      // the error word: a wait ran out
constexpr int kMaxDevices = 64;
// Words of a shard's entry in the host table (lbm_ring_p2p): 18 pointers,
// then h, h_prev, h_next, row_base, remote_prev, remote_next.
constexpr int kWords = 24;
static_assert(kMaxDeps <= kThreads, "one thread a dependency");

// One shard of a launch. state[0] holds the state at the launch's first
// epoch; chunk c reads state[c & 1] and writes state[(c + 1) & 1].
struct Shard {
  const float* obst;       // (h + 2k, nx) mask band; band row 0 = row_base
  float* state[2];
  const float* prev_in;    // previous shard's state[0] (9, h_prev, nx)
  const float* next_in;    // next shard's state[0] (9, h_next, nx)
  float* lo[2];            // own landing slots by epoch parity
  float* hi[2];
  float* push_lo[2];       // the next shard's lo slots
  float* push_hi[2];       // the previous shard's hi slots
  int* flags;              // own tiles' flags
  const int* flags_prev;
  const int* flags_next;
  float* partials;         // (n_outer k, ntiles)
  float* sums;             // (n_outer k,)
  int h, h_prev, h_next, row_base, remote_prev, remote_next;
  int item0, ntiles;
};

struct Launch {
  Shard shard[kMaxLocal];
  int n_local, items, n_outer, base, pull0, tiles_x;
  int* error;              // this card's error word
  unsigned int* counter;   // this card's ticket counter, zeroed, left so
};

__device__ __forceinline__ int load_acquire(const int* p, bool sys) {
  int v;
  if (sys)
    asm volatile("ld.acquire.sys.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v, bool sys) {
  if (sys)
    asm volatile("st.release.sys.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Dependency d (< kMaxDeps) of tile `tile` of shard S: the flag to wait
// on, or null; *sys where it lies on another card.
__device__ __forceinline__ const int* dependency(const Shard& S, int tiles_x,
                                                 int tile, int k, int d,
                                                 bool* sys) {
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int col = wrap(tx + d % kDepCols - 2, tiles_x);
  const int slot = d / kDepCols;
  const int y0 = ty * kTile, own = min(kTile, S.h - y0);
  *sys = false;
  if (slot < 3) {
    const int r = ty + slot - 1;
    const int tiles_y = (S.h + kTile - 1) / kTile;
    return r >= 0 && r < tiles_y ? S.flags + r * tiles_x + col : nullptr;
  }
  if (slot < 5) {   // the previous shard's last two tile rows
    const int r = (S.h_prev + kTile - 1) / kTile - 1 - (slot - 3);
    if (ty != 0 || r < 0) return nullptr;
    *sys = S.remote_prev;
    return S.flags_prev + r * tiles_x + col;
  }
  if (y0 + own + k <= S.h) return nullptr;   // the next shard's first row
  *sys = S.remote_next;
  return S.flags_next + col;
}

template <int kK>
__global__ void __launch_bounds__(kThreads, 1)
    ring_p2p_kernel(const __grid_constant__ Launch L, tpulbm::LbmArgs a,
                    int vec16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sums[kMaxK][kWarps];
  __shared__ unsigned char acc_rows[2][kMaxW];
  __shared__ int go;
  // The stepped tile's outputs, read by the step's stores and partials:
  // held in shared memory, not in registers live across the step loop,
  // whose 80 registers a thread the step needs (ptxas spilled K6 where
  // they were registers; PERF.md).
  __shared__ struct {
    float* out;            // the shard's next state, (9, h, nx)
    float* push_lo;        // the next shard's lo slot of the next parity
    float* push_hi;        // the previous shard's hi slot
    float* partials;       // column `tile` of the chunk's first row
    int h, y0, x0, ntiles;
    int remote_lo, remote_hi;   // push_lo's, push_hi's shard on another card
  } to;
  constexpr int k = kK;
  constexpr int kx = col_margin(k);
  constexpr int wh = kTile + 2 * k;     // window rows
  constexpr int w = kTile + 2 * kx;     // window columns
  constexpr int plane = wh * w;
  constexpr int sfloats = stage_floats(k);
  const int total = L.items * L.n_outer;
  const size_t slab_plane = (size_t)k * a.nx;
  const Cells<kK> cells;
  const int sl = threadIdx.x & (kSegLanes - 1);
  const int seg_w = vec16 ? 4 : 1;

  // item -> chunk c, shard j, tile
  auto locate = [&](int item, int* c, int* j, int* tile) {
    *c = item / L.items;
    const int r = item - *c * L.items;
    int s = 0;
    while (s + 1 < L.n_local && r >= L.shard[s + 1].item0) ++s;
    *j = s;
    *tile = r - L.shard[s].item0;
  };

  // One poll of the item's dependencies: true in every thread where all
  // have finished the epoch before the item's.
  auto ready = [&](int item2) {
    int ok = 1;
    if (threadIdx.x < kMaxDeps) {
      int c, j, tile;
      locate(item2, &c, &j, &tile);
      bool sys;
      const int* f =
          dependency(L.shard[j], L.tiles_x, tile, k, threadIdx.x, &sys);
      if (f) ok = load_acquire(f, sys) >= L.base + c;
    }
    return __syncthreads_and(ok) != 0;
  };

  // Waits for the item's dependencies; false in every thread where the
  // card's error word is set (this or another CTA gave up).
  auto wait = [&](int c, int j, int tile) {
    if (threadIdx.x < kMaxDeps) {
      bool sys;
      const int* f =
          dependency(L.shard[j], L.tiles_x, tile, k, threadIdx.x, &sys);
      if (f) {
        const long long t0 = globaltimer();
        for (int n = 1; load_acquire(f, sys) < L.base + c; ++n) {
          if ((n & 31) == 0) {
            if (*(volatile int*)L.error) break;
            if (globaltimer() - t0 > kSpinNs) {
              atomicExch(L.error, kErrTimeout);
              break;
            }
          }
          __nanosleep(100);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) go = *(volatile int*)L.error == 0;
    __syncthreads();
    return go != 0;
  };

  // Issues the copy of the item's window into stage st: band rows
  // [32 ty, 32 ty + 32 + 2k) of lo | shard | hi, columns 32 tx - kx ...
  // (mod nx).
  auto issue = [&](int c, int j, int tile, int st) {
    const Shard& S = L.shard[j];
    const int e = L.base + c;
    const int ty = tile / L.tiles_x;
    const int y0 = ty * kTile, x0 = (tile - ty * L.tiles_x) * kTile;
    const float *lo, *hi;
    size_t lo_plane = slab_plane, hi_plane = slab_plane;
    if (L.pull0 && c == 0) {
      lo = S.prev_in + (size_t)(S.h_prev - k) * a.nx;
      hi = S.next_in;
      lo_plane = (size_t)S.h_prev * a.nx;
      hi_plane = (size_t)S.h_next * a.nx;
    } else {
      lo = S.lo[e & 1];
      hi = S.hi[e & 1];
    }
    const float* mid = S.state[c & 1];
    const size_t mid_plane = (size_t)S.h * a.nx;
    float* stage = smem + st * sfloats;
    int wcol[kMaxSegs], gcol[kMaxSegs];
#pragma unroll
    for (int m = 0; m < kMaxSegs; ++m) {
      wcol[m] = (sl + kSegLanes * m) * seg_w;
      gcol[m] = wrap(x0 - kx + wcol[m], a.nx);
    }
    for (int wy = threadIdx.x / kSegLanes; wy < wh; wy += kRowSlots) {
      const int sr = y0 + wy;   // band row
      int r = sr - k;
      const float* buf = mid;
      size_t bplane = mid_plane;
      if (r < 0) {
        buf = lo, r = sr, bplane = lo_plane;
      } else if (r >= S.h) {
        buf = hi, r -= S.h, bplane = hi_plane;
      }
      const bool in = sr < S.h + 2 * k;
      if (sl == 0)
        acc_rows[st][wy] = in && wrap(S.row_base + sr, a.ny) == a.accel_row;
      const float* mrow = S.obst + (size_t)sr * a.nx;
      float* drow = stage + wy * w;
#pragma unroll
      for (int m = 0; m < kMaxSegs; ++m) {
        if (wcol[m] >= w) break;
        float* d = drow + wcol[m];
        const int cc = gcol[m];
        const float* g = buf + (size_t)r * a.nx + cc;
        if (!in) {
          for (int x = 0; x < seg_w; ++x) {
            for (int q = 0; q < 9; ++q) d[q * plane + x] = 0.0f;
            d[9 * plane + x] = 1.0f;
          }
        } else if (vec16) {
          for (int q = 0; q < 9; ++q)
            tpulbm::cp_async16(d + q * plane, g + q * bplane);
          tpulbm::cp_async16(d + 9 * plane, mrow + cc);
        } else {
          for (int q = 0; q < 9; ++q) d[q * plane] = __ldcg(g + q * bplane);
          d[9 * plane] = mrow[cc];
        }
      }
    }
  };

  // The item whose flag thread 0 releases next (its tile is stepped and
  // stored), or -1. The barriers after the stores order every thread's
  // stores before thread 0's release (the pattern of CUTLASS's
  // GenericBarrier), at sys scope where a neighbour is on another card.
  int pending = -1;
  auto publish = [&] {
    if (threadIdx.x == 0 && pending >= 0) {
      int pc, pj, pt;
      locate(pending, &pc, &pj, &pt);
      const Shard& P = L.shard[pj];
      const bool sys = P.remote_prev || P.remote_next;
      if (sys) __threadfence_system();
      store_release(P.flags + pt, L.base + pc + 1, sys);
    }
    pending = -1;
  };

  int item = blockIdx.x;
  if (item >= total) return;
  {
    int c, j, tile;
    locate(item, &c, &j, &tile);
    if (!wait(c, j, tile)) return;
    issue(c, j, tile, 0);
    tpulbm::cp_async_commit();
  }
  int st = 0;
  for (; item < total; item += gridDim.x) {
    const int next = item + gridDim.x;
    bool issued = false;
    if (threadIdx.x == 0) {
      int c, j, tile;
      locate(item, &c, &j, &tile);
      const Shard& S = L.shard[j];
      const int parity = (L.base + c + 1) & 1;
      const int ty = tile / L.tiles_x;
      to.out = S.state[(c + 1) & 1];
      to.push_lo = S.push_lo[parity];
      to.push_hi = S.push_hi[parity];
      to.partials = S.partials + (size_t)c * k * S.ntiles + tile;
      to.h = S.h;
      to.y0 = ty * kTile;
      to.x0 = (tile - ty * L.tiles_x) * kTile;
      to.ntiles = S.ntiles;
      to.remote_lo = S.remote_next;
      to.remote_hi = S.remote_prev;
    }
    tpulbm::cp_async_wait<0>();
    __syncthreads();   // the item's window is in stage st, `to` is set
    step_tile<kK>(
        smem + st * sfloats, acc_rows[st], min(kTile, to.h - to.y0),
        min(kTile, a.nx - to.x0), cells, warp_sums, a,
        [&](int oy, int ox, const float* res) {
          const int row = to.y0 + oy, col = to.x0 + ox, h = to.h;
          float* o = to.out + (size_t)row * a.nx + col;
          const size_t oplane = (size_t)h * a.nx;
#pragma unroll
          for (int q = 0; q < 9; ++q) o[q * oplane] = res[q];
          // Each thread that stored to another card fences at sys scope
          // itself, before the barriers that precede thread 0's release,
          // so the release does not rest on the cumulativity of one
          // thread's fence over the other warps' NVLink stores.
          if (row >= h - k) {
            float* p = to.push_lo + (size_t)(row - (h - k)) * a.nx + col;
#pragma unroll
            for (int q = 0; q < 9; ++q) p[q * slab_plane] = res[q];
            if (to.remote_lo) __threadfence_system();
          }
          if (row < k) {
            float* p = to.push_hi + (size_t)row * a.nx + col;
#pragma unroll
            for (int q = 0; q < 9; ++q) p[q * slab_plane] = res[q];
            if (to.remote_hi) __threadfence_system();
          }
        },
        [&](int s, float v) { to.partials[(size_t)s * to.ntiles] = v; },
        [&] {
          // After the first step the tile before's stores have drained, so
          // its release and this poll wait on nothing (right after the
          // stores both waited for them); the next window, where its
          // neighbourhood is done, then flies under the other k - 1 steps.
          publish();
          if (next < total) {
            issued = ready(next);
            if (issued) {
              int nc, nj, nt;
              locate(next, &nc, &nj, &nt);
              issue(nc, nj, nt, st ^ 1);
              tpulbm::cp_async_commit();
            }
          }
        });
    pending = item;
    if (next < total && !issued) {
      publish();
      int nc, nj, nt;
      locate(next, &nc, &nj, &nt);
      if (!wait(nc, nj, nt)) break;
      issue(nc, nj, nt, st ^ 1);
      tpulbm::cp_async_commit();
    }
    st ^= 1;
  }
  publish();
  tpulbm::cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x == 0) go = *(volatile int*)L.error == 0;
  __syncthreads();
  if (go && tpulbm::last_ticket(L.counter)) {
    for (int j = 0; j < L.n_local; ++j) {
      const Shard& S = L.shard[j];
      for (int c = 0; c < L.n_outer; ++c) {
        tpulbm::reduce_rows(L.counter, S.partials + (size_t)c * k * S.ntiles,
                            S.sums + c * k, k, S.ntiles);
        __syncthreads();
      }
    }
  }
}

int smem_bytes(int k) { return 2 * stage_floats(k) * (int)sizeof(float); }

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// The persistent grid of an instance on the current device, its shared-
// memory limit set on first use: every CTA of a launch of at most this many
// is resident at once, which the waits need.
template <int kK>
cudaError_t configure(int* grid_cap) {
  static int cap[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cap[dev]) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(ring_p2p_kernel<kK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(kK));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ring_p2p_kernel<kK>, kThreads, smem_bytes(kK));
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap[dev] = per_sm * sms;
  }
  *grid_cap = cap[dev];
  return cudaSuccess;
}

template <int kK>
int launch(const Launch& l, const tpulbm::LbmArgs& a, cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = configure<kK>(&cap);
  if (e != cudaSuccess) return (int)e;
  const int total = l.items * l.n_outer;
  bool vec16 = a.nx % 4 == 0;
  for (int j = 0; j < l.n_local; ++j) {
    const Shard& s = l.shard[j];
    for (const void* p : {(const void*)s.obst, (const void*)s.state[0],
                          (const void*)s.state[1], (const void*)s.prev_in,
                          (const void*)s.next_in, (const void*)s.lo[0],
                          (const void*)s.lo[1], (const void*)s.hi[0],
                          (const void*)s.hi[1]})
      vec16 = vec16 && aligned16(p);
  }
  ring_p2p_kernel<kK><<<total < cap ? total : cap, kThreads, smem_bytes(kK),
                        stream>>>(l, a, vec16 ? 1 : 0);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const Launch&, const tpulbm::LbmArgs&, cudaStream_t);
constexpr LaunchFn kLaunch[kMaxK] = {launch<1>, launch<2>, launch<3>,
                                     launch<4>, launch<5>, launch<6>,
                                     launch<7>, launch<8>};
constexpr cudaError_t (*kConfigure[kMaxK])(int*) = {
    configure<1>, configure<2>, configure<3>, configure<4>,
    configure<5>, configure<6>, configure<7>, configure<8>};

}  // namespace

extern "C" {

int lbm_ring_p2p_words() { return kWords; }
int lbm_ring_p2p_max_local() { return kMaxLocal; }
int lbm_ring_p2p_max_outer() { return kMaxOuter; }
int lbm_ring_p2p_smem(int k) { return smem_bytes(k); }

// CTAs of a k-step launch on the current device (its co-resident grid); a
// negative CUDA error code on failure.
int lbm_ring_p2p_ctas(int k) {
  if (k < 1 || k > kMaxK) return -(int)cudaErrorInvalidValue;
  int cap = 0;
  const cudaError_t e = kConfigure[k - 1](&cap);
  return e == cudaSuccess ? cap : -(int)e;
}

// Lets device `from` read and write device `to`'s memory. Returns 0,
// cudaErrorPeerAccessUnsupported where cudaDeviceCanAccessPeer says no, or
// the error of enabling it; access enabled before (by PyTorch, or an
// earlier call) is no error, and the error it leaves is cleared. Restores
// the current device.
int lbm_ring_p2p_enable_peer(int from, int to) {
  int cur = 0, can = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess) e = cudaDeviceCanAccessPeer(&can, from, to);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaSetDevice(from);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(to, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : back);
}

// n_outer (<= kMaxOuter) chunks of k (<= 8) steps of n_local (<=
// kMaxLocal) shards of the ring, the epochs base .. base + n_outer - 1;
// table: kWords int64 words a shard (the Shard fields in order, pointers
// then ints; see ops/ring_p2p.py), all shards of the launch on the current
// device; pull0: chunk 0 reads prev_in / next_in, not the slots; error: the
// device's error word; counter: a zeroed unsigned int of the device, left
// zeroed (the last CTA resets it), not shared with a launch that may run
// at the same time. Launches on the current device and stream; returns
// cudaGetLastError(), or the error of configuring the kernel.
int lbm_ring_p2p(const long long* table, int n_local, int n_outer, int base,
                 int pull0, int* error, unsigned int* counter, int ny,
                 int nx, int accel_row,
                 float omega, float w1, float w2, int k,
                 cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n_local < 1 || n_local > kMaxLocal ||
      n_outer < 1 || n_outer > kMaxOuter || nx < 1 || base < 0)
    return (int)cudaErrorInvalidValue;
  Launch l{};
  l.n_local = n_local;
  l.n_outer = n_outer;
  l.base = base;
  l.pull0 = pull0;
  l.tiles_x = (nx + kTile - 1) / kTile;
  l.error = error;
  l.counter = counter;
  int items = 0;
  for (int j = 0; j < n_local; ++j) {
    const long long* t = table + (size_t)j * kWords;
    Shard& s = l.shard[j];
    auto ptr = [&](int i) { return reinterpret_cast<float*>(t[i]); };
    s.obst = ptr(0);
    s.state[0] = ptr(1), s.state[1] = ptr(2);
    s.prev_in = ptr(3), s.next_in = ptr(4);
    s.lo[0] = ptr(5), s.lo[1] = ptr(6), s.hi[0] = ptr(7), s.hi[1] = ptr(8);
    s.push_lo[0] = ptr(9), s.push_lo[1] = ptr(10);
    s.push_hi[0] = ptr(11), s.push_hi[1] = ptr(12);
    s.flags = reinterpret_cast<int*>(t[13]);
    s.flags_prev = reinterpret_cast<const int*>(t[14]);
    s.flags_next = reinterpret_cast<const int*>(t[15]);
    s.partials = ptr(16);
    s.sums = ptr(17);
    s.h = (int)t[18], s.h_prev = (int)t[19], s.h_next = (int)t[20];
    s.row_base = (int)t[21];
    s.remote_prev = (int)t[22], s.remote_next = (int)t[23];
    if (s.h < k || s.h_prev < k || s.h_next < k || s.row_base < 0 ||
        s.row_base >= ny)
      return (int)cudaErrorInvalidValue;
    s.item0 = items;
    s.ntiles = l.tiles_x * ((s.h + kTile - 1) / kTile);
    items += s.ntiles;
  }
  l.items = items;
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  return kLaunch[k - 1](l, a, stream);
}

}  // extern "C"
