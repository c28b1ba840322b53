// The grid kind's step (ring_p2p.cu::grid_p2p_kernel): k D2Q9-BGK steps of
// the owned items (own_rows x own_cols cells, at most kMaxW columns) of the
// periodic grid that one CTA takes, as one row wavefront over the k time
// levels that streams through the CTA's items one after the other, and each
// item's k per-step partial sums of |u|.
//
// Why not tile_step.cuh's square window. There a 32 x 32 tile steps inside a
// 48 x 48 window held whole in shared memory, in place: the computed
// rectangle shrinks one cell a side and step, so 1.51 updates are computed
// an owned one at k = 8, every thread's results wait in registers through a
// barrier before they are written back, and a second barrier follows, two
// a step. A larger square does not fit: its window would take the second
// stage that lets the next window load under the step.
//
// The stream. An item's input is its window rows: the owned rows and k more
// above and below (L = own_rows + 2k rows) of w + 2 col_margin(k) columns,
// rows and columns wrapping modulo (ny, nx). The CTA's items follow each
// other in one sequence of row positions: item n's window row r is position
// base_n + r, and the copy group sets base_n where the item before ends
// (base_{n+1} = base_n + L_n) when item n + 1 is posted by then; otherwise
// it leaves a gap of drain(k) positions, in which the item before finishes,
// and starts item n + 1 once it is posted. Level 0 is the input; level s
// (1 <= s <= k) is the state after s steps. Level s computes position q
// from level s - 1's positions q - 1 .. q + 1, where q is a row r of an item
// with s <= r < L - s, over the columns [cm + s, w + 2 kx - cm - s) (kx =
// col_margin(k), cm = kx - k: the width shrinks one cell a side and level);
// level k is the owned rows and columns. In wave i level s takes the kRows
// positions kRows i + 1 - (kRows + 1)(s - 1) ...: each level runs kRows + 1
// positions behind the one below it, so what it reads was written in an
// earlier wave, and one barrier a wave orders everything. A position in a
// gap, or a row outside a level's rows, is skipped.
//   Memory. Every level 0 .. k - 1 keeps its rows in a ring of kRing
// positions (position q in ring row q % kRing; the kRows rows it writes in
// a wave and the kRows + 2 that the level above reads fit, and the rows of
// the wave after lie in rows freed a wave before): ten planes, the nine
// populations and the mask, which every level carries up with the cell.
// Level 0 is filled by the copy group by cp.async (RowCopy: a thread's
// pieces of a row and their wrapped columns set once an item), one `full`
// mbarrier a ring row (every position arrives on it, a gap without copies)
// and an `empty` one, arrived on once the position has been read for the
// last time; each position's accelerated-row bits lie in a ring of
// kBitsRing positions. Level k stores the owned cells straight to the
// output state. Shared memory grows with the item's width, not with its
// height, no result waits in registers through a barrier, and the stream
// has no fill or drain between items that follow each other: the
// recompute is the cone of a tall item, (h + 2k - 2s)(w + 2k - 2s) updates
// at level s, 1.236 an owned one for 64 x 64 at k = 8, and each level
// skips 2s positions between two items.
//   Lanes. Thread t takes the cells t + p kThreads (p < kPer) of a flat list
// of one wave's cells, level by level (kRows rows of each level's columns),
// fixed for a launch; a warp mostly holds cells of one level.
//   Sums. A thread adds the |u| of its cells that are owned into one register
// a cell, down the waves; once a cell passes its item's last row it leaves
// the register in `wsum` (kSums buffers, by item number modulo kSums) at the
// entry of the item's rows it took (those of one residue modulo kRows, at
// its column), and warp s - 1 sums level s's entries of an item in a fixed
// order (lane l: entries l, l + 32, ..., then shuffles) once every level-s
// cell has passed it: the same inputs give the same bits wherever the item
// lies in the stream, in the grid kind's own order
// (ops/ring_p2p.py::grid_sums_ref reduces the items' partials), not K4's.
// The warp sums item m in the wave after the one whose first level-s
// position reached the end of the item's level-s rows, and no barrier
// parts the sum from that wave's cells, which reach at most 2 kRows + 1
// positions past that end. A cell leaves item n's sum once it reaches the
// end of item n's rows, which for item m + kSums lies at least kSums (2k +
// 1) positions past item m's (an item has a row or more): so no cell
// leaves a sum in the buffer that a warp reads in the same wave. Two
// buffers would not do at k = 1, where two 1-row ragged items may follow
// item m (tests/test_torch_wave.py).
// Every cell update is lbm_cell's, unchanged, so the state is K4's bits.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "async_copy.cuh"
#include "lbm_cell.cuh"

namespace tpulbm {
namespace wave {

constexpr int kMaxK = 8;           // steps a chunk
constexpr int kMaxW = 64;          // item columns at most
constexpr int kRows = 3;           // positions a level computes a wave
constexpr int kRing = 8;           // positions of a level's ring
constexpr int kBitsRing = 64;      // positions of the accelerated-row bits
constexpr int kThreads = 576;      // stepping threads
constexpr int kJobs = 4;           // items in flight in a CTA
constexpr int kPlanes = 10;        // populations and mask of a ring row
constexpr int kSums = 3;           // buffers of the cells' sums (Sums)
// Cells of a wave at most: kRows rows of each level s's kMaxW + 2k - 2s
// columns, at k = kMaxK.
constexpr int kMaxCells =
    kRows * (kMaxK * (kMaxW + 2 * kMaxK) - kMaxK * (kMaxK + 1));
constexpr int kPer = (kMaxCells + kThreads - 1) / kThreads;
static_assert(kRing >= 2 * kRows + 2 && (kRing & (kRing - 1)) == 0,
              "a ring holds the rows read and written in one wave, and the "
              "rows of the wave after it lie in rows freed a wave before");
static_assert((kBitsRing & (kBitsRing - 1)) == 0 &&
                  kBitsRing >= (kRows + 1) * kMaxK + kRing + kRows + 2,
              "the bits ring spans level k's rows up to the copy group's");
static_assert(kMaxK <= kThreads / 32, "one warp a level sums its partial");
static_assert(kSums * 3 > 2 * kRows + 1,
              "no cell leaves a sum in the buffer summed in its wave, for "
              "items of one row at k = 1");

__host__ __device__ constexpr int col_margin(int k) { return (k + 3) & ~3; }

// Floats of one plane of a ring row, and of a ring row.
__host__ __device__ constexpr int pitch(int k) {
  return kMaxW + 2 * col_margin(k);
}
__host__ __device__ constexpr int row_floats(int k) {
  return kPlanes * pitch(k);
}

// Floats of a k-step launch's rings, levels 0 .. k - 1.
__host__ __device__ constexpr int smem_floats(int k) {
  return k * kRing * row_floats(k);
}

// Cells of level s in one wave, for items of w columns and k steps.
__host__ __device__ constexpr int level_cells(int w, int k, int s) {
  return kRows * (w + 2 * k - 2 * s);
}

// Level s's first position in wave 0.
__host__ __device__ constexpr int first(int s) {
  return 1 - (kRows + 1) * (s - 1);
}

// The gap after an item when the next one is not posted: the positions in
// which every level passes the item's last row and its level-k partial is
// summed (the wave after), all before thread 0 awaits a position past the
// gap (kRows (k + 2) - 1 of them at least; tests/test_torch_wave.py).
__host__ __device__ constexpr int drain(int k) {
  return (kRows + 1) * k + 2 * kRows + 2;
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// The barrier of the kThreads stepping threads: named barrier kBar.
template <int kBar>
__device__ __forceinline__ void sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kBar), "n"(kThreads) : "memory");
}

// Level s - 1's rows q - 1, q, q + 1 at the cell's column, in the level's
// ring (ten planes of kPitch floats: populations, then the mask, nonzero =
// blocked); bit dy + 1 of acc set where row q + dy is the accelerated row.
template <int kPitch>
struct RingSrc {
  const float *lo, *mid, *hi;
  unsigned acc;
  __device__ __forceinline__ const float* row(int dy) const {
    return dy < 0 ? lo : dy > 0 ? hi : mid;
  }
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return row(dy)[k * kPitch + dx];
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return row(dy)[9 * kPitch + dx] == 0.0f;
  }
  __device__ __forceinline__ bool accel(int dy) const {
    return (acc >> (dy + 1)) & 1u;
  }
};

// An item of the grid kind: the producer writes it and arrives on its
// slot's `posted`; the copy group then sets base and, last, seq (the item's
// number in the CTA), which marks base set for the stepping warps.
struct Job {
  const float* src;        // the chunk's input state, (9, ny, nx)
  float* out;              // the chunk's output state
  float* partials;         // column `item` of the chunk's first row
  int y0, x0, own_rows, own_cols, items;
  int live;                // 0: no more items
  int rec, epoch;          // its flag and the epoch it finishes (producer)
  int base;                // position of window row 0 (copy group)
  volatile int seq;        // the item's number once base is set
};

// What the stepping warps share besides the rings: the items, the sums'
// buffers and the wave at which the last item was summed (-1 before).
struct Stream {
  Job job[kJobs];
  unsigned long long posted[kJobs], done[kJobs];
  unsigned long long full[kRing], empty[kRing];
  float wsum[kSums][kMaxCells];
  unsigned char bits[kBitsRing];
  volatile int finished;
  int next[2];             // the copy group's choice after item n: n & 1
};

// The copy group's part (kCopy threads, named barrier kBar): every
// position in order, each on its ring row's `full` once the row is free
// (`empty` of the position kRing before): an item's window rows, copied
// (see copy_row), or a gap. Items are started as described above; after
// the stop item, gaps until the stepping warps have finished.
template <int kK, int kCopy, int kBar>
__device__ __forceinline__ void copy_stream(float* smem, Stream& S,
                                            const float* obst, int w,
                                            int vec16, const LbmArgs& a,
                                            int t);

// The stepping warps' part (kThreads threads, named barrier kBar): waves
// until the stop item is reached and every item is summed. Stores level
// k's owned cells into each item's output state, its step-s partial into
// partials[(s - 1) items], and arrives on the item's `done` once both are
// written. Returns, in thread 0, the SM cycles it was blocked awaiting
// level-0 ring rows that the copy group had not landed (0 elsewhere).
template <int kK, int kBar>
__device__ __forceinline__ unsigned long long step_stream(float* smem,
                                                          Stream& S, int w,
                                                          const LbmArgs& a);

// ---------------------------------------------------------------------------

// Copy-group thread t's part of a window row (of kPlanes planes of w + 2
// col_margin(k) columns: the nine populations, then the mask) in pieces of
// kSeg floats (4: 16-byte cp.async.cg, where nx % 4 == 0 and the buffers
// are aligned, so that every piece lies in one grid row; 1: __ldcg):
// pieces t, t + kCopy, ..., each at d[m] in a ring row and, for the item
// set last, at g[m] + gy nx in device memory for grid row gy (null: none).
// An item's pieces and their wrapped columns are set once (set), so a row
// costs its copies alone.
template <int kK, int kCopy, int kSeg>
struct RowCopy {
  static constexpr int kM =
      (kPlanes * (kMaxW + 2 * col_margin(kK)) / kSeg + kCopy - 1) / kCopy;
  const float* g[kM];
  int d[kM];

  __device__ __forceinline__ void set(const Job& J, const float* obst, int w,
                                      const LbmArgs& a, int t) {
    constexpr int kx = col_margin(kK);
    const int per = (w + 2 * kx) / kSeg;   // pieces a plane
    const size_t gplane = (size_t)a.ny * a.nx;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int e = t + m * kCopy, q = e / per, c = (e - q * per) * kSeg;
      g[m] = nullptr;
      d[m] = q * pitch(kK) + c;
      if (q < kPlanes)
        g[m] = (q < 9 ? J.src + q * gplane : obst) + wrap(J.x0 - kx + c, a.nx);
    }
  }

  __device__ __forceinline__ void copy(float* dst, int gy, int nx) const {
    const size_t row = (size_t)gy * nx;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (!g[m]) continue;
      if constexpr (kSeg == 4)
        cp_async16(dst + d[m], g[m] + row);
      else
        dst[d[m]] = __ldcg(g[m] + row);
    }
  }
};

template <int kK, int kCopy, int kBar, int kSeg>
__device__ __forceinline__ void copy_items(float* smem, Stream& S,
                                           const float* obst, int w,
                                           const LbmArgs& a, int t) {
  constexpr int k = kK;
  constexpr int RF = row_floats(k);
  RowCopy<kK, kCopy, kSeg> rc;
  int p = 0;   // the next position
  // One position on its ring row once the row is free: fn(slot) copies
  // into it (or nothing, a gap).
  auto put = [&](auto fn) {
    const int slot = p & (kRing - 1);
    if (p >= kRing) mbar_wait(&S.empty[slot], ((p / kRing) - 1) & 1);
    fn(slot);
    mbar_arrive_copies(&S.full[slot]);
    mbar_arrive(&S.full[slot]);
    ++p;
  };
  for (int n = 0;; ++n) {
    const int js = n & (kJobs - 1);
    Job& J = S.job[js];
    mbar_wait(&S.posted[js], (n / kJobs) & 1);
    if (t == 0) {
      J.base = p;
      __threadfence_block();
      J.seq = n;
    }
    if (!J.live) break;
    rc.set(J, obst, w, a, t);
    const int rows = J.own_rows + 2 * k;
    int gy = wrap(J.y0 - k, a.ny);
    for (int r = 0; r < rows; ++r) {
      put([&](int slot) {
        if (t == 0) {
          const int up = gy + 1 == a.ny ? 0 : gy + 1;
          const int dn = gy == 0 ? a.ny - 1 : gy - 1;
          S.bits[p & (kBitsRing - 1)] = (dn == a.accel_row) |
                                        (gy == a.accel_row) << 1 |
                                        (up == a.accel_row) << 2;
        }
        rc.copy(smem + slot * RF, gy, a.nx);
      });
      gy = gy + 1 == a.ny ? 0 : gy + 1;
    }
    // the next item goes on at once where it is posted, else after a gap
    // in which this one drains: thread 0 looks, for the whole group
    const int nn = n + 1;
    if (t == 0)
      S.next[n & 1] =
          mbar_test(&S.posted[nn & (kJobs - 1)], (nn / kJobs) & 1);
    asm volatile("bar.sync %0, %1;" ::"n"(kBar), "n"(kCopy) : "memory");
    if (!S.next[n & 1])
      for (int g = 0; g < drain(k); ++g) put([](int) {});
  }
  // after the stop: gaps until the stepping warps are past their last
  // wave, fw + 1 (whose rows thread 0 awaits at the end of wave fw)
  for (;;) {
    const int fw = S.finished;
    if (fw >= 0 && p > kRows * (fw + 1) + kRows + 1) break;
    const int slot = p & (kRing - 1);
    if (p >= kRing && !mbar_test(&S.empty[slot], ((p / kRing) - 1) & 1))
      continue;
    mbar_arrive_copies(&S.full[slot]);
    mbar_arrive(&S.full[slot]);
    ++p;
  }
  cp_async_wait<0>();
}

template <int kK, int kCopy, int kBar>
__device__ __forceinline__ void copy_stream(float* smem, Stream& S,
                                            const float* obst, int w,
                                            int vec16, const LbmArgs& a,
                                            int t) {
  if (vec16)
    copy_items<kK, kCopy, kBar, 4>(smem, S, obst, w, a, t);
  else
    copy_items<kK, kCopy, kBar, 1>(smem, S, obst, w, a, t);
}

template <int kK, int kBar>
__device__ __forceinline__ unsigned long long step_stream(float* smem,
                                                          Stream& S, int w,
                                                          const LbmArgs& a) {
  constexpr int k = kK;
  constexpr int kx = col_margin(k);
  constexpr int cm = kx - k;
  constexpr int P = pitch(k);
  constexpr int RF = row_floats(k);
  const size_t plane = (size_t)a.ny * a.nx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // This thread's cells of the wave list (list index threadIdx.x + p
  // kThreads): level (0: none), first position, column, its level's ring
  // at the column; and the item n it is in: the positions [lo, hi) it
  // computes there and [ob, oe) it owns, at level k the output row of
  // position 0, and where its sum goes in wsum: the entry of the item's
  // rows r % kRows it takes (list index + wd), whatever position the
  // item starts at, so that an item's sums do not depend on the items
  // before it. While its item is not open (its base not set), lo is past
  // every position and hi before it, so that every wave looks again.
  int lev[kPer], c0[kPer], col[kPer], n[kPer];
  int lo[kPer], hi[kPer], ob[kPer], oe[kPer], wd[kPer];
  int so[kPer], ro[kPer];   // its ring at the column; ring row of q - 1
  float* orow[kPer];
  float acc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int f = threadIdx.x + p * kThreads;
    lev[p] = c0[p] = col[p] = 0;
    int off = 0;
    for (int s = 1; s <= k; ++s) {
      const int cells = level_cells(w, k, s), width = cells / kRows;
      if (f >= off && f < off + cells) {
        const int j = (f - off) / width;
        lev[p] = s;
        c0[p] = first(s) + j;
        col[p] = cm + s + (f - off - j * width);
      }
      off += cells;
    }
    so[p] = (lev[p] - 1) * kRing * RF + col[p];
    ro[p] = ((c0[p] - 1) & (kRing - 1)) * RF;
    n[p] = 0;
    lo[p] = ob[p] = oe[p] = INT_MAX;
    hi[p] = INT_MIN;
    wd[p] = 0;
    orow[p] = nullptr;
    acc[p] = 0.0f;
  }
  // Warp s - 1's sums of level s: the item m to sum next, once its base is
  // set (mpend false), and the position at which level s is past it.
  const int ls = warp + 1;
  int m = 0, mend = 0, off = 0;
  bool mpend = true;
  for (int s = 1; s < ls && s <= k; ++s) off += level_cells(w, k, s);
  int waited = 0;   // positions [0, waited) are in (thread 0's count)
  unsigned long long fill = 0;   // thread 0's blocked awaits, SM cycles
  // Thread 0 waits for the positions level 1 reads in the next wave, and a
  // barrier hands them to every stepping thread: level 1 reads positions
  // [kRows i, kRows i + kRows + 2) in wave i. A wait whose first test
  // fails is timed into `fill`: the rows' loads, or an item the copy group
  // has not been handed yet.
  auto await = [&](int i) {
    if (threadIdx.x == 0)
      for (; waited < kRows * i + kRows + 2; ++waited) {
        unsigned long long* b = &S.full[waited & (kRing - 1)];
        const int phase = (waited / kRing) & 1;
        if (mbar_test(b, phase)) continue;
        const long long c0 = clock64();
        mbar_wait(b, phase);
        fill += clock64() - c0;
      }
  };
  await(0);
  sync<kBar>();

#pragma unroll 1
  for (int i = 0;; ++i) {
    const int fw = S.finished;
    if (fw >= 0 && fw < i) break;   // set in an earlier wave: all see it
    // Sums: warp s - 1 sums level s's registers of item m once every
    // level-s cell has passed it (all of them were past it a wave ago).
    if (ls <= k) {
      const Job& J = S.job[m & (kJobs - 1)];
      if (mpend && J.seq == m) {
        __threadfence_block();
        if (J.live) {
          mend = J.base + J.own_rows + 2 * k - ls;
          mpend = false;
        } else if (ls == k && lane == 0 && fw < 0) {
          S.finished = i;   // the stop item: every item is summed
        }
      }
      if (!mpend && kRows * (i - 1) + first(ls) >= mend) {
        const float* ws = S.wsum[m % kSums] + off;
        const int cnt = level_cells(w, k, ls);
        float v = 0.0f;
        for (int x = lane; x < cnt; x += 32) v += ws[x];
        for (int d = 16; d > 0; d >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, d);
        if (lane == 0) {
          J.partials[(size_t)(ls - 1) * J.items] = v;
          if (ls == k) mbar_arrive(&S.done[m & (kJobs - 1)]);
        }
        __syncwarp();
        ++m;
        mpend = true;
      }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int s = lev[p];
      if (!s) continue;
      const int q = kRows * i + c0[p];
      // Past its item's rows, or its item not open: leaves the sum of the
      // item it passed, and opens the next item once its base is set.
      while (q >= hi[p]) {
        if (lo[p] != INT_MAX) {   // open, and past it
          S.wsum[n[p] % kSums][threadIdx.x + p * kThreads + wd[p]] = acc[p];
          acc[p] = 0.0f;
          ++n[p];
          lo[p] = ob[p] = oe[p] = INT_MAX;
          hi[p] = INT_MIN;
        }
        const Job& J = S.job[n[p] & (kJobs - 1)];
        if (J.seq != n[p]) break;
        __threadfence_block();
        if (!J.live) break;
        const int b = J.base, own = J.own_rows, oc = J.own_cols;
        const int j = c0[p] - first(s);   // its row of the level's kRows
        wd[p] = (((c0[p] - b) % kRows + kRows) % kRows - j) *
                (level_cells(w, k, s) / kRows);
        hi[p] = b + own + 2 * k - s;
        lo[p] = s < k || col[p] < kx + oc ? b + s : hi[p];
        if (col[p] >= kx && col[p] < kx + oc) {
          ob[p] = b + k;
          oe[p] = b + k + own;
        }
        orow[p] = J.out + J.x0 + (col[p] - kx) +
                  ((ptrdiff_t)J.y0 - k - b) * a.nx;
      }
      // ring rows of q - 1, q, q + 1 (ro[p] steps kRows rows a wave)
      const int r0 = ro[p];
      int r1 = r0 + RF, r2 = r0 + 2 * RF;
      r1 = r1 >= kRing * RF ? r1 - kRing * RF : r1;
      r2 = r2 >= kRing * RF ? r2 - kRing * RF : r2;
      ro[p] = r0 + kRows * RF >= kRing * RF ? r0 + (kRows - kRing) * RF
                                             : r0 + kRows * RF;
      if (q < lo[p] || q >= hi[p]) continue;
      const float* ring = smem + so[p];
      const float* mid = ring + r1;
      float res[9];
      const float speed = lbm_cell(
          RingSrc<P>{ring + r0, mid, ring + r2, S.bits[q & (kBitsRing - 1)]},
          RegDst{res}, a);
      if (s < k) {
        float* d = const_cast<float*>(mid) + kRing * RF;
#pragma unroll
        for (int c = 0; c < 9; ++c) d[c * P] = res[c];
        d[9 * P] = mid[9 * P];
      } else {
        float* o = orow[p] + (ptrdiff_t)q * a.nx;
#pragma unroll
        for (int c = 0; c < 9; ++c) o[c * plane] = res[c];
      }
      if (q >= ob[p] && q < oe[p]) acc[p] += speed;
    }
    await(i + 1);   // the rows the next wave needs were freed a wave ago
    sync<kBar>();   // this wave's reads are done, the next wave's rows in
    if (threadIdx.x == 0)
      for (int q = kRows * i; q < kRows * i + kRows; ++q)
        mbar_arrive(&S.empty[q & (kRing - 1)]);
  }
  return fill;
}

}  // namespace wave
}  // namespace tpulbm
