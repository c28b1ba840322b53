// K2 lbm_resident_chunk: up to 512 D2Q9-BGK steps of a small periodic grid
// in ONE persistent cooperative launch over about every SM, each CTA's
// block of the grid held in its shared memory for the whole chunk, and
// each CTA waiting only for its eight neighbours' edges between phases.
//
// Replaces: tpulbm/ops/pallas_resident.py::_kernel (make_resident_step),
// which keeps the whole grid in VMEM and ping-pongs it there for up to 512
// steps per call, and ::_kernel_hbm (make_resident_step_hbm), the same for
// 100K-135K cells with the state in HBM between calls. On the H100 the
// grid is spread over C = cy x cx co-resident CTAs (128 of the 132 SMs),
// and each CTA keeps its block in its own shared memory: the 128^2 to
// 256x512 grids are 0.6-5.2 MB of state, 5-41 KB a CTA against 227 KB of
// shared memory a block.
//
// Partition. CTA r = i cx + j owns rows [band_start(i, ny, cy), ...) and
// columns [band_start(j, nx, cx), ...): ny / cy rows (the first ny % cy
// block rows one more) by nx / cx columns (likewise). Its window holds the
// block and h halo rows and columns on each side (window cell (wr, wc) is
// global cell (y0 - h + wr, x0 - h + wc), mod ny and nx), cell by cell:
// kStride floats a cell, the nine populations, the mask and a pad (an odd
// stride, so a warp's 32 cells hit 32 banks), in two copies that the steps
// ping-pong. A window of R = rows + 2h rows by W = cols + 2h columns takes
// 2 R W 44 B plus R words of accelerated-row bits: at 256x512 over 8 x 16
// CTAs, h = 5, 2 x 42 x 42 x 44 + 168 = 155,400 B (ops/resident.py's
// window_smem; at most kMaxSmem). The window is loaded once per launch,
// and the block is stored to `out` once, from registers, after the last
// step.
//
// The step. Every load of a step is a shared-memory load at a constant
// offset from the cell (lbm_cell.cuh's lbm_cell, the cell code of every
// kernel of the port, so the state is bitwise K4's): a thread
// computes its cells (kCells, the instance's) from one copy into the
// other, and one block barrier publishes the new state. The warps' sums of
// step s are summed by the last warp after that barrier, off the next
// step's path (the warp sums are kept two steps).
//
// Temporal depth h. With h halo rows and columns a CTA runs h steps
// between exchanges on a window that shrinks by one cell a side a step
// (the margin scheme of tile_step.cuh): step j of a phase of p <= h steps
// computes the block and m = p - 1 - j cells around it, so that after p
// steps the block is exact. A chunk is ceil(k / h) phases, the last one
// k mod h steps where h does not divide k.
//
// Exchange, no grid barrier between steps. In the last step of each phase
// but the chunk's last, a CTA writes its first and last h rows and its
// first and last h columns (four strips) to its slots of parity e & 1 (e
// the phase) in `slots`, global memory, each value in one 8-byte word with
// the low 32 bits of its epoch (base + e + 1) above it: the epoch flag
// rides in every word, so one single-copy atomic store publishes value and
// flag together, with no fence and no separate flag (a flag released
// behind a fence, then polled, then the slots read, cost twice as much a
// handoff; PERF.md). Then the CTA fills the next copy's halo
// from its eight neighbours' strips (periodic over the CTA grid; a corner
// from the diagonal neighbour's row strip), taking each word once it
// carries the epoch (ld.relaxed.gpu: through L2, never a stale L1 line),
// before the step's barrier. Two parities suffice: a CTA writes parity
// e & 1 again in phase e + 2 only after it has taken its neighbours'
// phase-e + 1 words, which they wrote after taking its phase-e words (the
// dependency is mutual). Slots are never cleared: the wrapper zeroes them
// when it makes them and passes a base above every epoch of earlier
// launches, so a word left from any earlier phase or launch never carries
// the epoch awaited. Every spin is bounded by %globaltimer (kSpinNs,
// 10 s); past it the kernel traps, so a broken protocol faults the launch
// and never hangs the card. The spins need every CTA resident: the launch
// is cudaLaunchCooperativeKernel, which refuses a grid that is not, and
// the entry point returns its error, which the wrapper raises; nothing
// falls back to another kernel.
//
// Per-step sums: each CTA adds the |u| of its block's cells only (never a
// halo cell's recomputed value) in a fixed order and writes its partial of
// step s to row s of the (k, C) partials; after the last step one grid
// barrier (the chunk's only one) precedes the epilogue, where CTA r
// reduces rows r, r + C, ... in K3's fixed order
// (lbm_cell.cuh::reduce_row). No float atomics: reruns are bitwise.
//
// Measured on an H100 80GB HBM3 at a 700 W power limit (PERF.md;
// chip_smoke.py's kernel phase, tools/resident_sweep.py for every CTA grid
// and h): a 512-step chunk in 0.72 ms at 128^2 (1.40 us a step), 0.81 ms at
// 128x256 (1.58), 1.04 ms at 256^2 (2.04) and 1.66 ms at 256x512 (3.23),
// 0.48-0.58x the grid-barrier design it replaced and 0.62x K5, a since
// removed design in one thread block cluster, at 128^2.
// A step costs at least ~1.4 us (~2,770 cycles at 1980 MHz) even at a few
// hundred cells a CTA: one cell update's dependent chain a thread; without
// the barrier, the sums or the handoff a step is only 2-7 % shorter.
//
// Counting. Each instance has a twin, kCount = true, that the entry point
// launches where it is given counter words (ops/resident.py does while a
// torch.profiler session is open): the same steps, stores and sums, bit for
// bit, and each warp timing its own step in SM cycles (clock64's counter;
// every lane keeps the totals in registers, lane 0's count): its cells and
// warp sum from the step's start (the barrier's release before it; the last
// warp's sum of the step before's partial included), the halo fill of an
// edge step from its first load to its last word taken (and, of that, the
// slowest lane's polls of words not yet carrying the epoch), its wait at
// the step barrier, and the launch's ends (the window's load before the
// first step; the last partial, the grid barrier and the epilogue after the
// last). A CTA times its life in %globaltimer and clock64 from entry to
// exit, converts its warps' cycles to ns at that ratio once, at exit, and
// adds them to the words (namespace count). No step reads %globaltimer.
// Every counting line is behind `if constexpr`, so the plain instance's
// code is the kernel's without them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStride = 11;               // floats a cell in the window
constexpr int kMaxSmem = 231424;          // dynamic shared memory a CTA
constexpr int kMaxK = 512;                // steps of a launch
constexpr int kMaxDevices = 64;
constexpr long long kSpinNs = 10000000000LL;   // a wait's bound, 10 s

// The counting instance's words (ops/resident.py's COUNTERS, in this
// order): the CTAs' lives times their warps, the warps' time on cells, on
// halo fills, spinning in them, at the step barrier and at the launch's
// ends (ns); steps times warps, over the CTAs; steps and launches.
namespace count {
enum : int {
  kWarpNs, kCellNs, kFillNs, kSpinNs, kBarrierNs, kEndsNs, kWarpSteps,
  kSteps, kLaunches
};
}  // namespace count

// The kernel's instances, (cells a thread, threads a CTA), smallest first:
// a step's cells one a thread where they fit (fewer threads, cheaper
// barriers; 128 registers a thread at 512, 85 at 768, 64 at 1024), else
// two. ops/resident.py's RESIDENT_INSTANCES lists the same.
#define TPULBM_RESIDENT_INSTANCES(X) X(1, 512) X(1, 768) X(1, 1024) X(2, 1024)
static_assert(512 >= tpulbm::kReduceThreads,
              "a CTA's threads reduce a row of partials");

__host__ __device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// First row (column) of block row i of n rows cut into c: n / c each, the
// first n % c one more.
__host__ __device__ __forceinline__ int band_start(int i, int n, int c) {
  const int q = n / c, m = n % c;
  return i * q + (i < m ? i : m);
}

// Bytes of dynamic shared memory of a launch: the largest block's window
// (ceil(ny / cy) + 2h rows by ceil(nx / cx) + 2h cells) and a word a
// window row.
__host__ __device__ __forceinline__ long long window_smem(int ny, int nx,
                                                          int cy, int cx,
                                                          int h) {
  const long long rows = (ny + cy - 1) / cy + 2 * h;
  const long long cols = (nx + cx - 1) / cx + 2 * h;
  return 2 * rows * cols * kStride * 4 + rows * 4;
}

// Bits 0, 1, 2: global rows g - 1, g, g + 1 (mod ny) are the accelerated row.
__device__ __forceinline__ unsigned accel_bits(int g,
                                               const tpulbm::LbmArgs& a) {
  return (unsigned)(wrap(g - 1, a.ny) == a.accel_row) |
         (unsigned)(g == a.accel_row) << 1 |
         (unsigned)(wrap(g + 1, a.ny) == a.accel_row) << 2;
}

// The old state around one cell of the window (c points at it): kStride
// floats a cell, ws floats a window row; bit dy + 1 of acc set where row
// y + dy is the accelerated row.
struct WindowSrc {
  const float* c;
  int ws;
  unsigned acc;
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return c[dy * ws + dx * kStride + k];
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return c[dy * ws + dx * kStride + 9] == 0.0f;
  }
  __device__ __forceinline__ bool accel(int dy) const {
    return (acc >> (dy + 1)) & 1u;
  }
};

// Lane 0 gets the warp's sum (a fixed tree).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// A slot word: the value's bits below, its epoch's low 32 bits above, so
// that one 8-byte store (single-copy atomic) publishes both.
__device__ __forceinline__ void store_word(unsigned long long* p, float v,
                                           unsigned tag) {
  const unsigned long long w =
      (unsigned long long)tag << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The low 32 bits of the SM's cycle counter (clock64's). Read as %clock64
// instead, the counting cost less, but the warps' wait at the step barrier
// read 1-3 % at every shape, below the share of warps with no cell in the
// step, which wait for all of it: that read does not keep its place.
__device__ __forceinline__ unsigned clock32() {
  unsigned c;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(c) :: "memory");
  return c;
}

// A warp's step totals in the counting instance, in SM cycles (far below
// 2^32 in a launch, 2 s): add(to) gives `to` the cycles since the last
// add. Every lane keeps them; lane 0's count.
struct Tally {
  unsigned mark = 0, cell = 0, fill = 0, spin = 0, barrier = 0;
  __device__ __forceinline__ void add(unsigned& to) {
    const unsigned now = clock32();
    to += now - mark;
    mark = now;
  }
};

// The counting instance's words of a CTA in shared memory: its entry in
// %globaltimer and clock64, each warp's cycles before its first step (the
// window's load: held in a register through the steps, it came out past
// 2^32 in the 64-register instances), and the sums of its warps' totals at
// exit (count::kCellNs order). A template, so that only the counting
// instances hold them.
template <int kNW>
struct CtaWords {
  long long t_entry, c_entry;
  unsigned long long total[5];
  unsigned load[kNW];
};

template <int kNW>
__device__ __forceinline__ CtaWords<kNW>& cta_words() {
  __shared__ CtaWords<kNW> w;
  return w;
}

// A CTA's slots: 4 strips (its first h rows, last h rows, first h columns,
// last h columns) x 2 parities, each nine planes of `plane` words; strip
// element (a, b): row strips a * cols + b (a < h, b < cols), column strips
// a * h + b (a < rows, b < h).
struct Slots {
  unsigned long long* base;
  size_t plane;   // h x the largest block side
  __device__ __forceinline__ unsigned long long* at(int r, int strip,
                                                    int parity) const {
    return base + ((size_t)(r * 4 + strip) * 2 + parity) * 9 * plane;
  }
};

template <int kCells, int kNT, bool kCount>
__global__ void __launch_bounds__(kNT, 1)
    resident_kernel(const float* __restrict__ f_in,
                    const float* __restrict__ obst, float* __restrict__ out,
                    unsigned long long* __restrict__ slot_words,
                    float* __restrict__ partials, float* __restrict__ sums,
                    int k_steps, int cy, int cx, int h,
                    unsigned long long base, tpulbm::LbmArgs a,
                    unsigned long long* __restrict__ counts) {
  constexpr int kNW = kNT / 32;
  extern __shared__ __align__(16) float win[];
  __shared__ float warp_sums[2][kNW];
  const int ctas = gridDim.x, r = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int ny = a.ny, nx = a.nx;
  const int bi = r / cx, bj = r - bi * cx;
  const int y0 = band_start(bi, ny, cy), x0 = band_start(bj, nx, cx);
  const int rows = band_start(bi + 1, ny, cy) - y0;
  const int cols = band_start(bj + 1, nx, cx) - x0;
  const int nrow = rows + 2 * h, ncol = cols + 2 * h;   // the window
  const int ws = ncol * kStride;
  const size_t gplane = (size_t)ny * nx;
  const int rmax = (ny + cy - 1) / cy, cmax = (nx + cx - 1) / cx;
  const size_t wsize = (size_t)(rmax + 2 * h) * (cmax + 2 * h) * kStride;
  float* cur = win;           // the state a step reads
  float* nxt = win + wsize;   // where it writes
  unsigned* const accb = reinterpret_cast<unsigned*>(win + 2 * wsize);
  const Slots slots{slot_words, (size_t)h * (rmax > cmax ? rmax : cmax)};
  [[maybe_unused]] Tally tally;   // the counting instance's
  if constexpr (kCount) {
    tally.mark = clock32();
    if (t == 0) {
      CtaWords<kNW>& w = cta_words<kNW>();
      w.t_entry = globaltimer();
      w.c_entry = clock64();
      for (int i = 0; i < 5; ++i) w.total[i] = 0;
    }
  }

  // The window, once: nine planes and the mask, halos included (the mask
  // in both buffers).
  for (int i = t; i < nrow * ncol; i += kNT) {
    const int wr = i / ncol, wc = i - wr * ncol;
    const size_t g = (size_t)wrap(y0 - h + wr, ny) * nx +
                     wrap(x0 - h + wc, nx);
    float* d = win + (size_t)i * kStride;
#pragma unroll
    for (int q = 0; q < 9; ++q) d[q] = __ldg(f_in + q * gplane + g);
    d[9] = d[wsize + 9] = __ldg(obst + g);
  }
  for (int wr = t; wr < nrow; wr += kNT)
    accb[wr] = accel_bits(wrap(y0 - h + wr, ny), a);

  // This thread's cells t + q kNT of a phase's first step region (the
  // block and h - 1 cells a side, rows of w1 cells), fixed for the launch:
  // the row and column in the window of the region's first cell.
  const int w1 = cols + 2 * (h - 1);
  int li[kCells], cj[kCells];
#pragma unroll
  for (int q = 0; q < kCells; ++q) {
    const int c = t + q * kNT;
    li[q] = c / w1;
    cj[q] = c - li[q] * w1;
  }
  __syncthreads();
  if constexpr (kCount) {
    const unsigned now = clock32();
    if (lane == 0) cta_words<kNW>().load[warp] = now - tally.mark;
    tally.mark = now;
  }

  int s = 0;
  for (unsigned long long e = 0;; ++e) {
    const int p = min(h, k_steps - s);   // steps of phase e
    for (int j = 0; j < p; ++j, ++s) {
      const int m = p - 1 - j;   // cells computed beyond the block a side
      const int d = h - 1 - m;   // this step's region inside the first's
      const bool last = s == k_steps - 1;
      const bool edge = j == p - 1 && !last;   // fill the slots
      const unsigned tag = (unsigned)(base + e + 1);
      const int par = (int)(e & 1);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        const int wr = li[q] + 1, wc = cj[q] + 1;   // window coordinates
        if (!(li[q] >= d && li[q] < rows + 2 * (h - 1) - d && cj[q] >= d &&
              cj[q] < w1 - d))
          continue;
        const size_t at = (size_t)wr * ws + wc * kStride;
        float res[9];
        const float u = tpulbm::lbm_cell(WindowSrc{cur + at, ws, accb[wr]},
                                         tpulbm::RegDst{res}, a);
        const int by = wr - h, bx = wc - h;   // block coordinates
        if (by >= 0 && by < rows && bx >= 0 && bx < cols) acc += u;
        if (last) {   // m = 0: the block, into out
          float* o = out + (size_t)(y0 + by) * nx + x0 + bx;
#pragma unroll
          for (int v = 0; v < 9; ++v) o[v * gplane] = res[v];
          continue;
        }
#pragma unroll
        for (int v = 0; v < 9; ++v) nxt[at + v] = res[v];
        if (edge) {   // m = 0: a block cell
          unsigned long long* o[4] = {
              by < h ? slots.at(r, 0, par) + by * cols + bx : nullptr,
              by >= rows - h
                  ? slots.at(r, 1, par) + (by - rows + h) * cols + bx
                  : nullptr,
              bx < h ? slots.at(r, 2, par) + by * h + bx : nullptr,
              bx >= cols - h
                  ? slots.at(r, 3, par) + by * h + bx - cols + h
                  : nullptr};
#pragma unroll
          for (int st = 0; st < 4; ++st)
            if (o[st])
#pragma unroll
              for (int v = 0; v < 9; ++v)
                store_word(o[st] + v * slots.plane, res[v], tag);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) warp_sums[s & 1][warp] = acc;
      if constexpr (kCount) tally.add(tally.cell);
      if (edge) {
        // Exchange e: the halo of the next state from the neighbours'
        // strips, each word taken once it carries this epoch. Halo cell
        // (by, bx) (block coordinates, outside [0, rows) x [0, cols)) lies
        // in neighbour (dy, dx); a row strip of it where dy != 0 (corners
        // too), else a column strip.
        [[maybe_unused]] unsigned spun = 0;   // this lane's failed polls
        for (int i = t; i < nrow * ncol; i += kNT) {
          const int wr = i / ncol, wc = i - wr * ncol;
          const int by = wr - h, bx = wc - h;
          const int dy = by < 0 ? -1 : by >= rows ? 1 : 0;
          const int dx = bx < 0 ? -1 : bx >= cols ? 1 : 0;
          if (dy == 0 && dx == 0) continue;
          const int ni = wrap(bi + dy, cy), nj = wrap(bj + dx, cx);
          const int n = ni * cx + nj;
          const int nrows = band_start(ni + 1, ny, cy) - band_start(ni, ny, cy);
          const int ncols = band_start(nj + 1, nx, cx) - band_start(nj, nx, cx);
          const int ly = dy < 0 ? by + nrows : dy > 0 ? by - rows : by;
          const int lx = dx < 0 ? bx + ncols : dx > 0 ? bx - cols : bx;
          const unsigned long long* src =
              dy < 0 ? slots.at(n, 1, par) + (ly - nrows + h) * ncols + lx
              : dy > 0 ? slots.at(n, 0, par) + ly * ncols + lx
              : dx < 0 ? slots.at(n, 3, par) + ly * h + lx - ncols + h
                       : slots.at(n, 2, par) + ly * h + lx;
          unsigned long long word[9];
          long long t0 = 0;
          [[maybe_unused]] unsigned c0 = 0;
          for (;;) {
            bool ready = true;
#pragma unroll
            for (int v = 0; v < 9; ++v) {
              word[v] = load_word(src + v * slots.plane);
              ready &= (unsigned)(word[v] >> 32) == tag;
            }
            if (ready) break;
            if (t0 == 0) {
              if constexpr (kCount) c0 = clock32();
              t0 = globaltimer();
            } else if (globaltimer() - t0 > kSpinNs) {
              __trap();
            }
          }
          if constexpr (kCount)
            if (t0 != 0) spun += clock32() - c0;
          float* dst = nxt + (size_t)i * kStride;
#pragma unroll
          for (int v = 0; v < 9; ++v)
            dst[v] = __uint_as_float((unsigned)word[v]);
        }
        if constexpr (kCount) {
          __syncwarp();
          tally.add(tally.fill);
          tally.spin += __reduce_max_sync(0xffffffffu, spun);
        }
      }
      __syncthreads();   // state s + 1 is in nxt, the halo too
      if constexpr (kCount) tally.add(tally.barrier);
      // The partial of step s, off the next step's path: the last warp
      // sums the warp sums (kept two steps, so the next step's never
      // overwrite them first).
      if (warp == kNW - 1) {
        const float v = warp_sum(lane < kNW ? warp_sums[s & 1][lane] : 0.0f);
        if (lane == 0) partials[(size_t)s * ctas + r] = v;
      }
      float* const tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (s == k_steps) break;
  }
  cg::this_grid().sync();   // every partial is written
  for (int q = r; q < k_steps; q += ctas)
    tpulbm::reduce_row(partials, sums, q, ctas, warp_sums[0]);
  if constexpr (kCount) {
    CtaWords<kNW>& w = cta_words<kNW>();
    if (lane == 0) {
      const unsigned mine[5] = {tally.cell, tally.fill, tally.spin,
                                tally.barrier,
                                clock32() - tally.mark + w.load[warp]};
      for (int i = 0; i < 5; ++i) atomicAdd(&w.total[i], mine[i]);
    }
    __syncthreads();
    if (t == 0) {
      const long long life = globaltimer() - w.t_entry;
      const long long cycles = clock64() - w.c_entry;
      const double ns = cycles > 0 ? (double)life / (double)cycles : 0.0;
      atomicAdd(counts + count::kWarpNs, (unsigned long long)life * kNW);
      for (int i = 0; i < 5; ++i)
        atomicAdd(counts + count::kCellNs + i,
                  (unsigned long long)((double)w.total[i] * ns));
      atomicAdd(counts + count::kWarpSteps, (unsigned long long)k_steps * kNW);
      if (r == 0) {
        atomicAdd(counts + count::kSteps, (unsigned long long)k_steps);
        atomicAdd(counts + count::kLaunches, 1ull);
      }
    }
  }
}

// The instance's shared-memory limit, set once per device.
template <int kCells, int kNT, bool kCount>
cudaError_t prepare() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(resident_kernel<kCells, kNT, kCount>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int kCells, int kNT>
cudaError_t max_ctas(int smem, int* n) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = prepare<kCells, kNT, false>();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resident_kernel<kCells, kNT, false>, kNT, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) *n = per_sm * sms;
  return e;
}

template <int kCells, int kNT, bool kCount>
int launch(const float* f_in, const float* obst, float* out,
           unsigned long long* slots, float* partials, float* sums, int cy,
           int cx, int h, unsigned long long base, int k_steps,
           tpulbm::LbmArgs a, unsigned long long* counts,
           cudaStream_t stream) {
  cudaError_t e = prepare<kCells, kNT, kCount>();
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&f_in,    (void*)&obst,  (void*)&out,
                  (void*)&slots,   (void*)&partials, (void*)&sums,
                  (void*)&k_steps, (void*)&cy,    (void*)&cx,
                  (void*)&h,       (void*)&base,  (void*)&a,
                  (void*)&counts};
  e = cudaLaunchCooperativeKernel(
      (const void*)resident_kernel<kCells, kNT, kCount>, dim3(cy * cx),
      dim3(kNT), args, (size_t)window_smem(a.ny, a.nx, cy, cx, h), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch's plan holds the grid: ops/resident.py's resident_instance
// chose it; this refuses what would overrun the window or the instance's
// threads.
bool holds(int ny, int nx, int cy, int cx, int h, int cells, int threads) {
  if (cy < 1 || cx < 1 || h < 1 || ny / cy < h || nx / cx < h) return false;
  const long long rows = (ny + cy - 1) / cy, cols = (nx + cx - 1) / cx;
  return window_smem(ny, nx, cy, cx, h) <= kMaxSmem &&
         (rows + 2 * (h - 1)) * (cols + 2 * (h - 1)) <=
             (long long)cells * threads;
}

}  // namespace

extern "C" {

// The most CTAs of the instance of `cells` cells a thread and `threads`
// threads (one of TPULBM_RESIDENT_INSTANCES), with smem bytes of dynamic
// shared memory each, that the current device holds at once (a
// cooperative launch's limit); a negative CUDA error code where the device
// holds none or has no cooperative launch.
int lbm_resident_max_ctas(int cells, int threads, int smem) {
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define TPULBM_MAX_CTAS(C, T) \
  if (cells == C && threads == T) e = max_ctas<C, T>(smem, &n);
  TPULBM_RESIDENT_INSTANCES(TPULBM_MAX_CTAS)
#undef TPULBM_MAX_CTAS
  return e == cudaSuccess ? n : -(int)e;
}

// k_steps (1-512) steps of the (9, ny, nx) grid f_in -> out (distinct) over
// cy x cx CTAs of the instance (cells, threads) with h halo cells a side;
// obst the (ny, nx) float32 mask, nonzero = blocked; slots: cy cx x 4 x 2
// x 9 x h max(ceil(ny / cy), ceil(nx / cx)) words, zeroed before the
// first launch and never holding an epoch above base; partials (k_steps,
// cy cx) floats; sums the k_steps per-step sums. Returns the launch's
// error code (cudaErrorInvalidValue where the plan does not hold the grid
// or names no instance, cudaErrorCooperativeLaunchTooLarge where the CTAs
// cannot all be resident). counts: null launches the plain instance;
// else the counting instance, which adds to these count::kLaunches + 1
// words (zeroed by the caller before its first launch).
int lbm_resident_chunk(const float* f_in, const float* obst, float* out,
                       unsigned long long* slots, float* partials,
                       float* sums, int cy, int cx, int h, int cells,
                       int threads, unsigned long long base, int ny, int nx,
                       int k_steps, int accel_row, float omega, float w1,
                       float w2, unsigned long long* counts,
                       cudaStream_t stream) {
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  if (k_steps < 1 || k_steps > kMaxK ||
      !holds(ny, nx, cy, cx, h, cells, threads))
    return (int)cudaErrorInvalidValue;
#define TPULBM_LAUNCH(C, T)                                                \
  if (cells == C && threads == T)                                          \
    return counts ? launch<C, T, true>(f_in, obst, out, slots, partials,   \
                                       sums, cy, cx, h, base, k_steps, a,  \
                                       counts, stream)                     \
                  : launch<C, T, false>(f_in, obst, out, slots, partials,  \
                                        sums, cy, cx, h, base, k_steps, a, \
                                        counts, stream);
  TPULBM_RESIDENT_INSTANCES(TPULBM_LAUNCH)
#undef TPULBM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
