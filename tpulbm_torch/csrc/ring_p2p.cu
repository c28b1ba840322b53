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
//   Work items (c, r), r a tile of one of this launch's shards (their tiles
//     in shard order), walked chunk-major: walk index c * items + i. A
//     persistent grid (one CTA a SM, co-resident by construction:
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor) walks them, CTA b
//     taking walk indices b, b + grid, ... in order.
//   Walk: chunk c's walk starts one tile row further down: index i of
//     chunk c is record (i + c rot) % items, rot the tiles of a tile row.
//     Started at record 0, a shard's first tile row came first in every
//     chunk, and it waits on the previous shard's last tile row of the
//     chunk before, which that shard's card walked last: 1-63 indices
//     earlier at 1024^2 over four cards, in the same round of CTAs, so the
//     CTA waited about a whole tile and the tiles after it in turn. Rotated,
//     where a card's shards are consecutive in the ring (one a card, or all
//     on one), every dependency of an item lies at least items - 2 rot - 1
//     indices before it (191 at 1024^2 over four cards, more than the 132
//     CTAs of an H100). Any walk that keeps each chunk's items inside the
//     chunk's index range keeps the protocol: every dependency of a chunk-c
//     item is a chunk c - 1 item, of a smaller index on every card. Torus
//     mode walks each chunk from its first record (rot 0).
//   The tile graph, built once on the host (ops/ring_p2p.py::tile_graph)
//     and kept on the card for the ring's life (only the epoch changes
//     between launches): record r (kRec ints) holds tile r's shard, tile,
//     window origin, owned extent, duties and its dependencies: every tile
//     with owned cells within k cells of its own (rows across the shard
//     edges, columns periodic), itself included, as flag indices into this
//     card's flat flag array (one int a tile, the record's own at index r)
//     or, after them, into another card's (peer << kPeerShift | index). The
//     relation is symmetric, so it also orders every write after a read:
//     chunk c + 1 writes the buffer chunk c read, and a landing slot is
//     rewritten two epochs later, only after the tiles that read it have
//     finished. No grid-wide barrier: chunk c + 1 starts wherever its
//     neighbourhood is done. Before a tile of chunk c (epoch e = base + c)
//     loads its window, every dependency's flag reads at least e.
//   Flags hold the last epoch the tile finished + 1, never reset: the epoch
//     rises across launches and runner calls (the counterpart of the TPU
//     kernel's base-parity scalar), so no memset races a kernel on another
//     card that reads the flag.
//   Warp specialisation. 896 threads: warps 0-23 step tiles (tile_step.cuh,
//     its barriers named, kStepBar), warp 24 is the producer, warps 24-27
//     the copy group. For the CTA's next item the producer polls the
//     dependencies (one lane a flag, ld.acquire at gpu scope, sys where the
//     flag lies on another card), then writes the stage's job and window
//     source, arrives on the stage's `posted` mbarrier, and the copy group
//     copies the window into the free stage by cp.async.cg (16 B, L2 only:
//     never a stale L1 line of a buffer another SM wrote; without 16-byte
//     alignment, __ldcg loads), each thread arriving on the stage's `full`
//     mbarrier once for its stores and once, through
//     cp.async.mbarrier.arrive, when its copies land. The stepping warps
//     wait only on `full`: no protocol code, barrier or poll in the step.
//     After a tile's stores they meet at a named barrier and one thread
//     arrives on the stage's `done`; the producer waits for it and
//     releases the tile's flag (st.release, sys scope where a tile on
//     another card waits on it). While the tile steps, the producer polls
//     the next item's flags; where they are done the next window flies
//     under the step; otherwise it releases the tile's flag first and then
//     waits, so no CTA waits on an item while it holds one that a wait
//     could need.
//   Slabs, pushed: a tile that owns one of its shard's last k rows writes
//     it into the next shard's lo landing slot, one of its first k rows into
//     the previous shard's hi slot, the slot of the next epoch's parity; the
//     window load reads lo | shard | hi as K4's ring mode does. A slot is
//     (9, k, nx) in a (9, 8, nx) buffer. The first chunk of a runner call
//     (pull0) reads the neighbours' input states instead: they hold the
//     call's start state, and no slot does yet (in one process; across
//     processes a neighbour's state lies in another process, so the runner
//     pushes each input's edge rows into the slots and orders every
//     process after the pushes first, then launches with pull0 = 0:
//     ops/ring_p2p.py::Exchange.enter). Where a tile pushes onto
//     another card, each stepping thread fences at sys scope once after its
//     stores (not once a stored cell), before the barrier that precedes
//     the release, so the release does not rest on the cumulativity of one
//     thread's fence over the other warps' NVLink stores.
//   Registers: one CTA a SM of 896 threads leaves 72 a thread (896 x 72 =
//     64,512), which the step takes without spilling now that no protocol
//     state lives across it: the stepped tile's outputs live in shared
//     memory (`job`), written by the producer.
//   Sums: each tile's k partials go to column `tile` of rows [ck, ck + k)
//     of its shard's (n_outer k, ntiles) partials; the CTA that draws the
//     launch's last ticket (lbm_cell.cuh::last_ticket, one counter a card)
//     reduces each (chunk, shard)'s k rows in reduce_rows's order: K4's
//     bits, chunk by chunk, with no atomic in a tile's path.
//   Every wait on a flag is bounded by %globaltimer (kSpinNs, 10 s); when
//     the bound runs out the producer writes the card's error word and
//     stops its CTA, and every producer of the card gives up once it sees
//     the word. The runner reads the word with the av series and raises: a
//     broken protocol fails, it never hangs.
//   Wait counters: a wait whose first poll fails is timed until every flag
//     is done (a wait that never blocks costs a compare), and counts as
//     remote where a flag of another card was among those not done at that
//     first poll; each CTA also times its own life, entry to exit, by
//     %globaltimer. The waits are timed in SM cycles (clock64): a wait's end
//     is on the path of the next tile's issue, and a %globaltimer read
//     there, used at once, cost the ring 3.5 % at 1024^2 over four H100s
//     (PERF.md); the CTA's life in both clocks converts them to ns at its
//     exit. The producer also counts the items it took after its first
//     (kNextN) and, of those, the ones it issued while the item before was
//     still stepping (kAheadN: the window flew under the step; the others
//     are counted in the wait cycles' high bits). Then the CTA adds them
//     into the card's counter words (kCtaNs ... kAheadN, u64, after the
//     error word in the card's exchange block), and CTA 0 counts the
//     launch. The runner reads them with the error word
//     (ops/ring_p2p.py::WAITS). Nothing else in the step, the copies or the
//     flags changes: the same bits.
//   One instance per k (1 to 8), as K4.
//   Across processes each process launches on its own shards; a card's
//     landing slots, flag array, error word and counter words lie in one
//     cudaMalloc block (lbm_ring_p2p_alloc) that the processes of its
//     shards' neighbours map by CUDA IPC (lbm_ring_p2p_open). A shard of
//     another process counts as another card, even on the same physical
//     card: its flags are read and released, and the pushes to it fenced,
//     at system scope.
//
// Bound. One launch moves the shards' states and masks in once and the
// states out once (76 B a cell, the slabs are a few rows) and does 94 fp32
// operations a cell update, n_outer k updates a cell: operations bound it
// from a few chunks on (0.0118 ms a chunk at 1024^2, 0.75 ms for 64
// chunks). The design adds what K4 adds (the 1.51x recompute, the shared-
// memory traffic of the step loop) and reads and writes each chunk's state
// through L2 and device memory; the waits are the producer's.
//
// Torus mode (lbm_torus_p2p, torus_p2p_kernel) runs the same protocol over
// the (h, w) blocks of the 2-D torus (--mesh-shape) that lie on one card:
// the Hopper counterpart of the JAX package's torus runner
// (tpulbm/dist/runner.py::_make_runner_2d_kstep), one program whose scan
// holds both ppermute phases and pallas_kstep.py::_kernel with
// x_halo=True for every chunk. It computes what K4's torus mode
// (kstep_tile.cu::lbm_kstep_tile_torus) computes chunk by chunk with the
// host's two-phase exchange between chunks: the same tiles, tile step,
// window and sums, the same bits.
//   Window: the band of K4's torus mode, ylo over xlo | block | xhi over
//     yhi (the x slabs col_margin(k) wide, their k valid columns next to
//     the block). Each of its nine pieces (row part x column part) is read
//     from one buffer: the landing slots (ylo, yhi, xlo, xhi of the
//     epoch's parity) and the block's state; on the first chunk of a
//     runner call (pull0) the eight neighbours' input states instead.
//   Pushes: a tile's owned cells in the block's last k columns go into the
//     right neighbour's xlo slot, its first k into the left one's xhi; its
//     last k rows into the lower neighbour's ylo (the slot's middle w
//     columns), its first k into the upper one's yhi; and a corner's k x k
//     cells into the diagonal neighbour's y slot, at the slot's margin
//     columns: the host's exchange carried them through the x-extended
//     band, here they are sent straight. A neighbour may be the block
//     itself or one block may be several neighbours (one row or column of
//     blocks, two blocks a side): each push writes its own cells.
//   Dependencies: every tile with owned cells within k of a tile's own on
//     the global grid, wrapping in both axes: tiles of the x, y and diagonal
//     neighbour blocks among them (ops/ring_p2p.py::torus_graph). The slots
//     rewritten two epochs later are read only by tiles of that relation,
//     the diagonal readers of a corner included.
//   The blocks' entries (kTorusWords pointers and integers a block) lie in a
//     table in device memory, read by the producer as it posts an item, so
//     a card holds up to kMaxTorusLocal blocks, whose records name up to
//     kMaxTorusPeers flag arrays.
//   Across processes as ring mode: a block of another process counts as
//     another card, its slots and flags reached through an IPC mapping at
//     system scope; before a runner call's first launch the runner pushes
//     each block's input edges and corners into its neighbours' slots
//     (ops/ring_p2p.py::TorusExchange.enter), which then runs with
//     pull0 = 0.
//
// Grid kind (lbm_grid_p2p, grid_p2p_kernel) runs the same protocol over the
// whole periodic (ny, nx) grid of one card: the one-card wide route
// (dist/runner.py::kernel_plan), in place of one launch of K4's whole-grid
// mode (kstep_tile.cu::lbm_kstep_tile) a chunk, whose state it computes to
// the bit, with its own items and step (wave_step.cuh).
//   Items: h x w owned cells (w <= 64 columns), from the grid's shape alone
//     (ops/ring_p2p.py::grid_item), row-major, one flag each; the cone
//     relation (ops/ring_p2p.py::grid_graph, both axes wrapping) orders
//     each write after every read of the buffer it overwrites, as above.
//     No landing slots, pushes, pull0, peers or system-scope fences: chunk
//     c reads state[c & 1] and writes state[(c + 1) & 1].
//   Walk: chunk c's walk starts at item row c (rot items on), so that an
//     item's dependencies in chunk c - 1 lie more than two item rows'
//     items before it in the walk; started at row 0, the first items of a
//     chunk waited on the last ones of the chunk before (the rows wrap),
//     a round of CTAs after them.
//   Step: the stepping warps step the CTA's items as one row wavefront
//     over the k levels that streams from one item into the next
//     (wave_step.cuh::step_stream), one named barrier a wave; the copy
//     warps stream the items' window rows ahead of it (copy_stream); the
//     producer posts up to kJobs items, each once its flags are done, and
//     releases each item's flag once it is stored (produce_stream).
//   Bound and design. A chunk moves the state in and out once and does 94
//     fp32 operations an owned update (0.0118 ms at 1024^2, operations).
//     The square window of the other kinds computes 1.51 updates an owned
//     one at k = 8 and takes two barriers a step; a larger square does not
//     fit beside a second stage. The wavefront's shared memory grows with
//     the width alone, so the item can be tall: 1.242 updates an owned one
//     at 1024^2's 61 x 64 items, 1.113 at 8192^2's 2048 x 64.
//   Sums: each item's k partials in wave_step.cuh's fixed order, reduced by
//     reduce_rows: the grid kind's own bits, not K4's order of 32 x 32
//     tiles (ops/ring_p2p.py::grid_sums_ref is the plain version of the
//     reduction).
//   Flags: one int an item of this card, never reset, the epoch carried
//     across launches and runner calls (ops/ring_p2p.py::GridExchange).
//   Counters: as above, the producer's wait counts only while the CTA has
//     no item in flight; and thread 0 of the stepping warps times each of
//     its awaits of a level-0 ring row whose first test fails (kFillNs):
//     the wavefront blocked on the copy group's loads, or on an item not
//     yet posted.
//   Not torus mode over a 1 x 1 block: that would push four edge slabs
//     and the corners every chunk into slots only the block itself reads.

#include <cuda_runtime.h>

#include <cstring>
#include <initializer_list>
#include <type_traits>

#include "async_copy.cuh"
#include "lbm_cell.cuh"
#include "tile_step.cuh"
#include "wave_step.cuh"

namespace {

using namespace tpulbm::tile;
using tpulbm::mbar_arrive;
using tpulbm::mbar_arrive_copies;
using tpulbm::mbar_init;
using tpulbm::mbar_test;
using tpulbm::mbar_wait;

constexpr int kMaxLocal = 16;       // shards of one launch
constexpr int kMaxOuter = 64;       // chunks of one launch
// Flag arrays a card's records name, its own first: ring mode's, and torus
// mode's (every layout of up to 16 (process, card) keys; PERF.md). The
// array lies in the launch's parameters; the ring keeps 4, so its launch
// keeps the parameter layout it was tuned with.
constexpr int kMaxPeers = 4;
constexpr int kMaxTorusPeers = 16;
// A tile's record in the graph: shard, tile, y0, x0, owned rows, owned
// columns, duties, local | remote << 8 dependency counts, then the
// dependencies, local ones first.
constexpr int kRec = 40;
constexpr int kRecDeps = 8;
constexpr int kMaxDeps = kRec - kRecDeps;
constexpr int kPeerShift = 24;      // dependency: peer << 24 | flag index
constexpr int kPushRemote = 1;      // duty: pushes an edge row to a card
constexpr int kReadRemote = 2;      // duty: a tile on another card waits
// The copy group: the producer warp and kCopyWarps - 1 warps that only copy
// windows (one warp's copy took ~5.6 us, on the path of a chain of one-round
// chunks; PERF.md). 896 threads leave 72 registers a thread, which the
// step needs.
constexpr int kCopyWarps = 4;
constexpr int kBlock = kThreads + 32 * kCopyWarps;
constexpr int kStepBar = 1;         // named barrier of the stepping warps
constexpr int kCopyBar = 2;         // ... of the grid kind's copy warps
constexpr long long kSpinNs = 10000000000LL;
constexpr int kErrTimeout = 1;      // the error word: a wait ran out
// The counter words (unsigned long long): the CTAs' lives, their producers'
// blocked waits, the part of those that waited on another card, launches,
// the grid kind's stepping warps' blocked waits for level-0 ring rows
// (0 in ring and torus mode), and the items a ring or torus producer took
// after its first and those of them it issued ahead (0 in the grid kind).
constexpr int kCtaNs = 0, kWaitNs = 1, kRemoteNs = 2, kLaunches = 3;
constexpr int kFillNs = 4;
constexpr int kNextN = 5;
constexpr int kAheadN = 6;
// Bits of a producer's blocked-wait cycles below its count of items issued
// after the step before (produce): 2^40 cycles are ~10 minutes.
constexpr int kLateShift = 40;
constexpr int kMaxDevices = 64;
// Words of a shard's entry in the host table (lbm_ring_p2p): 15 pointers,
// then h, h_prev, h_next, row_base.
constexpr int kWords = 19;
static_assert(kMaxDeps == 32, "one producer lane a dependency");
// Torus mode: blocks of one launch, and the words of a block's entry in its
// table (lbm_torus_p2p): the pointers at the indices below, then row_base.
constexpr int kMaxTorusLocal = 64;
constexpr int kTorusWords = 26;
constexpr int kTObst = 0, kTState = 1, kTPartials = 3, kTSums = 4;
constexpr int kTIn = 5;      // the 8 neighbours' input states, kNbr order
constexpr int kTSlot = 13;   // own landing buffers: xlo, xhi, ylo, yhi
constexpr int kTPush = 17;   // the 8 pushes' landing buffers, kPush order
constexpr int kTRowBase = 25;
// Neighbours: left, right, up, down, up-left, up-right, down-left,
// down-right.
enum Nbr { kW, kE, kN, kS, kNW, kNE, kSW, kSE };
// Pushes, in table order: the right neighbour's xlo (the block's last k
// columns), the left one's xhi (first k), the lower one's ylo (last k
// rows), the upper one's yhi (first k rows), then the corners: the
// lower-right's ylo (last rows, last columns), the lower-left's ylo, the
// upper-right's yhi and the upper-left's yhi.
enum Push { kToE, kToW, kToS, kToN, kToSE, kToSW, kToNE, kToNW };

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
  float* partials;         // (n_outer k, ntiles)
  float* sums;             // (n_outer k,)
  int h, h_prev, h_next, row_base, ntiles;
};

// The protocol's part of a launch, in both modes (kPeers flag arrays).
template <int kPeers>
struct Protocol {
  const int* graph;                  // (items, kRec), walk order
  const int* peer_flags[kPeers];     // [0]: this card's flat flag array
  int* flags;                        // peer_flags[0], written
  int n_local, items, n_outer, base, pull0;
  int* error;              // this card's error word
  unsigned int* counter;   // this card's ticket counter, zeroed, left so
  unsigned long long* waits;   // this card's counter words (kCtaNs ...)
};

// The shard table first: with the protocol's fields first the ring's
// launch ran ~0.6 % slower at 8192^2 over 4 shards (PERF.md).
struct Launch {
  Shard shard[kMaxLocal];
  Protocol<kMaxPeers> p;
  int rot;                 // tiles a tile row: chunk c's walk starts at c rot
};

// Torus mode: the (h, w) blocks of the launch in `table` (kTorusWords int64
// a block, on the card). A block's landing buffers hold two slots each, the
// second xstride (x) or ystride (y) floats after the first: an x slot is
// (9, h, kx), a y slot (9, k, w + 2kx), kx = col_margin(k).
struct TorusLaunch {
  Protocol<kMaxTorusPeers> p;
  const long long* table;
  int h, w;
  long long xstride, ystride;
};

// Grid kind: the whole (ny, nx) grid, its items of w columns row-major.
// state[0] holds the state at the launch's first epoch, as a ring shard's.
struct GridLaunch {
  Protocol<1> p;
  const float* obst;       // (ny, nx) mask
  float* state[2];
  float* partials;         // (n_outer k, items)
  float* sums;             // (n_outer k,)
  int w;                   // item columns
  int rot;                 // items a row: chunk c's walk starts at item c rot
};

// The stepped tile of a stage, written by the producer before it arrives
// on the stage's `full` barrier: the stepping warps read it from shared
// memory, not from registers live across the step loop.
struct Job {
  float* out;              // the shard's next state, (9, h, nx)
  float* push_lo;          // the next shard's lo slot of the next parity
  float* push_hi;          // the previous shard's hi slot
  float* partials;         // column `tile` of the chunk's first row
  int h, y0, x0, own_rows, own_cols, ntiles;
  int push_remote;         // a push goes to another card
  int live;                // 0: no more tiles
};

// Torus mode's stepped tile: as Job, its landing buffers by Push.
struct TorusJob {
  float* out;              // the block's next state, (9, h, w)
  float* push[8];          // the slots of the next parity, Push order
  float* partials;
  int y0, x0, own_rows, own_cols, ntiles;
  int push_remote;
  int live;
};

// The producer's view of an item; lane l holds dependency l.
struct Item {
  int c, r, j, tile, y0, x0, own_rows, own_cols, duties;
  const int* flag;         // this lane's dependency, or null
  bool sys;                // it lies on another card
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

// Where a stage's window comes from, written by the producer for the copy
// group: band rows [y0, y0 + 32 + 2k) of lo | mid | hi (planes of lo_plane,
// mid_plane, hi_plane floats), columns x0 - kx ... (mod nx); live = 0: no
// more windows.
struct Window {
  const float *lo, *mid, *hi, *obst;
  size_t lo_plane, mid_plane, hi_plane;
  int h, row_base, y0, x0, live;
};

// Copy-group thread t's part of window W into `stage`: segments of kSeg
// columns (4: cp.async.cg of 16 B; 1: __ldcg), t taking segments t,
// t + 32 kCopyWarps, ... of the window's rows in order.
template <int kK, int kSeg>
__device__ __forceinline__ void copy_window(float* stage, unsigned char* acc,
                                            const Window& W,
                                            const tpulbm::LbmArgs& a, int t) {
  constexpr int k = kK;
  constexpr int kx = col_margin(k);
  constexpr int wh = kTile + 2 * k;
  constexpr int w = kTile + 2 * kx;
  constexpr int plane = wh * w;
  constexpr int segs = w / kSeg;
  for (int s = t; s < wh * segs; s += 32 * kCopyWarps) {
    const int wy = s / segs, wc = (s - wy * segs) * kSeg;
    const int sr = W.y0 + wy;   // band row
    int r = sr - k;
    const float* buf = W.mid;
    size_t bplane = W.mid_plane;
    if (r < 0) {
      buf = W.lo, r = sr, bplane = W.lo_plane;
    } else if (r >= W.h) {
      buf = W.hi, r -= W.h, bplane = W.hi_plane;
    }
    const bool in = sr < W.h + 2 * k;
    if (wc == 0) acc[wy] = in && wrap(W.row_base + sr, a.ny) == a.accel_row;
    float* d = stage + wy * w + wc;
    if (!in) {
      for (int e = 0; e < kSeg; ++e) {
        for (int q = 0; q < 9; ++q) d[q * plane + e] = 0.0f;
        d[9 * plane + e] = 1.0f;
      }
      continue;
    }
    int col = W.x0 - kx + wc;
    while (col < 0) col += a.nx;
    while (col >= a.nx) col -= a.nx;
    const float* g = buf + (size_t)r * a.nx + col;
    const float* m = W.obst + (size_t)sr * a.nx + col;
    if constexpr (kSeg == 4) {
#pragma unroll
      for (int q = 0; q < 9; ++q)
        tpulbm::cp_async16(d + q * plane, g + q * bplane);
      tpulbm::cp_async16(d + 9 * plane, m);
    } else {
#pragma unroll
      for (int q = 0; q < 9; ++q) d[q * plane] = __ldcg(g + q * bplane);
      d[9 * plane] = __ldcg(m);
    }
  }
}

// Torus mode's window source: band (h + 2k, w + 2kx) cell (sr, c) of
// piece[3 ry + rx] (ry: rows [0, k), [k, k + h), [k + h, h + 2k); rx:
// columns [0, kx), [kx, kx + w), [kx + w, w + 2kx)) is population q at
// buf[off + sr pitch + c + q plane]; the mask band obst is (h + 2k, w + 2kx).
struct Piece {
  const float* buf;
  long long off, plane;
  int pitch;
};

struct TorusWindow {
  Piece piece[9];
  const float* obst;
  int h, w, row_base, y0, x0, live;
};

// Copy-group thread t's part of torus window W, as copy_window: window
// column wc of a tile at block column x0 is band column x0 + wc, as in
// K4's torus mode. Cells past the band are filled as blocked cells, and so
// are, with 4-byte copies, the x slabs' padding columns (which no step
// reads; with 16-byte copies every 4-column segment lies in one piece and
// is copied whole, padding included).
template <int kK, int kSeg>
__device__ __forceinline__ void copy_window(float* stage, unsigned char* acc,
                                            const TorusWindow& W,
                                            const tpulbm::LbmArgs& a, int t) {
  constexpr int k = kK;
  constexpr int kx = col_margin(k);
  constexpr int wh = kTile + 2 * k;
  constexpr int w = kTile + 2 * kx;
  constexpr int plane = wh * w;
  constexpr int segs = w / kSeg;
  const int band_cols = W.w + 2 * kx;
  for (int s = t; s < wh * segs; s += 32 * kCopyWarps) {
    const int wy = s / segs, wc = (s - wy * segs) * kSeg;
    const int sr = W.y0 + wy, c = W.x0 + wc;   // band row and column
    const bool in = sr < W.h + 2 * k;
    if (wc == 0) acc[wy] = in && wrap(W.row_base + sr, a.ny) == a.accel_row;
    float* d = stage + wy * w + wc;
    bool fill = !in || c >= band_cols;
    if constexpr (kSeg == 1) fill = fill || c < kx - k || c >= kx + W.w + k;
    if (fill) {
      for (int e = 0; e < kSeg; ++e) {
        for (int q = 0; q < 9; ++q) d[q * plane + e] = 0.0f;
        d[9 * plane + e] = 1.0f;
      }
      continue;
    }
    const int ry = sr < k ? 0 : (sr < k + W.h ? 1 : 2);
    const int rx = c < kx ? 0 : (c < kx + W.w ? 1 : 2);
    const Piece& P = W.piece[3 * ry + rx];
    const float* g = P.buf + (P.off + (long long)sr * P.pitch + c);
    const float* m = W.obst + (size_t)sr * band_cols + c;
    if constexpr (kSeg == 4) {
#pragma unroll
      for (int q = 0; q < 9; ++q)
        tpulbm::cp_async16(d + q * plane, g + q * P.plane);
      tpulbm::cp_async16(d + 9 * plane, m);
    } else {
#pragma unroll
      for (int q = 0; q < 9; ++q) d[q * plane] = __ldcg(g + q * P.plane);
      d[9 * plane] = __ldcg(m);
    }
  }
}

// Copy-group thread t's part of stage st's window (a Window or
// TorusWindow), then its arrivals on full: once for its stores, once
// (cp.async.mbarrier.arrive) when its copies land.
template <int kK, class Win>
__device__ __forceinline__ void copy_part(float* stage, unsigned char* acc,
                                          const Win& W,
                                          unsigned long long* full,
                                          const tpulbm::LbmArgs& a, int vec16,
                                          int t) {
  if (vec16)
    copy_window<kK, 4>(stage, acc, W, a, t);
  else
    copy_window<kK, 1>(stage, acc, W, a, t);
  mbar_arrive_copies(full);
  mbar_arrive(full);
}

// Ring mode's post of an item: the stepped tile's job and the source of
// its window (lo | shard | hi: the landing slots of the epoch's parity, or
// with pull0 on chunk 0 the neighbours' input states).
template <int kK>
__device__ __forceinline__ void post(const Launch& L, const Item& it, Job& J,
                                     Window& W, const tpulbm::LbmArgs& a) {
  constexpr int k = kK;
  const Shard& S = L.shard[it.j];
  const int e = L.p.base + it.c;
  const size_t slab_plane = (size_t)k * a.nx;
  const int parity = (e + 1) & 1;
  J.out = S.state[(it.c + 1) & 1];
  J.push_lo = S.push_lo[parity];
  J.push_hi = S.push_hi[parity];
  J.partials = S.partials + (size_t)it.c * k * S.ntiles + it.tile;
  J.h = S.h;
  J.y0 = it.y0;
  J.x0 = it.x0;
  J.own_rows = it.own_rows;
  J.own_cols = it.own_cols;
  J.ntiles = S.ntiles;
  J.push_remote = it.duties & kPushRemote;
  J.live = 1;
  if (L.p.pull0 && it.c == 0) {
    W.lo = S.prev_in + (size_t)(S.h_prev - k) * a.nx;
    W.hi = S.next_in;
    W.lo_plane = (size_t)S.h_prev * a.nx;
    W.hi_plane = (size_t)S.h_next * a.nx;
  } else {
    W.lo = S.lo[e & 1];
    W.hi = S.hi[e & 1];
    W.lo_plane = W.hi_plane = slab_plane;
  }
  W.mid = S.state[it.c & 1];
  W.mid_plane = (size_t)S.h * a.nx;
  W.obst = S.obst;
  W.h = S.h;
  W.row_base = S.row_base;
  W.y0 = it.y0;
  W.x0 = it.x0;
  W.live = 1;
}

__device__ __forceinline__ int torus_tiles(const TorusLaunch& L) {
  return ((L.h + kTile - 1) / kTile) * ((L.w + kTile - 1) / kTile);
}

// Torus mode's post: the job, with its eight landing slots of the next
// parity, and the window's nine pieces (TorusWindow): the block's state in
// the middle; around it the landing slots of the epoch's parity, or with
// pull0 on chunk 0 the neighbours' input states, at the offsets that put
// their cells next to the block.
template <int kK>
__device__ __forceinline__ void post(const TorusLaunch& L, const Item& it,
                                     TorusJob& J, TorusWindow& W,
                                     const tpulbm::LbmArgs&) {
  constexpr int k = kK;
  constexpr int kx = col_margin(k);
  const long long* tb = L.table + (size_t)it.j * kTorusWords;
  auto ptr = [&](int i) { return reinterpret_cast<float*>(__ldg(tb + i)); };
  const int e = L.p.base + it.c, h = L.h, w = L.w;
  const int ntiles = torus_tiles(L);
  J.out = ptr(kTState + ((it.c + 1) & 1));
#pragma unroll
  for (int d = 0; d < 8; ++d)
    J.push[d] = ptr(kTPush + d) + ((e + 1) & 1) * (d == kToE || d == kToW
                                                       ? L.xstride
                                                       : L.ystride);
  J.partials = ptr(kTPartials) + (size_t)it.c * k * ntiles + it.tile;
  J.y0 = it.y0;
  J.x0 = it.x0;
  J.own_rows = it.own_rows;
  J.own_cols = it.own_cols;
  J.ntiles = ntiles;
  J.push_remote = it.duties & kPushRemote;
  J.live = 1;
  const long long hw = (long long)h * w, yw = w + 2 * kx;
  auto set = [&](int i, const float* buf, long long off, long long pitch,
                 long long plane) {
    W.piece[i] = Piece{buf, off, plane, (int)pitch};
  };
  set(4, ptr(kTState + (it.c & 1)), -k * (long long)w - kx, w, hw);
  if (L.p.pull0 && it.c == 0) {
    const long long top = (long long)(h - k) * w, mid = -(long long)k * w,
                    bot = -(long long)(k + h) * w;
    const long long left = w - kx, centre = -kx, right = -kx - w;
    set(0, ptr(kTIn + kNW), top + left, w, hw);
    set(1, ptr(kTIn + kN), top + centre, w, hw);
    set(2, ptr(kTIn + kNE), top + right, w, hw);
    set(3, ptr(kTIn + kW), mid + left, w, hw);
    set(5, ptr(kTIn + kE), mid + right, w, hw);
    set(6, ptr(kTIn + kSW), bot + left, w, hw);
    set(7, ptr(kTIn + kS), bot + centre, w, hw);
    set(8, ptr(kTIn + kSE), bot + right, w, hw);
  } else {
    const long long xo = (e & 1) * L.xstride, yo = (e & 1) * L.ystride;
    const float* ylo = ptr(kTSlot + 2) + yo;
    const float* yhi = ptr(kTSlot + 3) + yo;
    for (int i = 0; i < 3; ++i) {
      set(i, ylo, 0, yw, k * yw);
      set(6 + i, yhi, -(long long)(k + h) * yw, yw, k * yw);
    }
    set(3, ptr(kTSlot) + xo, -(long long)k * kx, kx, (long long)h * kx);
    set(5, ptr(kTSlot + 1) + xo, -(long long)k * kx - kx - w, kx,
        (long long)h * kx);
  }
  W.obst = ptr(kTObst);
  W.h = h;
  W.w = w;
  W.row_base = (int)__ldg(tb + kTRowBase);
  W.y0 = it.y0;
  W.x0 = it.x0;
  W.live = 1;
}

// Grid kind's post: the item's job, state[c & 1] read and state[(c + 1) &
// 1] written, its flag and the epoch it finishes.
template <int kK>
__device__ __forceinline__ void post(const GridLaunch& L, const Item& it,
                                     tpulbm::wave::Job& J) {
  J.src = L.state[it.c & 1];
  J.out = L.state[(it.c + 1) & 1];
  J.partials = L.partials + (size_t)it.c * kK * L.p.items + it.tile;
  J.y0 = it.y0;
  J.x0 = it.x0;
  J.own_rows = it.own_rows;
  J.own_cols = it.own_cols;
  J.items = L.p.items;
  J.live = 1;
  J.rec = it.r;
  J.epoch = L.p.base + it.c + 1;
}

// Torus mode's store of owned cell (oy, ox) of job J's tile: the block's
// next state, and each push whose cells hold it (see Push).
template <int kK>
__device__ __forceinline__ void torus_store(const TorusLaunch& L,
                                            const TorusJob& J, int oy, int ox,
                                            const float* res) {
  constexpr int k = kK;
  constexpr int kx = col_margin(k);
  const int h = L.h, w = L.w, row = J.y0 + oy, col = J.x0 + ox;
  const size_t yw = w + 2 * kx;
  const size_t xplane = (size_t)h * kx, yplane = k * yw;
  auto put = [&](float* p, size_t plane) {
#pragma unroll
    for (int q = 0; q < 9; ++q) p[q * plane] = res[q];
  };
  put(J.out + (size_t)row * w + col, (size_t)h * w);
  const bool east = col >= w - k, west = col < k;
  const size_t ec = col - (w - kx);   // the column in a slot's left margin
  if (east) put(J.push[kToE] + (size_t)row * kx + ec, xplane);
  if (west) put(J.push[kToW] + (size_t)row * kx + col, xplane);
  if (row >= h - k) {
    const size_t r = (row - (h - k)) * yw;
    put(J.push[kToS] + r + kx + col, yplane);
    if (east) put(J.push[kToSE] + r + ec, yplane);
    if (west) put(J.push[kToSW] + r + kx + w + col, yplane);
  }
  if (row < k) {
    const size_t r = row * yw;
    put(J.push[kToN] + r + kx + col, yplane);
    if (east) put(J.push[kToNE] + r + ec, yplane);
    if (west) put(J.push[kToNW] + r + kx + w + col, yplane);
  }
}

// Record r of the graph as item (c, r), read by the producer warp: lane l
// holds dependency l.
template <class LaunchT>
__device__ __forceinline__ Item read_item(const LaunchT& L, int c, int r) {
  const int lane = threadIdx.x & 31;
  Item it;
  it.c = c;
  it.r = r;
  const int* rec = L.p.graph + (size_t)r * kRec;
  const int hdr = __ldg(rec + (lane & (kRecDeps - 1)));
  const int dep = __ldg(rec + kRecDeps + lane);
  it.j = __shfl_sync(0xffffffffu, hdr, 0);
  it.tile = __shfl_sync(0xffffffffu, hdr, 1);
  it.y0 = __shfl_sync(0xffffffffu, hdr, 2);
  it.x0 = __shfl_sync(0xffffffffu, hdr, 3);
  it.own_rows = __shfl_sync(0xffffffffu, hdr, 4);
  it.own_cols = __shfl_sync(0xffffffffu, hdr, 5);
  it.duties = __shfl_sync(0xffffffffu, hdr, 6);
  const int counts = __shfl_sync(0xffffffffu, hdr, 7);
  const int local = counts & 255, deps = local + (counts >> 8);
  it.flag = lane < deps ? L.p.peer_flags[dep >> kPeerShift] +
                              (dep & ((1 << kPeerShift) - 1))
                        : nullptr;
  it.sys = lane >= local;
  return it;
}

// One poll of the item's flags (ld.acquire, one lane a flag): in every
// lane, the lanes whose flag has not finished the epoch before the item's
// (0: all done).
template <class LaunchT>
__device__ __forceinline__ unsigned poll_item(const LaunchT& L,
                                              const Item& it) {
  const int ok = !it.flag || load_acquire(it.flag, it.sys) >= L.p.base + it.c;
  const unsigned pending = __ballot_sync(0xffffffffu, !ok);
  __syncwarp();
  return pending;
}

// The producer warp of ring and torus mode (LaunchT: Launch or
// TorusLaunch): walks the CTA's walk indices blockIdx.x, + gridDim.x, ... of
// the launch's chunks in order (ring mode's chunk c starting at record
// c rot, torus mode's at 0). For each it polls the dependencies' flags,
// hands the item on (issue(it, st): its job into stage st, the (n >> 1)-th
// use of stage st = n & 1), waits until it is stored (done[st]) and
// releases its flag. While item n steps it polls the next item's flags and
// issues it as soon as they are done; otherwise it releases item n's flag
// first and then waits. stop(st): no more items in stage st. Leaves its
// blocked waits (SM cycles: all, and those on another card) in waited[0]'s
// low kLateShift bits and waited[1], the items it took after its first in
// waited[2], and those of them it issued after the item before was stored
// in waited[0]'s high bits (finish unpacks them): a counter of their own,
// or unpacking them here, cost ring mode 2.5-3.4 % a chunk at 8192^2 over 4
// shards and 128^2 over 2 on one H100 (PERF.md). The step's code follows
// this code in the kernel and moved with its length, whatever the
// registers.
template <class LaunchT, class Issue, class Stop>
__device__ __forceinline__ void produce(const LaunchT& L,
                                        unsigned long long* done,
                                        unsigned long long* waited,
                                        Issue issue, Stop stop) {
  constexpr bool kRing = std::is_same_v<LaunchT, Launch>;
  const int lane = threadIdx.x & 31;
  const int total = L.p.items * L.p.n_outer;

  auto fetch = [&](int item) {
    const int c = item / L.p.items;
    int r = item - c * L.p.items;
    if constexpr (kRing) r = (r + c * L.rot) % L.p.items;
    return read_item(L, c, r);
  };
  auto poll = [&](const Item& it) { return poll_item(L, it); };

  // The blocked waits (SM cycles): all of them, and those that found a
  // flag of another card not done at their first poll. wait_cyc also
  // counts, from bit kLateShift, the items issued after the step before.
  unsigned long long wait_cyc = 0, remote_cyc = 0;

  // Polls until the item's flags are done: false where the card's error
  // word is set (this or another CTA gave up) or the bound ran out. A
  // wait whose first poll fails is timed into wait_cyc (and remote_cyc).
  auto wait = [&](const Item& it) {
    const unsigned pending = poll(it);
    if (!pending) return true;
    const bool remote = (pending & __ballot_sync(0xffffffffu, it.sys)) != 0;
    const long long t0 = globaltimer(), c0 = clock64();
    bool ok = false;
    for (int n = 1;; ++n) {
      if ((n & 31) == 0) {
        int bad = 0;
        if (lane == 0) {
          bad = *(volatile int*)L.p.error;
          if (!bad && globaltimer() - t0 > kSpinNs) {
            atomicExch(L.p.error, kErrTimeout);
            bad = 1;
          }
        }
        if (__shfl_sync(0xffffffffu, bad, 0)) break;
      }
      __nanosleep(100);
      if (!poll(it)) {
        ok = true;
        break;
      }
    }
    const unsigned long long dc = clock64() - c0;
    wait_cyc += dc;
    if (remote) remote_cyc += dc;
    return ok;
  };

  // The item's flag, after its stores (done): epoch + 1.
  auto release = [&](const Item& it) {
    if (lane == 0)
      store_release(L.p.flags + it.r, L.p.base + it.c + 1,
                    it.duties & kReadRemote);
    __syncwarp();
  };

  int item = blockIdx.x;   // < total: the grid is at most total
  int n = 0;               // at the end: the items taken after the first
  Item it = fetch(item);
  if (!wait(it)) {
    stop(0);
  } else {
    issue(it, 0);
    for (;; ++n) {
      const int st = n & 1, phase = (n >> 1) & 1;
      const int next = item + gridDim.x;
      Item nt;
      bool have = false;
      if (next < total) {
        // While item n steps: the next one, once its flags are done.
        nt = fetch(next);
        while (!(have = !poll(nt)) && !mbar_test(&done[st], phase)) {
        }
        if (have) issue(nt, st ^ 1);
      }
      mbar_wait(&done[st], phase);
      release(it);
      if (next >= total) {
        stop(st ^ 1);
        break;
      }
      if (!have) {
        if (!wait(nt)) {
          stop(st ^ 1);
          break;
        }
        wait_cyc += 1ull << kLateShift;
        issue(nt, st ^ 1);
      }
      item = next;
      it = nt;
    }
  }
  if (lane == 0) {
    waited[0] = wait_cyc;
    waited[1] = remote_cyc;
    waited[2] = n;
  }
}

// The end of every kind's CTA, all threads: where the card's error word is
// clear, the CTA that draws the launch's last ticket reduces each (chunk,
// shard or block)'s k rows of partials in reduce_rows's order; then each
// CTA adds its life (from t_entry, c_entry) and its producer's waited
// cycles (and, in the grid kind, its stepping warps' in waited[2]),
// converted to ns, into the card's counter words, in ring and torus mode
// its producer's counts of items (waited[2], and waited[0]'s high bits:
// produce), and CTA 0 counts the launch.
template <int kK, class LaunchT>
__device__ __forceinline__ void finish(const LaunchT& L, long long t_entry,
                                       long long c_entry,
                                       const unsigned long long* waited) {
  constexpr bool kTorus = std::is_same_v<LaunchT, TorusLaunch>;
  constexpr bool kGrid = std::is_same_v<LaunchT, GridLaunch>;
  constexpr int k = kK;
  __shared__ int go;
  __syncthreads();
  if (threadIdx.x == 0) go = *(volatile int*)L.p.error == 0;
  __syncthreads();
  if (go && tpulbm::last_ticket(L.p.counter)) {
    for (int j = 0; j < L.p.n_local; ++j) {
      const float* partials;
      float* sums;
      int ntiles;
      if constexpr (kTorus) {
        const long long* tb = L.table + (size_t)j * kTorusWords;
        partials = reinterpret_cast<const float*>(__ldg(tb + kTPartials));
        sums = reinterpret_cast<float*>(__ldg(tb + kTSums));
        ntiles = torus_tiles(L);
      } else if constexpr (kGrid) {
        partials = L.partials;
        sums = L.sums;
        ntiles = L.p.items;
      } else {
        partials = L.shard[j].partials;
        sums = L.shard[j].sums;
        ntiles = L.shard[j].ntiles;
      }
      for (int c = 0; c < L.p.n_outer; ++c) {
        tpulbm::reduce_rows(L.p.counter, partials + (size_t)c * k * ntiles,
                            sums + c * k, k, ntiles);
        __syncthreads();
      }
    }
  }
  if (threadIdx.x == 0) {
    const long long life = globaltimer() - t_entry;
    const long long cycles = clock64() - c_entry;
    const double ns = cycles > 0 ? (double)life / (double)cycles : 0.0;
    constexpr unsigned long long kCycles = (1ull << kLateShift) - 1;
    const unsigned long long wait_cyc =
        kGrid ? waited[0] : waited[0] & kCycles;
    const unsigned long long late = kGrid ? 0 : waited[0] >> kLateShift;
    atomicAdd(L.p.waits + kCtaNs, (unsigned long long)life);
    atomicAdd(L.p.waits + kWaitNs, (unsigned long long)(wait_cyc * ns));
    atomicAdd(L.p.waits + kRemoteNs, (unsigned long long)(waited[1] * ns));
    if constexpr (kGrid)
      atomicAdd(L.p.waits + kFillNs, (unsigned long long)(waited[2] * ns));
    else {
      atomicAdd(L.p.waits + kNextN, waited[2]);
      atomicAdd(L.p.waits + kAheadN, waited[2] - late);
    }
    if (blockIdx.x == 0) atomicAdd(L.p.waits + kLaunches, 1ull);
  }
}

// The kernel of ring and torus mode (LaunchT: Launch or TorusLaunch), one
// CTA.
template <int kK, class LaunchT>
__device__ __forceinline__ void p2p_body(const LaunchT& L,
                                         const tpulbm::LbmArgs& a,
                                         int vec16) {
  constexpr bool kTorus = std::is_same_v<LaunchT, TorusLaunch>;
  using JobT = std::conditional_t<kTorus, TorusJob, Job>;
  using WinT = std::conditional_t<kTorus, TorusWindow, Window>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sums[kMaxK][kWarps];
  __shared__ unsigned char acc_rows[2][kMaxW];
  __shared__ JobT job[2];
  __shared__ WinT win[2];
  // posted[s]: win[s] is set (the producer's arrival); full[s]: stage s's
  // window and job are in (the copy group's arrivals and copies); done[s]:
  // its tile is stored (one arrival)
  __shared__ unsigned long long posted[2], full[2], done[2];
  // the CTA's entry in both clocks; its producer's waits (cycles): all,
  // and those on another card; its items after the first (produce)
  __shared__ long long t_entry, c_entry;
  __shared__ unsigned long long waited[3];
  constexpr int k = kK;
  constexpr int sfloats = stage_floats(k);
  if (threadIdx.x == 0) {
    t_entry = globaltimer();
    c_entry = clock64();
    for (int s = 0; s < 2; ++s) {
      mbar_init(&posted[s], 1);
      mbar_init(&full[s], 32 * kCopyWarps);
      mbar_init(&done[s], 1);
    }
  }
  __syncthreads();

  if (threadIdx.x < kThreads) {
    // The stepping warps: tile n of this CTA in stage n & 1, the
    // (n >> 1)-th use of the stage.
    const Cells<kK> cells;
    for (int n = 0;; ++n) {
      const int st = n & 1;
      mbar_wait(&full[st], (n >> 1) & 1);
      const JobT& J = job[st];
      if (!J.live) break;
      auto partial = [&](int s, float v) {
        J.partials[(size_t)s * J.ntiles] = v;
      };
      if constexpr (kTorus) {
        step_tile<kK, kStepBar>(
            smem + st * sfloats, acc_rows[st], J.own_rows, J.own_cols, cells,
            warp_sums, a,
            [&](int oy, int ox, const float* res) {
              torus_store<kK>(L, J, oy, ox, res);
            },
            partial);
      } else {
        step_tile<kK, kStepBar>(
            smem + st * sfloats, acc_rows[st], J.own_rows, J.own_cols, cells,
            warp_sums, a,
            [&](int oy, int ox, const float* res) {
              const int row = J.y0 + oy, col = J.x0 + ox, h = J.h;
              float* o = J.out + (size_t)row * a.nx + col;
              const size_t oplane = (size_t)h * a.nx;
              const size_t slab_plane = (size_t)k * a.nx;
#pragma unroll
              for (int q = 0; q < 9; ++q) o[q * oplane] = res[q];
              if (row >= h - k) {
                float* p = J.push_lo + (size_t)(row - (h - k)) * a.nx + col;
#pragma unroll
                for (int q = 0; q < 9; ++q) p[q * slab_plane] = res[q];
              }
              if (row < k) {
                float* p = J.push_hi + (size_t)row * a.nx + col;
#pragma unroll
                for (int q = 0; q < 9; ++q) p[q * slab_plane] = res[q];
              }
            },
            partial);
      }
      if (J.push_remote) __threadfence_system();
      // every stepping thread's stores (and sys fence) and reads of job[st]
      // are done: the producer may release the tile and refill the stage
      step_sync<kStepBar>();
      if (threadIdx.x == 0) mbar_arrive(&done[st]);
    }
  } else if (threadIdx.x >= kThreads + 32) {
    // The copy warps: window n into stage n & 1, once the producer set it.
    const int t = threadIdx.x - kThreads;
    for (int n = 0;; ++n) {
      const int st = n & 1;
      mbar_wait(&posted[st], (n >> 1) & 1);
      if (!win[st].live) {
        mbar_arrive(&full[st]);
        break;
      }
      copy_part<kK>(smem + st * sfloats, acc_rows[st], win[st], &full[st], a,
                    vec16, t);
    }
    tpulbm::cp_async_wait<0>();
  } else {
    // The producer warp: the item's job and window into stage st, win[st]
    // for the copy warps (posted), this warp's part of the copy, the
    // arrivals on full.
    const int lane = threadIdx.x & 31;
    auto issue = [&](const Item& it, int st) {
      if (lane == 0) {
        post<kK>(L, it, job[st], win[st], a);
        mbar_arrive(&posted[st]);
      }
      __syncwarp();
      copy_part<kK>(smem + st * sfloats, acc_rows[st], win[st], &full[st], a,
                    vec16, lane);
    };
    // The stepping and copy warps find no more tiles in stage st.
    auto stop = [&](int st) {
      if (lane == 0) {
        job[st].live = 0;
        win[st].live = 0;
        mbar_arrive(&posted[st]);
      }
      mbar_arrive(&full[st]);
    };
    produce(L, done, waited, issue, stop);
    tpulbm::cp_async_wait<0>();
  }
  finish<kK>(L, t_entry, c_entry, waited);
}

// The grid kind's block: its stepping warps, the producer, and kGridCopy
// threads that only copy (a row's copies are few since wave_step.cuh's
// RowCopy sets them once an item).
constexpr int kGridCopy = 96;
constexpr int kGridBlock = tpulbm::wave::kThreads + 32 + kGridCopy;

// The grid kind's producer warp: posts the CTA's items (walk index
// blockIdx.x + n gridDim.x, chunk c = index / items starting its walk at
// item row c: record (index + c rot) % items) into the stream's kJobs slots
// in order, each once its flags are done and its slot is free; releases
// each item's flag once it is done, in order; then posts the stop item. A
// wait counts (waited[0], SM cycles) while the CTA has no item in flight
// and the next item's flags are not done; past kSpinNs, or where the card's
// error word is set, the producer gives up: it posts the stop at once.
template <int kK>
__device__ __forceinline__ void produce_stream(const GridLaunch& L,
                                               tpulbm::wave::Stream& S,
                                               unsigned long long* waited) {
  namespace wv = tpulbm::wave;
  const int lane = threadIdx.x & 31;
  const int total = L.p.items * L.p.n_outer;
  const int mine = (total - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  int posted = 0, released = 0, polls = 0;
  bool have = false, bad = false, stopped = false;
  long long t0 = -1, idle0 = -1;
  unsigned long long wait_cyc = 0;
  Item it;
  for (;;) {
    while (released < posted &&
           mbar_test(&S.done[released & (wv::kJobs - 1)],
                     (released / wv::kJobs) & 1)) {
      const wv::Job& J = S.job[released & (wv::kJobs - 1)];
      if (lane == 0) store_release(L.p.flags + J.rec, J.epoch, false);
      __syncwarp();
      ++released;
    }
    if (stopped) {
      if (released == posted) break;
      continue;
    }
    if (posted - released >= wv::kJobs) continue;   // every slot in flight
    if (bad || posted == mine) {
      if (lane == 0) {
        S.job[posted & (wv::kJobs - 1)].live = 0;
        mbar_arrive(&S.posted[posted & (wv::kJobs - 1)]);
      }
      __syncwarp();
      stopped = true;
      continue;
    }
    if (!have) {
      const int w = blockIdx.x + posted * gridDim.x;
      const int c = w / L.p.items;
      it = read_item(L, c, (w - c * L.p.items + c * L.rot) % L.p.items);
      have = true;
    }
    if (!poll_item(L, it)) {
      if (idle0 >= 0) wait_cyc += clock64() - idle0;
      idle0 = t0 = -1;
      if (lane == 0) {
        post<kK>(L, it, S.job[posted & (wv::kJobs - 1)]);
        mbar_arrive(&S.posted[posted & (wv::kJobs - 1)]);
      }
      __syncwarp();
      ++posted;
      have = false;
      continue;
    }
    if (t0 < 0) {
      t0 = globaltimer();
      polls = 0;
    }
    if (idle0 < 0 && released == posted) idle0 = clock64();
    if ((++polls & 31) == 0) {
      int err = 0;
      if (lane == 0) {
        err = *(volatile int*)L.p.error;
        if (!err && globaltimer() - t0 > kSpinNs) {
          atomicExch(L.p.error, kErrTimeout);
          err = 1;
        }
      }
      bad = __shfl_sync(0xffffffffu, err, 0) != 0;
    }
    __nanosleep(100);
  }
  if (idle0 >= 0) wait_cyc += clock64() - idle0;
  if (lane == 0) {
    waited[0] = wait_cyc;
    waited[1] = 0;
  }
}

// The grid kind's kernel, one CTA: the stepping warps step the CTA's items
// as one row wavefront (wave_step.cuh::step_stream), the copy warps stream
// their window rows ahead of it (copy_stream), and the producer posts them
// and releases their flags (produce_stream).
template <int kK>
__device__ __forceinline__ void grid_body(const GridLaunch& L,
                                          const tpulbm::LbmArgs& a,
                                          int vec16) {
  namespace wv = tpulbm::wave;
  extern __shared__ __align__(16) float smem[];
  __shared__ wv::Stream S;
  __shared__ long long t_entry, c_entry;
  // the producer's waits with no item in flight; the stepping warps' on
  // level-0 ring rows (SM cycles)
  __shared__ unsigned long long waited[3];
  if (threadIdx.x == 0) {
    t_entry = globaltimer();
    c_entry = clock64();
    for (int j = 0; j < wv::kJobs; ++j) {
      mbar_init(&S.posted[j], 1);
      mbar_init(&S.done[j], 1);
      S.job[j].seq = -1;
    }
    for (int r = 0; r < wv::kRing; ++r) {
      mbar_init(&S.full[r], kGridCopy);
      mbar_init(&S.empty[r], 1);
    }
    S.finished = -1;
  }
  __syncthreads();
  if (threadIdx.x < wv::kThreads) {
    const unsigned long long fill =
        wv::step_stream<kK, kStepBar>(smem, S, L.w, a);
    if (threadIdx.x == 0) waited[2] = fill;
  } else if (threadIdx.x >= wv::kThreads + 32) {
    wv::copy_stream<kK, kGridCopy, kCopyBar>(
        smem, S, L.obst, L.w, vec16, a, threadIdx.x - wv::kThreads - 32);
  } else {
    produce_stream<kK>(L, S, waited);
  }
  finish<kK>(L, t_entry, c_entry, waited);
}

template <int kK>
__global__ void __launch_bounds__(kBlock, 1)
    ring_p2p_kernel(const __grid_constant__ Launch L, tpulbm::LbmArgs a,
                    int vec16) {
  p2p_body<kK>(L, a, vec16);
}

template <int kK>
__global__ void __launch_bounds__(kBlock, 1)
    torus_p2p_kernel(const __grid_constant__ TorusLaunch L,
                     tpulbm::LbmArgs a, int vec16) {
  p2p_body<kK>(L, a, vec16);
}

template <int kK>
__global__ void __launch_bounds__(kGridBlock, 1)
    grid_p2p_kernel(const __grid_constant__ GridLaunch L, tpulbm::LbmArgs a,
                    int vec16) {
  grid_body<kK>(L, a, vec16);
}

int smem_bytes(int k) { return 2 * stage_floats(k) * (int)sizeof(float); }

// The grid kind's rings (wave_step.cuh).
int grid_smem_bytes(int k) {
  return tpulbm::wave::smem_floats(k) * (int)sizeof(float);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

enum class Kind { kRing, kTorus, kGrid };

// Dynamic shared memory of a kind's k-step instance.
template <Kind kKind>
int smem_of(int k) {
  return kKind == Kind::kGrid ? grid_smem_bytes(k) : smem_bytes(k);
}

// The kernel of a kind and k.
template <Kind kKind, int kK>
constexpr auto kernel_of() {
  if constexpr (kKind == Kind::kTorus)
    return torus_p2p_kernel<kK>;
  else if constexpr (kKind == Kind::kGrid)
    return grid_p2p_kernel<kK>;
  else
    return ring_p2p_kernel<kK>;
}

// The persistent grid of an instance on the current device, its shared-
// memory limit set on first use: every CTA of a launch of at most this many
// is resident at once, which the waits need.
template <Kind kKind, int kK>
cudaError_t configure(int* grid_cap) {
  static int cap[kMaxDevices];
  constexpr auto kernel = kernel_of<kKind, kK>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cap[dev]) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_of<kKind>(kK));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kKind == Kind::kGrid ? kGridBlock : kBlock,
          smem_of<kKind>(kK));
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
  cudaError_t e = configure<Kind::kRing, kK>(&cap);
  if (e != cudaSuccess) return (int)e;
  const int total = l.p.items * l.p.n_outer;
  bool vec16 = a.nx % 4 == 0;
  for (int j = 0; j < l.p.n_local; ++j) {
    const Shard& s = l.shard[j];
    for (const void* p : {(const void*)s.obst, (const void*)s.state[0],
                          (const void*)s.state[1], (const void*)s.prev_in,
                          (const void*)s.next_in, (const void*)s.lo[0],
                          (const void*)s.lo[1], (const void*)s.hi[0],
                          (const void*)s.hi[1]})
      vec16 = vec16 && aligned16(p);
  }
  ring_p2p_kernel<kK><<<total < cap ? total : cap, kBlock, smem_bytes(kK),
                        stream>>>(l, a, vec16 ? 1 : 0);
  return (int)cudaGetLastError();
}

// A launch of torus mode or the grid kind (LaunchT: TorusLaunch or
// GridLaunch), vec16 decided by the caller.
template <Kind kKind, int kK, class LaunchT>
int launch_kind(const LaunchT& l, const tpulbm::LbmArgs& a, int vec16,
                cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = configure<kKind, kK>(&cap);
  if (e != cudaSuccess) return (int)e;
  const int total = l.p.items * l.p.n_outer;
  const int grid = total < cap ? total : cap;
  if constexpr (kKind == Kind::kTorus)
    torus_p2p_kernel<kK><<<grid, kBlock, smem_bytes(kK), stream>>>(l, a,
                                                                   vec16);
  else
    grid_p2p_kernel<kK><<<grid, kGridBlock, grid_smem_bytes(kK), stream>>>(
        l, a, vec16);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const Launch&, const tpulbm::LbmArgs&, cudaStream_t);
constexpr LaunchFn kLaunch[kMaxK] = {launch<1>, launch<2>, launch<3>,
                                     launch<4>, launch<5>, launch<6>,
                                     launch<7>, launch<8>};
using TorusLaunchFn = int (*)(const TorusLaunch&, const tpulbm::LbmArgs&, int,
                              cudaStream_t);
constexpr TorusLaunchFn kTorusLaunch[kMaxK] = {
    launch_kind<Kind::kTorus, 1, TorusLaunch>,
    launch_kind<Kind::kTorus, 2, TorusLaunch>,
    launch_kind<Kind::kTorus, 3, TorusLaunch>,
    launch_kind<Kind::kTorus, 4, TorusLaunch>,
    launch_kind<Kind::kTorus, 5, TorusLaunch>,
    launch_kind<Kind::kTorus, 6, TorusLaunch>,
    launch_kind<Kind::kTorus, 7, TorusLaunch>,
    launch_kind<Kind::kTorus, 8, TorusLaunch>};
using GridLaunchFn = int (*)(const GridLaunch&, const tpulbm::LbmArgs&, int,
                             cudaStream_t);
constexpr GridLaunchFn kGridLaunch[kMaxK] = {
    launch_kind<Kind::kGrid, 1, GridLaunch>,
    launch_kind<Kind::kGrid, 2, GridLaunch>,
    launch_kind<Kind::kGrid, 3, GridLaunch>,
    launch_kind<Kind::kGrid, 4, GridLaunch>,
    launch_kind<Kind::kGrid, 5, GridLaunch>,
    launch_kind<Kind::kGrid, 6, GridLaunch>,
    launch_kind<Kind::kGrid, 7, GridLaunch>,
    launch_kind<Kind::kGrid, 8, GridLaunch>};
constexpr cudaError_t (*kConfigure[kMaxK])(int*) = {
    configure<Kind::kRing, 1>, configure<Kind::kRing, 2>,
    configure<Kind::kRing, 3>, configure<Kind::kRing, 4>,
    configure<Kind::kRing, 5>, configure<Kind::kRing, 6>,
    configure<Kind::kRing, 7>, configure<Kind::kRing, 8>};

// f() with `device` current; restores the current device.
template <class F>
int on_device(int device, F f) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = f();
  const cudaError_t back = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : back);
}

}  // namespace

extern "C" {

int lbm_ring_p2p_words() { return kWords; }
int lbm_ring_p2p_max_local() { return kMaxLocal; }
int lbm_ring_p2p_max_outer() { return kMaxOuter; }
int lbm_ring_p2p_smem(int k) { return smem_bytes(k); }
int lbm_grid_p2p_smem(int k) { return grid_smem_bytes(k); }

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

// K6's exchange memory across processes (ops/ring_p2p.py::Exchange): a
// process's landing slots, flag array and error word of a card lie in one
// cudaMalloc block, which the processes of its neighbour shards map with
// CUDA IPC. The block is no PyTorch tensor: the caching allocator
// sub-allocates its blocks, and an IPC handle names a whole cudaMalloc
// allocation.

int lbm_ring_p2p_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// A zeroed block of `bytes` on `device` into *ptr, the zeroing finished;
// where `handle` is not null, its IPC handle (lbm_ring_p2p_handle_bytes()
// bytes) into it.
int lbm_ring_p2p_alloc(int device, long long bytes, void** ptr,
                       void* handle) {
  return on_device(device, [&]() {
    *ptr = nullptr;
    cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
    if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    if (e == cudaSuccess && handle)
      e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
    if (e != cudaSuccess && *ptr) {
      cudaFree(*ptr);
      *ptr = nullptr;
    }
    return e;
  });
}

// Frees a block of lbm_ring_p2p_alloc once `device`'s work is done.
int lbm_ring_p2p_free(int device, void* ptr) {
  return on_device(device, [&]() {
    const cudaError_t e = cudaDeviceSynchronize();
    const cudaError_t f = cudaFree(ptr);
    return e != cudaSuccess ? e : f;
  });
}

// Maps another process's block (its IPC handle) into this process for
// `device`, peer access to the block's card enabled as needed, into *ptr.
int lbm_ring_p2p_open(int device, const void* handle, void** ptr) {
  return on_device(device, [&]() {
    cudaIpcMemHandle_t h;
    std::memcpy(&h, handle, sizeof h);
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

// Unmaps a block of lbm_ring_p2p_open.
int lbm_ring_p2p_close(int device, void* ptr) {
  return on_device(device, [&]() { return cudaIpcCloseMemHandle(ptr); });
}

// `height` rows of `width` bytes from src (rows spitch bytes apart) to dst
// (dpitch apart), on `stream` of the current device; either side may be a
// mapping of lbm_ring_p2p_open, or host memory.
int lbm_ring_p2p_copy(void* dst, long long dpitch, const void* src,
                      long long spitch, long long width, long long height,
                      cudaStream_t stream) {
  return (int)cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch,
                                (size_t)width, (size_t)height,
                                cudaMemcpyDefault, stream);
}

// n_outer (<= kMaxOuter) chunks of k (<= 8) steps of n_local (<=
// kMaxLocal) shards of the ring, the epochs base .. base + n_outer - 1;
// table: kWords int64 words a shard (the Shard fields in order, pointers
// then ints; see ops/ring_p2p.py), all shards of the launch on the current
// device; graph: the card's (items, kRec) int32 tile graph on the device,
// items the shards' tiles (chunk c's walk starts c tile rows on,
// wrapping); peer_flags: n_peers (<= kMaxPeers) flag arrays
// that the graph names, this card's first; pull0: chunk 0 reads prev_in /
// next_in, not the slots; error: the device's error word; waits: the
// device's 7 counter words (kCtaNs ... kAheadN), added to; counter: a zeroed
// unsigned int of the device, left zeroed (the last CTA resets it), not
// shared with a launch that may run at the same time. Launches on the
// current device and stream; returns cudaGetLastError(), or the error of
// configuring the kernel.
int lbm_ring_p2p(const long long* table, int n_local, const int* graph,
                 int items, const long long* peer_flags, int n_peers,
                 int n_outer, int base, int pull0, int* error,
                 unsigned long long* waits, unsigned int* counter, int ny,
                 int nx, int accel_row, float omega, float w1, float w2,
                 int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n_local < 1 || n_local > kMaxLocal ||
      n_outer < 1 || n_outer > kMaxOuter || nx < 1 || base < 0 ||
      n_peers < 1 || n_peers > kMaxPeers || !graph || !waits)
    return (int)cudaErrorInvalidValue;
  Launch l{};
  l.p.n_local = n_local;
  l.p.n_outer = n_outer;
  l.p.base = base;
  l.p.pull0 = pull0;
  l.p.graph = graph;
  for (int p = 0; p < n_peers; ++p)
    l.p.peer_flags[p] = reinterpret_cast<const int*>(peer_flags[p]);
  l.p.flags = reinterpret_cast<int*>(peer_flags[0]);
  l.p.error = error;
  l.p.counter = counter;
  l.p.waits = waits;
  const int tiles_x = (nx + kTile - 1) / kTile;
  int tiles = 0;
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
    s.partials = ptr(13);
    s.sums = ptr(14);
    s.h = (int)t[15], s.h_prev = (int)t[16], s.h_next = (int)t[17];
    s.row_base = (int)t[18];
    if (s.h < k || s.h_prev < k || s.h_next < k || s.row_base < 0 ||
        s.row_base >= ny)
      return (int)cudaErrorInvalidValue;
    s.ntiles = tiles_x * ((s.h + kTile - 1) / kTile);
    tiles += s.ntiles;
  }
  if (items != tiles) return (int)cudaErrorInvalidValue;
  l.p.items = items;
  l.rot = tiles_x;
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  return kLaunch[k - 1](l, a, stream);
}

// Torus mode: n_outer (<= kMaxOuter) chunks of k (<= 8) steps of n_local
// (<= kMaxTorusLocal) (h, w) blocks of the (ny, nx) torus, the epochs
// base .. base + n_outer - 1. host_table and table: the same (n_local,
// kTorusWords) int64 entries (ops/ring_p2p.py::TORUS_TABLE), on the host
// (checked here) and on the card (read by the kernel until it ends); a
// block's landing buffers hold two slots, 9 h 8 floats (x) and
// 9 * 8 (w + 16) (y) apart. The rest as lbm_ring_p2p; pull0: chunk 0 reads
// the eight neighbours' input states; n_peers <= kMaxTorusPeers.
int lbm_torus_p2p(const long long* host_table, const long long* table,
                  int n_local, const int* graph, int items,
                  const long long* peer_flags, int n_peers, int n_outer,
                  int base, int pull0, int* error, unsigned long long* waits,
                  unsigned int* counter, int ny, int nx, int accel_row,
                  float omega, float w1, float w2, int k, int h, int w,
                  cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n_local < 1 || n_local > kMaxTorusLocal ||
      n_outer < 1 || n_outer > kMaxOuter || base < 0 || h < k || w < k ||
      n_peers < 1 || n_peers > kMaxTorusPeers || !graph || !table || !waits)
    return (int)cudaErrorInvalidValue;
  TorusLaunch l{};
  l.p.n_local = n_local;
  l.p.n_outer = n_outer;
  l.p.base = base;
  l.p.pull0 = pull0;
  l.p.graph = graph;
  for (int p = 0; p < n_peers; ++p)
    l.p.peer_flags[p] = reinterpret_cast<const int*>(peer_flags[p]);
  l.p.flags = reinterpret_cast<int*>(peer_flags[0]);
  l.p.error = error;
  l.p.counter = counter;
  l.p.waits = waits;
  l.table = table;
  l.h = h;
  l.w = w;
  l.xstride = 9LL * h * kMaxK;
  l.ystride = 9LL * kMaxK * (w + 2 * kMaxK);
  const int ntiles = ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
  if (items != n_local * ntiles) return (int)cudaErrorInvalidValue;
  l.p.items = items;
  // 16-byte window copies: every piece's rows start 16-B aligned
  bool vec16 = w % 4 == 0;
  for (int j = 0; j < n_local; ++j) {
    const long long* t = host_table + (size_t)j * kTorusWords;
    for (int i = 0; i < kTRowBase; ++i)
      vec16 = vec16 && t[i] && aligned16(reinterpret_cast<void*>(t[i]));
    if (t[kTRowBase] < 0 || t[kTRowBase] >= ny)
      return (int)cudaErrorInvalidValue;
  }
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  return kTorusLaunch[k - 1](l, a, vec16 ? 1 : 0, stream);
}

// Grid kind: n_outer (<= kMaxOuter) chunks of k (<= 8) steps of the whole
// (ny, nx) grid, the epochs base .. base + n_outer - 1: state0 holds the
// state at epoch base, chunk c reads state[c % 2] and writes
// state[(c + 1) % 2] (state0, state1 (9, ny, nx), distinct); obst the
// (ny, nx) float32 mask; partials (n_outer k, items), sums (n_outer k,);
// graph the card's (items, kRec) int32 item graph of the grid, items its
// items of item_h x item_w cells (item_w a multiple of 4, at most 64,
// wave_step.cuh::kMaxW; ops/ring_p2p.py::grid_graph); flags its
// flag array (one int an item). The rest as lbm_ring_p2p.
int lbm_grid_p2p(float* state0, float* state1, const float* obst,
                 float* partials, float* sums, const int* graph, int items,
                 int item_h, int item_w, int* flags, int n_outer, int base,
                 int* error, unsigned long long* waits, unsigned int* counter,
                 int ny, int nx, int accel_row, float omega, float w1,
                 float w2, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n_outer < 1 || n_outer > kMaxOuter || ny < 1 ||
      nx < 1 || base < 0 || !graph || !flags || !waits || !error ||
      state0 == state1 || item_h < 1 || item_w < 4 ||
      item_w > tpulbm::wave::kMaxW || item_w % 4 ||
      items != ((ny + item_h - 1) / item_h) * ((nx + item_w - 1) / item_w))
    return (int)cudaErrorInvalidValue;
  GridLaunch l{};
  l.p.n_local = 1;
  l.p.n_outer = n_outer;
  l.p.base = base;
  l.p.graph = graph;
  l.p.peer_flags[0] = flags;
  l.p.flags = flags;
  l.p.items = items;
  l.p.error = error;
  l.p.counter = counter;
  l.p.waits = waits;
  l.obst = obst;
  l.state[0] = state0;
  l.state[1] = state1;
  l.partials = partials;
  l.sums = sums;
  l.w = item_w;
  l.rot = (nx + item_w - 1) / item_w;
  const bool vec16 = nx % 4 == 0 && aligned16(state0) && aligned16(state1) &&
                     aligned16(obst);
  const tpulbm::LbmArgs a{ny, nx, accel_row, omega, w1, w2};
  return kGridLaunch[k - 1](l, a, vec16 ? 1 : 0, stream);
}

}  // extern "C"
