"""The ring's chunks with the slab exchange inside the kernel: kernel K6.

K6 (``csrc/ring_p2p.cu::lbm_ring_p2p``) advances every shard of the 1-D
ring that lies on one card by ``n_outer`` chunks of k <= 8 steps in one
persistent launch. Between chunks the shards hand their edge rows to each
other inside the kernel: a tile that owns one of its shard's last k rows
writes it into the next shard's lo landing slot, one of its first k rows
into the previous shard's hi slot (device memory, or peer memory where the
neighbour lies on another card), and a tile waits for its neighbourhood's
flags before it loads its window. It is the counterpart of the JAX
package's in-kernel exchange, ``pallas_kstep_rdma._kernel`` (``n_outer``
= 1) and ``pallas_resident_rdma._kernel`` (up to ``MAX_OUTER`` chunks a
call, the JAX runner's ``max_outer_per_call``), and computes what
``kstep_tile.ring_chunk`` (K4 ring mode) computes chunk by chunk with the
slabs copied between chunks: the same bits, state and per-step sums.

``Exchange`` holds what lasts across a runner's calls: each shard's landing
slots, two (9, 8, nx) lo and two hi buffers chosen by the parity of the
global chunk count (the epoch); on the card, a flat array of one flag a
tile of the card's shards, one error word a card, and, for each k, the
card's tile graph (``tile_graph``): a record a tile in the kernel's walk
order, with its dependencies as indices into the flag arrays. The slots,
flags, error word and wait counters of a card lie in one ``cudaMalloc``
block. The sums' epilogue draws its tickets on the card's ticket counter
(``_build.ticket_counter``), as K4's does. The epoch rises across launches
and calls and no flag is ever reset (a reset on one card would race a
kernel on another that reads the flag).

Over several processes (``dist.multihost``) the ring is the JAX package's
over a global mesh: each process launches K6 on its own shards, and a
card's block is mapped into the processes of its shards' neighbours by
CUDA IPC, so the slabs and flags cross processes inside the kernel as
they cross cards. A shard is keyed by (process, card): a neighbour in
another process counts as another card, at system scope, even on the
same physical card. A neighbour's input state lies in another process, so
a launch there never reads it (pull0): ``Exchange.enter`` pushes each
shard's input edge rows into the neighbours' slots first and orders every
process after the pushes (the TPU kernel's entry,
pallas_resident_rdma.py:127-147), and ``Exchange.check`` ORs the error
words of every process at the end of a runner call.

K6 counts its own waits: each CTA times its producer's waits that block
on a neighbour tile's flag (and the part of them that found a flag of
another card not done) in SM cycles, and its own life by
``%globaltimer``, which converts the cycles to ns, and adds them into
counter words of its card's block (``WAIT_WORDS``, after the error word),
with a count of launches; the grid kind's CTAs also time the waits of
their stepping warps for level-0 ring rows (``fill_ns``, 0 in ring and
torus mode), and a ring or torus CTA's producer counts the items it took
after its first (``next_n``) and those of them it issued while the item
before was still stepping (``ahead_n``; both 0 in the grid kind).
``Exchange.check`` reads them in
the same copy as the error word and adds what each card counted since
its last read to ``WAITS[card index]``, this process's cards only;
``reset_waits`` clears it.

Torus mode (``torus_p2p_chunks``, ``TorusExchange``) runs the same
protocol over the blocks of the 2-D torus, in one process or across
processes alike: there ``TorusExchange.enter`` pushes each block's input
edges and corners into its eight neighbours' slots before a call's first
launch.

The grid kind (``grid_p2p_chunks``, ``GridExchange``) runs the same
protocol over the whole periodic grid of one card, the one-card route of
every grid outside the resident gate (``dist.runner.resident_route``): up
to ``MAX_OUTER`` chunks a launch, its items handing off between chunks
through their flags alone (no slots, no pushes). Its items are taller
than the other kinds' tiles (``grid_item``) and step as row wavefronts
over the k time levels (``csrc/wave_step.cuh``). The state is the bits of
K4's whole-grid chunks (``kstep_tile.tile_chunk``), which stay its
reference; the per-step sums are summed in the grid kind's own order
(``grid_sums_ref`` the plain version of its reduction). On CPU tensors,
``grid_p2p_chunks_ref``.

``p2p_chunks`` runs one launch a card; on CPU tensors it takes the plain
version, ``p2p_chunks_ref``: ``n_outer`` chunks of ``ring_chunk_ref`` over
every shard (this process's, the slabs of others through the transport),
the slabs of each chunk written into the next epoch's landing slots,
chunk 0 reading the neighbours' states where ``pull0`` (the first chunk of
a runner call), the slots elsewhere.
"""

from __future__ import annotations

import ctypes
import os
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.dist import multihost
from tpulbm_torch.ops import _build, kstep_tile
from tpulbm_torch.ops.kstep import check_chunk
from tpulbm_torch.utils.profiling import span

MAX_OUTER = 64      # chunks of one launch (csrc/ring_p2p.cu::kMaxOuter)
MAX_LOCAL = 16      # shards of one launch on one card (kMaxLocal)
SLAB_ROWS = kstep_tile.TILE_K   # rows of a landing buffer
TILE = 32           # owned tile edge (csrc/tile_step.cuh::kTile)
# Bytes of one shard's partials a launch, (n_outer k, ntiles) floats, at
# most: a launch of an 8192^2 shard of 4 takes 32 chunks (16 MiB), so the
# deck's peak device memory over 4 shards stays under 5.0 GiB.
PARTIALS_BYTES = 16 << 20
# Words of a shard's entry in lbm_ring_p2p's table (csrc/ring_p2p.cu::
# kWords): the pointers, then the integers.
TABLE = ("obst", "state0", "state1", "prev_in", "next_in", "lo0", "lo1",
         "hi0", "hi1", "push_lo0", "push_lo1", "push_hi0", "push_hi1",
         "partials", "sums", "h", "h_prev", "h_next", "row_base")
# The tile graph (csrc/ring_p2p.cu::kRec): a record of REC int32 a tile,
# REC_DEPS words of header (HEADER), then up to REC - REC_DEPS
# dependencies, this card's first, each PEER_SHIFT-shifted peer | index.
REC = 40
REC_DEPS = 8
HEADER = ("shard", "tile", "y0", "x0", "own_rows", "own_cols", "duties",
          "counts")
PEER_SHIFT = 24
MAX_PEERS = 4       # flag arrays a card's records name, its own first
MAX_TORUS_PEERS = 16    # ... in torus mode (kMaxTorusPeers)
PUSH_REMOTE = 1     # duty: the tile pushes an edge row onto another card
READ_REMOTE = 2     # duty: a tile on another card waits on its flag
# K6's counter words, uint64 from byte WAITS_AT of a card's exchange block
# (csrc/ring_p2p.cu::kCtaNs ... kAheadN): the CTAs' lives, their blocked
# waits, the part of those that waited on another card (ns), launches, and
# the grid kind's stepping warps' blocked waits for the rows the copy group
# loads (ns; 0 in ring and torus mode), and the items a ring or torus
# producer took after its first and those of them it issued ahead, under
# the step of the item before (kNextN, kAheadN; 0 in the grid kind).
WAIT_WORDS = ("cta_ns", "wait_ns", "remote_ns", "launches", "fill_ns",
              "next_n", "ahead_n")
WAITS_AT = 8
# What K6 counted on each card of this process since the last
# reset_waits(): {card index: {word: count}} (in the style of
# _build.LAUNCHES), added to by Exchange.check.
WAITS: dict = {}


def reset_waits() -> None:
    WAITS.clear()


def ntiles(h: int, nx: int) -> int:
    """Owned tiles of a shard of h rows (the row length of its partials)."""
    return -(-h // TILE) * -(-nx // TILE)


def outer_per_launch(rows, nx: int, k: int, items: int | None = None) -> int:
    """Chunks a launch: MAX_OUTER, fewer where the largest shard's (or
    torus block's: ``rows`` its height, ``nx`` its width; or the grid
    kind's ``items``) partials would pass PARTIALS_BYTES."""
    per_chunk = 4 * k * (items or ntiles(max(rows), nx))
    return max(1, min(MAX_OUTER, PARTIALS_BYTES // per_chunk))


def _touch(a0, alen, b0, blen, n: int, k: int):
    """(len(a0), len(b0)) bools: interval [a0, a0 + alen) widened by k on
    each side meets [b0, b0 + blen), both modulo n."""
    s = a0[:, None] - k
    span = alen[:, None] + 2 * k
    return ((span >= n) | ((b0[None] - s) % n < span)
            | ((s - b0[None]) % n < blen[None]))


def _tile_rows(rows, t):
    """Every tile row of the ring (tiles of t rows): (shard, row in shard,
    first global row, rows owned)."""
    out, off = [], 0
    for d, h in enumerate(rows):
        for ty in range(-(-h // t)):
            out.append((d, ty, off + ty * t, min(t, h - ty * t)))
        off += h
    return np.array(out, dtype=np.int64).reshape(-1, 4)


def _reach(rows, nx: int, k: int, t: int, tw: int):
    """The cone relation in factors for tiles of t rows and tw columns:
    (tile rows, R, C), R[a, b] where tile row b has owned rows within k of
    tile row a's (across shard edges, modulo the ring's rows), C[x, y]
    where tile column y has owned columns within k of tile column x's
    (modulo nx)."""
    tr = _tile_rows(rows, t)
    r = _touch(tr[:, 2], tr[:, 3], tr[:, 2], tr[:, 3], sum(rows), k)
    x0 = np.arange(0, nx, tw)
    xl = np.minimum(tw, nx - x0)
    return tr, r, _touch(x0, xl, x0, xl, nx, k)


def tile_graph(mesh, rows, nx: int, k: int, t: int = TILE,
               tw: int | None = None):
    """Each card's tile graph for K6: {card: (records, peers)}. A tile
    waits on every tile with owned cells within k cells of its own, itself
    included (a symmetric relation; _reach). records (items, REC) int32
    holds a record a tile of the card's shards (in mesh order, tiles
    row-major), the kernel's walk within a chunk from the record where
    the chunk starts (chunk c's at tile row c, wrapping: ring mode and the
    grid kind, csrc/ring_p2p.cu): HEADER (shard as the
    launch's index, tile, window origin y0 and x0, owned rows and columns,
    duties, local | remote << 8 dependency counts), then its dependencies
    as flag indices, this card's first, those on another card as
    peers.index(card) << PEER_SHIFT | index. A card's flag array holds its
    shards' tiles in record order, so a tile's own flag is its record's
    index. peers: the cards whose flag arrays the records name, this
    card's first. Tiles are t x t cells, or t rows of tw columns."""
    tw = tw or t
    cards = list(dict.fromkeys(mesh))
    local = {c: [d for d in range(len(rows)) if mesh[d] == c] for c in cards}
    tr, r, c = _reach(rows, nx, k, t, tw)
    tiles_x = c.shape[0]
    card_of, flag0, where = {}, {}, {}
    for card in cards:
        i = 0
        for j, d in enumerate(local[card]):
            card_of[d], flag0[d], where[d] = card, i, j
            i += -(-rows[d] // t) * tiles_x
    ys = [np.flatnonzero(c[x]) for x in range(tiles_x)]
    width = max(map(len, ys))
    ypad = np.array([list(y) + [-1] * (width - len(y)) for y in ys])
    x0 = np.arange(tiles_x) * tw
    out = {}
    for card in cards:
        peers = [card]
        recs = []
        for d in local[card]:
            h = rows[d]
            for a in np.flatnonzero(tr[:, 0] == d):
                ty = int(tr[a, 1])
                hit = np.flatnonzero(r[a])
                srcs, bases = [], []
                for b in hit:
                    e = int(tr[b, 0])
                    if card_of[e] not in peers:
                        peers.append(card_of[e])
                    srcs.append(peers.index(card_of[e]))
                    bases.append(flag0[e] + int(tr[b, 1]) * tiles_x)
                src = np.repeat(srcs, width)[None, :]
                idx = (np.repeat(bases, width)[None, :]
                       + np.tile(ypad, len(hit)))
                bad = np.tile(ypad, len(hit)) < 0
                key = np.where(bad, 2, (src > 0).astype(np.int64))
                order = np.argsort(key, axis=1, kind="stable")
                dep = np.take_along_axis((src << PEER_SHIFT) | idx, order, 1)
                key = np.take_along_axis(key, order, 1)
                n_local = (key == 0).sum(1)
                n_remote = (key == 1).sum(1)
                if (n_local + n_remote).max() > REC - REC_DEPS:
                    raise ValueError(f"a tile of shard {d} waits on "
                                     f"{(n_local + n_remote).max()} tiles, "
                                     f"more than {REC - REC_DEPS}")
                rec = np.zeros((tiles_x, REC), dtype=np.int64)
                rec[:, 0] = where[d]
                rec[:, 1] = ty * tiles_x + np.arange(tiles_x)
                rec[:, 2] = ty * t
                rec[:, 3] = x0
                rec[:, 4] = min(t, h - ty * t)
                rec[:, 5] = np.minimum(tw, nx - x0)
                n = len(rows)
                push = ((ty * t + rec[:, 4] > h - k)
                        & (card_of[(d + 1) % n] != card)) | (
                    (ty * t < k) & (card_of[(d - 1) % n] != card))
                rec[:, 6] = (push * PUSH_REMOTE
                             + (n_remote > 0) * READ_REMOTE)
                rec[:, 7] = n_local | n_remote << 8
                m = min(dep.shape[1], REC - REC_DEPS)
                rec[:, REC_DEPS:REC_DEPS + m] = np.where(
                    key[:, :m] < 2, dep[:, :m], 0)
                recs.append(rec)
        if len(peers) > MAX_PEERS:
            raise ValueError(f"K6: the shards on {card} wait on flags of "
                             f"{len(peers)} cards, at most {MAX_PEERS}")
        out[card] = (np.concatenate(recs).astype(np.int32), peers)
    return out


def slot(buf, parity: int, k: int, nx: int):
    """The (9, k, nx) slab of landing buffer ``buf`` (2, 9 * 8 * nx) in
    slot ``parity``."""
    return buf[parity, :9 * k * nx].view(9, k, nx)


SLOT_BYTES = 9 * SLAB_ROWS * 4      # bytes of one landing slot a column
ALIGN = 256                         # the block's pieces start 256-aligned


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def block_layout(rows, shards, nx: int):
    """Byte offsets in a card's exchange block (one of each process and
    card, ``lbm_ring_p2p_alloc``): the error word at 0, K6's counter words
    (``WAIT_WORDS``) at "waits", the flag array (one int a tile of
    ``shards``, in record order) at "flags", then each shard d's lo and hi
    landing buffers, two slots each, at layout[d]. Returns (layout,
    bytes); every process computes any block's."""
    buf = _up(2 * SLOT_BYTES * nx)
    layout = {"error": 0, "waits": WAITS_AT, "flags": ALIGN}
    at = ALIGN + _up(4 * sum(ntiles(rows[d], nx) for d in shards))
    for d in shards:
        layout[d] = (at, at + buf)
        at += 2 * buf
    return layout, at


class Exchange:
    """The landing slots, flags, error words, tile graphs and epoch of a
    p2p ring over ``mesh`` (shard d on mesh[d], ``rows[d]`` rows of ``nx``
    columns; ``None`` for a shard of another process, whose ``transport``
    the ring's, ``dist.multihost.Transport``). Made once a runner, by every
    process of the ring alike.

    On the CPU the slots are tensors, ``land_lo[j]`` and ``land_hi[j]`` of
    this process's j-th shard. On the card each (process, card) holds one
    block (``block_layout``) of its shards' slots, its flag array and its
    error word. Shards are keyed by (process, card), so a shard of another
    process counts as another card even on the same physical card: its
    flags and slots are reached through a CUDA IPC mapping, at system
    scope. Over several processes the blocks' IPC handles are gathered
    once, and each process maps the blocks of its shards' neighbours in
    other processes on the card of the shard beside them (the span
    ``lbm.dist.ipc_open``), once for each of this process's cards that a
    neighbour's tiles reach from; neighbour cards of one process get peer
    access (raising, with the two cards, where it is refused). The
    addresses of a block are taken as one card sees them (``via``, the
    (process, card) key of the card whose launch uses them): its own
    allocation, or that card's mapping of it."""

    def __init__(self, mesh, rows, nx: int, transport=None):
        self.mesh, self.rows, self.nx = list(mesh), list(rows), nx
        self.tr = transport or multihost.Transport(self.mesh)
        self.local, self.world = self.tr.local, self.tr.world
        self.index = {d: j for j, d in enumerate(self.local)}
        self.epoch = 0
        self.failed = False
        self.k_last = None
        self.graphs = {}
        n = len(self.mesh)
        if self.mesh[self.local[0]].type != "cuda":
            self._cpu_slots()
            return
        places = (self.tr.places() if self.world > 1
                  else [(0, multihost.card(d)[0]) for d in self.mesh])
        self.keys = [tuple(pl[:2]) for pl in places]
        self.cards = list(dict.fromkeys(self.keys[d] for d in self.local))
        self.device = {self.keys[d]: self.mesh[d] for d in self.local}
        self.on = {key: [d for d in range(n) if self.keys[d] == key]
                   for key in set(self.keys)}
        lib = _build.library()
        for d in self.local:
            for e in self._neighbours(d):
                a, b = self.mesh[d], self.mesh[e]
                if b is not None and a != b:
                    enable_peer(lib, a.index, b.index)
        self.blocks, self.mapped, handles, own = {}, {}, {}, []
        self.counted = {key: np.zeros(len(WAIT_WORDS), dtype=np.uint64)
                        for key in self.cards}
        for key in self.cards:
            layout, size = self._layout(self.on[key])
            ptr, handle = alloc_block(self.device[key], size,
                                      export=self.world > 1)
            self.blocks[key] = (ptr, layout)
            handles[key] = handle
            own.append((_index(self.device[key]), ptr))
        if self.world == 1:
            weakref.finalize(self, _free_blocks, own).atexit = False
            return
        with span("lbm.dist.ipc_open"):
            self.opened = self._open(places, handles)
        multihost.at_shutdown(lambda: self.close(own))

    def _cpu_slots(self) -> None:
        """The landing buffers of the plain version, per local shard."""
        self.land_lo = [torch.zeros((2, 9 * SLAB_ROWS * self.nx))
                        for _ in self.local]
        self.land_hi = [torch.zeros((2, 9 * SLAB_ROWS * self.nx))
                        for _ in self.local]

    def _neighbours(self, d: int):
        """The shards whose slots and flags shard d's tiles reach."""
        n = len(self.mesh)
        return (d - 1) % n, (d + 1) % n

    def _layout(self, shards):
        return block_layout(self.rows, shards, self.nx)

    def _tile_graph(self, k: int):
        return tile_graph(self.keys, self.rows, self.nx, k)

    def _open(self, places, handles):
        """Map the blocks of this process's shards' neighbours in other
        processes (the handles gathered from every process), on each card
        of a shard beside them (``self.mapped[via, key]``); returns
        [(device index, mapping)]."""
        every = {}
        for part in self.tr.all_gather_object(handles):
            every.update(part)
        visible = multihost.visible_cards()
        opened = []
        for d in self.local:
            via = self.keys[d]
            for e in self._neighbours(d):
                key = self.keys[e]
                if self.tr.is_local(e) or (via, key) in self.mapped:
                    continue
                dev = self.mesh[d]
                if places[e][2] not in visible:
                    raise ValueError(
                        f"cuda-p2p across processes: shard {e} of process "
                        f"{key[0]} lies on card {places[e][2]}, which this "
                        f"process cannot see (CUDA_VISIBLE_DEVICES="
                        f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); every "
                        f"neighbour's card must be visible in each process")
                ptr = open_block(dev, every[key])
                opened.append((_index(dev), ptr))
                self.mapped[via, key] = (ptr, self._layout(self.on[key])[0])
        return opened

    def close(self, own) -> None:
        """Unmap the neighbours' blocks, wait for every process to do the
        same, then free this process's blocks (``dist.multihost.shutdown``
        calls it on every process). After a failed launch it frees nothing:
        another process may still run into the blocks."""
        for dev in dict.fromkeys(self.device.values()):
            torch.cuda.synchronize(dev)
        for index, ptr in self.opened:
            close_block(index, ptr)
        if self.failed:
            return
        self.tr.barrier()
        _free_blocks(own)

    def _block(self, key, via):
        """(address, layout) of ``key``'s block as card ``via`` sees it."""
        if key in self.blocks:
            return self.blocks[key]
        return self.mapped[via, key]

    def slots(self, d: int, via=None):
        """(lo, hi): the addresses of shard d's landing buffers (slot 0;
        slot 1 follows it), in its block or card ``via``'s mapping of it."""
        ptr, layout = self._block(self.keys[d], via)
        return ptr + layout[d][0], ptr + layout[d][1]

    def flags(self, key, via=None) -> int:
        ptr, layout = self._block(key, via)
        return ptr + layout["flags"]

    def error(self, key) -> int:
        ptr, layout = self.blocks[key]
        return ptr + layout["error"]

    def waits(self, key) -> int:
        ptr, layout = self.blocks[key]
        return ptr + layout["waits"]

    def graph(self, k: int):
        """{this process's card: (its tile graph on the card, the flag
        arrays its records name)} for k steps a chunk (``tile_graph`` keyed
        by (process, card)), made on first use."""
        if k not in self.graphs:
            graphs = self._tile_graph(k)
            self.graphs[k] = {
                key: (torch.from_numpy(graphs[key][0]).to(self.device[key]),
                      np.array([self.flags(p, key) for p in graphs[key][1]],
                               dtype=np.int64))
                for key in self.cards}
        return self.graphs[k]

    def barrier(self) -> None:
        """Order every card's stream of this process after the work issued
        so far on every other: the first chunk of a call reads the
        neighbours' input states, which another card's stream may still be
        writing."""
        devs = list(dict.fromkeys(self.mesh[d] for d in self.local))
        if len(devs) < 2:
            return
        events = {}
        for c in devs:
            events[c] = torch.cuda.Event()
            events[c].record(torch.cuda.current_stream(c))
        for c in devs:
            for o in devs:
                if o != c:
                    torch.cuda.current_stream(c).wait_event(events[o])

    def enter(self, states, k: int) -> None:
        """The first chunk of a launch across processes, in place of its
        reads of the neighbours' states (pull0), which lie in another
        process: as the TPU kernel's entry (pallas_resident_rdma.py:
        127-147), each shard pushes its input's last k rows into the next
        shard's lo slot and its first k rows into the previous shard's hi
        slot, of the launch's first epoch's parity (a copy on its card's
        stream, after the launch that wrote the input). Then the entry
        order: every card of this process synchronised and a host barrier,
        so no launch reads a slot before every process's pushes landed.

        The order before a push needs no host step: the slot it writes was
        last read two epochs earlier by the neighbour's tiles within k of
        the seam, and this shard's launch of the epoch between (which its
        stream ran to the end before the push) waited on exactly those
        tiles' flags. A call ends in ``check``'s host OR besides."""
        n, nx, parity = len(self.mesh), self.nx, self.epoch % 2
        width = k * nx * 4          # bytes of a slab's plane
        for j, d in enumerate(self.local):
            h, src, via = self.rows[d], states[j].data_ptr(), self.keys[d]
            lo = self.slots((d + 1) % n, via)[0] + parity * SLOT_BYTES * nx
            hi = self.slots((d - 1) % n, via)[1] + parity * SLOT_BYTES * nx
            for dst, off in ((lo, (h - k) * nx * 4), (hi, 0)):
                copy_rows(dst, width, src + off, h * nx * 4, width, 9,
                          states[j].device)
        for dev in dict.fromkeys(self.device.values()):
            torch.cuda.synchronize(dev)
        self.tr.barrier()

    def check(self) -> None:
        """Raise where a card's error word is set: a wait of K6 ran out
        (csrc/ring_p2p.cu::kSpinNs). Reads this process's words to the host
        (after its launches), each card's error word and counter words in
        one copy (the span ``lbm.dist.check``), and adds what the counters
        gained since the last read to ``WAITS``; over several processes the
        flags are ORed over the host group, so every process raises
        together, and when it returns no launch of the call runs on any
        process."""
        if self.mesh[self.local[0]].type != "cuda":
            return
        bad = []
        n = len(WAIT_WORDS)
        with span("lbm.dist.check"):
            for key in self.cards:
                # the error word (int32, then padding) and the counters
                head = np.zeros(1 + n, dtype=np.uint64)
                copy_bytes(head.ctypes.data, self.error(key),
                           WAITS_AT + 8 * n, self.device[key])
                if head[:1].view(np.int32)[0]:
                    bad.append(str(self.device[key]))
                self.counted[key] = _count_waits(self.device[key], head[1:],
                                                 self.counted[key])
        if self.tr.any(bool(bad)):
            self.failed = True
            raise RuntimeError(
                f"lbm_ring_p2p: a wait on a neighbour's flag ran out on "
                f"{', '.join(bad) or 'a card of another process'}; the "
                f"ring's state is lost")


def _count_waits(device, words, counted):
    """Add what a card's counter words (``WAIT_WORDS``, uint64) gained
    since ``counted`` to ``WAITS``; returns the words, the next call's
    ``counted``."""
    card = WAITS.setdefault(_index(device), dict.fromkeys(WAIT_WORDS, 0))
    for word, value in zip(WAIT_WORDS, (words - counted).tolist()):
        card[word] += value
    return words


def enable_peer(lib, a: int, b: int) -> None:
    """Let card a read and write card b's memory (K6's peer slots and
    flags), or raise naming both."""
    code = lib.lbm_ring_p2p_enable_peer(a, b)
    if code:
        raise RuntimeError(
            f"lbm_ring_p2p: cuda:{a} cannot access cuda:{b}'s memory (CUDA "
            f"error {code}, {lib.lbm_error_string(code).decode()}): the "
            f"cuda-p2p ring needs peer access between neighbour cards")


def alloc_block(device, nbytes: int, export: bool = False):
    """A zeroed exchange block of ``nbytes`` on a card (``cudaMalloc``,
    not PyTorch's allocator): (its address, its IPC handle as bytes where
    ``export``, else None)."""
    lib = _build.library()
    ptr = ctypes.c_void_p()
    handle = (ctypes.create_string_buffer(lib.lbm_ring_p2p_handle_bytes())
              if export else None)
    _build.check(lib.lbm_ring_p2p_alloc(
        _index(device), nbytes, ctypes.byref(ptr),
        ctypes.addressof(handle) if export else None),
        f"lbm_ring_p2p_alloc ({nbytes} bytes on {device})")
    return ptr.value, (handle.raw if export else None)


def open_block(device, handle: bytes) -> int:
    """The address of another process's block (its IPC handle), mapped
    into this process for ``device``."""
    lib = _build.library()
    ptr = ctypes.c_void_p()
    buf = ctypes.create_string_buffer(handle, len(handle))
    _build.check(lib.lbm_ring_p2p_open(_index(device),
                                       ctypes.addressof(buf),
                                       ctypes.byref(ptr)),
                 f"lbm_ring_p2p_open (on {device})")
    return ptr.value


def close_block(device, ptr: int) -> None:
    """Unmap a block of ``open_block``."""
    lib = _build.library()
    _build.check(lib.lbm_ring_p2p_close(_index(device), ptr),
                 f"lbm_ring_p2p_close (on {device})")


def _index(device) -> int:
    """A card's device index (an int stays as it is)."""
    if isinstance(device, int):
        return device
    return multihost.card(torch.device(device))[0]


def _free_blocks(blocks) -> None:
    """Free [(device index, address)] of ``alloc_block``."""
    lib = _build.library()
    for index, ptr in blocks:
        _build.check(lib.lbm_ring_p2p_free(index, ptr), "lbm_ring_p2p_free")


def copy_rows(dst: int, dpitch: int, src: int, spitch: int, width: int,
              rows: int, device) -> None:
    """``rows`` rows of ``width`` bytes from address src (rows ``spitch``
    bytes apart) to dst (``dpitch`` apart), on ``device``'s current stream;
    either side a block, a mapping, a tensor's storage or host memory."""
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        _build.check(lib.lbm_ring_p2p_copy(dst, dpitch, src, spitch, width,
                                           rows, stream.cuda_stream),
                     f"lbm_ring_p2p_copy ({rows} x {width} B on {device})")


def copy_bytes(dst: int, src: int, nbytes: int, device) -> None:
    """``copy_rows`` of one row of ``nbytes``, then the stream
    synchronised."""
    copy_rows(dst, nbytes, src, nbytes, nbytes, 1, device)
    torch.cuda.current_stream(device).synchronize()


def p2p_chunks_ref(states, bands, land_lo, land_hi, params: LBMParams,
                   k: int, n_outer: int, base: int, row_bases, pull0: bool,
                   transport=None):
    """Plain version of ``p2p_chunks`` over every shard of the ring (or,
    with a ``transport`` of several processes, over this process's shards,
    every list in ``transport.local``'s order): ``n_outer`` chunks of
    ``kstep_tile.ring_chunk_ref``. Chunk c (epoch base + c) steps shard d
    from its lo and hi slabs: the previous shard's last k rows and the next
    shard's first k rows, where ``pull0`` and c = 0, else slot (base + c) %
    2 of ``land_lo[d]`` and ``land_hi[d]``; then writes each shard's last k
    rows into the next shard's lo slot and its first k rows into the
    previous shard's hi slot of parity (base + c + 1) % 2. A slab of a
    shard in another process comes through the transport, in its fixed
    order (``dist.multihost.ring_pieces``). ``bands[d]`` is shard d's
    (h + 2k, nx) mask band, band row 0 global row ``row_bases[d]``. Returns
    (the states after n_outer chunks, per shard the (n_outer k,) per-step
    sums); updates the landing buffers in place."""
    nx = params.nx

    def edges(f):
        """Per shard of f: (the previous shard's last k rows, the next
        shard's first k rows)."""
        if transport is None:
            n = len(f)
            return [(f[d - 1][:, -k:], f[(d + 1) % n][:, :k])
                    for d in range(n)]
        n = len(transport.devices)
        halo = transport.move(multihost.ring_pieces(k, n, (9,), nx),
                              multihost.by_shard(transport.local, f, n))
        return [(halo[2 * d], halo[2 * d + 1]) for d in transport.local]

    f, sums = list(states), [[] for _ in states]
    first = edges(f) if pull0 else None
    for c in range(n_outer):
        e = base + c
        new = []
        for j in range(len(f)):
            if pull0 and c == 0:
                lo, hi = first[j]
            else:
                lo = slot(land_lo[j], e % 2, k, nx)
                hi = slot(land_hi[j], e % 2, k, nx)
            g, s = kstep_tile.ring_chunk_ref(lo, f[j], hi, bands[j], params,
                                             k, row_bases[j])
            new.append(g)
            sums[j].append(s)
        for j, (lo, hi) in enumerate(edges(new)):
            slot(land_lo[j], (e + 1) % 2, k, nx).copy_(lo)
            slot(land_hi[j], (e + 1) % 2, k, nx).copy_(hi)
        f = new
    return f, [torch.cat(s) for s in sums]


def p2p_chunks(ex: Exchange, states, spares, bands, params: LBMParams,
               k: int, n_outer: int, row_bases, pull0: bool):
    """``n_outer`` chunks of k steps of this process's shards of ``ex``'s
    ring from ``states`` (lists in ``ex.local``'s order, shard d on
    ex.mesh[d]), epochs ex.epoch onwards; advances ex.epoch. ``spares``: a
    second buffer a shard, which the launch ping-pongs with the state. One
    K6 launch a card, on its current stream; on CPU tensors,
    ``p2p_chunks_ref`` (its slabs across processes through ``ex.tr``).
    Returns (the states, the buffers now free, per shard the (n_outer k,)
    raw per-step sums)."""
    if states[0].device.type == "cpu":
        f, sums = p2p_chunks_ref(states, bands, ex.land_lo, ex.land_hi,
                                 params, k, n_outer, ex.epoch, row_bases,
                                 pull0, ex.tr if ex.world > 1 else None)
        ex.epoch += n_outer
        return f, list(states), sums
    sums = _p2p_launch(ex, states, spares, bands, params, k, n_outer,
                       row_bases, pull0)[0]
    if n_outer % 2:
        return list(spares), list(states), sums
    return list(states), list(spares), sums


def _p2p_launch(ex: Exchange, states, spares, bands, params: LBMParams,
                k: int, n_outer: int, row_bases, pull0: bool):
    """K6 on this process's CUDA shards (lists in ``ex.local``'s order),
    one launch a card: (per shard the sums, per shard the (n_outer k,
    ntiles) partials that the kernel reduced into them). Over several
    processes a launch with ``pull0`` runs ``ex.enter`` and reads the slots
    instead; in one process a launch of another k than the one before it
    is ordered after every card's launch before it (``ex.barrier``): its
    tiles wait only on their k-cone, narrower than the cone of the reads
    of the launch before, whose slots its pushes rewrite."""
    n, nx, rows = len(ex.mesh), params.nx, ex.rows
    if ex.failed:
        raise RuntimeError("lbm_ring_p2p: an earlier launch of this ring "
                           "failed; its flags and ticket counters are lost")
    if not (1 <= k <= kstep_tile.TILE_K and 1 <= n_outer <= MAX_OUTER
            and k <= min(rows) and n >= 2 and len(states) == len(ex.local)):
        raise ValueError(f"K6 takes 1 to {kstep_tile.TILE_K} steps over "
                         f"shards of at least k rows and 1 to {MAX_OUTER} "
                         f"chunks, got k {k}, {n_outer} chunks, rows {rows}, "
                         f"{len(states)} states for {len(ex.local)} shards")
    for j, d in enumerate(ex.local):
        _build.require_cuda(states[j], spares[j], bands[j])
        if (states[j].device != ex.mesh[d]
                or states[j].shape != (9, rows[d], nx)
                or spares[j].shape != states[j].shape
                or spares[j].data_ptr() == states[j].data_ptr()
                or bands[j].shape != (rows[d] + 2 * k, nx)
                or not 0 <= row_bases[j] < params.ny):
            raise ValueError(
                f"shard {d}: state {tuple(states[j].shape)} on "
                f"{states[j].device}, spare {tuple(spares[j].shape)}, mask "
                f"{tuple(bands[j].shape)}, row {row_bases[j]}; the ring "
                f"wants {rows[d]} rows of the ({params.ny}, {nx}) grid on "
                f"{ex.mesh[d]} and a distinct spare")
    if pull0 and ex.world > 1:
        ex.enter(states, k)
        pull0 = False
    elif ex.k_last not in (None, k):
        ex.barrier()
    ex.k_last = k
    lib = _build.library()
    partials = [torch.empty((n_outer * k, ntiles(rows[d], nx)),
                            dtype=torch.float32, device=ex.mesh[d])
                for d in ex.local]
    sums = [torch.empty(n_outer * k, dtype=torch.float32, device=ex.mesh[d])
            for d in ex.local]
    graph = ex.graph(k)
    for card in ex.cards:
        local = [j for j, d in enumerate(ex.local) if ex.keys[d] == card]
        if len(local) > MAX_LOCAL:
            raise ValueError(f"K6 takes at most {MAX_LOCAL} shards a card, "
                             f"got {len(local)} on {ex.device[card]}")
        table = np.array([_entry(ex, states, spares, bands, partials, sums,
                                 row_bases, j) for j in local],
                         dtype=np.int64)
        records, peer_flags = graph[card]
        dev = ex.device[card]
        with _build.on_device(states[local[0]]):
            _build.LAUNCHES["ring_p2p"] += 1
            _build.LAUNCHES["reduce_partials"] += n_outer * len(local)
            _build.check(
                lib.lbm_ring_p2p(
                    table.ctypes.data, len(local), records.data_ptr(),
                    records.shape[0], peer_flags.ctypes.data,
                    len(peer_flags), n_outer, ex.epoch,
                    int(pull0), ex.error(card), ex.waits(card),
                    _build.ticket_counter(dev).data_ptr(), params.ny, nx,
                    params.accel_row, params.omega, params.accel_w1,
                    params.accel_w2, k,
                    torch.cuda.current_stream(dev).cuda_stream),
                f"lbm_ring_p2p ({k} steps, {n_outer} chunks, "
                f"{len(local)} shards on {dev}, "
                f"{lib.lbm_ring_p2p_smem(k)} B of dynamic shared memory)")
    ex.epoch += n_outer
    return sums, partials


def _entry(ex: Exchange, states, spares, bands, partials, sums, row_bases,
           j):
    """The words of this process's j-th shard d in the launch table, in
    TABLE's order: its buffers, its neighbours' input states (read only
    with pull0, in one process; the own slots where a neighbour lies in
    another process), its and its neighbours' landing buffers (peer or
    IPC-mapped addresses where they lie on another card or in another
    process), then its integers."""
    n, d = len(ex.mesh), ex.local[j]
    p, q = (d - 1) % n, (d + 1) % n
    lo, hi = ex.slots(d)
    slot_bytes = SLOT_BYTES * ex.nx

    def state(e, own):
        return states[ex.index[e]].data_ptr() if e in ex.index else own

    words = dict(
        obst=bands[j].data_ptr(), state0=states[j].data_ptr(),
        state1=spares[j].data_ptr(), prev_in=state(p, lo),
        next_in=state(q, hi), partials=partials[j].data_ptr(),
        sums=sums[j].data_ptr(), h=ex.rows[d], h_prev=ex.rows[p],
        h_next=ex.rows[q], row_base=row_bases[j])
    via = ex.keys[d]
    for name, base in (("lo", lo), ("hi", hi),
                       ("push_lo", ex.slots(q, via)[0]),
                       ("push_hi", ex.slots(p, via)[1])):
        words[name + "0"], words[name + "1"] = base, base + slot_bytes
    return [words[name] for name in TABLE]


# Torus mode (csrc/ring_p2p.cu::lbm_torus_p2p): the (h, w) blocks of a
# dy x dx torus, in one process or across processes.
MAX_TORUS_LOCAL = 64   # blocks of one launch on one card (kMaxTorusLocal)
# The neighbours of block (i, j), (di, dj) (csrc/ring_p2p.cu::Nbr): left,
# right, up, down, up-left, up-right, down-left, down-right.
NEIGHBOURS = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1),
              (1, 1))
NBR_NAMES = ("w", "e", "n", "s", "nw", "ne", "sw", "se")
# The pushes of a block after each chunk (csrc/ring_p2p.cu::Push): (the
# landing buffer, the neighbour (di, dj) that holds it). The block's cells
# in its last k rows (di = 1), its first k (di = -1) or all rows (di = 0),
# and likewise in columns by dj, go to the buffer's slot of the next
# epoch's parity: an x slot's k columns beside the block, a y slot's middle
# w columns (dj = 0) or its margin columns beside them (a corner).
TORUS_PUSHES = (("xlo", 0, 1), ("xhi", 0, -1), ("ylo", 1, 0), ("yhi", -1, 0),
                ("ylo", 1, 1), ("ylo", 1, -1), ("yhi", -1, 1),
                ("yhi", -1, -1))
# Words of a block's entry in lbm_torus_p2p's table (kTorusWords): its
# buffers, the neighbours' input states (NBR_NAMES), its own landing
# buffers, the pushes' landing buffers (TORUS_PUSHES, named by the
# neighbour), its first band row's global row.
PUSH_NAMES = ("e", "w", "s", "n", "se", "sw", "ne", "nw")
TORUS_TABLE = ("obst", "state0", "state1", "partials", "sums",
               *(f"in_{n}" for n in NBR_NAMES), "xlo", "xhi", "ylo", "yhi",
               *(f"to_{n}" for n in PUSH_NAMES), "row_base")
TORUS_BUFFERS = ("xlo", "xhi", "ylo", "yhi")


def torus_neighbour(b: int, di: int, dj: int, dy: int, dx: int) -> int:
    """The row-major index of block b's neighbour (di, dj) on the torus."""
    i, j = divmod(b, dx)
    return ((i + di) % dy) * dx + (j + dj) % dx


def _band_tiles(n_blocks: int, size: int, t: int):
    """(first cell, cells) of every tile row (or column) of n_blocks blocks
    of `size` rows (columns) side by side, in global order."""
    first = [b * size + u * t for b in range(n_blocks)
             for u in range(-(-size // t))]
    return (np.array(first, dtype=np.int64),
            np.array([min(t, size - u * t) for _ in range(n_blocks)
                      for u in range(-(-size // t))], dtype=np.int64))


def _padded(rel):
    """Per row of a bool relation, its true columns, padded with -1."""
    idx = [np.flatnonzero(r) for r in rel]
    width = max(map(len, idx))
    return np.array([list(i) + [-1] * (width - len(i)) for i in idx])


def torus_peers(keys2d) -> dict:
    """{card key: the card keys whose flag arrays the records of its blocks
    name, its own first} for the torus whose block (i, j) lies on card key
    keys2d[i][j]: the keys of its blocks and of their eight neighbours, in
    row-major order. A tile waits only on tiles of its block and of the
    eight neighbour blocks (k <= min(h, w)), and on a tile of each of them
    (the neighbours' edge tiles lie within one cell), whatever k."""
    dy, dx = len(keys2d), len(keys2d[0])
    keys = [c for row in keys2d for c in row]
    out = {}
    for b, key in enumerate(keys):
        peers = out.setdefault(key, [key])
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                e = keys[torus_neighbour(b, di, dj, dy, dx)]
                if e not in peers:
                    peers.append(e)
    return out


def torus_refusal(keys2d) -> str:
    """Why torus mode cannot run the torus whose block (i, j) lies on card
    key keys2d[i][j] ((process, card index)): a card of more than
    MAX_TORUS_LOCAL blocks (one launch holds every block of its card: its
    tiles wait on each other's flags), or one whose blocks' records name
    more than MAX_TORUS_PEERS flag arrays (``torus_peers``); "" where it
    can. ``dist.runner.make_runner`` asks it when it builds the runner."""
    keys = [c for row in keys2d for c in row]
    for key in dict.fromkeys(keys):
        if keys.count(key) > MAX_TORUS_LOCAL:
            return (f"{keys.count(key)} blocks on {_key_text(key)}, at most "
                    f"{MAX_TORUS_LOCAL} a card")
    for key, peers in torus_peers(keys2d).items():
        if len(peers) > MAX_TORUS_PEERS:
            return (f"the blocks on {_key_text(key)} wait on the flag arrays "
                    f"of {len(peers)} (process, card)s, at most "
                    f"{MAX_TORUS_PEERS}")
    return ""


def _key_text(key) -> str:
    return f"(process {key[0]}, cuda:{key[1]})"


def torus_graph(mesh2d, h: int, w: int, k: int, t: int = TILE):
    """Each card's tile graph for torus mode: {card: (records, peers)}, as
    ``tile_graph``. ``mesh2d``: the dy x dx card keys of the blocks. A tile
    waits on every tile with owned cells within k cells of its own on the
    global (dy h, dx w) grid, both axes wrapping: tiles of its block and of
    the x, y and diagonal neighbour blocks, on this card or another (a
    symmetric relation, the product of one on tile rows and one on tile
    columns). Records in walk order: the card's blocks row-major, tiles
    row-major; HEADER's block is the launch index. Duties: PUSH_REMOTE where
    one of the tile's pushes (TORUS_PUSHES whose cells it owns) lands on
    another card, READ_REMOTE where a tile on another card waits on it.
    peers: ``torus_peers``'s (1 <= k <= min(h, w))."""
    dy, dx = len(mesh2d), len(mesh2d[0])
    if not 1 <= k <= min(h, w):
        raise ValueError(f"torus mode takes 1 <= k <= min(h, w), got k {k} "
                         f"for ({h}, {w}) blocks")
    keys = [c for row in mesh2d for c in row]
    cards = list(dict.fromkeys(keys))
    card_of = np.array([cards.index(c) for c in keys])
    peer_keys = torus_peers(mesh2d)
    ty_n, tx_n = -(-h // t), -(-w // t)
    nt = ty_n * tx_n
    r0, rl = _band_tiles(dy, h, t)
    c0, cl = _band_tiles(dx, w, t)
    rows = _padded(_touch(r0, rl, r0, rl, dy * h, k))
    cols = _padded(_touch(c0, cl, c0, cl, dx * w, k))
    flag0 = np.zeros(len(keys), dtype=np.int64)
    launch = np.zeros(len(keys), dtype=np.int64)
    for c in range(len(cards)):
        on = np.flatnonzero(card_of == c)
        flag0[on] = np.arange(len(on)) * nt
        launch[on] = np.arange(len(on))
    tile = np.arange(nt)
    ty, tx = tile // tx_n, tile % tx_n
    y0, x0 = ty * t, tx * t
    own_r, own_c = np.minimum(t, h - y0), np.minimum(t, w - x0)
    # the tiles whose cells a push (di, dj) takes: rows by di, columns by dj
    rows_own = {0: np.ones(nt, bool), 1: y0 + own_r > h - k, -1: y0 < k}
    cols_own = {0: np.ones(nt, bool), 1: x0 + own_c > w - k, -1: x0 < k}
    out = {}
    for c, card in enumerate(cards):
        peers = [cards.index(e) for e in peer_keys[card]]
        pidx = np.zeros(len(cards), dtype=np.int64)
        pidx[peers] = np.arange(len(peers))
        recs = []
        for b in np.flatnonzero(card_of == c):
            i, j = divmod(int(b), dx)
            gr = rows[i * ty_n + ty]               # (nt, WR) global tile rows
            gc = cols[j * tx_n + tx]               # (nt, WC)
            dr = np.repeat(gr, gc.shape[1], axis=1)
            dc = np.tile(gc, (1, gr.shape[1]))
            bad = (dr < 0) | (dc < 0)
            dr, dc = np.where(bad, 0, dr), np.where(bad, 0, dc)
            blk = (dr // ty_n) * dx + dc // tx_n
            ut = (dr % ty_n) * tx_n + dc % tx_n
            dcard = card_of[blk]
            key = np.where(bad, 2, (dcard != c).astype(np.int64))
            order = np.argsort(key, axis=1, kind="stable")
            dep = np.take_along_axis(
                (pidx[dcard] << PEER_SHIFT) | (flag0[blk] + ut), order, 1)
            key = np.take_along_axis(key, order, 1)
            n_local = (key == 0).sum(1)
            n_remote = (key == 1).sum(1)
            if (n_local + n_remote).max() > REC - REC_DEPS:
                raise ValueError(f"a tile of block {b} waits on "
                                 f"{(n_local + n_remote).max()} tiles, more "
                                 f"than {REC - REC_DEPS}")
            push = np.zeros(nt, bool)
            for _, di, dj in TORUS_PUSHES:
                dest = card_of[torus_neighbour(b, di, dj, dy, dx)]
                push |= rows_own[di] & cols_own[dj] & (dest != c)
            rec = np.zeros((nt, REC), dtype=np.int64)
            rec[:, 0] = launch[b]
            rec[:, 1] = tile
            rec[:, 2] = y0
            rec[:, 3] = x0
            rec[:, 4] = own_r
            rec[:, 5] = own_c
            rec[:, 6] = push * PUSH_REMOTE + (n_remote > 0) * READ_REMOTE
            rec[:, 7] = n_local | n_remote << 8
            m = min(dep.shape[1], REC - REC_DEPS)
            rec[:, REC_DEPS:REC_DEPS + m] = np.where(key[:, :m] < 2,
                                                     dep[:, :m], 0)
            recs.append(rec)
        out[card] = (np.concatenate(recs).astype(np.int32), peer_keys[card])
    return out


def xslot(buf, parity: int, k: int, h: int):
    """The (9, h, col_margin(k)) x slot of landing buffer ``buf`` (2,
    9 * h * 8) in slot ``parity``."""
    kx = kstep_tile.col_margin(k)
    return buf[parity, :9 * h * kx].view(9, h, kx)


def yslot(buf, parity: int, k: int, w: int):
    """The (9, k, w + 2 col_margin(k)) y slot of landing buffer ``buf`` (2,
    9 * 8 * (w + 16)) in slot ``parity``."""
    xw = w + 2 * kstep_tile.col_margin(k)
    return buf[parity, :9 * k * xw].view(9, k, xw)


def torus_buffer_floats(h: int, w: int):
    """{buffer: floats of one of its two slots} of a block's landing
    buffers."""
    x, y = 9 * h * SLAB_ROWS, 9 * SLAB_ROWS * (w + 2 * SLAB_ROWS)
    return {"xlo": x, "xhi": x, "ylo": y, "yhi": y}


def torus_block_layout(blocks, h: int, w: int):
    """Byte offsets in a card's exchange block for torus mode: the error
    word at 0, the counter words at "waits", the flag array (one int a tile
    of ``blocks``, in walk order) at "flags", then each block b's four
    landing buffers, two slots each, at layout[b] ({buffer: offset}).
    Returns (layout, bytes)."""
    layout = {"error": 0, "waits": WAITS_AT, "flags": ALIGN}
    at = ALIGN + _up(4 * ntiles(h, w) * len(blocks))
    floats = torus_buffer_floats(h, w)
    for b in blocks:
        layout[b] = {}
        for name in TORUS_BUFFERS:
            layout[b][name] = at
            at += _up(2 * 4 * floats[name])
    return layout, at


class TorusExchange(Exchange):
    """The landing slots, flags, error words, tile graphs and epoch of the
    torus over the dy x dx ``mesh2d`` of (h, w) blocks (block (i, j) on
    mesh2d[i][j]; ``None`` for a block of another process, whose
    ``transport`` the torus's): ``Exchange`` with four landing buffers a
    block (xlo, xhi, ylo, yhi, two slots each) and ``torus_graph``. On the
    CPU the slots are tensors, ``land[j][buffer]`` of this process's j-th
    block. The cards of a block's eight neighbours get peer access
    (raising, with the two cards, where it is refused); across processes
    the neighbours' blocks are mapped as the ring's."""

    def __init__(self, mesh2d, h: int, w: int, transport=None):
        self.dy, self.dx, self.h, self.w = len(mesh2d), len(mesh2d[0]), h, w
        flat = [d for row in mesh2d for d in row]
        super().__init__(flat, [h] * len(flat), w, transport)

    def _cpu_slots(self) -> None:
        floats = torus_buffer_floats(self.h, self.w)
        self.land = [{name: torch.zeros((2, floats[name]))
                      for name in TORUS_BUFFERS} for _ in self.local]

    def _neighbours(self, b: int):
        return [torus_neighbour(b, di, dj, self.dy, self.dx)
                for di, dj in NEIGHBOURS]

    def _layout(self, blocks):
        return torus_block_layout(blocks, self.h, self.w)

    def _tile_graph(self, k: int):
        keys = [self.keys[i * self.dx:(i + 1) * self.dx]
                for i in range(self.dy)]
        return torus_graph(keys, self.h, self.w, k)

    def buffers(self, b: int, via=None):
        """{buffer: address of slot 0} of block b's landing buffers (slot 1
        follows torus_buffer_floats later), as card ``via`` sees them."""
        ptr, layout = self._block(self.keys[b], via)
        return {name: ptr + off for name, off in layout[b].items()}

    def enter(self, states, k: int) -> None:
        """``Exchange.enter`` for the torus: each of this process's blocks
        pushes its input's pieces into its eight neighbours' slots of the
        launch's first epoch's parity, the cells of the kernel's pushes
        (TORUS_PUSHES): its last and first k columns into the right and
        left neighbours' xlo and xhi, its last and first k rows into the
        lower and upper neighbours' ylo and yhi (the middle w columns), its
        k x k corners into the diagonal neighbours' y slots' margin
        columns; a copy on its card's stream. Then the entry order: every
        card of this process synchronised and a host barrier. The order
        before a push is the ring's: the slot was last read two epochs
        earlier by tiles of the neighbour within one cell of this block,
        which this block's launch of the epoch between waited on."""
        h, w, parity = self.h, self.w, self.epoch % 2
        kx = kstep_tile.col_margin(k)
        yw = w + 2 * kx
        floats = torus_buffer_floats(h, w)
        span = {0: (0, w), 1: (w - k, k), -1: (0, k)}    # columns by dj
        for j, b in enumerate(self.local):
            src, dev, via = states[j].data_ptr(), states[j].device, self.keys[b]
            for buf, di, dj in TORUS_PUSHES:
                e = torus_neighbour(b, di, dj, self.dy, self.dx)
                dst = self.buffers(e, via)[buf] + parity * 4 * floats[buf]
                c0, cols = span[dj]
                if di == 0:
                    # an x slot (9, h, kx): the k columns next to the block
                    at = kx - k if dj == 1 else 0
                    copy_rows(dst + 4 * at, 4 * kx, src + 4 * c0, 4 * w,
                              4 * cols, 9 * h, dev)
                    continue
                # a y slot (9, k, w + 2 kx): the middle columns or a margin
                at = {0: kx, 1: kx - k, -1: kx + w}[dj]
                r0 = h - k if di == 1 else 0
                for q in range(9):
                    copy_rows(dst + 4 * (q * k * yw + at), 4 * yw,
                              src + 4 * ((q * h + r0) * w + c0), 4 * w,
                              4 * cols, k, dev)
        for dev in dict.fromkeys(self.device.values()):
            torch.cuda.synchronize(dev)
        self.tr.barrier()


def torus_halo_pieces(k: int, dy: int, dx: int, lead: tuple, h: int, w: int):
    """The pieces that K4's torus mode takes for a chunk of k steps, for
    every block of the dy x dx torus, as ``Transport.move`` pieces (src,
    dst, shape, cut), eight a block in this order: xlo and xhi (the left
    neighbour's last k columns in the last k of col_margin(k) columns, the
    right one's first k in the first, zeros beside them); ylo in three
    parts, the upper-left neighbour's last k rows' last k columns (in
    col_margin(k) columns as xlo), the upper neighbour's last k rows and
    the upper-right's last k rows' first k columns (as xhi); yhi in three
    likewise from the lower neighbours' first k rows. ``lead``: (9,) for
    states, () for masks."""
    kx = kstep_tile.col_margin(k)
    x, y, m = (*lead, h, kx), (*lead, k, kx), (*lead, k, w)

    def lo(t):
        return F.pad(t[..., -k:], (kx - k, 0))

    def hi(t):
        return F.pad(t[..., :k], (0, kx - k))

    def up(cut):
        return lambda t: cut(t[..., -k:, :])

    def down(cut):
        return lambda t: cut(t[..., :k, :])

    def whole(t):
        return t

    out = []
    for b in range(dy * dx):
        def nb(di, dj):
            return torus_neighbour(b, di, dj, dy, dx)

        out += [(nb(0, -1), b, x, lo), (nb(0, 1), b, x, hi),
                (nb(-1, -1), b, y, up(lo)), (nb(-1, 0), b, m, up(whole)),
                (nb(-1, 1), b, y, up(hi)), (nb(1, -1), b, y, down(lo)),
                (nb(1, 0), b, m, down(whole)), (nb(1, 1), b, y, down(hi))]
    return out


def torus_halos(f, dy: int, dx: int, k: int, transport=None):
    """Per block of the row-major blocks ``f`` (or their masks), the four
    pieces that K4's torus mode takes, cut straight from the neighbours
    (``torus_halo_pieces``): xlo, xhi, and ylo, yhi with the diagonal
    neighbours' k x k corners beside the rows (the rows of the x-extended
    bands that the host's two-phase exchange takes), on the block's
    device. With a ``transport``
    of several processes, ``f`` and the result are this process's blocks
    (``transport.local``'s order), the other processes' pieces moved
    through it."""
    n = dy * dx
    h, w = f[0].shape[-2:]
    pieces = torus_halo_pieces(k, dy, dx, tuple(f[0].shape[:-2]), h, w)
    if transport is None:
        got = [cut(f[src]).to(f[dst].device) for src, dst, _, cut in pieces]
        local = range(n)
    else:
        got = transport.move(pieces, multihost.by_shard(transport.local, f,
                                                        n))
        local = transport.local
    out = []
    for b in local:
        xlo, xhi, *y = got[8 * b:8 * b + 8]
        out.append((xlo, xhi, torch.cat(y[:3], dim=-1),
                    torch.cat(y[3:], dim=-1)))
    return out


def torus_p2p_chunks_ref(states, bands, land, params: LBMParams, k: int,
                         n_outer: int, base: int, row_bases, pull0: bool,
                         dy: int, dx: int, transport=None):
    """Plain version of ``torus_p2p_chunks`` over every block of the dy x dx
    torus (row-major lists; or, with a ``transport`` of several processes,
    over this process's blocks, every list in ``transport.local``'s
    order): ``n_outer`` chunks of ``kstep_tile.torus_chunk_ref``. Chunk c
    (epoch base + c) steps block b from its four pieces: ``torus_halos`` of
    the states where ``pull0`` and c = 0, else slot (base + c) % 2 of its
    ``land`` buffers; then writes each block's pieces of the new states
    (``torus_halos``, the other processes' through the transport) into the
    slots of parity (base + c + 1) % 2. ``bands[j]``: the block's (h + 2k,
    w + 2 col_margin(k)) mask band, band row 0 global row ``row_bases[j]``.
    Returns (the states after n_outer chunks, per block the (n_outer k,)
    per-step sums); updates the landing buffers in place."""
    h, w = states[0].shape[1:]
    slot = {"xlo": (xslot, h), "xhi": (xslot, h), "ylo": (yslot, w),
            "yhi": (yslot, w)}

    def view(j, name, parity):
        fn, size = slot[name]
        return fn(land[j][name], parity, k, size)

    f, sums = list(states), [[] for _ in states]
    for c in range(n_outer):
        e = base + c
        if pull0 and c == 0:
            pieces = torus_halos(f, dy, dx, k, transport)
        else:
            pieces = [[view(j, name, e % 2) for name in TORUS_BUFFERS]
                      for j in range(len(f))]
        new = []
        for j, (xlo, xhi, ylo, yhi) in enumerate(pieces):
            g, s = kstep_tile.torus_chunk_ref(xlo, f[j], xhi, ylo, yhi,
                                              bands[j], params, k,
                                              row_bases[j])
            new.append(g)
            sums[j].append(s)
        for j, got in enumerate(torus_halos(new, dy, dx, k, transport)):
            for name, piece in zip(TORUS_BUFFERS, got):
                view(j, name, (e + 1) % 2).copy_(piece)
        f = new
    return f, [torch.cat(s) for s in sums]


def torus_p2p_chunks(ex: TorusExchange, states, spares, bands,
                     params: LBMParams, k: int, n_outer: int, row_bases,
                     pull0: bool):
    """``n_outer`` chunks of k steps of this process's blocks of ``ex``'s
    torus from ``states`` (lists in ``ex.local``'s order, block b on
    ex.mesh[b]), epochs ex.epoch onwards; advances ex.epoch. ``spares``: a
    second buffer a block, which the launch ping-pongs with the state. One
    torus-mode launch of K6 a card (``LAUNCHES["torus_p2p"]``), on its
    current stream; on CPU tensors, ``torus_p2p_chunks_ref`` (its pieces
    across processes through ``ex.tr``). Returns (the states, the buffers
    now free, per block the (n_outer k,) raw per-step sums)."""
    if states[0].device.type == "cpu":
        f, sums = torus_p2p_chunks_ref(states, bands, ex.land, params, k,
                                       n_outer, ex.epoch, row_bases, pull0,
                                       ex.dy, ex.dx,
                                       ex.tr if ex.world > 1 else None)
        ex.epoch += n_outer
        return f, list(states), sums
    sums = _torus_launch(ex, states, spares, bands, params, k, n_outer,
                         row_bases, pull0)[0]
    if n_outer % 2:
        return list(spares), list(states), sums
    return list(states), list(spares), sums


def _torus_launch(ex: TorusExchange, states, spares, bands,
                  params: LBMParams, k: int, n_outer: int, row_bases,
                  pull0: bool):
    """Torus mode of K6 on this process's CUDA blocks (lists in
    ``ex.local``'s order), one launch a card: (per block the sums, per
    block the (n_outer k, ntiles) partials that the kernel reduced into
    them). Each card's table of its blocks goes to the card (pinned, on the
    card's stream) before its launch. Over several processes a launch with
    ``pull0`` runs ``ex.enter`` and reads the slots instead; in one process
    a launch of another k than the one before it is ordered after every
    card's launch before it (``ex.barrier``), as in ``_p2p_launch``."""
    h, w, local = ex.h, ex.w, ex.local
    kx = kstep_tile.col_margin(k)
    if ex.failed:
        raise RuntimeError("lbm_torus_p2p: an earlier launch of this torus "
                           "failed; its flags and ticket counters are lost")
    if not (1 <= k <= kstep_tile.TILE_K and 1 <= n_outer <= MAX_OUTER
            and k <= min(h, w) and len(states) == len(local)):
        raise ValueError(f"torus mode takes 1 to {kstep_tile.TILE_K} steps "
                         f"over blocks of at least k rows and columns and 1 "
                         f"to {MAX_OUTER} chunks, got k {k}, {n_outer} "
                         f"chunks, ({h}, {w}) blocks, {len(states)} states "
                         f"for {len(local)} blocks")
    for j, b in enumerate(local):
        _build.require_cuda(states[j], spares[j], bands[j])
        if (states[j].device != ex.mesh[b] or states[j].shape != (9, h, w)
                or spares[j].shape != states[j].shape
                or spares[j].data_ptr() == states[j].data_ptr()
                or bands[j].shape != (h + 2 * k, w + 2 * kx)
                or not 0 <= row_bases[j] < params.ny):
            raise ValueError(
                f"block {b}: state {tuple(states[j].shape)} on "
                f"{states[j].device}, spare {tuple(spares[j].shape)}, mask "
                f"{tuple(bands[j].shape)}, row {row_bases[j]}; the torus "
                f"wants ({h}, {w}) blocks of the ({params.ny}, {params.nx}) "
                f"grid on {ex.mesh[b]} and a distinct spare")
    if pull0 and ex.world > 1:
        ex.enter(states, k)
        pull0 = False
    elif ex.k_last not in (None, k):
        ex.barrier()
    ex.k_last = k
    lib = _build.library()
    nt = ntiles(h, w)
    partials = [torch.empty((n_outer * k, nt), dtype=torch.float32,
                            device=ex.mesh[b]) for b in local]
    sums = [torch.empty(n_outer * k, dtype=torch.float32, device=ex.mesh[b])
            for b in local]
    graph = ex.graph(k)
    for card in ex.cards:
        on = [j for j, b in enumerate(local) if ex.keys[b] == card]
        table = np.array([_torus_entry(ex, states, spares, bands, partials,
                                       sums, row_bases, j) for j in on],
                         dtype=np.int64)
        records, peer_flags = graph[card]
        dev = ex.device[card]
        with _build.on_device(states[on[0]]):
            on_card = torch.from_numpy(table).pin_memory().to(
                dev, non_blocking=True)
            _build.LAUNCHES["torus_p2p"] += 1
            _build.LAUNCHES["reduce_partials"] += n_outer * len(on)
            _build.check(
                lib.lbm_torus_p2p(
                    table.ctypes.data, on_card.data_ptr(), len(on),
                    records.data_ptr(), records.shape[0],
                    peer_flags.ctypes.data, len(peer_flags), n_outer,
                    ex.epoch, int(pull0), ex.error(card), ex.waits(card),
                    _build.ticket_counter(dev).data_ptr(), params.ny,
                    params.nx, params.accel_row, params.omega,
                    params.accel_w1, params.accel_w2, k, h, w,
                    torch.cuda.current_stream(dev).cuda_stream),
                f"lbm_torus_p2p ({k} steps, {n_outer} chunks, "
                f"{len(on)} ({h}, {w}) blocks on {dev}, "
                f"{lib.lbm_ring_p2p_smem(k)} B of dynamic shared memory)")
    ex.epoch += n_outer
    return sums, partials


def _torus_entry(ex: TorusExchange, states, spares, bands, partials, sums,
                 row_bases, j: int):
    """The words of this process's j-th block b in its card's launch table,
    in TORUS_TABLE's order: its buffers, its eight neighbours' input states
    (read only with pull0, in one process; across processes, where a
    neighbour lies in another, the block's own state stands in), its
    landing buffers, the landing buffers of its pushes (peer or IPC-mapped
    addresses where they lie on another card or in another process), its
    first band row."""
    b = ex.local[j]
    via = ex.keys[b]
    words = dict(obst=bands[j].data_ptr(), state0=states[j].data_ptr(),
                 state1=spares[j].data_ptr(), partials=partials[j].data_ptr(),
                 sums=sums[j].data_ptr(), row_base=row_bases[j],
                 **ex.buffers(b))
    for name, (di, dj) in zip(NBR_NAMES, NEIGHBOURS):
        e = torus_neighbour(b, di, dj, ex.dy, ex.dx)
        words[f"in_{name}"] = states[ex.index.get(e, j)].data_ptr()
    for (buf, di, dj), name in zip(TORUS_PUSHES, PUSH_NAMES):
        e = torus_neighbour(b, di, dj, ex.dy, ex.dx)
        words[f"to_{name}"] = ex.buffers(e, via)[buf]
    return [words[name] for name in TORUS_TABLE]


# The grid kind (csrc/ring_p2p.cu::lbm_grid_p2p): the whole periodic
# (ny, nx) grid of one card, the one-card route outside the resident gate.
# A CTA steps its items as one row wavefront (csrc/wave_step.cuh), items of
# grid_item's shape, at most ITEM_W columns.
ITEM_W = 64             # csrc/wave_step.cuh::kMaxW
# The item shape's rule (grid_item): a chunk of at least GRID_ITEMS items,
# two a CTA of an H100's GRID_CTAS = 132, and of more than GRID_CTAS + 2
# item rows' items, so that in the walk (each chunk starting one item row
# further down) an item's dependencies lie more than a round of GRID_CTAS
# items before it; items of at least MIN_ITEM_H rows and MIN_ITEM_W
# columns. The rule reads the grid's shape alone, so that the item graph
# and the flags are those of the grid on any card.
GRID_CTAS = 132
GRID_ITEMS = 2 * GRID_CTAS
MIN_ITEM_H = 8
MIN_ITEM_W = 16


def item_ratio(h: int, w: int, k: int) -> float:
    """Cell updates computed a cell update owned, for an item of h x w
    owned cells at k steps: level s computes h + 2k - 2s rows of
    w + 2k - 2s columns (csrc/wave_step.cuh). 1.506 for a 32 x 32 tile at
    k = 8, the square window's cone too; 1.236 for 64 x 64."""
    done = sum((h + 2 * k - 2 * s) * (w + 2 * k - 2 * s)
               for s in range(1, k + 1))
    return done / (k * h * w)


def grid_item(ny: int, nx: int, k: int = kstep_tile.TILE_K):
    """The grid kind's item shape for a (ny, nx) grid, from its shape
    alone: (h, w, the updates computed an owned one, item_ratio). Items are
    ITEM_W columns wide where nx allows, and as tall as a chunk of at least
    GRID_ITEMS and more than GRID_CTAS + 2 item rows' items allows: the
    fewest item rows n that give that many, h = ceil(ny / n), so that the
    rows split evenly. Where even items of MIN_ITEM_H rows give fewer, h
    stays at MIN_ITEM_H and w halves, down to MIN_ITEM_W columns."""
    w = ITEM_W
    while True:
        cols = -(-nx // w)
        want = max(GRID_ITEMS, GRID_CTAS + 2 * cols + 1)
        n = max(1, -(-want // cols))
        h = max(MIN_ITEM_H, -(-ny // n))
        if -(-ny // h) * cols >= want or w <= MIN_ITEM_W:
            break
        w //= 2
    return h, w, item_ratio(h, w, k)


def grid_items(ny: int, nx: int) -> int:
    """Items of the grid kind's (ny, nx) grid: the length of its flag array
    and of a row of its partials."""
    h, w, _ = grid_item(ny, nx)
    return -(-ny // h) * -(-nx // w)


def grid_outer_per_launch(ny: int, nx: int, k: int) -> int:
    """Chunks a grid-kind launch of the (ny, nx) grid (outer_per_launch of
    its items)."""
    return outer_per_launch([ny], nx, k, items=grid_items(ny, nx))


def grid_graph(ny: int, nx: int, k: int, shape=None):
    """The grid kind's item graph of the whole periodic (ny, nx) grid:
    (items, REC) int32 records of its items of ``shape`` (h, w) cells
    (``grid_item``'s where None), row-major (the kernel's walk and the flag
    array's order), an item waiting on every item with owned cells within k
    cells of its own, both axes wrapping (a symmetric relation), duties 0.
    It is ``tile_graph``'s of a ring of one shard on one card, whose rows
    wrap modulo ny as its columns modulo nx."""
    h, w = shape or grid_item(ny, nx)[:2]
    return tile_graph([0], [ny], nx, k, h, w)[0][0]


def grid_sums_ref(partials) -> np.ndarray:
    """Plain version of the grid kind's reduction: each row of the
    (rows, items) float32 ``partials`` (one row a step) summed in the order
    of ``csrc/lbm_cell.cuh::reduce_rows``, so the kernel's sums are these
    bits of its partials. Thread i of kReduceThreads = 256 adds entries i,
    i + 256, ... in turn; warps of 32 threads sum by shuffles (lane l adds
    lane l + 16, then l + 8, ... 1); one warp sums the warp sums alike.
    Returns a (rows,) float32 array. (K4 reduces its tiles' partials in the
    same order.)"""
    p = np.asarray(partials, dtype=np.float32)
    rows, n = p.shape
    threads = 256
    v = np.zeros((rows, threads), dtype=np.float32)
    for j in range(0, n, threads):
        part = p[:, j:j + threads]
        v[:, :part.shape[1]] += part
    return _warp_tree(_warp_tree(v.reshape(rows, -1, 32))[..., 0]
                      .reshape(rows, 1, -1))[:, 0, 0]


def _warp_tree(v: np.ndarray) -> np.ndarray:
    """__shfl_down_sync's tree over the last axis (lanes, padded with zeros
    to 32): lane l adds lane l + d for d = 16, 8, 4, 2, 1 (a lane past the
    warp adds its own value, as shfl_down leaves it). Lane 0 holds the
    sum."""
    v = np.concatenate([v, np.zeros(v.shape[:-1] + (32 - v.shape[-1],),
                                    dtype=np.float32)], axis=-1)
    for d in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[..., d:], v[..., 32 - d:]], axis=-1)
    return v


class GridExchange:
    """What the grid kind keeps on one card for one (ny, nx) grid: its item
    shape (``grid_item``: ``h``, ``w``, ``items``); the flag array, one
    int32 an item (row-major); one int64 tensor of the error word (word 0)
    and K6's counter words (``WAIT_WORDS`` after it, at byte ``WAITS_AT``,
    as a card's exchange block holds them); each k's item graph on the card
    (``grid_graph``, made on first use); and the epoch.
    No flag is ever reset: the epoch rises across launches and runner
    calls, so every runner of the grid on the card shares one
    (``grid_exchange``). Its launches run on the card's current stream, as
    K4's, whose ticket counter they share."""

    def __init__(self, device, ny: int, nx: int):
        self.device, self.ny, self.nx = device, ny, nx
        self.h, self.w, _ = grid_item(ny, nx)
        self.items = grid_items(ny, nx)
        self.flags = torch.zeros(self.items, dtype=torch.int32,
                                 device=device)
        self.words = torch.zeros(1 + len(WAIT_WORDS), dtype=torch.int64,
                                 device=device)
        self.counted = np.zeros(len(WAIT_WORDS), dtype=np.uint64)
        self.epoch = 0
        self.graphs = {}

    def graph(self, k: int) -> torch.Tensor:
        if k not in self.graphs:
            self.graphs[k] = torch.from_numpy(
                grid_graph(self.ny, self.nx, k, (self.h, self.w))).to(
                    self.device)
        return self.graphs[k]

    def check(self) -> None:
        """Raise where the error word is set: a wait ran out (kSpinNs).
        Reads the error word and the counter words to the host in one copy
        after the card's launches (the span ``lbm.dist.check``) and adds
        what the counters gained to ``WAITS``. A failed launch leaves the
        flags and the card's ticket counter in no known state: the exchange
        leaves the cache, so the next launch on the grid starts from fresh
        flags, and the ticket counter is zeroed."""
        with span("lbm.dist.check"):
            head = self.words.cpu().numpy().view(np.uint64)
        self.counted = _count_waits(self.device, head[1:], self.counted)
        if head[0]:
            _GRIDS.pop((self.device, self.ny, self.nx), None)
            _build.ticket_counter(self.device).zero_()
            raise RuntimeError(
                f"lbm_grid_p2p: a wait on a neighbour tile's flag ran out on "
                f"{self.device} ({self.ny} x {self.nx} grid); the grid's "
                f"state is lost")


# {(card, ny, nx): GridExchange} of this process
_GRIDS: dict = {}


def grid_exchange(device, ny: int, nx: int) -> GridExchange:
    """The ``GridExchange`` of a CUDA card and grid shape, made on first
    use."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, ny, nx)
    if key not in _GRIDS:
        _GRIDS[key] = GridExchange(device, ny, nx)
    return _GRIDS[key]


def grid_p2p_chunks_ref(f, obst_f, params: LBMParams, k: int, n_outer: int):
    """Plain version of ``grid_p2p_chunks``: K4's plain chain,
    ``kstep_tile.tile_chunk_ref`` chunk by chunk. Returns (the state after
    n_outer chunks of k steps, the (n_outer k,) raw per-step sums)."""
    sums = []
    for _ in range(n_outer):
        f, s = kstep_tile.tile_chunk_ref(f, obst_f, params, k)
        sums.append(s)
    return f, torch.cat(sums)


def grid_p2p_chunks(f, spare, obst_f, params: LBMParams, k: int,
                    n_outer: int):
    """``n_outer`` chunks of k <= 8 steps of the whole periodic (9, ny, nx)
    grid ``f`` over its (ny, nx) float32 mask ``obst_f`` (nonzero =
    blocked): one grid-kind launch of K6 (``LAUNCHES["grid_p2p"]``) on f's
    card and current stream, the epochs its ``grid_exchange``'s. ``spare``
    (f's shape, apart from it) is the second buffer, which the launch
    ping-pongs with f: the state lands in f after an even count of chunks,
    in spare after an odd one. On CPU tensors, ``grid_p2p_chunks_ref``,
    its result written where the kernel's lands. Returns (the state, the
    buffer now free, the (n_outer k,) raw per-step sums)."""
    bufs = (f, spare)
    if f.device.type == "cpu":
        g, sums = grid_p2p_chunks_ref(f, obst_f, params, k, n_outer)
        bufs[n_outer % 2].copy_(g)
    else:
        sums = _grid_launch(f, spare, obst_f, params, k, n_outer)[0]
    return bufs[n_outer % 2], bufs[1 - n_outer % 2], sums


def _grid_launch(f, spare, obst_f, params: LBMParams, k: int, n_outer: int):
    """The grid kind of K6 on CUDA tensors: (the (n_outer k,) sums, the
    (n_outer k, items) partials that the kernel reduced into them,
    ``grid_sums_ref``'s bits chunk by chunk)."""
    check_chunk(f, obst_f, params, k)
    _build.require_cuda(f, spare)
    if not (1 <= k <= kstep_tile.TILE_K and 1 <= n_outer <= MAX_OUTER
            and spare.shape == f.shape
            and spare.data_ptr() != f.data_ptr()):
        raise ValueError(f"the grid kind takes 1 to {kstep_tile.TILE_K} "
                         f"steps, 1 to {MAX_OUTER} chunks and a spare of "
                         f"the state's shape apart from it, got k {k}, "
                         f"{n_outer} chunks, spare {tuple(spare.shape)}")
    ny, nx = params.ny, params.nx
    ex = grid_exchange(f.device, ny, nx)
    lib = _build.library()
    with _build.on_device(f):
        items = ex.items
        partials = torch.empty((n_outer * k, items), dtype=torch.float32,
                               device=f.device)
        sums = torch.empty(n_outer * k, dtype=torch.float32, device=f.device)
        words = ex.words.data_ptr()
        _build.LAUNCHES["grid_p2p"] += 1
        _build.LAUNCHES["reduce_partials"] += n_outer
        _build.check(
            lib.lbm_grid_p2p(
                f.data_ptr(), spare.data_ptr(), obst_f.data_ptr(),
                partials.data_ptr(), sums.data_ptr(), ex.graph(k).data_ptr(),
                items, ex.h, ex.w, ex.flags.data_ptr(), n_outer, ex.epoch,
                words, words + WAITS_AT,
                _build.ticket_counter(f.device).data_ptr(),
                ny, nx, params.accel_row, params.omega, params.accel_w1,
                params.accel_w2, k,
                torch.cuda.current_stream(f.device).cuda_stream),
            f"lbm_grid_p2p ({k} steps, {n_outer} chunks, {ny} x {nx} in "
            f"{ex.h} x {ex.w} items on {f.device}, "
            f"{lib.lbm_grid_p2p_smem(k)} B of dynamic shared memory)")
    ex.epoch += n_outer
    return sums, partials
