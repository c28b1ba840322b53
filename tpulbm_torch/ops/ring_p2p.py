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
order, with its dependencies as indices into the flag arrays. The sums'
epilogue draws its tickets on the card's ticket counter
(``_build.ticket_counter``), as K4's does. The epoch rises across launches
and calls and no flag is ever reset (a reset on one card would race a
kernel on another that reads the flag).

``p2p_chunks`` runs one launch a card; on CPU tensors it takes the plain
version, ``p2p_chunks_ref``: ``n_outer`` chunks of ``ring_chunk_ref`` over
every shard, the slabs of each chunk written into the next epoch's landing
slots, chunk 0 reading the neighbours' states where ``pull0`` (the first
chunk of a runner call), the slots elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, kstep_tile

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
PUSH_REMOTE = 1     # duty: the tile pushes an edge row onto another card
READ_REMOTE = 2     # duty: a tile on another card waits on its flag


def ntiles(h: int, nx: int) -> int:
    """Owned tiles of a shard of h rows (the row length of its partials)."""
    return -(-h // TILE) * -(-nx // TILE)


def outer_per_launch(rows, nx: int, k: int) -> int:
    """Chunks a launch: MAX_OUTER, fewer where the largest shard's partials
    would pass PARTIALS_BYTES."""
    per_chunk = 4 * k * ntiles(max(rows), nx)
    return max(1, min(MAX_OUTER, PARTIALS_BYTES // per_chunk))


def _touch(a0, alen, b0, blen, n: int, k: int):
    """(len(a0), len(b0)) bools: interval [a0, a0 + alen) widened by k on
    each side meets [b0, b0 + blen), both modulo n."""
    s = a0[:, None] - k
    span = alen[:, None] + 2 * k
    return ((span >= n) | ((b0[None] - s) % n < span)
            | ((s - b0[None]) % n < blen[None]))


def _tile_rows(rows, t):
    """Every tile row of the ring: (shard, row in shard, first global row,
    rows owned)."""
    out, off = [], 0
    for d, h in enumerate(rows):
        for ty in range(-(-h // t)):
            out.append((d, ty, off + ty * t, min(t, h - ty * t)))
        off += h
    return np.array(out, dtype=np.int64).reshape(-1, 4)


def _reach(rows, nx: int, k: int, t: int):
    """The cone relation in factors: (tile rows, R, C), R[a, b] where tile
    row b has owned rows within k of tile row a's (across shard edges,
    modulo the ring's rows), C[x, y] where tile column y has owned columns
    within k of tile column x's (modulo nx)."""
    tr = _tile_rows(rows, t)
    r = _touch(tr[:, 2], tr[:, 3], tr[:, 2], tr[:, 3], sum(rows), k)
    x0 = np.arange(0, nx, t)
    xl = np.minimum(t, nx - x0)
    return tr, r, _touch(x0, xl, x0, xl, nx, k)


def tile_graph(mesh, rows, nx: int, k: int, t: int = TILE):
    """Each card's tile graph for K6: {card: (records, peers)}. A tile
    waits on every tile with owned cells within k cells of its own, itself
    included (a symmetric relation; _reach). records (items, REC) int32
    holds a record a tile of the card's shards (in mesh order, tiles
    row-major), the kernel's walk within a chunk: HEADER (shard as the
    launch's index, tile, window origin y0 and x0, owned rows and columns,
    duties, local | remote << 8 dependency counts), then its dependencies
    as flag indices, this card's first, those on another card as
    peers.index(card) << PEER_SHIFT | index. A card's flag array holds its
    shards' tiles in walk order, so a tile's own flag is its record's
    index. peers: the cards whose flag arrays the records name, this
    card's first."""
    cards = list(dict.fromkeys(mesh))
    local = {c: [d for d in range(len(rows)) if mesh[d] == c] for c in cards}
    tr, r, c = _reach(rows, nx, k, t)
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
    x0 = np.arange(tiles_x) * t
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
                rec[:, 5] = np.minimum(t, nx - x0)
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


class Exchange:
    """The landing slots, flags, error words, tile graphs and epoch of a
    p2p ring over ``mesh`` (shard d on mesh[d], ``rows[d]`` rows of ``nx``
    columns). Made once a runner; on the card it enables peer access
    between the cards of neighbour shards (raising, with the two cards,
    where it is refused) and waits for its zeroed buffers."""

    def __init__(self, mesh, rows, nx: int):
        self.mesh, self.rows, self.nx = list(mesh), list(rows), nx
        self.epoch = 0
        self.failed = False
        n = len(self.mesh)

        def zeros(shape, d, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.mesh[d])

        self.land_lo = [zeros((2, 9 * SLAB_ROWS * nx), d) for d in range(n)]
        self.land_hi = [zeros((2, 9 * SLAB_ROWS * nx), d) for d in range(n)]
        self.cards = list(dict.fromkeys(self.mesh))
        self.local = {c: [d for d in range(n) if self.mesh[d] == c]
                      for c in self.cards}
        self.graphs = {}
        if self.mesh[0].type != "cuda":
            return
        lib = _build.library()
        for d in range(n):
            for e in ((d - 1) % n, (d + 1) % n):
                a, b = self.mesh[d].index, self.mesh[e].index
                if a != b:
                    enable_peer(lib, a, b)
        self.flags = {c: torch.zeros(sum(ntiles(self.rows[d], nx)
                                         for d in self.local[c]),
                                     dtype=torch.int32, device=c)
                      for c in self.cards}
        self.errors = {c: torch.zeros(1, dtype=torch.int32, device=c)
                       for c in self.cards}
        for c in self.cards:
            torch.cuda.synchronize(c)

    def graph(self, k: int):
        """{card: (its tile graph on the card, the flag pointers its records
        name)} for k steps a chunk (``tile_graph``), made on first use."""
        if k not in self.graphs:
            graphs = tile_graph(self.mesh, self.rows, self.nx, k)
            self.graphs[k] = {
                c: (torch.from_numpy(recs).to(c),
                    np.array([self.flags[p].data_ptr() for p in peers],
                             dtype=np.int64))
                for c, (recs, peers) in graphs.items()}
        return self.graphs[k]

    def barrier(self) -> None:
        """Order every card's stream after the work issued so far on every
        other card: the first chunk of a call reads the neighbours' input
        states, which another card's stream may still be writing."""
        if len(self.cards) < 2:
            return
        events = {}
        for c in self.cards:
            events[c] = torch.cuda.Event()
            events[c].record(torch.cuda.current_stream(c))
        for c in self.cards:
            for o in self.cards:
                if o != c:
                    torch.cuda.current_stream(c).wait_event(events[o])

    def check(self) -> None:
        """Raise where a card's error word is set: a wait of K6 ran out
        (csrc/ring_p2p.cu::kSpinNs). Reads every card's word to the host."""
        if self.mesh[0].type != "cuda":
            return
        bad = [str(c) for c, e in self.errors.items() if int(e.item())]
        if bad:
            self.failed = True
            raise RuntimeError(
                f"lbm_ring_p2p: a wait on a neighbour's flag ran out on "
                f"{', '.join(bad)}; the ring's state is lost")


def enable_peer(lib, a: int, b: int) -> None:
    """Let card a read and write card b's memory (K6's peer slots and
    flags), or raise naming both."""
    code = lib.lbm_ring_p2p_enable_peer(a, b)
    if code:
        raise RuntimeError(
            f"lbm_ring_p2p: cuda:{a} cannot access cuda:{b}'s memory (CUDA "
            f"error {code}, {lib.lbm_error_string(code).decode()}): the "
            f"cuda-p2p ring needs peer access between neighbour cards")


def p2p_chunks_ref(states, bands, land_lo, land_hi, params: LBMParams,
                   k: int, n_outer: int, base: int, row_bases, pull0: bool):
    """Plain version of ``p2p_chunks`` over every shard of the ring:
    ``n_outer`` chunks of ``kstep_tile.ring_chunk_ref``. Chunk c (epoch
    base + c) steps shard d from its lo and hi slabs: the previous shard's
    last k rows and the next shard's first k rows, where ``pull0`` and
    c = 0, else slot (base + c) % 2 of ``land_lo[d]`` and ``land_hi[d]``;
    then writes each shard's last k rows into the next shard's lo slot and
    its first k rows into the previous shard's hi slot of parity
    (base + c + 1) % 2. ``bands[d]`` is shard d's (h + 2k, nx) mask band,
    band row 0 global row ``row_bases[d]``. Returns (the states after
    n_outer chunks, per shard the (n_outer k,) per-step sums); updates the
    landing buffers in place."""
    n, nx = len(states), params.nx
    f, sums = list(states), [[] for _ in states]
    for c in range(n_outer):
        e = base + c
        new = []
        for d in range(n):
            if pull0 and c == 0:
                lo, hi = f[d - 1][:, -k:], f[(d + 1) % n][:, :k]
            else:
                lo = slot(land_lo[d], e % 2, k, nx)
                hi = slot(land_hi[d], e % 2, k, nx)
            g, s = kstep_tile.ring_chunk_ref(lo, f[d], hi, bands[d], params,
                                             k, row_bases[d])
            new.append(g)
            sums[d].append(s)
        for d in range(n):
            slot(land_lo[(d + 1) % n], (e + 1) % 2, k, nx).copy_(
                new[d][:, -k:])
            slot(land_hi[(d - 1) % n], (e + 1) % 2, k, nx).copy_(
                new[d][:, :k])
        f = new
    return f, [torch.cat(s) for s in sums]


def p2p_chunks(ex: Exchange, states, spares, bands, params: LBMParams,
               k: int, n_outer: int, row_bases, pull0: bool):
    """``n_outer`` chunks of k steps of every shard of ``ex``'s ring from
    ``states`` (shard d on ex.mesh[d]), epochs ex.epoch onwards; advances
    ex.epoch. ``spares``: a second buffer a shard, which the launch
    ping-pongs with the state. One K6 launch a card, on its current stream;
    on CPU tensors, ``p2p_chunks_ref``. Returns (the states, the buffers
    now free, per shard the (n_outer k,) raw per-step sums)."""
    if states[0].device.type == "cpu":
        f, sums = p2p_chunks_ref(states, bands, ex.land_lo, ex.land_hi,
                                 params, k, n_outer, ex.epoch, row_bases,
                                 pull0)
        ex.epoch += n_outer
        return f, list(states), sums
    sums = _p2p_launch(ex, states, spares, bands, params, k, n_outer,
                       row_bases, pull0)[0]
    if n_outer % 2:
        return list(spares), list(states), sums
    return list(states), list(spares), sums


def _p2p_launch(ex: Exchange, states, spares, bands, params: LBMParams,
                k: int, n_outer: int, row_bases, pull0: bool):
    """K6 on CUDA shards, one launch a card: (per shard the sums, per shard
    the (n_outer k, ntiles) partials that the kernel reduced into them)."""
    n, nx, rows = len(states), params.nx, ex.rows
    if ex.failed:
        raise RuntimeError("lbm_ring_p2p: an earlier launch of this ring "
                           "failed; its flags and ticket counters are lost")
    if not (1 <= k <= kstep_tile.TILE_K and 1 <= n_outer <= MAX_OUTER
            and k <= min(rows) and n >= 2):
        raise ValueError(f"K6 takes 1 to {kstep_tile.TILE_K} steps over "
                         f"shards of at least k rows and 1 to {MAX_OUTER} "
                         f"chunks, got k {k}, {n_outer} chunks, rows {rows}")
    for d in range(n):
        _build.require_cuda(states[d], spares[d], bands[d])
        if (states[d].device != ex.mesh[d]
                or states[d].shape != (9, rows[d], nx)
                or spares[d].shape != states[d].shape
                or spares[d].data_ptr() == states[d].data_ptr()
                or bands[d].shape != (rows[d] + 2 * k, nx)
                or not 0 <= row_bases[d] < params.ny):
            raise ValueError(
                f"shard {d}: state {tuple(states[d].shape)} on "
                f"{states[d].device}, spare {tuple(spares[d].shape)}, mask "
                f"{tuple(bands[d].shape)}, row {row_bases[d]}; the ring wants "
                f"{rows[d]} rows of the ({params.ny}, {nx}) grid on "
                f"{ex.mesh[d]} and a distinct spare")
    lib = _build.library()
    partials = [torch.empty((n_outer * k, ntiles(rows[d], nx)),
                            dtype=torch.float32, device=ex.mesh[d])
                for d in range(n)]
    sums = [torch.empty(n_outer * k, dtype=torch.float32, device=ex.mesh[d])
            for d in range(n)]
    graph = ex.graph(k)
    for card in ex.cards:
        local = ex.local[card]
        if len(local) > MAX_LOCAL:
            raise ValueError(f"K6 takes at most {MAX_LOCAL} shards a card, "
                             f"got {len(local)} on {card}")
        table = np.array([_entry(ex, states, spares, bands, partials, sums,
                                 row_bases, d) for d in local],
                         dtype=np.int64)
        records, peer_flags = graph[card]
        with _build.on_device(states[local[0]]):
            _build.LAUNCHES["ring_p2p"] += 1
            _build.LAUNCHES["reduce_partials"] += n_outer * len(local)
            _build.check(
                lib.lbm_ring_p2p(
                    table.ctypes.data, len(local), records.data_ptr(),
                    records.shape[0], peer_flags.ctypes.data,
                    len(peer_flags), n_outer, ex.epoch,
                    int(pull0), ex.errors[card].data_ptr(),
                    _build.ticket_counter(card).data_ptr(), params.ny, nx,
                    params.accel_row, params.omega, params.accel_w1,
                    params.accel_w2, k,
                    torch.cuda.current_stream(card).cuda_stream),
                f"lbm_ring_p2p ({k} steps, {n_outer} chunks, "
                f"{len(local)} shards on {card}, "
                f"{lib.lbm_ring_p2p_smem(k)} B of dynamic shared memory)")
    ex.epoch += n_outer
    return sums, partials


def _entry(ex: Exchange, states, spares, bands, partials, sums, row_bases,
           d):
    """Shard d's words of the launch table, in TABLE's order: its buffers,
    its neighbours' input states and landing buffers (peer pointers where
    they lie on another card), then its integers."""
    n = len(states)
    p, q = (d - 1) % n, (d + 1) % n
    lo, hi = ex.land_lo[d], ex.land_hi[d]
    row = 9 * SLAB_ROWS * ex.nx * 4     # bytes of a landing slot

    def halves(buf):
        return buf.data_ptr(), buf.data_ptr() + row

    words = dict(
        obst=bands[d].data_ptr(), state0=states[d].data_ptr(),
        state1=spares[d].data_ptr(), prev_in=states[p].data_ptr(),
        next_in=states[q].data_ptr(), partials=partials[d].data_ptr(),
        sums=sums[d].data_ptr(), h=ex.rows[d], h_prev=ex.rows[p],
        h_next=ex.rows[q], row_base=row_bases[d])
    words["lo0"], words["lo1"] = halves(lo)
    words["hi0"], words["hi1"] = halves(hi)
    words["push_lo0"], words["push_lo1"] = halves(ex.land_lo[q])
    words["push_hi0"], words["push_hi1"] = halves(ex.land_hi[p])
    return [words[name] for name in TABLE]
