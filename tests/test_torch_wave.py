"""The grid kind's step (``csrc/wave_step.cuh``) and its item shape and
sums, on the CPU.

The kernel runs only on the card. Here an eager model of one CTA's stream
steps its items as the kernel does. The copy group lays the items' window
rows one after the other in a sequence of positions (a gap of
``drain(k)`` positions after an item whose next one the model
says was not posted in time) and fills level 0's ring of ``RING``
positions as far ahead as the ring's releases let it. In wave i level s
takes its ``R`` positions ``R i + 1 - (R + 1)(s - 1)`` ... and computes
those that are rows of an item inside the level's
rows, from level s - 1's ring, over the columns that shrink one a side and
level; level k writes the owned cells to the output state. Every ring row
carries the position it holds and the wave that wrote it: a read checks
both (no row read before it is written, in the wave that writes it, or
after it is overwritten), and no ring row is written in a wave that reads
it. The model's cell arithmetic is the plain version's (``ops.step_torch``,
pair-symmetric), so its state must be bitwise
``kstep_tile.tile_chunk_ref``'s. It adds the |u| of the owned cells in the
kernel's order (a register a cell of the wave list, down the waves; left
in one of ``SUMS`` buffers by item number once the cell is past the item,
at the entry of the item's rows it took, those of one residue modulo
``R``, so that an item's sums do not depend on where it starts; lanes of
32 and shuffles once every cell of the level is past it, checked; no wave
leaves a sum in a buffer that it sums, checked, since the kernel parts the
two by no barrier), and ``ring_p2p.grid_sums_ref`` reduces the items'
partials as the kernel's epilogue does. The model's constants are read
from the header (``R`` = kRows, ``RING`` = kRing, ``SUMS`` = kSums).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY, NSPEEDS
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner
from tpulbm_torch.ops import kstep, kstep_tile, ring_p2p, step_torch

torch.set_num_threads(2)

HEADER = (Path(__file__).resolve().parent.parent / "tpulbm_torch" / "csrc"
          / "wave_step.cuh").read_text()


def _const(name):
    """wave_step.cuh's ``constexpr int name``."""
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER)[1])


R, RING, SUMS, THREADS = (_const(n) for n in ("kRows", "kRing", "kSums",
                                                "kThreads"))


def drain(k):
    """wave_step.cuh::drain(k): the gap after an item when the next one is
    not posted (its text pinned below)."""
    return (R + 1) * k + 2 * R + 2


def _case(ny, nx, seed):
    """A seeded 10 % random mask and a 1 % perturbation of the rest state;
    the accelerated row (ny - 2) is the model's to cross."""
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.1
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    f0 = (initial_state(p).numpy()
          * (1 + 0.01 * rng.rand(9, ny, nx))).astype(np.float32)
    return p, torch.tensor(mask), torch.tensor(f0)


class Ring:
    """A ring of ``n`` rows of (10, wc) values (nine populations, the
    mask): position q in ring row q % n, each tagged with the position it
    holds and the wave that wrote it."""

    def __init__(self, n, wc):
        self.n = n
        self.vals = torch.full((n, 10, wc), float("nan"))
        self.tag = [(None, None)] * n

    def write(self, q, wave, vals, cols):
        self.vals[q % self.n][:, cols] = vals
        self.tag[q % self.n] = (q, wave)

    def read(self, q, wave):
        held, written = self.tag[q % self.n]
        assert held == q and written < wave, (q, wave, held, written)
        return self.vals[q % self.n]


def _level_row(f3, blocked3, gy, p, cols):
    """Level s's row from level s - 1's rows q - 1 .. q + 1 (f3 (9, 3, wc),
    blocked3 (3, wc), gy their grid rows) over the window columns ``cols``
    (a range): the plain version's arithmetic, accelerating the source rows
    that are the accelerated row. Returns ((9, len(cols)), speed)."""
    for j in range(3):
        if gy[j] == p.accel_row:
            f3 = step_torch.accelerate(f3, blocked3, p, row=j)
    lo, hi = cols.start, cols.stop
    pulled = [f3[q, 1 - CY[q], lo - CX[q]:hi - CX[q]] for q in range(NSPEEDS)]
    out, speed = physics.collide(pulled, blocked3[1, lo:hi], p.omega, True)
    return torch.stack(out), speed


def wave_stream(f, out, obst, p, k, items, w, gaps, bufs=SUMS):
    """One CTA's stream over ``items`` [(y0, x0, own_rows, own_cols)] of w
    columns (see the module; ``gaps[n]``: the gap positions after item n,
    0 where item n + 1 was posted in time, else drain(k); ``bufs``: the
    sums' buffers), writing the owned cells into ``out``. Returns each
    item's (k,) float32 partials in the kernel's order."""
    ny, nx = obst.shape
    kx = kstep_tile.col_margin(k)
    cm, wc = kx - k, w + 2 * kx
    bases, pos = [], 0
    for n, (_, _, own, _) in enumerate(items):
        bases.append(pos)
        pos += own + 2 * k + gaps[n]

    def where(q):
        """(item, window row) of position q, or None in a gap."""
        for n, b in enumerate(bases):
            if b <= q < b + items[n][2] + 2 * k:
                return n, q - b
        return None

    rings = [Ring(RING, wc) for _ in range(k)]
    width = [w + 2 * k - 2 * s for s in range(k + 1)]
    # a cell's register: (level, j, column index) -> (item, sum)
    reg = {(s, j, c): [0, np.float32(0)] for s in range(1, k + 1)
           for j in range(R) for c in range(width[s])}
    wsum = [{} for _ in range(bufs)]
    left = {}                    # (item, level) -> cells that left their sum
    parts = np.full((len(items), k), np.nan, np.float32)
    summed = [0] * (k + 1)       # the item each level sums next
    loaded = released = 0
    end = bases[-1] + items[-1][2] + 2 * k
    for i in range(10 ** 6):
        if summed[k] == len(items):
            break
        # the sums of every level s whose cells are all past item summed[s]
        sums_read, sums_left = set(), set()   # (level, buffer) this wave
        for s in range(1, k + 1):
            m = summed[s]
            if m < len(items) and R * (i - 1) + 1 - (R + 1) * (s - 1) >= (
                    bases[m] + items[m][2] + 2 * k - s):
                assert left.get((m, s), 0) == R * width[s], (m, s)
                sums_read.add((s, m % bufs))
                flat = np.array([wsum[m % bufs][(s, cls, c)]
                                 for cls in range(R)
                                 for c in range(width[s])], np.float32)
                v = np.zeros(32, np.float32)
                for a in range(0, flat.size, 32):
                    v[:flat[a:a + 32].size] += flat[a:a + 32]
                parts[m, s - 1] = ring_p2p._warp_tree(v[None])[0, 0]
                summed[s] += 1
                if s == k and gaps[m] == drain(k):
                    # done within the gap: thread 0 awaited this wave's
                    # positions at the end of the wave before, no further
                    gap_end = (bases[m] + items[m][2] + 2 * k
                               + drain(k))
                    assert R * i + R + 2 <= gap_end, "drain too short"
        # the copy group: every position whose ring row is free
        while loaded < min(end, released + RING):
            at = where(loaded)
            if at:
                n, r = at
                g = (items[n][0] - k + r) % ny
                gx = torch.arange(items[n][1] - kx, items[n][1] - kx + wc) % nx
                rows = torch.cat([f[:, g][:, gx], obst[g][gx][None]])
                rings[0].write(loaded, -1, rows, slice(None))
            loaded += 1
        need = R * i + R + 2
        assert loaded >= min(end, need), "the ring is too short"
        reads, writes = set(), set()
        for s in range(1, k + 1):
            for j in range(R):
                q = R * i + 1 - (R + 1) * (s - 1) + j
                for c in range(width[s]):
                    cell = reg[(s, j, c)]
                    if (cell[0] < len(items) and q >= bases[cell[0]]
                            + items[cell[0]][2] + 2 * k - s):
                        n = cell[0]
                        # at the entry of the item's rows it took: residue
                        # (q - base) % R, wherever the item starts
                        wsum[n % bufs][(s, (q - bases[n]) % R, c)] = cell[1]
                        sums_left.add((s, n % bufs))
                        left[(n, s)] = left.get((n, s), 0) + 1
                        cell[0], cell[1] = n + 1, np.float32(0)
                at = where(q)
                if not at:
                    continue
                n, r = at
                y0, x0, own, own_cols = items[n]
                if not s <= r < own + 2 * k - s:
                    continue
                src = rings[s - 1]
                band = torch.stack([src.read(q + d, i) for d in (-1, 0, 1)],
                                   dim=1)
                reads |= {(s - 1, (q + d) % src.n) for d in (-1, 0, 1)}
                cols = range(cm + s, wc - cm - s)
                if s == k:
                    cols = range(cm + s, min(wc - cm - s, kx + own_cols))
                gy = [(y0 - k + r + d) % ny for d in (-1, 0, 1)]
                new, speed = _level_row(band[:9], band[9] != 0, gy, p, cols)
                c = slice(cols.start, cols.stop)
                if s < k:
                    rings[s].write(q, i, torch.cat([new, band[9:, 1, c]]), c)
                    writes.add((s, q % rings[s].n))
                else:
                    out[:, y0 + r - k, x0:x0 + len(cols)] = new
                if not k <= r < k + own:
                    continue
                for ci, col in enumerate(cols):
                    if kx <= col < kx + own_cols:
                        cell = reg[(s, j, col - cm - s)]
                        assert cell[0] == n
                        cell[1] = np.float32(
                            cell[1] + np.float32(speed[ci].item()))
        assert not reads & writes, f"wave {i} writes a ring row it reads"
        assert not sums_read & sums_left, \
            f"wave {i} leaves a sum in a buffer it sums"
        released = R * i + R
    return parts


def wave_chunk(f, obst, p, k, shape, ctas, c=0, seed=0, gapped=0.5,
               bufs=SUMS):
    """One chunk of the grid kind over every item of ``shape`` (rows,
    columns): the walk of chunk c (starting at item row c) dealt to
    ``ctas`` streams, each with gaps after a share ``gapped`` of its items,
    at random (seeded), and ``bufs`` sums' buffers. Returns (the state, the
    (k, items) partials)."""
    ny, nx = obst.shape
    h, w = shape
    cols = -(-nx // w)
    items = [(y0, x0, min(h, ny - y0), min(w, nx - x0))
             for y0 in range(0, ny, h) for x0 in range(0, nx, w)]
    walk = [(r + c * cols) % len(items) for r in range(len(items))]
    rng = np.random.RandomState(seed)
    out = torch.full_like(f, float("nan"))
    parts = np.full((k, len(items)), np.nan, np.float32)
    for b in range(ctas):
        mine = walk[b::ctas]
        gaps = np.where(rng.rand(len(mine)) < 1 - gapped, 0, drain(k))
        got = wave_stream(f, out, obst, p, k, [items[x] for x in mine], w,
                          gaps, bufs)
        parts[:, mine] = got.T
    return out, parts


# Grids with ragged edge items: 100 x 130 at the kernel's shape for it
# (ring_p2p.grid_item: 8 x 16, a 4-row last item row, a 2-column last
# item column); a 40 x 136 grid of 64-column items (an 8-column last item
# column) and 24-row items (a 16-row last item row); a 20 x 70 grid whose
# single item row is the whole grid, its window rows crossing the
# accelerated row twice; a 136 x 12 grid of 64 x 4 items, 16 times taller
# than wide as 8192^2's 2048 x 64 (an 8-row last item row, window rows
# 4 + 2 col_margin(k) wide, wider than the grid at k = 8).
WAVE_CASES = [((100, 130), None, 3), ((40, 136), (24, 64), 2),
              ((20, 70), (20, 64), 1), ((136, 12), (64, 4), 2)]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("grid,shape,ctas", WAVE_CASES,
                         ids=[f"{y}x{x}" for (y, x), _, _ in WAVE_CASES])
def test_wave_schedule_is_k4s_plain_chunk(grid, shape, ctas, k):
    """The eager model of the stream (items one after the other in
    positions, gaps, levels, rings, shrinking widths) gives tile_chunk_ref's
    state bitwise; no ring row is read before it is written, in the wave
    that writes it, or after it is overwritten; every cell of a level has
    left its sum of an item before the level's sum is taken; the partials,
    reduced as the kernel's epilogue reduces them (grid_sums_ref), give the
    chunk's sums within 2e-6."""
    ny, nx = grid
    shape = shape or ring_p2p.grid_item(ny, nx)[:2]
    p, mask, f = _case(ny, nx, ny + nx + k)
    obst = mask.float()
    got, parts = wave_chunk(f, obst, p, k, shape, ctas, c=k, seed=k)
    want, sums = kstep_tile.tile_chunk_ref(f, obst, p, k)
    assert torch.equal(got, want)
    model = ring_p2p.grid_sums_ref(parts)
    np.testing.assert_allclose(model, sums.numpy(), rtol=2e-6)


def test_wave_item_sums_do_not_depend_on_the_stream():
    """An item's partials are the same bits wherever it lies in its CTA's
    stream: the 100 x 130 grid's items dealt to 1 and to 3 streams, with
    other gaps, give bitwise the same (k, items) partials (and state)."""
    p, mask, f = _case(100, 130, 11)
    obst = mask.float()
    shape = ring_p2p.grid_item(100, 130)[:2]
    a_state, a = wave_chunk(f, obst, p, 8, shape, 1, c=0, seed=1)
    b_state, b = wave_chunk(f, obst, p, 8, shape, 3, c=2, seed=2)
    assert torch.equal(a_state, b_state)
    assert np.array_equal(a, b)


def test_wave_sums_hold_back_to_back_one_row_items():
    """At k = 1 the items of a 17 x 130 grid (grid_item: 8 x 16, so its
    last item row has one row) streamed with no gaps put nine 1-row items
    back to back: with the header's kSums buffers no wave leaves a sum in a
    buffer it sums, the state is tile_chunk_ref's and the sums its within
    2e-6; with two buffers, by item parity, a cell leaves item m + 2's sum
    in the wave that sums item m."""
    p, mask, f = _case(17, 130, 5)
    obst = mask.float()
    shape = ring_p2p.grid_item(17, 130)[:2]
    assert shape == (8, 16)
    got, parts = wave_chunk(f, obst, p, 1, shape, 1, gapped=0)
    want, sums = kstep_tile.tile_chunk_ref(f, obst, p, 1)
    assert torch.equal(got, want)
    np.testing.assert_allclose(ring_p2p.grid_sums_ref(parts), sums.numpy(),
                               rtol=2e-6)
    with pytest.raises(AssertionError, match="leaves a sum in a buffer"):
        wave_chunk(f, obst, p, 1, shape, 1, gapped=0, bufs=2)


def test_item_shape_is_pinned():
    """The grid kind's item shape and cone: 1.506 updates computed an owned
    one for K4's 32 x 32 tile at k = 8, 1.236 for a 64 x 64 item, 1.173
    for 64 x 128; the shapes the rule picks: 64 columns, and as tall as a
    chunk of at least 2 x 132 items (and more than 132 + 2 item rows'
    items) allows (61 rows at 1024^2, 272 items; 228 at 2048^2, 288; 2048
    at 8192^2, 512), and at 100 x 130, where even 8-row items of 64 or 32
    columns are too few, 8 x 16 (117 items)."""
    assert round(ring_p2p.item_ratio(32, 32, 8), 3) == 1.506
    assert round(ring_p2p.item_ratio(64, 64, 8), 3) == 1.236
    assert round(ring_p2p.item_ratio(128, 64, 8), 3) == 1.173
    shapes = {g: ring_p2p.grid_item(*g)[:2]
              for g in ((1024, 1024), (2048, 2048), (8192, 8192),
                        (100, 130))}
    assert shapes == {(1024, 1024): (61, 64), (2048, 2048): (228, 64),
                      (8192, 8192): (2048, 64), (100, 130): (8, 16)}
    assert [ring_p2p.grid_items(*g) for g in shapes] == [272, 288, 512, 117]
    h, w, ratio = ring_p2p.grid_item(1024, 1024)
    assert ratio == ring_p2p.item_ratio(h, w, 8)
    # a remainder launch keeps the shape, its cone at its own k
    assert ring_p2p.grid_item(1024, 1024, 3)[:2] == (61, 64)


def test_grid_chunks_a_launch_count_items():
    """A grid-kind launch takes up to MAX_OUTER chunks, fewer only where its
    items' partials would pass PARTIALS_BYTES: 64 at every deck's shape
    now that 8192^2 has 512 items (with K4's 65,536 tiles it took 8), and
    kernel_plan takes the same count."""
    for n in (1024, 2048, 4096, 8192):
        assert ring_p2p.grid_outer_per_launch(n, n, 8) == ring_p2p.MAX_OUTER
    assert ring_p2p.outer_per_launch([8192], 8192, 8) == 8
    p = LBMParams(nx=8192, ny=8192, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    plan = runner.kernel_plan(p, 8 * 70 + 3)
    assert [n for _, _, n in plan] == [64, 6, 1]


@pytest.mark.parametrize("rows,items", [(8, 1), (3, 272), (8, 4096),
                                        (1, 300)])
def test_grid_sums_ref_is_reduce_rows_order(rows, items):
    """grid_sums_ref, the plain version of the kernel's reduction of the
    partials, agrees with reduce_partials_ref (torch.sum) within 1e-6 and
    is bitwise a scalar walk of reduce_rows's order: thread i of 256 adds
    entries i, i + 256, ...; the warp trees; the tree of the warp sums."""
    rng = np.random.RandomState(rows * items)
    parts = (rng.rand(rows, items) * 10).astype(np.float32)
    got = ring_p2p.grid_sums_ref(parts)
    ref = kstep.reduce_partials_ref(torch.tensor(parts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)

    def tree(v):
        v = list(v) + [np.float32(0)] * (32 - len(v))
        for d in (16, 8, 4, 2, 1):
            v = [np.float32(v[l] + v[l + d if l + d < 32 else l])
                 for l in range(32)]
        return v[0]

    for s in range(rows):
        threads = []
        for i in range(256):
            v = np.float32(0)
            for j in range(i, items, 256):
                v = np.float32(v + parts[s, j])
            threads.append(v)
        warps = [tree(threads[w * 32:(w + 1) * 32]) for w in range(8)]
        assert tree(warps) == got[s]


def test_wave_constants_are_the_headers():
    """The model's constants are the header's (read from it above); its
    drain(k) is the header's, the widest item (ring_p2p.ITEM_W, the shape
    rule's) is kMaxW, and the most cells a wave holds (kMaxCells) are three
    a stepping thread (kThreads) at most."""
    assert "return (kRows + 1) * k + 2 * kRows + 2;" in HEADER
    assert drain(8) == 40
    assert _const("kMaxW") == ring_p2p.ITEM_W
    cells = R * sum(ring_p2p.ITEM_W + 16 - 2 * s for s in range(1, 9))
    assert -(-cells // THREADS) == 3
