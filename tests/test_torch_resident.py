"""K2 (``ops.resident``, ``csrc/resident.cu``) on the CPU: an eager model of
its schedule, and its partition rule against the CUDA source.

K2 runs only on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``
and ``tools/resident_sweep.py`` hold it against its plain version there);
here the wrapper takes its plain version, and the model checks what the
CUDA source does that the plain version does not show. Each CTA is a
generator under a seeded scheduler: its window is its band with h halo
rows and a halo column a side; a phase of p <= h steps computes, at step
j, the band and p - 1 - j rows a side; in the phase's last step the CTA
writes its first and last h band rows to its slots of parity e & 1, then
releases its epoch flag (base + e + 1), waits until both neighbours'
flags reach it, and copies their slots into its halo rows. Slot writes
become visible either at once or only at the release (both are legal on
the card), every slot carries the phase and step that wrote it, and every
window value carries the step it holds, so a read of a stale or early
value fails. The per-step partial adds the band's |u| in the kernel's
thread order. Plain float32 arithmetic in the kernel's per-cell order, so
the model's state is bitwise the plain chunk's; its sums differ only by
the summation order (1e-6, as the K4 model of test_torch_wide).
"""

import random
import re

import numpy as np
import pytest
import torch

from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner as truntime
from tpulbm_torch.ops import _build, kstep, resident, step_torch

torch.set_num_threads(2)

SUMS_RTOL = 1e-6


def _case(ny, nx, seed, p_block=0.1):
    """A random mask and a 1 % perturbation of the rest state (numpy)."""
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < p_block
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    f0 = (initial_state(p).numpy()
          * (1 + 0.01 * rng.rand(9, ny, nx))).astype(np.float32)
    return p, torch.tensor(f0), torch.tensor(mask, dtype=torch.float32)


def _shfl_tree(v):
    """Lane 0 of the __shfl_down_sync tree over the last axis (32 lanes)."""
    for off in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[..., off:], v[..., 32 - off:]], dim=-1)
    return v[..., 0]


def _partial(speed, threads, cells):
    """A CTA's partial of one step from the |u| of a step's cells in cell
    order (0 where a cell is not counted): thread t adds its cells
    t + threads j in turn, warp trees, then one warp's tree over the warp
    sums."""
    x = torch.zeros(cells * threads)
    x[:speed.numel()] = speed.flatten()
    acc = torch.zeros(threads)
    for j in range(cells):
        acc = acc + x[j * threads:(j + 1) * threads]
    warps = _shfl_tree(acc.reshape(threads // 32, 32))
    return _shfl_tree(torch.cat([warps, torch.zeros(32 - warps.numel())]))


def _step(g, blocked, stamp, s, lo, hi, accel_rows, p):
    """State s + 1 of window g on rows and columns [lo, hi) (hi a pair):
    (new values, |u|). Every value read must hold state s."""
    (rlo, clo), (rhi, chi) = lo, hi
    assert (stamp[rlo - 1:rhi + 1, clo - 1:chi + 1] == s).all(), \
        "a step read a value that does not hold the step before's state"
    for wy in accel_rows:
        g = step_torch.accelerate(g, blocked, p, row=wy)
    pulled = [g[q, rlo - CY[q]:rhi - CY[q], clo - CX[q]:chi - CX[q]]
              for q in range(9)]
    new, speed = physics.collide(pulled, blocked[rlo:rhi, clo:chi],
                                 p.omega, True)
    return torch.stack(new), speed


class Memory:
    """The exchange's global memory: slot rows (CTA, side, parity, row) ->
    (values, tag, step), which outlive a launch. A write is seen at once,
    or (``late``) at a later turn of the scheduler, row by row in any
    order."""

    def __init__(self, late, rng):
        self.slots, self.late, self.rng, self.pending = {}, late, rng, []

    def write(self, key, value):
        if self.late:
            self.pending.append((key, value))
        else:
            self.slots[key] = value

    def tick(self):
        """A turn of the scheduler: some late writes land."""
        keep = []
        for key, value in self.pending:
            if self.rng.random() < 0.5:
                self.slots[key] = value
            else:
                keep.append((key, value))
        self.pending = keep

    def ready(self, keys, tag):
        return all(self.slots.get(key, (None, None))[1] == tag
                   for key in keys)


def _cta(r, f, o, p, k, plan, base, mem, out, partials):
    """CTA r of one K2 launch, as a generator that yields where the card
    may run other CTAs (after each step, in each spin of a wait)."""
    ny, nx = p.ny, p.nx
    cy, cx, h, cells, threads = plan
    bi, bj = divmod(r, cx)

    def block(i, j):   # (y0, x0, rows, cols) of block (i, j), periodic
        i, j = i % cy, j % cx
        y0, x0 = resident.band_start(i, ny, cy), resident.band_start(j, nx, cx)
        return (y0, x0, resident.band_start(i + 1, ny, cy) - y0,
                resident.band_start(j + 1, nx, cx) - x0)

    y0, x0, rows, cols = block(bi, bj)
    assert rows >= h and cols >= h
    grows = torch.arange(y0 - h, y0 + rows + h) % ny
    gcols = torch.arange(x0 - h, x0 + cols + h) % nx
    win = f[:, grows][:, :, gcols].clone()
    blk = o[grows][:, gcols] != 0
    stamp = torch.zeros((rows + 2 * h, cols + 2 * h), dtype=torch.int64)
    accel_rows = [i for i, g in enumerate(grows.tolist()) if g == p.accel_row]
    w1 = cols + 2 * (h - 1)   # the thread layout: a full phase's first step
    s, e = 0, 0
    while s < k:
        n = min(h, k - s)
        for j in range(n):
            m = n - 1 - j
            lo, hi = (h - m, h - m), (h + rows + m, h + cols + m)
            assert (rows + 2 * (h - 1)) * w1 <= cells * threads
            vals, speed = _step(win, blk, stamp, s, lo, hi, accel_rows, p)
            counted = torch.zeros((rows + 2 * (h - 1), w1))
            counted[h - 1:h - 1 + rows, h - 1:h - 1 + cols] = \
                speed[m:m + rows, m:m + cols]
            partials[s, r] = _partial(counted, threads, cells)
            if s == k - 1:
                out[:, y0:y0 + rows, x0:x0 + cols] = vals
                return
            win[:, lo[0]:hi[0], lo[1]:hi[1]] = vals
            stamp[lo[0]:hi[0], lo[1]:hi[1]] = s + 1
            s += 1
            if j < n - 1:
                yield
                continue
            # the phase's last step (m = 0, vals is the block): the strips,
            # a slot row a block row (its first and last h rows, the first
            # and last h columns of each row)
            tag, par = base + e + 1, e % 2
            for i in range(rows):
                strips = [(2, vals[:, i, :h]), (3, vals[:, i, cols - h:])]
                if i < h:
                    strips.append((0, vals[:, i]))
                if i >= rows - h:
                    strips.append((1, vals[:, i]))
                for strip, v in strips:
                    mem.write((r, strip, par, i if strip >= 2 or strip == 0
                               else i - rows + h), (v.clone(), tag, s))
            # exchange e: the halo from the eight neighbours, each slot row
            # taken once it carries the tag
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy == dx == 0:
                        continue
                    nb = (bi + dy) % cy * cx + (bj + dx) % cx
                    _, _, nrows, ncols = block(bi + dy, bj + dx)
                    wr = {-1: 0, 0: h, 1: h + rows}[dy]
                    wc = {-1: 0, 0: h, 1: h + cols}[dx]
                    if dy:   # row strips: last rows below, first above
                        strip, n_rows = (1 if dy < 0 else 0), h
                        c0 = {-1: ncols - h, 0: 0, 1: 0}[dx]
                        c1 = c0 + (h if dx else cols)
                    else:    # column strips: last columns left, first right
                        strip, n_rows, c0, c1 = (3 if dx < 0 else 2), rows, 0, h
                    keys = [(nb, strip, par, i) for i in range(n_rows)]
                    while not mem.ready(keys, tag):
                        yield
                    for i, key in enumerate(keys):
                        row, _, step = mem.slots[key]
                        assert step == s, \
                            f"CTA {r} took CTA {nb}'s slot row of step " \
                            f"{step} at step {s}"
                        win[:, wr + i, wc:wc + c1 - c0] = row[:, c0:c1]
                        stamp[wr + i, wc:wc + c1 - c0] = s
            e += 1
            yield


def _launch(f, o, p, k, plan, mem, base, rng):
    """One K2 launch of the model, its CTAs in a seeded random order:
    (state, (k, CTAs) partials, the next launch's base). A CTA that waits
    for a slot row that never comes (overwritten, or never written) makes
    the launch fail."""
    ctas, h = plan[0] * plan[1], plan[2]
    out = torch.empty_like(f)
    partials = torch.zeros((k, ctas))
    live = {r: _cta(r, f, o, p, k, plan, base, mem, out, partials)
            for r in range(ctas)}
    for _ in range(100 * ctas * (k + 2)):
        if not live:
            break
        r = rng.choice(sorted(live))
        try:
            next(live[r])
        except StopIteration:
            del live[r]
        mem.tick()
    assert not live, f"CTAs {sorted(live)} never finished"
    return out, partials, base + -(-k // h)


# (ny, nx, cy, cx, h): the three resident decks at the plans they run
# (test_resident_plan's: 128 CTAs, h = 5), the 128x256 and 256^2 decks'
# shapes over a few CTAs (blocks of 32 x 32, the 4-cell instance), a ragged
# grid (blocks of 24 or 23 rows by 23 or 22 columns), a grid whose
# accelerated row 32 is the first row of block row 16 and in block row 15's
# upper halo, one whose accelerated row 38 is in block row 4's last h rows
# and in block row 0's lower halo, h = 1, and one column and one row of
# CTAs (a CTA is its own left and right, or lower and upper, neighbour);
# each at k = 1, h - 1 (where h > 1), h and 3h + 1 steps.
SHAPES = [(128, 128, 8, 16, 5), (256, 128, 16, 8, 5), (256, 256, 8, 16, 5),
          (256, 128, 8, 4, 2), (256, 256, 8, 8, 4), (70, 90, 3, 4, 3),
          (34, 64, 17, 2, 2), (40, 130, 5, 3, 2), (64, 48, 4, 4, 1),
          (64, 48, 8, 1, 2), (24, 64, 1, 8, 2)]
CASES = [(shape, k) for shape in SHAPES
         for k in sorted({1, shape[4] - 1, shape[4], 3 * shape[4] + 1} - {0})]


@pytest.mark.parametrize("late", [False, True],
                         ids=["seen-at-once", "seen-late"])
@pytest.mark.parametrize(
    "shape,k", CASES, ids=[f"{'x'.join(map(str, s))}-k{k}" for s, k in CASES])
def test_resident_schedule_model(shape, k, late):
    """Two K2 launches of k steps in a row, the slots kept between them,
    against two resident_chunk_ref chunks: state bitwise; the partials
    reduced within 1e-6 of the plain sums."""
    ny, nx, cy, cx, h = shape
    p, f, o = _case(ny, nx, seed=ny + nx + k)
    if shape == (34, 64, 17, 2, 2):
        assert resident.band_start(16, ny, cy) == p.accel_row
    if shape == (40, 130, 5, 3, 2):
        assert resident.band_start(4, ny, cy) + 6 == p.accel_row
    plan = (cy, cx, h, *resident.resident_instance(ny, nx, cy, cx, h))
    rng = random.Random(k * 1000 + cy * cx)
    mem = Memory(late, rng)
    base = 0
    for _ in range(2):
        out, partials, base = _launch(f, o, p, k, plan, mem, base, rng)
        f_r, s_r = resident.resident_chunk_ref(f, o, p, k)
        assert torch.equal(out, f_r)
        np.testing.assert_allclose(
            kstep.reduce_partials_ref(partials).numpy(), s_r.numpy(),
            rtol=SUMS_RTOL)
        f = out


@pytest.mark.parametrize("ny,nx,plan", [
    (128, 128, (8, 16, 5, 1, 512)),     # the 128^2 deck
    (256, 128, (16, 8, 5, 1, 768)),     # the 128x256 deck
    (256, 256, (8, 16, 5, 1, 1024)),    # the 256^2 deck
    (256, 512, (8, 16, 5, 2, 1024)),    # _kernel_hbm's shape
    (8, 1664, (1, 128, 5, 1, 512)),     # one row of CTAs
    (8, 16384, (1, 128, 4, 2, 1024)),   # the widest aligned resident rows:
    (8, 17280, (1, 128, 4, 2, 1024)),   # h = 5 overruns the threads
])
def test_resident_plan(ny, nx, plan):
    """The plan at the deck shapes, at 256x512 and at the edges of the
    resident gate (8 rows of 16,384 and 17,280 cells): the CTA grid,
    h, the instance; the window fits, and the route is K2's."""
    assert resident.resident_plan(ny, nx) == plan
    assert resident.window_smem(ny, nx, *plan[:3]) <= \
        resident.RESIDENT_MAX_SMEM
    p = LBMParams(nx=nx, ny=ny, max_iters=12, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    assert {fn for fn, _, _ in truntime.kernel_plan(p, 12)} == \
        {resident.resident_chunk}


def test_resident_plan_bounds():
    """Fewer CTAs where the grid has too few rows or columns for h, a
    shallower h where the deeper one's window or threads overrun, a fixed
    CTA grid (a column of bands), and a grid too small for any plan."""
    assert resident.resident_plan(16, 16) == (3, 3, 5, 1, 512)
    assert resident.resident_plan(256, 256, 64, 4, cy=64) == \
        (64, 1, 2, 2, 1024)
    assert resident.resident_plan(2, 2) == (1, 1, 2, 1, 512)
    assert resident.resident_instance(256, 256, 128, 2, 3) is None
    assert resident.resident_instance(10, 10, 1, 1, 10) == (1, 1024)
    assert resident.resident_instance(10, 10, 2, 1, 6) is None


def test_resident_rule_matches_the_cuda_source():
    """The Python rule (band_start, window_smem, resident_instance) and the
    C entry point's guard use the same constants, formulas and
    instances."""
    src = (_build.CSRC / "resident.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kStride") == resident.RESIDENT_STRIDE
    assert const("kMaxSmem") == resident.RESIDENT_MAX_SMEM
    assert const("kMaxK") == resident.RESIDENT_K
    listed = re.search(r"#define TPULBM_RESIDENT_INSTANCES\(X\) (.*)",
                       src).group(1)
    assert tuple(tuple(map(int, x)) for x in re.findall(
        r"X\((\d+), (\d+)\)", listed)) == resident.RESIDENT_INSTANCES
    assert "return i * q + (i < m ? i : m);" in src
    assert "const long long rows = (ny + cy - 1) / cy + 2 * h;" in src
    assert "const long long cols = (nx + cx - 1) / cx + 2 * h;" in src
    assert "return 2 * rows * cols * kStride * 4 + rows * 4;" in src
    assert "ny / cy < h || nx / cx < h" in src
    assert ("(rows + 2 * (h - 1)) * (cols + 2 * (h - 1)) <=\n"
            "             (long long)cells * threads;") in src


def test_resident_launch_refuses_cpu_tensors():
    """On a CPU tensor the launcher raises before touching nvcc; the
    wrapper takes its plain version only there, into a given ``out``."""
    p, f, o = _case(24, 40, seed=5)
    _build.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        resident._resident_launch(f, o, p, 3)
    assert _build.LAUNCHES["resident_chunk"] == 0
    out = torch.empty_like(f)
    got, sums = resident.resident_chunk(f, o, p, 3, out=out)
    f_r, s_r = resident.resident_chunk_ref(f, o, p, 3)
    assert got is out and torch.equal(got, f_r) and torch.equal(sums, s_r)
    assert _build.LAUNCHES["resident_chunk"] == 0
