"""The wide-grid slice of tpulbm_torch (K4, ``ops.kstep_tile``) against the
JAX package's wide tiers: the lane-folded skew with its seam fix, the 2-D
skew, the 2-D K-step, the three seam fixes, the router, and the slice end to
end through ``Simulation``.

On the CPU the wrappers take their plain PyTorch versions (K4 runs only on
the card; ``chip_smoke.py`` holds it against the same plain versions
there). The JAX side runs its Pallas kernels in interpret mode, as its own
CPU tests do, in the production pair-symmetric form on both sides. Every
input is made from a seed with numpy and fed to both packages. Tolerances as
test_torch_kernels: f atol 1e-7 and per-step av rtol 1e-4 over at most 11
steps; measured on these inputs: at most 4.8e-8 in f and 5.8e-6 relative in
the kernel-level sums, 1.8e-5 in the end-to-end av series (the canonical
equilibrium of the port's plain Simulation against pair-symmetric Pallas).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulbm
from tpulbm.core.params import LBMParams as JParams
from tpulbm.dist import runner as jrunner
from tpulbm.dist.mesh import get_mesh
from tpulbm.ops import pallas_kstep2d, pallas_kstep_skew
from tpulbm.ops import pallas_kstep_skew2d, pallas_kstep_skew_fold
from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner as truntime
from tpulbm_torch.io.obstacles import write_obstacles
from tpulbm_torch.io.params_file import read_params, write_params
from tpulbm_torch.ops import kstep, kstep_tile, resident, ring_p2p, step_torch
from tpulbm_torch.sim.simulation import Simulation

torch.set_num_threads(2)

F_ATOL = 1e-7
AV_RTOL = 1e-4
K = 8


def _case(ny, nx, seed=3, p_block=0.1):
    """A random mask and a 1 % perturbation of the rest state."""
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < p_block
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    f0 = (initial_state(p).numpy()
          * (1 + 0.01 * rng.rand(9, ny, nx))).astype(np.float32)
    return p, mask, f0


def _jp(p):
    return JParams(**dataclasses.asdict(p))


def _close(f, av, f_ref, av_ref):
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=0,
                               atol=F_ATOL)
    np.testing.assert_allclose(np.asarray(av), np.asarray(av_ref),
                               rtol=AV_RTOL)


def _tile_run(p, mask, f0, ks):
    """tile_chunk chunks of ks steps from f0; returns (f, av series)."""
    obst_f = torch.tensor(mask, dtype=torch.float32)
    f, sums = torch.tensor(f0), []
    for k in ks:
        f, s = kstep_tile.tile_chunk(f, obst_f, p, k)
        assert s.shape == (k,)
        sums.append(s)
    av = torch.cat(sums) * torch.tensor(p.free_cells_inv, dtype=torch.float32)
    return f.numpy(), av.numpy()


def test_tile_chunk_matches_fold_runner():
    """An 8-step tile_chunk plus a 3-step one vs the lane-folded skew at
    F=2 (main kernel + unfolded seam fix per chunk, folded jnp remainder)."""
    p, mask, f0 = _case(96, 256)
    assert pallas_kstep_skew_fold.pick_fold(96, 256) == 2
    n = 11
    f_j, av_j = pallas_kstep_skew_fold.make_fold_runner(_jp(p), n)(
        jnp.asarray(f0), jnp.asarray(mask))
    _close(*_tile_run(p, mask, f0, [K, 3]), f_j, av_j)


def test_tile_chunk_matches_skew2d_runner():
    """Against the 2-D skew on 4 x 4 tiles of (24, 256) with the monolithic
    seam fix, and its 3-step remainder."""
    p, mask, f0 = _case(96, 1024, seed=4)
    n = 11
    r = jrunner._make_skew_runner(
        _jp(p), n, get_mesh(n_devices=1),
        maker=pallas_kstep_skew2d.make_skew2d, tile=(24, 256))
    f_j, av_j = r(jnp.asarray(f0), jnp.asarray(mask))
    _close(*_tile_run(p, mask, f0, [K, 3]), f_j, av_j)


def test_tile_chunk_remainder_matches_kstep2d():
    """A 5-step tile_chunk vs the 2-D K-step kernel (the wide grids'
    sub-8-step remainder), whose column margins wrap the torus."""
    p, mask, f0 = _case(48, 512, seed=5)
    k = 5
    assert pallas_kstep2d.supported(48, 512, k)
    r = jrunner._make_kstep_runner(_jp(p), k, get_mesh(n_devices=1), k,
                                   maker=pallas_kstep2d.make_kstep2d)
    f_j, av_j = r(jnp.asarray(f0), jnp.asarray(mask))
    _close(*_tile_run(p, mask, f0, [k]), f_j, av_j)


def _band(f0, mask, lo, hi):
    rows = np.arange(lo, hi) % mask.shape[0]
    return f0[:, rows], mask[rows].astype(np.float32)


def _band_chunk(band, oband, p, k, row_base):
    """The seam fixes' function through ring_chunk: k steps of the band
    whose row 0 is global row row_base, cut into lo (k rows), shard and hi
    (k rows); its rows [k, rows - k) after k steps and their sums."""
    band = torch.tensor(band)
    return kstep_tile.ring_chunk(band[:, :k], band[:, k:-k], band[:, -k:],
                                 torch.tensor(oband), p, k, row_base)


def test_band_chunk_matches_fold_fix():
    """ring_chunk over rows [-(m+K), m+K) vs make_fold_fix (F=2), which
    reads rows [-bh, bh) and keeps rows [-m, m) at every step: values and
    per-step sums. The band holds the accelerated row ny-2."""
    p, mask, f0 = _case(96, 256, seed=6)
    F = 2
    m = pallas_kstep_skew_fold.fix_band_half(F)
    bh = pallas_kstep_skew_fold.fix_band_side(F)
    ve = bh - m - K   # rows [-m, m) inside the fix's vals (fold runner)
    band, oband = _band(f0, mask, -bh, bh)
    fix = pallas_kstep_skew_fold.make_fold_fix(
        p.ny, p.nx, F, p.omega, p.accel_w1, p.accel_w2)
    scal = jnp.asarray([[p.accel_row, (p.ny - bh) % p.ny]], dtype=jnp.int32)
    vals_j, sums_j = fix(jnp.asarray(band), jnp.asarray(oband), scal)
    band, oband = _band(f0, mask, -(m + K), m + K)
    vals, sums = _band_chunk(band, oband, p, K, p.ny - m - K)
    assert vals.shape == (9, 2 * m, p.nx)
    _close(vals.numpy(), sums.numpy(),
           np.asarray(vals_j)[:, ve:ve + 2 * m], sums_j)


@pytest.mark.parametrize("tiled", [True, False])
def test_band_chunk_matches_skew_fixes(tiled):
    """ring_chunk over rows [-2K, 2K) vs the seam fix of the skew tiers,
    x-tiled (two tiles of 128 columns) and monolithic: the values of rows
    [-K, K) after K steps. Values only: the fixes' per-step sums cover a
    row set that slides down one row per step to complement the skewed main
    kernel (owned_step_dy=-1, pallas_kstep_skew.py:810-814), which no
    whole-band sum matches."""
    p, mask, f0 = _case(96, 256, seed=7)
    if tiled:
        fix = pallas_kstep_skew.make_skew_fix_tiled(
            p.nx, p.ny, p.omega, p.accel_w1, p.accel_w2, bx=128)
    else:
        fix = pallas_kstep_skew.make_skew_fix(
            p.nx, p.ny, p.omega, p.accel_w1, p.accel_w2)
    band, oband = _band(f0, mask, -2 * K, 2 * K)
    scal = jnp.asarray([[p.accel_row, p.ny - 2 * K]], dtype=jnp.int32)
    vals_j, _ = fix(jnp.asarray(band), jnp.asarray(oband), scal)
    vals, sums = _band_chunk(band, oband, p, K, p.ny - 2 * K)
    assert vals.shape == (9, 2 * K, p.nx) and sums.shape == (K,)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j), rtol=0,
                               atol=F_ATOL)


def test_band_chunk_rows_equal_the_whole_grid():
    """ring_chunk on a band away from the seam and the accelerated row
    gives, bitwise, the whole-grid chunk's values on its kept rows (same
    plain arithmetic)."""
    p, mask, f0 = _case(72, 160, seed=8)
    f, _ = kstep_tile.tile_chunk(torch.tensor(f0),
                                 torch.tensor(mask, dtype=torch.float32), p, 5)
    band, oband = _band(f0, mask, 20, 51)
    vals, _ = _band_chunk(band, oband, p, 5, 20)
    assert torch.equal(vals, f[:, 25:46])


# (ny, nx, n_steps): the seven decks at their step counts and the shapes
# around the tier boundaries. 272x8192 at 16 steps reaches the 2-D K-step
# tier with exact_all=True, i.e. pallas_kstep2d._kernel_row_inner
# (tpulbm/dist/runner.py:208-222,1785-1794).
ROUTES = [
    (128, 128, 40000), (128, 256, 40000), (256, 256, 80000),
    (1024, 1024, 20000), (2048, 2048, 4000), (4096, 4096, 2000),
    (8192, 8192, 1000), (256, 512, 1003), (96, 1024, 1003),
    (72, 2048, 1003), (96, 2048, 1003), (24, 8192, 1003),
    (1001, 1024, 1003), (1001, 1000, 1003), (100, 130, 1003),
    (272, 8192, 16),
]


def _jax_resident(monkeypatch, ny, nx, n):
    """Whether the JAX make_runner picks its resident tier for the grid,
    spied on its makers (nothing is built or compiled)."""
    hit = []

    def spy(name):
        def fn(*a, **kw):
            hit.append(name)
            return lambda f, o: (f, None)
        return fn

    monkeypatch.setattr(jrunner, "_make_resident_runner", spy("resident"))
    for maker in ("_make_skew_runner", "_make_kstep_runner",
                  "_make_kstep_bands_runner", "_make_xpad_runner"):
        monkeypatch.setattr(jrunner, maker, spy(maker))
    monkeypatch.setattr(pallas_kstep_skew_fold, "make_fold_runner",
                        spy("fold"))
    p = LBMParams(nx=nx, ny=ny, max_iters=n, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85).with_free_cells(nx * ny)
    jrunner.make_runner(_jp(p), n, get_mesh(n_devices=1), backend="pallas")
    assert len(hit) <= 1
    return hit == ["resident"], p


@pytest.mark.parametrize("ny,nx,n", ROUTES)
def test_kernel_family_matches_the_jax_router(monkeypatch, ny, nx, n):
    """The port's route follows the JAX package's single-device router for
    the same grid and steps: K2 where it picks its resident tier, K6's grid
    kind wherever it picks another."""
    resident_tier, p = _jax_resident(monkeypatch, ny, nx, n)
    assert truntime.resident_route(ny, nx) is resident_tier
    want = resident.resident_chunk if resident_tier else \
        ring_p2p.grid_p2p_chunks
    plan = truntime.kernel_plan(p, n)
    assert {fn for fn, _, _ in plan} == {want}
    assert sum(k * c for _, k, c in plan) == n


def test_row_inner_grid_routes_to_k4(monkeypatch):
    """At 272x8192 and 16 steps the JAX router builds the 2-D K-step tier
    with exact_all=True at k = 8, whose tile passes the row_inner test of
    _make_kstep_runner (tpulbm/dist/runner.py:215-221): the grid runs
    pallas_kstep2d._kernel_row_inner. The port sends it to K6's grid
    kind, two chunks of 8 steps in one launch."""
    resident_tier, p = _jax_resident(monkeypatch, 272, 8192, 16)
    tile = pallas_kstep2d.pick_tile(272, 8192)
    assert not resident_tier and tile is not None
    assert tile[0] >= pallas_kstep2d._MY + K and 272 // tile[0] >= 2
    assert not truntime.resident_route(272, 8192)
    assert truntime.kernel_plan(p, 16) == [(ring_p2p.grid_p2p_chunks, K, 2)]


@pytest.mark.parametrize("ny,nx,expect", [
    (256, 512, [("resident", 12, 1)]),         # 131,072 cells: _kernel_hbm
    (100, 130, [("grid", 8, 1), ("grid", 4, 1)]),   # not 8/128-aligned
    (100, 128, [("grid", 8, 1), ("grid", 4, 1)]),   # ny % 8 != 0
])
def test_kernel_plan_resident_gate(ny, nx, expect):
    """K2 takes the JAX resident gate, supported or supported_hbm
    (pallas_resident.py:35-60): 8/128-aligned grids of at most 135K cells,
    whatever the step count (256x512 is _kernel_hbm's shape); the others go
    to K6's grid kind."""
    p = LBMParams(nx=nx, ny=ny, max_iters=12, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    names = {resident.resident_chunk: "resident",
             ring_p2p.grid_p2p_chunks: "grid"}
    assert [(names[fn], k, c)
            for fn, k, c in truntime.kernel_plan(p, 12)] == expect


def test_wide_deck_end_to_end(tmp_path):
    """A 72x2048 deck with a random mask, 11 steps: above the resident gate
    and too wide for the 1-D skew, so the JAX router folds it (F=2) and the
    port routes it to K6's grid kind. The port's Simulation (plain oracle
    on the CPU) and its cuda plan (through the grid kind's plain version,
    K4's plain chain) against the JAX Simulation on the fold runner: state
    and av series."""
    ny, nx, n = 72, 2048, 11
    rng = np.random.RandomState(9)
    mask = rng.rand(ny, nx) < 0.05
    pf, of = tmp_path / "input.params", tmp_path / "obstacles.dat"
    write_params(pf, LBMParams(nx=nx, ny=ny, max_iters=n, reynolds_dim=10,
                               density=0.1, accel=0.005, omega=1.85))
    write_obstacles(of, mask)
    assert read_params(pf).max_iters == n
    assert pallas_kstep_skew_fold.pick_fold(ny, nx) == 2

    jsim = tpulbm.Simulation.from_files(pf, of, mesh=get_mesh(n_devices=1),
                                        backend="pallas")
    jres = jsim.run(n_steps=n)
    sim = Simulation.from_files(pf, of, device="cpu")
    res = sim.run()
    assert sim.step_count == n and res.av_vels.shape == (n,)
    _close(sim.f.numpy(), res.av_vels, jsim.f, jres.av_vels)
    assert abs(res.reynolds - jres.reynolds) < 1e-4 * abs(jres.reynolds)

    plan = truntime.kernel_plan(sim.params, n)
    assert plan == [(ring_p2p.grid_p2p_chunks, K, 1),
                    (ring_p2p.grid_p2p_chunks, 3, 1)]
    f, av = truntime.run_plan(plan, initial_state(sim.params),
                              sim.obstacles.float(), sim.params)
    _close(f.numpy(), av.numpy(), jsim.f, jres.av_vels)


# An eager model of K4's schedule (csrc/kstep_tile.cu): persistent CTAs
# walking the 32 x 32 tiles in a fixed stride, each tile's window loaded
# with its row and column wraps (ring mode: the row's buffer, lo, shard or
# hi, and blocked zeros past the band; its first column a multiple of 4, kx
# = k rounded up to 4 columns left of the tile), k steps on the shrinking
# rectangle whose results are all computed before any is written back (the
# register write-back), the last step's owned cells to the output, and the
# per-tile partials in the kernel's order (a thread's three cells t + 768 j
# in turn, warp trees, then one warp's tree over the 24 warp sums), in the
# column of the tile's index. Plain float32 arithmetic, so its state is bitwise the
# plain chunks'; its sums differ from theirs only by the summation order.
K4_THREADS, K4_CELLS, K4_TILE, K4_GRID = 768, 3, 32, 5


def _shfl_tree(v):
    """Lane 0 of the __shfl_down_sync tree over the last axis (32 lanes)."""
    for off in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[..., off:], v[..., 32 - off:]], dim=-1)
    return v[..., 0]


def _k4_partial(speed_owned):
    """A tile-step's partial from the window's |u| of its owned cells (0
    elsewhere), in the kernel's order."""
    x = torch.zeros(K4_CELLS * K4_THREADS)
    x[:speed_owned.numel()] = speed_owned.flatten()
    acc = torch.zeros(K4_THREADS)
    for j in range(K4_CELLS):
        acc = acc + x[j * K4_THREADS:(j + 1) * K4_THREADS]
    warps = _shfl_tree(acc.reshape(K4_THREADS // 32, 32))
    return _shfl_tree(torch.cat([warps, torch.zeros(32 - warps.numel())]))


def _k4_model(p, k, out_rows, row_of, obst_of, accel_of):
    """K4 on a grid of out_rows output rows. row_of(y0, wy) -> (9, nx)
    populations of window row wy of tile-row y0, or None past a ring's
    band; obst_of(y0, wy) -> (nx,) mask; accel_of(y0, wy) -> the row is the
    accelerated row. Returns (out, (k, ntiles) partials)."""
    kx = (k + 3) // 4 * 4
    nx, wh, w, cm = p.nx, K4_TILE + 2 * k, K4_TILE + 2 * kx, kx - k
    tiles_x = -(-nx // K4_TILE)
    ntiles = tiles_x * -(-out_rows // K4_TILE)
    out = torch.full((9, out_rows, nx), float("nan"))
    partials = torch.full((k, ntiles), float("nan"))
    walked = []
    for cta in range(min(K4_GRID, ntiles)):
        for tile in range(cta, ntiles, K4_GRID):
            walked.append(tile)
            y0, x0 = tile // tiles_x * K4_TILE, tile % tiles_x * K4_TILE
            cols = torch.arange(x0 - kx, x0 - kx + w) % nx
            win = torch.zeros((9, wh, w))
            blocked = torch.ones((wh, w), dtype=torch.bool)
            accel = []
            for wy in range(wh):
                row = row_of(y0, wy)
                if row is not None:
                    win[:, wy] = row[:, cols]
                    blocked[wy] = obst_of(y0, wy)[cols] != 0
                    if accel_of(y0, wy):
                        accel.append(wy)
            own = torch.zeros((wh, w), dtype=torch.bool)
            own[k:k + min(K4_TILE, out_rows - y0),
                kx:kx + min(K4_TILE, nx - x0)] = True
            for s in range(k):
                lo, hi = s + 1, wh - s - 1
                xlo, xhi = cm + s + 1, w - cm - s - 1
                g = win
                for wy in accel:
                    g = step_torch.accelerate(g, blocked, p, row=wy)
                pulled = [g[q, lo - CY[q]:hi - CY[q], xlo - CX[q]:xhi - CX[q]]
                          for q in range(9)]
                new, speed = physics.collide(
                    pulled, blocked[lo:hi, xlo:xhi], p.omega, True)
                win = win.clone()
                win[:, lo:hi, xlo:xhi] = torch.stack(new)
                owned = torch.zeros((wh, w))
                owned[lo:hi, xlo:xhi] = speed
                partials[s, tile] = _k4_partial(torch.where(own, owned, 0.0))
            rows = min(K4_TILE, out_rows - y0)
            cs = min(K4_TILE, nx - x0)
            out[:, y0:y0 + rows, x0:x0 + cs] = win[:, k:k + rows, kx:kx + cs]
    assert sorted(walked) == list(range(ntiles))
    return out, partials


@pytest.mark.parametrize("k", [1, 3, 8])
def test_k4_schedule_model_whole_grid(k):
    """The model of K4's whole-grid schedule on a ragged 70x90 grid (2 x 2
    full tiles and ragged edges) whose accelerated row is in the last
    tile-row, against tile_chunk_ref: state bitwise; the per-tile partials
    reduced (the epilogue's plain version) within 1e-6 of the plain sums."""
    p, mask, f0 = _case(70, 90, seed=10 + k)
    f, o = torch.tensor(f0), torch.tensor(mask, dtype=torch.float32)
    out, partials = _k4_model(
        p, k, p.ny, lambda y0, wy: f[:, (y0 - k + wy) % p.ny],
        lambda y0, wy: o[(y0 - k + wy) % p.ny],
        lambda y0, wy: (y0 - k + wy) % p.ny == p.accel_row)
    f_r, s_r = kstep_tile.tile_chunk_ref(f, o, p, k)
    assert torch.equal(out, f_r)
    np.testing.assert_allclose(kstep.reduce_partials_ref(partials).numpy(),
                               s_r.numpy(), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_k4_schedule_model_ring(k):
    """The model of K4's ring mode on a 37-row shard of a 96x90 grid whose
    band holds the accelerated row and whose hi slab wraps to rows 0..k-1:
    each window row read from lo, the shard or hi, rows past the band
    blocked zeros; against ring_chunk_ref, as the whole-grid test."""
    p, mask, f0 = _case(96, 90, seed=20 + k)
    off, h = 59, 37
    rows = torch.arange(off - k, off + h + k) % p.ny
    band = torch.tensor(f0)[:, rows]
    ob = torch.tensor(mask, dtype=torch.float32)[rows]
    lo, shard, hi = band[:, :k], band[:, k:k + h], band[:, k + h:]
    base = (off - k) % p.ny

    def row_of(y0, wy):
        sr = y0 + wy
        if sr >= h + 2 * k:
            return None
        return (lo[:, sr] if sr < k else shard[:, sr - k] if sr < k + h
                else hi[:, sr - k - h])

    out, partials = _k4_model(
        p, k, h, row_of, lambda y0, wy: ob[y0 + wy],
        lambda y0, wy: (y0 + wy < h + 2 * k
                        and (base + y0 + wy) % p.ny == p.accel_row))
    f_r, s_r = kstep_tile.ring_chunk_ref(lo, shard, hi, ob, p, k, base)
    assert torch.equal(out, f_r)
    np.testing.assert_allclose(kstep.reduce_partials_ref(partials).numpy(),
                               s_r.numpy(), rtol=1e-6)
