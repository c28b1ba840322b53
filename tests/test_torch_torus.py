"""The 2-D torus of tpulbm_torch (``dist.mesh.get_mesh_2d``,
``dist.sharding.shard_blocks``, ``dist.runner.make_torus_runner``,
``kstep_tile.torus_chunk``, ``--mesh-shape``) against the JAX package's
torus on the 8-device virtual CPU mesh of conftest.py.

The port's blocks lie on the CPU here, so ``torus_chunk`` takes its plain
version (K4 torus mode runs only on the card; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the same plain version there).
A model of the kernel's window load checks what the CUDA source does that
the plain version does not show: which of the five pieces, through the
x slabs' padding, each window cell comes from. Every input comes from a
deck, or from a numpy seed for a perturbed state, and goes to both
packages.

Tolerances, the tiers of test_torch_ring: up to 25 steps f atol 1e-7 and av
rtol 1e-4 (XLA-CPU rounding against strict float32; the port adds each
block's sums once after the loop, the JAX package psums scaled block sums).
The ``torch`` backend steps each block with the canonical equilibrium, as
the JAX ``jnp`` torus; the kernel path and the Pallas x_halo kernel use the
pair-symmetric form (the kernels' production form, window_step.py:28).
Against the port's own single-device routes the torus's state is bitwise
equal (the same cell arithmetic per cell).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm import cli as jcli
from tpulbm.core.params import LBMParams as JParams
from tpulbm.dist import sharding as jsharding
from tpulbm.dist.mesh import get_mesh_2d as j_get_mesh_2d
from tpulbm.dist.runner import _make_runner_2d_kstep
from tpulbm.dist.runner import make_runner as j_make_runner
from tpulbm_torch import cli
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner, sharding
from tpulbm_torch.dist.mesh import get_mesh_2d
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import _build, kstep_tile
from tpulbm_torch.validation import check

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data"
TILE = 32             # csrc/kstep_tile.cu: kTile


def _deck(name="128x128"):
    p = read_params(DATA / f"input_{name}.params")
    mask, n_free = read_obstacles(DATA / f"obstacles_{name}.dat", p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _case(ny, nx, seed):
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.1
    return p.with_free_cells(ny * nx - int(mask.sum())), mask


def _jp(p):
    return JParams(**dataclasses.asdict(p))


def _perturbed(p, seed):
    rng = np.random.RandomState(seed)
    return (initial_state(p).numpy()
            * (1 + 0.01 * rng.rand(9, p.ny, p.nx))).astype(np.float32)


def _torus(p, mask, f0, n_steps, dy, dx, chunk_fn=None):
    """The port's torus on CPU blocks: (gathered f, av series) as numpy.
    chunk_fn None: make_runner's torch backend; else make_torus_runner."""
    mesh = get_mesh_2d(dy, dx, device="cpu")
    if chunk_fn is None:
        run = runner.make_runner(p, n_steps, "auto", "cpu", mesh=mesh)
    else:
        run = runner.make_torus_runner(p, n_steps, mesh, chunk_fn)
    blocks, obst = sharding.shard_blocks(torch.tensor(f0), torch.tensor(mask),
                                         mesh)
    blocks, av = run(blocks, obst)
    assert all(b.shape == (9, p.ny // dy, p.nx // dx) for b in blocks)
    return sharding.gather_blocks(blocks, dy, dx, "cpu").numpy(), av.numpy()


def _close(got, want, f_atol=1e-7):
    (f, av), (f_ref, av_ref) = got, want
    assert f.shape == f_ref.shape and av.shape == av_ref.shape
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=f_atol)
    np.testing.assert_allclose(av, av_ref, rtol=1e-4)


def _single_device(p, mask, f0, n_steps):
    """The port's single-device K4 plan (plain on the CPU)."""
    plan = runner._chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, n_steps)
    f, av = runner.run_plan(plan, torch.tensor(f0),
                            torch.tensor(mask, dtype=torch.float32), p)
    return f.numpy(), av.numpy()


@pytest.mark.parametrize("ny,d", [(n, d) for n in (2, 3, 8, 12, 128, 130)
                                  for d in (1, 2, 3, 4, 8)])
def test_even_splits_match_jax(ny, d):
    """validate_even_split and validate_even_col_split are the JAX
    package's: the same values, the same messages."""
    for ours, theirs in ((sharding.validate_even_split,
                          jsharding.validate_even_split),
                         (sharding.validate_even_col_split,
                          jsharding.validate_even_col_split)):
        try:
            want = theirs(ny, d)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                ours(ny, d)
            assert str(got.value) == str(e)
        else:
            assert ours(ny, d) == want


def test_shard_blocks_round_trip_and_mesh():
    """shard_blocks cuts (i, j) blocks in row-major order; gather_blocks puts
    states and masks back; get_mesh_2d on the CPU is a dy x dx grid of the
    CPU and refuses an empty side."""
    mesh = get_mesh_2d(2, 3, device="cpu")
    assert mesh == [[torch.device("cpu")] * 3] * 2
    f = torch.arange(9 * 12 * 18, dtype=torch.float32).reshape(9, 12, 18)
    obst = torch.rand(12, 18) < 0.5
    fs, obs = sharding.shard_blocks(f, obst, mesh)
    assert [tuple(b.shape) for b in fs] == [(9, 6, 6)] * 6
    assert torch.equal(fs[4], f[:, 6:12, 6:12])
    assert all(b.is_contiguous() for b in fs + obs)
    assert torch.equal(sharding.gather_blocks(fs, 2, 3, "cpu"), f)
    assert torch.equal(sharding.gather_blocks(obs, 2, 3, "cpu"), obst)
    with pytest.raises(ValueError):
        get_mesh_2d(0, 2, device="cpu")


def _window_model(pieces, k, h, w, ty, bx, vec16):
    """K4 torus mode's load of tile (ty, bx)'s window, as
    csrc/kstep_tile.cu's window load addresses it: per window cell the value
    of the piece it comes from, NaN where the load fills the cell as
    blocked (past the band). pieces: (lo, xlo, mid, xhi, hi) as numpy
    (planes, rows, cols). Also checks that each column segment lies in one
    piece."""
    lo, xlo, mid, xhi, hi = pieces
    kx = kstep_tile.col_margin(k)
    wh, ww = TILE + 2 * k, TILE + 2 * kx
    band_rows, band_cols = h + 2 * k, w + 2 * kx
    y0, x0 = ty * TILE, bx * TILE
    seg_w = 4 if vec16 else 1
    win = np.full((lo.shape[0], wh, ww), np.nan)
    for wy in range(wh):
        sr = y0 + wy
        r = sr - k
        buf, mid_row = mid, True
        if r < 0:
            buf, r, mid_row = lo, sr, False
        elif r >= h:
            buf, r, mid_row = hi, r - h, False
        for seg in range(0, ww, seg_w):
            c = x0 + seg
            if sr >= band_rows or c >= band_cols:
                continue
            if not mid_row:
                src, col = buf, c
            elif c < kx:
                src, col = xlo, c
            elif c < kx + w:
                src, col = mid, c - kx
            else:
                src, col = xhi, c - kx - w
            assert col + seg_w <= src.shape[-1], "a segment crosses a piece"
            win[:, wy, seg:seg + seg_w] = src[:, r, col:col + seg_w]
    return win


@pytest.mark.parametrize("h,w,k", [(40, 64, 8), (16, 128, 8), (37, 44, 3),
                                   (5, 6, 1), (64, 33, 5)])
def test_torus_window_model_is_the_band(h, w, k):
    """Every piece stamped with its name and cell index: the window the
    kernel loads is torus_chunk_ref's band (``torus_band``) wherever a
    step can reach from an owned cell, and the x slabs' padding or a
    blocked fill elsewhere; with w % 4 == 0 the 16-byte segments each lie in
    one piece. The shapes: a 512 x 512 block's ragged rows, the Pallas
    x_halo test's 16 x 128 blocks, a width off the 16-byte copies, a tiny
    block and a ragged column tile."""
    kx = kstep_tile.col_margin(k)
    shapes = {"lo": (k, w + 2 * kx), "xlo": (h, kx), "mid": (h, w),
              "xhi": (h, kx), "hi": (k, w + 2 * kx)}
    pieces = []
    for code, (name, shape) in enumerate(shapes.items(), start=1):
        n = shape[0] * shape[1]
        pieces.append((code * 1e6 + np.arange(n, dtype=np.float64)).reshape(
            (1, *shape)))
    lo, xlo, mid, xhi, hi = (torch.tensor(a) for a in pieces)
    band = kstep_tile.torus_band(xlo, mid, xhi, lo, hi, k).numpy()
    assert band.shape == (1, h + 2 * k, w + 2 * k)
    pads = {1e6 * c + i for c in (2, 4) for i in range(h * kx)} | {
        1e6 * c + i for c in (1, 5) for i in range(k * (w + 2 * kx))}
    for vec16 in ({True, False} if w % 4 == 0 else {False}):
        for ty in range(-(-h // TILE)):
            for bx in range(-(-w // TILE)):
                win = _window_model(pieces, k, h, w, ty, bx, vec16)
                for wy in range(TILE + 2 * k):
                    for wc in range(TILE + 2 * kx):
                        r, c = ty * TILE + wy, bx * TILE + wc - (kx - k)
                        v = win[0, wy, wc]
                        if 0 <= r < h + 2 * k and 0 <= c < w + 2 * k:
                            assert v == band[0, r, c], (ty, bx, wy, wc)
                        else:
                            # outside the band: padding or a blocked fill,
                            # and beyond every owned cell's k-step reach
                            assert np.isnan(v) or v in pads, (wy, wc, v)
                            own_rows = min(TILE, h - ty * TILE)
                            oc = wc - kx       # column in the owned tile
                            assert (wy >= own_rows + 2 * k or oc < -k
                                    or oc >= min(TILE, w - bx * TILE) + k)


def test_corner_perturbation_reaches_the_diagonal_block():
    """A perturbation of the last cell of block (0, 0) only: after one
    8-step chunk over 2x2 blocks, the diagonal block (1, 1) differs from the
    unperturbed run (the corner rides the y slab of the x-extended band),
    and the torus's state is bitwise the single-device plan's in both runs.
    Taking the y slabs before the x exchange would lose the corners."""
    p, mask = _case(48, 64, seed=7)
    mask[:] = False
    p = p.with_free_cells(p.ny * p.nx)
    f0 = _perturbed(p, 8)
    f1 = f0.copy()
    f1[5, 23, 31] *= 1.5      # (h - 1, w - 1), moving up and right
    runs = []
    for f in (f0, f1):
        got = _torus(p, mask, f, 8, 2, 2, kstep_tile.torus_chunk)
        assert np.array_equal(got[0], _single_device(p, mask, f, 8)[0])
        runs.append(got[0])
    diff = runs[0] != runs[1]
    assert diff[:, 24:, 32:].any() and diff[:, :24, :32].any()


@pytest.mark.parametrize("i0,j0,h,w,k", [(24, 32, 24, 32, 8),
                                          (0, 0, 24, 32, 8),
                                          (13, 50, 11, 14, 3)])
def test_torus_pieces_step_to_the_whole_grid(i0, j0, h, w, k):
    """torus_pieces, the cut that chip_smoke.py and the card's tests hand
    the kernel: its block after one torus_chunk (plain on the CPU) is
    bitwise that block of the whole grid's tile_chunk, including blocks
    whose slabs wrap both axes, and its x slabs' padding is zero."""
    p, mask = _case(48, 64, seed=31)
    f0 = torch.tensor(_perturbed(p, 32))
    o = torch.tensor(mask, dtype=torch.float32)
    xlo, block, xhi, ylo, yhi, ob, base = kstep_tile.torus_pieces(
        f0, o, i0, j0, h, w, k)
    kx = kstep_tile.col_margin(k)
    assert base == (i0 - k) % p.ny and ob.shape == (h + 2 * k, w + 2 * kx)
    for t in (xlo[..., :kx - k], xhi[..., k:], ylo[..., :kx - k],
              yhi[..., kx + w + k:]):
        assert not t.any()
    got = kstep_tile.torus_chunk(xlo, block, xhi, ylo, yhi, ob, p, k, base)
    whole = kstep_tile.tile_chunk(f0, o, p, k)[0]
    assert torch.equal(got[0], whole[:, i0:i0 + h, j0:j0 + w])


@pytest.mark.parametrize("dy,dx", [(2, 4), (4, 2), (2, 2), (1, 8)])
def test_torus_matches_jax_jnp_torus(dy, dx):
    """The torch backend's torus and the kernel path's (torus_chunk per
    block, plain on the CPU) on the 128^2 deck against the JAX jnp torus
    (ppermute halos, per-step two-phase exchange), 25 steps from the rest
    state (three 8-step chunks and one of 1)."""
    p, mask = _deck()
    f0 = initial_state(p).numpy()
    run = j_make_runner(_jp(p), 25, mesh=j_get_mesh_2d(dy, dx), backend="jnp")
    f_j, av_j = run(jnp.asarray(f0), jnp.asarray(mask))
    want = np.asarray(f_j), np.asarray(av_j)
    _close(_torus(p, mask, f0, 25, dy, dx), want)
    _close(_torus(p, mask, f0, 25, dy, dx, kstep_tile.torus_chunk), want)


def test_perturbed_torus_matches_jax_and_one_device():
    """A numpy-seeded perturbed 128^2 state over 2x4 blocks for 19 steps
    (8 + 8 + 3): the torch backend against the JAX jnp torus, and the kernel
    path's state bitwise the single-device K4 plan's."""
    p, mask = _deck()
    f0 = _perturbed(p, 21)
    run = j_make_runner(_jp(p), 19, mesh=j_get_mesh_2d(2, 4), backend="jnp")
    f_j, av_j = run(jnp.asarray(f0), jnp.asarray(mask))
    _close(_torus(p, mask, f0, 19, 2, 4), (np.asarray(f_j), np.asarray(av_j)))
    f, av = _torus(p, mask, f0, 19, 2, 4, kstep_tile.torus_chunk)
    f1, av1 = _single_device(p, mask, f0, 19)
    assert np.array_equal(f, f1)
    np.testing.assert_allclose(av, av1, rtol=1e-6)


@pytest.mark.parametrize("dy,dx", [(3, 2), (2, 3)])
def test_torus_state_equals_the_single_device_route(dy, dx):
    """Blocks of 48 x 44 and 32 x 66 (k = 8, a 5-step remainder) on a
    random mask: the state bitwise the single-device K4 plan's, the av
    series to float32 rounding."""
    p, mask = _case(96, 132, seed=dy * 10 + dx)
    f0 = _perturbed(p, 22)
    f, av = _torus(p, mask, f0, 21, dy, dx, kstep_tile.torus_chunk)
    f1, av1 = _single_device(p, mask, f0, 21)
    assert np.array_equal(f, f1)
    np.testing.assert_allclose(av, av1, rtol=1e-6)


def test_kernel_torus_matches_jax_x_halo_kernel():
    """The kernel path's torus against _make_runner_2d_kstep, whose blocks
    run pallas_kstep._kernel with x_halo=True (interpret mode), in its
    production pair-symmetric form as K4's: a 32 x 256 grid over 2x2
    (16 x 128 blocks, the narrowest the TPU tier takes), 10 steps (an
    8-step chunk and a 2-step one)."""
    p, mask = _case(32, 256, seed=9)
    f0 = _perturbed(p, 23)
    run = _make_runner_2d_kstep(_jp(p), 10, j_get_mesh_2d(2, 2), k=8)
    mesh = j_get_mesh_2d(2, 2)
    f_s, o_s = jsharding.shard_arrays(mesh, jnp.asarray(f0),
                                      jnp.asarray(mask))
    f_j, av_j = run(f_s, o_s)
    _close(_torus(p, mask, f0, 10, 2, 2, kstep_tile.torus_chunk),
           (np.asarray(f_j), np.asarray(av_j)))


def test_torus_errors():
    """An uneven split and blocks of fewer than 3 columns raise the JAX
    messages; cuda-p2p on a 2-D mesh raises as pallas-rdma does; the K4
    launcher refuses CPU tensors before touching nvcc."""
    p, mask = _deck()
    for shape in ((3, 2), (2, 64)):
        mesh = get_mesh_2d(*shape, device="cpu")
        with pytest.raises(ValueError) as ours:
            runner.make_runner(p, 4, "torch", "cpu", mesh=mesh)
        assert str(ours.value) == _jax_split_message(p, *shape)
    with pytest.raises(ValueError, match="cuda-p2p"):
        runner.make_runner(p, 4, "cuda-p2p", "cpu",
                           mesh=get_mesh_2d(2, 2, device="cpu"))
    f0 = initial_state(p)
    h, w, k = 64, 64, 8
    kx = kstep_tile.col_margin(k)
    with pytest.raises(ValueError, match="CUDA"):
        kstep_tile._torus_launch(
            torch.zeros(9, h, kx), f0[:, :h, :w].contiguous(),
            torch.zeros(9, h, kx), torch.zeros(9, k, w + 2 * kx),
            torch.zeros(9, k, w + 2 * kx), torch.zeros(h + 2 * k, w + 2 * kx),
            p, k, 0)
    assert _build.LAUNCHES["torus_chunk"] == 0


def _jax_split_message(p, dy, dx):
    try:
        jsharding.validate_even_split(p.ny, dy)
        jsharding.validate_even_col_split(p.nx, dx)
    except ValueError as e:
        return str(e)
    raise AssertionError("the JAX package accepts the split")


def test_cli_torus(tmp_path, capsys):
    """python -m tpulbm_torch --device cpu --mesh-shape 2x4 writes both
    files, whose bytes are the single-device run's, and which pass
    validation.check against python -m tpulbm --mesh-shape 2x4 (virtual CPU
    mesh, 50 steps); a bad --mesh-shape and an uneven one exit 1 with the
    JAX CLI's line."""
    pf, of = DATA / "input_128x128.params", DATA / "obstacles_128x128.dat"
    ours, one, theirs = tmp_path / "torch", tmp_path / "one", tmp_path / "jax"
    base = [str(pf), str(of), "--max-iters", "50"]
    assert cli.main([*base, "--device", "cpu", "--mesh-shape", "2x4",
                     "--out-dir", str(ours)]) == 0
    assert cli.main([*base, "--device", "cpu", "--out-dir", str(one)]) == 0
    assert jcli.main([*base, "--backend", "jnp", "--mesh-shape", "2x4",
                      "--out-dir", str(theirs)]) == 0
    assert ((ours / "final_state.dat").read_bytes()
            == (one / "final_state.dat").read_bytes())
    assert check.main([
        "--ref-av-vels-file", str(theirs / "av_vels.dat"),
        "--ref-final-state-file", str(theirs / "final_state.dat"),
        "--av-vels-file", str(ours / "av_vels.dat"),
        "--final-state-file", str(ours / "final_state.dat")]) == 0
    capsys.readouterr()
    for shape in ("2by4", "3x2"):
        assert cli.main([*base, "--device", "cpu", "--mesh-shape",
                         shape]) == 1
        err = capsys.readouterr().err
        assert jcli.main([*base, "--mesh-shape", shape]) == 1
        assert err == capsys.readouterr().err
