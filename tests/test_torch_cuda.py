"""tpulbm_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device (marker ``cuda``) and skips
without one. The file imports no jax, so it runs on a GPU host without jax;
there, skip the jax-importing conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: nvcc contracts a*b+c into FMAs where the plain PyTorch ops
round twice, so kernel and plain differ in the last bits, growing with the
steps of a chunk (the per-step |u| sums more than f); the gates are
chip_smoke.py's, where the measurement behind them is noted.
"""

import numpy as np
import pytest
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist.runner import make_runner, resident_route
from tpulbm_torch.ops import _build, kstep, kstep_tile, resident

F_ATOL = 5e-7
AV_RTOL = 3e-4
K3_RTOL = 1e-6


def _make_case():
    """The 200 x 136 case: a seeded 10 % random mask and a 1 % perturbation
    of the rest state, on cuda:0."""
    p = LBMParams(nx=136, ny=200, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(9)
    mask = rng.rand(p.ny, p.nx) < 0.1
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    dev = torch.device("cuda")
    f0 = initial_state(p, dev) * torch.tensor(
        1 + 0.01 * rng.rand(9, p.ny, p.nx), dtype=torch.float32, device=dev)
    return p, f0, torch.tensor(mask, device=dev)


@pytest.fixture
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _make_case()


def _close(got, want):
    (f_k, s_k), (f_r, s_r) = got, want
    assert (f_k - f_r).abs().max().item() <= F_ATOL
    assert ((s_k - s_r).abs() / s_r.abs()).max().item() <= AV_RTOL


def _counter_is_zero(device):
    """The last block of every launch resets the ticket counter."""
    assert _build.ticket_counter(device).item() == 0


@pytest.mark.cuda
def test_fused_step_chunks_match_plain(case):
    """K1 through skew_chunk (8 steps) and kstep_chunk (3 steps), with the
    chunk's sums from the last launch's epilogue."""
    p, f0, mask = case
    o = mask.float()
    _close(kstep.skew_chunk(f0, o, p), kstep.skew_chunk_ref(f0, o, p))
    _close(kstep.kstep_chunk(f0, o, p, 3), kstep.kstep_chunk_ref(f0, o, p, 3))
    _counter_is_zero(f0.device)


@pytest.mark.cuda
def test_resident_chunk_matches_plain_and_repeats_bitwise(case):
    """K2 with its epilogue; two runs give identical bytes (no float
    atomics)."""
    p, f0, mask = case
    o = mask.float()
    got = resident.resident_chunk(f0, o, p, 64)
    _close(got, resident.resident_chunk_ref(f0, o, p, 64))
    again = resident.resident_chunk(f0, o, p, 64)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_kstep_tile_chunks_match_plain_and_repeat_bitwise(case):
    """K4 with its epilogue: whole grid at 8 and 3 steps (its state at 8
    steps bitwise K1's), and ring mode on a band of
    rows [-16, 16) around the seam holding the accelerated row ny-2, cut
    into lo, shard and hi (the seam fixes' function), against the plain
    band chunk."""
    p, f0, mask = case
    o = mask.float()
    for k in (8, 3):
        got = kstep_tile.tile_chunk(f0, o, p, k)
        _close(got, kstep_tile.tile_chunk_ref(f0, o, p, k))
        again = kstep_tile.tile_chunk(f0, o, p, k)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        _counter_is_zero(f0.device)
    # K4's state is K1's, bitwise (the same cell arithmetic)
    assert torch.equal(kstep_tile.tile_chunk(f0, o, p, 8)[0],
                       kstep.skew_chunk(f0, o, p)[0])
    rows = torch.arange(-16, 16, device=f0.device) % p.ny
    band, ob = f0[:, rows].contiguous(), o[rows].contiguous()
    lo, shard, hi = (band[:, :8].contiguous(), band[:, 8:-8].contiguous(),
                     band[:, -8:].contiguous())
    _close(kstep_tile.ring_chunk(lo, shard, hi, ob, p, 8, p.ny - 16),
           kstep_tile.band_chunk_ref(band, ob, p, 8, p.ny - 16))


@pytest.mark.cuda
def test_cuda_runner_goes_through_the_kernels(case):
    """The cuda backend's runner launches the kernels of its route and
    agrees with the torch backend (canonical vs pair-symmetric: same gate).
    136 columns are off the resident gate's 128-alignment: K6's grid kind,
    one launch of 2 x 8 steps and one of 5, and no K1 or K4 launch."""
    p, f0, mask = case
    assert not resident_route(p.ny, p.nx)
    _build.reset_launches()
    # a runner takes its input over, so each gets a copy
    f, av = make_runner(p, 21, "cuda", "cuda")(f0.clone(), mask)
    assert _build.LAUNCHES["grid_p2p"] == 2
    assert _build.LAUNCHES["tile_chunk"] == 0
    assert _build.LAUNCHES["skew_chunk"] == _build.LAUNCHES["kstep_chunk"] == 0
    _counter_is_zero(f0.device)
    # in-kernel reductions, one per chunk (two 8-step chunks, one of 5)
    assert _build.LAUNCHES["reduce_partials"] == 3
    assert not hasattr(_build.library(), "lbm_reduce_partials")
    f_r, av_r = make_runner(p, 21, "torch", "cuda")(f0, mask)
    _close((f, av), (f_r, av_r))


def _grid_case(ny, nx, seed):
    """A (ny, nx) grid with a seeded 10 % random mask and a 1 % perturbed
    rest state on cuda:0 (random numbers from torch's generator on the
    card, so that 8192^2 is made in bulk)."""
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.rand((ny, nx), generator=gen, device="cuda") < 0.1
    p = p.with_free_cells(ny * nx - int(mask.sum().item()))
    f0 = initial_state(p, "cuda") * (1 + 0.01 * torch.rand(
        (9, ny, nx), generator=gen, device="cuda"))
    return p, f0, mask


def _k4_chain(f, o, p, k, n):
    """n chunks of K4's whole-grid mode: (the state, the sums)."""
    sums = []
    for _ in range(n):
        f, s = kstep_tile.tile_chunk(f, o, p, k)
        sums.append(s)
    return f, torch.cat(sums)


def _grid_model_av(p, f, o, plan):
    """The av series of the grid kind over ``plan`` (kernel_plan's) from
    state f, in the grid kind's own order: each launch's partials, reduced
    by ring_p2p.grid_sums_ref chunk by chunk, then the av scale. Returns
    (the state, the av series)."""
    from tpulbm_torch.ops import ring_p2p, step_torch

    sums, spare = [], torch.empty_like(f)
    for _, k, n in plan:
        _, parts = ring_p2p._grid_launch(f, spare, o, p, k, n)
        parts = parts.cpu().numpy()
        sums += [ring_p2p.grid_sums_ref(parts[c * k:(c + 1) * k])
                 for c in range(n)]
        if n % 2:
            f, spare = spare, f
    ring_p2p.grid_exchange(f.device, p.ny, p.nx).check()
    flat = torch.tensor(np.concatenate(sums), device=f.device)
    return f, step_torch.scale_sums(flat, p)


# The runner's steps a call at each shape: full launches of
# grid_outer_per_launch chunks (64), a shorter one and a remainder launch
GRID_STEPS = {(100, 130): 8 * 66 + 3, (1024, 1024): 8 * 66 + 3,
              (2048, 2048): 8 * 66 + 3, (8192, 8192): 8 * 66 + 3}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(GRID_STEPS),
                         ids=[f"{y}x{x}" for y, x in GRID_STEPS])
def test_grid_p2p_is_k4s_whole_grid_chain(shape):
    """K6's grid kind, the one-card wide route, against K4's whole-grid
    chunks at 100 x 130 (ragged items, 4-byte row copies), 1024^2, 2048^2
    and 8192^2: one launch of 3 chunks at each k of 1-8, its state bitwise
    the K4 chain's, the error word clear and the ticket counter 0; its sums
    bitwise grid_sums_ref of its partials (the grid kind's own order of
    summing, its items and not K4's tiles), chunk by chunk, and within
    K3_RTOL of the K4 chain's; then two runner calls of make_runner (the
    epoch carried across them, launches of several chunks and a
    remainder): the state and the Reynolds number bitwise those of the
    same calls run on K4 (run_plan over tile_chunk), the av series bitwise
    the grid kind's own order of the same launches (_grid_model_av) and
    within K3_RTOL of K4's, grid_p2p launches alone."""
    from tpulbm_torch.diag.observables import calc_reynolds
    from tpulbm_torch.dist.runner import _chunks, kernel_plan, run_plan
    from tpulbm_torch.ops import ring_p2p

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ny, nx = shape
    p, f0, mask = _grid_case(ny, nx, ny + nx)
    o = mask.float()
    for k in range(1, 9):
        f, spare = f0.clone(), torch.empty_like(f0)
        sums, partials = ring_p2p._grid_launch(f, spare, o, p, k, 3)
        want, want_sums = _k4_chain(f0, o, p, k, 3)
        torch.cuda.synchronize()
        _counter_is_zero(f0.device)
        assert torch.equal(spare, want)
        parts = partials.cpu().numpy()
        model = np.concatenate([ring_p2p.grid_sums_ref(parts[c * k:(c + 1)
                                                             * k])
                                for c in range(3)])
        assert np.array_equal(sums.cpu().numpy(), model)
        assert ((sums - want_sums).abs() / want_sums.abs()).max().item() \
            <= K3_RTOL
        assert ring_p2p.grid_exchange(f0.device, ny, nx).words[0].item() == 0
        del f, spare, want, partials
    n = GRID_STEPS[shape]
    plan = kernel_plan(p, n)
    assert {fn for fn, _, _ in plan} == {ring_p2p.grid_p2p_chunks}
    assert len(plan) == 3 and plan[-1][1:] == (n % 8, 1)
    run = make_runner(p, n, "cuda", "cuda")
    k4 = _chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, n)
    f, g, h = f0.clone(), f0.clone(), f0.clone()
    _build.reset_launches()
    for _ in range(2):
        f, av = run(f, mask)
        g, av_k4 = run_plan(k4, g, o, p)
        h, av_model = _grid_model_av(p, h, o, plan)
        torch.cuda.synchronize()
        _counter_is_zero(f0.device)
        assert torch.equal(f, g) and torch.equal(f, h)
        assert torch.equal(av, av_model)
        assert ((av - av_k4).abs() / av_k4.abs()).max().item() <= K3_RTOL
    assert _build.LAUNCHES["grid_p2p"] == 4 * len(plan)
    assert calc_reynolds(f, mask, p).item() == calc_reynolds(g, mask, p).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(17, 130), (17, 2240)],
                         ids=["17x130", "17x2240"])
def test_grid_p2p_sums_hold_back_to_back_one_row_items(shape):
    """At k = 1 the grid kind's items of a 17-row grid (8 x 16, its last
    item row of one row) follow each other in the CTAs' streams, 1-row
    items back to back (tests/test_torch_wave.py: with two sums buffers a
    cell would leave item m + 2's sum in the wave that sums item m): four
    launches of 64 chunks, each state bitwise K4's 64 chunks, its sums
    bitwise grid_sums_ref of its partials and within K3_RTOL of K4's,
    chunk by chunk; the error word clear and the ticket counter 0."""
    from tpulbm_torch.ops import ring_p2p

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ny, nx = shape
    assert ring_p2p.grid_item(ny, nx)[:2] == (8, 16)
    p, f0, mask = _grid_case(ny, nx, ny * nx)
    o = mask.float()
    want, want_sums = _k4_chain(f0, o, p, 1, 64)
    for _ in range(4):
        f, spare = f0.clone(), torch.empty_like(f0)
        sums, partials = ring_p2p._grid_launch(f, spare, o, p, 1, 64)
        torch.cuda.synchronize()
        _counter_is_zero(f0.device)
        assert torch.equal(f, want)   # an even count of chunks: back in f
        model = np.concatenate([ring_p2p.grid_sums_ref(row)
                                for row in partials.cpu().numpy()[:, None]])
        assert np.array_equal(sums.cpu().numpy(), model)
        assert ((sums - want_sums).abs() / want_sums.abs()).max().item() \
            <= K3_RTOL
        assert ring_p2p.grid_exchange(f0.device, ny, nx).words[0].item() == 0


@pytest.mark.cuda
def test_grid_p2p_with_a_stuck_flag_raises(case):
    """A tile's flag planted below the epoch (a tile that never finished):
    the next runner call's launch waits on it, its producers give up after
    the 10 s bound, and the call raises (no hang) within a minute; the
    ticket counter is zeroed and the grid's flags dropped, so the call after
    runs from fresh flags: its state bitwise K4's chunks, its av series
    within K3_RTOL of theirs."""
    import time

    from tpulbm_torch.dist.runner import _chunks, run_plan
    from tpulbm_torch.ops import ring_p2p

    p, f0, mask = case
    run = make_runner(p, 16, "cuda", "cuda")
    f, _ = run(f0.clone(), mask)
    ex = ring_p2p.grid_exchange(f.device, p.ny, p.nx)
    assert ex.epoch >= 2
    ex.flags[5] = ex.epoch - 2
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="ran out"):
        run(f, mask)
    assert time.perf_counter() - t0 < 60
    _counter_is_zero(f0.device)
    assert ring_p2p.grid_exchange(f.device, p.ny, p.nx) is not ex
    got, av = run(f0.clone(), mask)
    want, av_k4 = run_plan(_chunks(kstep_tile.tile_chunk, 8, 16), f0.clone(),
                           mask.float(), p)
    assert torch.equal(got, want)
    assert ((av - av_k4).abs() / av_k4.abs()).max().item() <= K3_RTOL


@pytest.mark.cuda
def test_fused_sums_reduce_the_partials_and_reset_the_counter(case):
    """Each stepping kernel's epilogue: the returned sums are its partials
    reduced (within K3_RTOL of reduce_partials_ref, bitwise on a rerun),
    and the ticket counter reads 0 after every launch."""
    p, f0, mask = case
    o = mask.float()
    rows = torch.arange(40 - 8, 40 + 37 + 8, device=f0.device) % p.ny
    band, ob = f0[:, rows].contiguous(), o[rows].contiguous()
    lo, shard, hi = (band[:, :8].contiguous(), band[:, 8:-8].contiguous(),
                     band[:, -8:].contiguous())
    launches = [
        lambda: kstep._fused_steps(f0, o, p, 8, "skew_chunk"),
        lambda: kstep._fused_steps(f0, o, p, 3, "kstep_chunk"),
        lambda: resident._resident_launch(f0, o, p, 64),
        lambda: kstep_tile._tile_launch(f0, o, p, 8),
        lambda: kstep_tile._tile_launch(f0, o, p, 3),
        lambda: kstep_tile._ring_launch(lo, shard, hi, ob, p, 8, 32),
    ]
    _counter_is_zero(f0.device)
    for launch in launches:
        _, sums, partials = launch()
        torch.cuda.synchronize()
        _counter_is_zero(f0.device)
        want = kstep.reduce_partials_ref(partials)
        assert ((sums - want).abs() / want.abs()).max().item() <= K3_RTOL
        _, again, _ = launch()
        torch.cuda.synchronize()
        _counter_is_zero(f0.device)
        assert torch.equal(sums, again)


def _random_state(ny, nx, seed):
    """(params, float mask, perturbed rest state) of a seeded 10 % random
    mask, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.1
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    dev = torch.device("cuda")
    f0 = initial_state(p, dev) * torch.tensor(
        1 + 0.01 * rng.rand(9, ny, nx), dtype=torch.float32, device=dev)
    return p, torch.tensor(mask, dtype=torch.float32, device=dev), f0


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(256, 128), (256, 256), (256, 512)],
                         ids=["128x256", "256x256", "256x512"])
def test_resident_chunk_at_the_resident_shapes(ny, nx):
    """K2 at the shapes it runs on the main path (the 128x256 and 256^2
    decks' grids, the custom example's 256x512) for 1, 3, 64, 392 and 512
    steps, against the plain version; a rerun bitwise; one launch a
    call."""
    p, o, f0 = _random_state(ny, nx, seed=ny + nx)
    for k in (1, 3, 64, 392, 512):
        _build.reset_launches()
        got = resident.resident_chunk(f0, o, p, k)
        assert _build.LAUNCHES["resident_chunk"] == 1
        _close(got, resident.resident_chunk_ref(f0, o, p, k))
        again = resident.resident_chunk(f0, o, p, k)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(128, 128), (256, 128), (256, 256)],
                         ids=["128x128", "128x256", "256x256"])
def test_resident_chunk_is_bitwise_k4(ny, nx):
    """K2 and K4 run the same cell code in two schedules: one K2 chunk of
    512 steps gives the state of 64 K4 whole-grid chunks of 8."""
    p, o, f0 = _random_state(ny, nx, seed=ny * nx)
    k = resident.RESIDENT_K
    f, bufs = f0, (torch.empty_like(f0), torch.empty_like(f0))
    for c in range(k // kstep_tile.TILE_K):
        f, _ = kstep_tile.tile_chunk(f, o, p, kstep_tile.TILE_K,
                                     out=bufs[c % 2])
    assert torch.equal(resident.resident_chunk(f0, o, p, k)[0], f)


@pytest.mark.cuda
def test_ring_chunk_matches_plain_and_repeats_bitwise(case):
    """K4 ring mode on a 100-row shard whose band holds the accelerated
    row at k = 8, and on a 49-row shard at k = 1, against the plain
    version, one launch each."""
    p, f0, mask = case
    o = mask.float()
    for k, off, h in ((8, 100, 100), (1, 150, 49)):
        rows = torch.arange(off - k, off + h + k, device=f0.device) % p.ny
        band, ob = f0[:, rows].contiguous(), o[rows].contiguous()
        lo, shard, hi = (band[:, :k].contiguous(),
                         band[:, k:k + h].contiguous(),
                         band[:, k + h:].contiguous())
        base = (off - k) % p.ny
        want = kstep_tile.ring_chunk_ref(lo, shard, hi, ob, p, k, base)
        _build.reset_launches()
        got = kstep_tile.ring_chunk(lo, shard, hi, ob, p, k, base)
        _close(got, want)
        assert _build.LAUNCHES["ring_chunk"] == 1
        again = kstep_tile.ring_chunk(lo, shard, hi, ob, p, k, base)
        assert torch.equal(got[0], again[0])
        assert torch.equal(got[1], again[1])
        _counter_is_zero(f0.device)


@pytest.mark.cuda
def test_ring_runners_give_the_single_device_state(case):
    """The cuda ring (one ring_chunk launch per shard and chunk) and the
    cuda-p2p ring (K6: one ring_p2p launch a card for the two 8-step chunks
    and one for the 5-step remainder, no ring_chunk launch) over 3 shards
    (uneven) and 4 shards, 21 steps: the state bitwise equal to the
    single-device K4 plan's, the cuda-p2p av series bitwise the cuda
    ring's, within the chunk gate of the plan's; cuda-p2p on one shard
    warns and runs the single-device route."""
    from tpulbm_torch.dist import sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.dist.runner import run_plan

    p, f0, mask = case
    plan = [(kstep_tile.tile_chunk, 8, 1)] * 2 + [
        (kstep_tile.tile_chunk, 5, 1)]
    # a run takes its input over: its third chunk writes where the first read
    f1, av1 = run_plan(plan, f0.clone(), mask.float(), p)
    for n in (3, 4):
        mesh = get_mesh(n)
        avs = {}
        for backend in ("cuda", "cuda-p2p"):
            fs, obs = sharding.shard_rows(f0, mask, mesh)
            _build.reset_launches()
            out, avs[backend] = make_runner(p, 21, backend, mesh=mesh)(fs,
                                                                      obs)
            if backend == "cuda":
                assert _build.LAUNCHES["ring_chunk"] == 3 * n
                assert _build.LAUNCHES["ring_p2p"] == 0
            else:
                assert _build.LAUNCHES["ring_p2p"] == 2 * len(set(mesh))
                assert _build.LAUNCHES["ring_chunk"] == 0
                assert _build.LAUNCHES["reduce_partials"] == 3 * n
            assert torch.equal(sharding.gather_rows(out, "cuda"), f1)
            av = avs[backend]
            assert ((av - av1).abs() / av1.abs()).max().item() <= AV_RTOL
        assert torch.equal(avs["cuda"], avs["cuda-p2p"])
    f, av = make_runner(p, 21, "cuda-p2p", mesh=get_mesh(1))(f0.clone(), mask)
    assert torch.equal(f, f1)


def _p2p_case(case, nx):
    """The fixture's case, or a 96 x nx grid of its kind (nx % 4 != 0: K6's
    4-byte window loads)."""
    if nx is None:
        return case
    p = LBMParams(nx=nx, ny=96, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    rng = np.random.RandomState(19)
    mask = rng.rand(p.ny, p.nx) < 0.1
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    dev = torch.device("cuda")
    f0 = initial_state(p, dev) * torch.tensor(
        1 + 0.01 * rng.rand(9, p.ny, p.nx), dtype=torch.float32, device=dev)
    return p, f0, torch.tensor(mask, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [None, 130])
def test_ring_p2p_matches_plain_and_the_cuda_ring(case, nx):
    """K6 over 3 shards of the 200 x 136 case (16-byte window loads) and of
    a 96 x 130 grid (4-byte loads), in launches of 2, 1, 5 and 1 chunks of
    8 steps (the first reads the neighbours' states, the others the
    landing slots their predecessor filled, from odd and even epochs):
    over the first two launches (3 chunks) against p2p_chunks_ref from
    the same slots (F_ATOL, AV_RTOL: over 9 chunks nvcc's FMA contraction
    moved the sums of this decaying flow by 9.5e-4 relative on an H100,
    and the cuda ring's by the same bits); bitwise on a rerun; state and
    sums over
    all 9 chunks bitwise the cuda ring's ring_chunk; the error word and
    the ticket counter back at 0; every chunk's sums the reduction of its
    partials (K3_RTOL)."""
    from tpulbm_torch.dist import sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.ops import ring_p2p

    p, f0, mask = _p2p_case(case, nx)
    mesh = get_mesh(3)
    shards, _ = sharding.shard_rows(f0, mask, mesh)
    rows, offsets = sharding.ring_rows(p.ny, 3)
    k = 8
    o = mask.float()
    bands = [o[torch.arange(off - k, off + h + k, device=o.device) % p.ny]
             .to(dev) for off, h, dev in zip(offsets, rows, mesh)]
    bases = [(off - k) % p.ny for off in offsets]
    launches = ((2, True), (1, False), (5, False), (1, False))

    def kernel(plan):
        ex = ring_p2p.Exchange(mesh, rows, p.nx)
        states = [s.clone() for s in shards]
        spares = [torch.empty_like(s) for s in states]
        ex.barrier()   # the clones are written on each card's stream
        sums, parts = [[] for _ in rows], []
        for n_outer, pull0 in plan:
            s, pt = ring_p2p._p2p_launch(ex, states, spares, bands, p, k,
                                         n_outer, bases, pull0)
            if n_outer % 2:
                states, spares = spares, states
            for d in range(3):
                sums[d].append(s[d])
            parts += [(n_outer, pt)]
        torch.cuda.synchronize()
        ex.check()
        _counter_is_zero(f0.device)
        return states, [torch.cat(s) for s in sums], parts

    _build.reset_launches()
    states, sums, parts = kernel(launches)
    assert _build.LAUNCHES["ring_p2p"] == 4 * len(set(mesh))
    first = kernel(launches[:2])
    # the plain version on the first card (shards of several cards too)
    nan, one = float("nan"), f0.device
    lo = [torch.full((2, 9 * 8 * p.nx), nan, device=one) for _ in rows]
    hi = [torch.full((2, 9 * 8 * p.nx), nan, device=one) for _ in rows]
    ref = [s.to(one) for s in shards]
    ref_sums = [[] for _ in rows]
    for base, (n_outer, pull0) in zip((0, 2), launches[:2]):
        ref, s = ring_p2p.p2p_chunks_ref(ref, [b.to(one) for b in bands], lo,
                                         hi, p, k, n_outer, base, bases,
                                         pull0)
        for d in range(3):
            ref_sums[d].append(s[d])
    for d in range(3):
        _close((first[0][d].to(one), first[1][d].to(one)),
               (ref[d], torch.cat(ref_sums[d])))
    again = kernel(launches)
    for d in range(3):
        assert torch.equal(states[d], again[0][d])
        assert torch.equal(sums[d], again[1][d])
    chunk = 0
    for n_outer, pt in parts:
        for c in range(n_outer):
            for d in range(3):
                want = kstep.reduce_partials_ref(pt[d][c * k:(c + 1) * k])
                got = sums[d][(chunk + c) * k:(chunk + c + 1) * k]
                assert ((got - want).abs() / want.abs()).max().item() <= (
                    K3_RTOL)
        chunk += n_outer
    # the cuda ring over the same 9 chunks
    ring = [s.clone() for s in shards]
    ring_sums = [[] for _ in rows]
    for _ in range(chunk):
        new = []
        for d in range(3):
            dev = ring[d].device
            f, s = kstep_tile.ring_chunk(
                ring[d - 1][:, -k:].contiguous().to(dev), ring[d],
                ring[(d + 1) % 3][:, :k].contiguous().to(dev), bands[d], p,
                k, bases[d])
            new.append(f)
            ring_sums[d].append(s)
        ring = new
    for d in range(3):
        assert torch.equal(states[d], ring[d])
        assert torch.equal(sums[d], torch.cat(ring_sums[d]))
    _counter_is_zero(f0.device)


@pytest.mark.cuda
def test_torus_chunk_matches_plain_and_the_whole_grid(case):
    """K4 torus mode on a 100 x 68 block whose band holds the accelerated
    row (k = 8), a 37 x 45 block off the 16-byte copies (k = 3) and a block
    of the k = 8 kernel at the grid's corner, against torus_chunk_ref; one
    launch each, reruns bitwise, the ticket counter back at 0, the sums
    the partials' (K3_RTOL); and the blocks of a 2 x 2 cut of the grid after
    one chunk bitwise the whole grid's tile_chunk."""
    p, f0, mask = case
    o = mask.float()
    for k, i0, j0, h, w in ((8, 100, 36, 100, 68), (3, 20, 7, 37, 45),
                            (8, 0, 0, 100, 68)):
        args = kstep_tile.torus_pieces(f0, o, i0, j0, h, w, k)
        want = kstep_tile.torus_chunk_ref(*args[:6], p, k, args[6])
        _build.reset_launches()
        got = kstep_tile.torus_chunk(*args[:6], p, k, args[6])
        assert _build.LAUNCHES["torus_chunk"] == 1
        _close(got, want)
        again = kstep_tile.torus_chunk(*args[:6], p, k, args[6])
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        _counter_is_zero(f0.device)
        _, sums, partials = kstep_tile._torus_launch(*args[:6], p, k, args[6])
        torch.cuda.synchronize()
        want = kstep.reduce_partials_ref(partials)
        assert ((sums - want).abs() / want.abs()).max().item() <= K3_RTOL
        _counter_is_zero(f0.device)
    whole = kstep_tile.tile_chunk(f0, o, p, 8)[0]
    for i0 in (0, 100):
        for j0 in (0, 68):
            args = kstep_tile.torus_pieces(f0, o, i0, j0, 100, 68, 8)
            block = kstep_tile.torus_chunk(*args[:6], p, 8, args[6])[0]
            assert torch.equal(block, whole[:, i0:i0 + 100, j0:j0 + 68])


@pytest.mark.cuda
def test_torus_runner_gives_the_single_device_state(case):
    """The cuda torus over 2x2 and 4x2 blocks, 21 steps: the one-process
    route, one torus_p2p launch a card for the two 8-step chunks and one
    for the 5-step remainder (no torus_chunk launch), the state bitwise the
    single-device K4 plan's, the av series within the chunk gate; cuda-p2p
    refuses a 2-D mesh."""
    from tpulbm_torch.dist import sharding
    from tpulbm_torch.dist.mesh import get_mesh_2d
    from tpulbm_torch.dist.runner import run_plan

    p, f0, mask = case
    plan = [(kstep_tile.tile_chunk, 8, 1)] * 2 + [
        (kstep_tile.tile_chunk, 5, 1)]
    f1, av1 = run_plan(plan, f0.clone(), mask.float(), p)
    for dy, dx in ((2, 2), (4, 2)):
        mesh = get_mesh_2d(dy, dx)
        fs, obs = sharding.shard_blocks(f0, mask, mesh)
        _build.reset_launches()
        out, av = make_runner(p, 21, "cuda", mesh=mesh)(fs, obs)
        cards = len({d for row in mesh for d in row})
        assert _build.LAUNCHES["torus_p2p"] == 2 * cards
        assert _build.LAUNCHES["torus_chunk"] == 0
        assert _build.LAUNCHES["reduce_partials"] == 3 * dy * dx
        assert torch.equal(sharding.gather_blocks(out, dy, dx, "cuda"), f1)
        assert ((av - av1).abs() / av1.abs()).max().item() <= AV_RTOL
    with pytest.raises(ValueError, match="cuda-p2p"):
        make_runner(p, 21, "cuda-p2p", mesh=get_mesh_2d(2, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dy,dx", [(2, 2), (2, 4), (1, 4), (8, 1), (1, 1)])
def test_torus_p2p_is_k4_torus_mode_and_the_plain_version(case, dy, dx):
    """Torus mode of K6 (lbm_torus_p2p) over dy x dx blocks of the 200 x 136
    grid (2x4 and 1x4: 34-column blocks, its 4-byte window loads; 1x4,
    8x1 and 1x1: a block its own neighbour), 45 steps in two runner calls
    of launches of 2 chunks (pull0, then the landing slots, and a 5-step
    remainder): the state and av series bitwise the parent route's (K4
    torus mode a block and chunk, the slabs copied by the host); the error
    word and the ticket counter 0; its first launches of 3 chunks against
    torus_p2p_chunks_ref (state within F_ATOL, sums within AV_RTOL)."""
    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh_2d
    from tpulbm_torch.ops import ring_p2p

    p, f0, mask = case
    mesh = get_mesh_2d(dy, dx)
    got = []
    for make in (lambda: runner.make_torus_runner(p, 45, mesh,
                                                  kstep_tile.torus_chunk),
                 lambda: runner.make_torus_p2p_runner(p, 45, mesh,
                                                      max_outer=2)):
        run = make()
        # (a 1x1 block is f0 itself, which a run takes over)
        fs, obs = sharding.shard_blocks(f0.clone(), mask, mesh)
        avs = []
        _build.reset_launches()
        for _ in range(2):
            fs, av = run(fs, obs)
            avs.append(av)
        got.append((sharding.gather_blocks(fs, dy, dx, "cuda"),
                    torch.cat(avs), dict(_build.LAUNCHES)))
    (f_k4, av_k4, n_k4), (f_p2p, av_p2p, n_p2p) = got
    cards = len({d for row in mesh for d in row})
    assert n_k4["torus_p2p"] == 0 and n_p2p["torus_chunk"] == 0
    assert n_p2p["torus_p2p"] == 2 * 4 * cards
    assert torch.equal(f_p2p, f_k4) and torch.equal(av_p2p, av_k4)
    _counter_is_zero(f0.device)

    h, w = p.ny // dy, p.nx // dx
    k = min(8, h, w)
    blocks, obs = sharding.shard_blocks(f0.clone(), mask, mesh)
    ex = ring_p2p.TorusExchange(mesh, h, w)
    bands = [torch.cat([ylo, torch.cat([xlo, o, xhi], -1), yhi], -2)
             for o, (xlo, xhi, ylo, yhi) in zip(
                 [o.float() for o in obs],
                 ring_p2p.torus_halos([o.float() for o in obs], dy, dx, k))]
    bases = [(b // dx * h - k) % p.ny for b in range(dy * dx)]
    states = [b.clone() for b in blocks]
    spares = [torch.empty_like(b) for b in blocks]
    land = [{name: torch.full((2, n), float("nan"), device=b.device)
             for name, n in ring_p2p.torus_buffer_floats(h, w).items()}
            for b in blocks]
    ref, sums_ref = [b.clone() for b in blocks], []
    sums = []
    for n_outer, pull0 in ((2, True), (1, False)):
        states, spares, s = ring_p2p.torus_p2p_chunks(
            ex, states, spares, bands, p, k, n_outer, bases, pull0)
        sums.append(torch.stack([x.cpu() for x in s]))
        ref, s = ring_p2p.torus_p2p_chunks_ref(
            ref, bands, land, p, k, n_outer, ex.epoch - n_outer, bases,
            pull0, dy, dx)
        sums_ref.append(torch.stack([x.cpu() for x in s]))
    ex.check()
    assert max((a - b).abs().max().item() for a, b in zip(states, ref)) \
        <= F_ATOL
    s, s_ref = torch.cat(sums, 1), torch.cat(sums_ref, 1)
    assert ((s - s_ref).abs() / s_ref.abs()).max().item() <= AV_RTOL
    _counter_is_zero(f0.device)


@pytest.mark.cuda
@pytest.mark.parametrize("torus", [False, True], ids=["ring4", "torus2x2"])
def test_k6_counts_its_waits_and_launches(case, torus):
    """K6's counters (ring_p2p.WAITS), ring mode over 4 row shards and
    torus mode over 2x2 blocks of the 200 x 136 case, runner calls of 8
    steps (one launch a card, then the call's check): after each call every
    card's launches one more, 0 <= remote_ns <= wait_ns <= cta_ns and
    cta_ns > 0; remote_ns 0 where every shard lies on one card (no flag
    of another card to wait on); the state bitwise the route without
    K6's exchange (the cuda ring, K4 torus mode)."""
    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh, get_mesh_2d
    from tpulbm_torch.ops import ring_p2p

    p, f0, mask = case
    if torus:
        mesh = get_mesh_2d(2, 2)
        devs = [d for row in mesh for d in row]
        cut = sharding.shard_blocks
        p2p = runner.make_torus_p2p_runner(p, 8, mesh)
        other = runner.make_torus_runner(p, 8, mesh, kstep_tile.torus_chunk)
    else:
        mesh = devs = get_mesh(4)
        cut = sharding.shard_rows
        p2p = runner.make_p2p_runner(p, 8, mesh)
        other = runner.make_ring_runner(p, 8, mesh, kstep_tile.ring_chunk)
    cards = sorted({d.index for d in devs})
    fs, obs = cut(f0.clone(), mask, mesh)
    gs = [f.clone() for f in fs]
    ring_p2p.reset_waits()
    for call in range(1, 5):
        fs, _ = p2p(fs, obs)
        gs, _ = other(gs, obs)
        assert sorted(ring_p2p.WAITS) == cards
        for c in cards:
            w = ring_p2p.WAITS[c]
            assert w["launches"] == call
            assert 0 <= w["remote_ns"] <= w["wait_ns"] <= w["cta_ns"]
            assert w["cta_ns"] > 0
            if len(cards) == 1:
                assert w["remote_ns"] == 0
    assert all(torch.equal(f, g) for f, g in zip(fs, gs))
    _counter_is_zero(f0.device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ring4", "torus2x2", "grid"])
def test_k6_counts_its_look_ahead(case, kind):
    """K6's counts of its producer's look-ahead (ring_p2p.WAITS' next_n and
    ahead_n), two runner calls of 64 steps (one launch of 8 chunks a card,
    then the call's check): in ring mode over 4 row shards and torus mode
    over 2x2 blocks of the 200 x 136 case, all on one card, next_n is every
    item a CTA took after its first, the launch's items less its CTAs, and
    0 <= ahead_n <= next_n; the grid kind (a 1024^2 grid) counts neither."""
    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh, get_mesh_2d
    from tpulbm_torch.ops import ring_p2p

    if kind == "grid":
        p, f0, mask = _grid_case(1024, 1024, 23)
        run, fs, obs = make_runner(p, 64, "cuda", "cuda"), f0, mask
        items = None
    else:
        p, f0, mask = case
        if kind == "torus2x2":
            mesh = get_mesh_2d(2, 2)
            run = runner.make_torus_p2p_runner(p, 64, mesh)
            fs, obs = sharding.shard_blocks(f0.clone(), mask, mesh)
            items = 4 * ring_p2p.ntiles(p.ny // 2, p.nx // 2)
        else:
            mesh = get_mesh(4)
            run = runner.make_p2p_runner(p, 64, mesh)
            fs, obs = sharding.shard_rows(f0.clone(), mask, mesh)
            items = 4 * ring_p2p.ntiles(p.ny // 4, p.nx)
    card = f0.device.index or 0
    ctas = _build.library().lbm_ring_p2p_ctas(8)
    ring_p2p.reset_waits()
    for call in range(1, 3):
        fs, _ = run(fs, obs)
        w = ring_p2p.WAITS[card]
        assert w["launches"] == call and w["cta_ns"] > 0
        if items is None:
            assert w["next_n"] == w["ahead_n"] == 0
        else:
            assert w["next_n"] == call * (8 * items - min(8 * items, ctas))
            assert 0 <= w["ahead_n"] <= w["next_n"]
    _counter_is_zero(f0.device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["200x136/3", "1024x1024/4"])
def test_p2p_runner_is_bitwise_the_cuda_ring(case, shape):
    """K6's ring mode (make_p2p_runner) against the cuda ring
    (make_ring_runner over ring_chunk), all shards on one card, over two
    runner calls of 539 steps: 67 chunks of 8 (a launch of 64 and a tail
    launch of 3) and a 3-step remainder, on 3 shards of the 200 x 136 case
    (3 tile rows a shard) and on 4 shards of a 1024^2 grid (8 tile rows a
    shard). 67 is a multiple of neither 64 nor a shard's tile rows, so the
    rotation of each chunk's walk crosses the tail launch and the call's
    end (each launch's first chunk starts at tile row 0). States and av
    series bitwise, each call's."""
    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh

    n = int(shape.split("/")[1])
    p, f0, mask = case if n == 3 else _grid_case(1024, 1024, 29)
    mesh = get_mesh(n)
    got = {}
    for name, run in (
            ("p2p", runner.make_p2p_runner(p, 539, mesh)),
            ("ring", runner.make_ring_runner(p, 539, mesh,
                                             kstep_tile.ring_chunk))):
        fs, obs = sharding.shard_rows(f0.clone(), mask, mesh)
        got[name] = []
        for _ in range(2):
            fs, av = run(fs, obs)
            got[name].append((sharding.gather_rows(fs, "cuda"), av))
    for (f, av), (g, bv) in zip(got["p2p"], got["ring"]):
        assert torch.equal(f, g)
        assert torch.equal(av, bv)
    _counter_is_zero(f0.device)


@pytest.mark.cuda
def test_grid_kind_counts_its_row_waits_at_8192(case):
    """The grid kind's word of its stepping warps' waits for the rows its
    copy group loads (ring_p2p.WAITS' fill_ns): one 8192^2 runner call of
    64 steps (one launch of 8 chunks, then the call's check) counts it, 0 <
    fill_ns <= cta_ns and wait_ns <= cta_ns, one launch, its state bitwise
    the same call run on K4's whole-grid chunks (run_plan over tile_chunk);
    a ring-mode call of K6 over 4 row shards of the 200 x 136 case leaves
    fill_ns 0 (its tile step counts none)."""
    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.dist.runner import _chunks, run_plan
    from tpulbm_torch.ops import ring_p2p

    p, f0, mask = _grid_case(8192, 8192, 8192)
    card = f0.device.index or 0
    ring_p2p.reset_waits()
    run = make_runner(p, 64, "cuda", "cuda")
    f, _ = run(f0.clone(), mask)
    w = ring_p2p.WAITS[card]
    assert w["launches"] == 1
    assert 0 < w["fill_ns"] <= w["cta_ns"]
    assert 0 <= w["wait_ns"] <= w["cta_ns"]
    want, _ = run_plan(_chunks(kstep_tile.tile_chunk, 8, 64), f0,
                       mask.float(), p)
    assert torch.equal(f, want)
    del f, want, f0, mask

    p, f0, mask = case
    mesh = get_mesh(4)
    fs, obs = sharding.shard_rows(f0.clone(), mask, mesh)
    ring_p2p.reset_waits()
    runner.make_p2p_runner(p, 8, mesh)(fs, obs)
    for c in sorted({d.index for d in mesh}):
        assert ring_p2p.WAITS[c]["cta_ns"] > 0
        assert ring_p2p.WAITS[c]["fill_ns"] == 0
    _counter_is_zero(f0.device)


@pytest.mark.cuda
def test_torus_past_64_blocks_a_card_is_k4_torus_mode(case, capfd):
    """136 blocks of 25 x 8 (8x17) on one card, past torus mode's 64 a
    card: make_runner builds K4's torus mode and says so on stderr; 21
    steps launch torus_chunk a block and chunk and no torus_p2p, the state
    bitwise the single-device K4 plan's."""
    from tpulbm_torch.dist import sharding
    from tpulbm_torch.dist.runner import run_plan

    p, f0, mask = case
    plan = [(kstep_tile.tile_chunk, 8, 1)] * 2 + [
        (kstep_tile.tile_chunk, 5, 1)]
    f1, av1 = run_plan(plan, f0.clone(), mask.float(), p)
    mesh = [[f0.device] * 17 for _ in range(8)]
    run = make_runner(p, 21, "cuda", mesh=mesh)
    assert "136 blocks on (process 0, cuda:0), at most 64" in \
        capfd.readouterr().err
    fs, obs = sharding.shard_blocks(f0, mask, mesh)
    _build.reset_launches()
    out, av = run(fs, obs)
    assert _build.LAUNCHES["torus_p2p"] == 0
    assert _build.LAUNCHES["torus_chunk"] == 3 * 136
    assert torch.equal(sharding.gather_blocks(out, 8, 17, "cuda"), f1)
    assert ((av - av1).abs() / av1.abs()).max().item() <= AV_RTOL


# A process of the 2x4 torus over two processes of four blocks, block
# (i, j) on cuda:j (argv[1]: the output directory): 512 steps of the case
# through make_runner, its blocks, av series and launch counts saved
_TORUS_CHILD = """
import sys
import numpy as np
from test_torch_cuda import _make_case
from tpulbm_torch.dist import multihost, sharding
from tpulbm_torch.dist.runner import make_runner
from tpulbm_torch.ops import _build
multihost.init_distributed("gloo")
try:
    p, f0, mask = _make_case()
    mesh = multihost.global_torus_mesh(2, 4, "cuda")
    tr = multihost.Transport([d for row in mesh for d in row])
    run = make_runner(p, 512, "cuda", mesh=mesh, transport=tr)
    fs, obs = sharding.shard_blocks(f0, mask, mesh)
    _build.reset_launches()
    out, av = run(fs, obs)
    np.savez(f"{sys.argv[1]}/rank{tr.rank}.npz", av=av.cpu().numpy(),
             p2p=_build.LAUNCHES["torus_p2p"],
             k4=_build.LAUNCHES["torus_chunk"],
             **{f"f{b}": o.cpu().numpy() for b, o in zip(tr.local, out)})
finally:
    multihost.shutdown()
"""


def _torus_children(case, tmp_path, visible=None):
    """``_TORUS_CHILD`` in two processes (gloo at a file:// store;
    ``visible[r]``: process r's CUDA_VISIBLE_DEVICES, else every card);
    checks that both ran to their end with the same av series and that
    their state is bitwise K4's torus mode in one process over this
    process's cards. Returns (each process's npz, each one's stderr)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh_2d

    p, f0, mask = case
    _build.build()
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        (str(root), str(root / "tests"))),
        TPULBM_COORDINATOR=f"file://{tmp_path}/store", TPULBM_NUM_PROCS="2",
        TPULBM_LOCAL_SHARDS="4", LOCAL_WORLD_SIZE="2",
        GLOO_SOCKET_IFNAME="lo")
    procs = []
    for r in range(2):
        env_r = dict(env, TPULBM_PROC_ID=str(r), LOCAL_RANK=str(r))
        if visible is not None:
            env_r["CUDA_VISIBLE_DEVICES"] = visible[r]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _TORUS_CHILD, str(tmp_path)], env=env_r,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root))
    try:
        outs = [proc.communicate(timeout=300) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
    parts = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for part in parts:
        assert np.array_equal(part["av"], parts[0]["av"])
    got = sharding.gather_blocks(
        [torch.from_numpy(parts[b // 4][f"f{b}"]) for b in range(8)], 2, 4,
        "cpu")
    mesh = get_mesh_2d(2, 4)
    run = runner.make_torus_runner(p, 512, mesh, kstep_tile.torus_chunk)
    fs, obs = sharding.shard_blocks(f0.clone(), mask, mesh)
    want, av = run(fs, obs)
    assert torch.equal(got, sharding.gather_blocks(want, 2, 4, "cpu"))
    assert np.array_equal(parts[0]["av"], av.cpu().numpy())
    return parts, [err for _, err in outs]


@pytest.mark.cuda
def test_torus_p2p_past_four_flag_arrays_is_k4_torus_mode(case, tmp_path):
    """Torus mode with more than 4 flag arrays a card: the 2x4 torus of
    the 200 x 136 case over two processes of four blocks, block (i, j) on
    cuda:j, so 8 (process, card) keys and 6 flag arrays a card (the
    neighbours in the other process through CUDA IPC). 512 steps (64
    chunks, one launch a card and process): torus_p2p launches and no
    torus_chunk, the state and av series bitwise K4's torus mode in one
    process over the same cards. Needs four cards."""
    from tpulbm_torch.ops import ring_p2p

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    keys = [[(i, j) for j in range(4)] for i in range(2)]
    assert max(map(len, ring_p2p.torus_peers(keys).values())) == 6
    parts, _ = _torus_children(case, tmp_path)
    for part in parts:
        assert int(part["p2p"]) == 4 and int(part["k4"]) == 0


@pytest.mark.cuda
def test_torus_with_hidden_neighbour_cards_is_k4_torus_mode(case,
                                                            tmp_path):
    """The same 2x4 torus where each process sees only its own card
    (CUDA_VISIBLE_DEVICES 0 and 1, as a per-rank launcher sets it): no
    process can map the other's blocks, so make_runner builds K4's torus
    mode in both, each saying so on stderr; the run ends (no process left
    waiting), torus_chunk a block and chunk and no torus_p2p, the state
    and av series bitwise K4's torus mode in one process. Needs two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    parts, errs = _torus_children(case, tmp_path, visible=("0", "1"))
    for part in parts:
        assert int(part["p2p"]) == 0 and int(part["k4"]) == 4 * 64
    assert "which process 0 cannot see" in errs[0]
    assert "not visible in another process" in errs[1] or \
        "which process 1 cannot see" in errs[1]
    for err in errs:
        assert "falling back to K4's torus mode" in err


# The second process of the IPC round trip: maps the block of the handle
# (hex, argv[1]) on cuda:0, checks that it holds 0 .. n - 1 (argv[2]),
# writes their negatives, unmaps it
_IPC_CHILD = """
import sys
import torch
from tpulbm_torch.ops import ring_p2p
handle, n = bytes.fromhex(sys.argv[1]), int(sys.argv[2])
ptr = ring_p2p.open_block(0, handle)
got = torch.empty(n, dtype=torch.float32, device="cuda:0")
ring_p2p.copy_bytes(got.data_ptr(), ptr, 4 * n, "cuda:0")
want = torch.arange(n, dtype=torch.float32, device="cuda:0")
assert torch.equal(got, want), "the mapped block lacks the exporter's values"
neg = -want
ring_p2p.copy_bytes(ptr, neg.data_ptr(), 4 * n, "cuda:0")
ring_p2p.close_block(0, ptr)
"""


@pytest.mark.cuda
def test_exchange_block_crosses_processes():
    """K6's exchange memory across processes, alone: this process exports
    a block (cudaMalloc, cudaIpcGetMemHandle) holding 0 .. n - 1; a second
    process on the same card maps it (cudaIpcOpenMemHandle), reads the
    values, writes their negatives and unmaps it; this process then reads
    the negatives."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tpulbm_torch.ops import ring_p2p

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, dev = 1 << 16, torch.device("cuda", 0)
    ptr, handle = ring_p2p.alloc_block(dev, 4 * n, export=True)
    try:
        vals = torch.arange(n, dtype=torch.float32, device=dev)
        ring_p2p.copy_bytes(ptr, vals.data_ptr(), 4 * n, dev)
        root = Path(__file__).resolve().parent.parent
        env = dict(os.environ, PYTHONPATH=str(root))
        proc = subprocess.run([sys.executable, "-c", _IPC_CHILD, handle.hex(),
                               str(n)], capture_output=True, text=True,
                              env=env, cwd=root, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        back = torch.empty_like(vals)
        ring_p2p.copy_bytes(back.data_ptr(), ptr, 4 * n, dev)
        assert torch.equal(back, -vals)
    finally:
        ring_p2p._free_blocks([(0, ptr)])


@pytest.mark.cuda
def test_f64_oracle_on_the_card_matches_the_cpu():
    """The float64 oracle (tools/validate_f64.py) on the card against the
    same run on the CPU, 100 steps of the 128^2 deck (the two devices sum
    rho and the av series in other orders: 1e-12 relative); on the card
    the CUDA-graph path bitwise its eager path over 250 steps (two graph
    replays and an eager remainder)."""
    from pathlib import Path

    from tpulbm_torch.tools import validate_f64 as v

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, obst = v.load_deck("128x128",
                          Path(__file__).resolve().parent.parent / "data")
    f_gpu, av_gpu = v.run_f64(p, obst, 100, device="cuda")
    f_cpu, av_cpu = v.run_f64(p, obst, 100, device="cpu")
    assert np.abs((f_gpu - f_cpu) / f_cpu).max() <= 1e-12
    assert np.abs((av_gpu - av_cpu) / av_cpu).max() <= 1e-12
    f_g, av_g = v.run_f64(p, obst, 250, device="cuda")
    f_e, av_e = v.run_f64(p, obst, 250, device="cuda", graph=False)
    assert np.array_equal(f_g, f_e) and np.array_equal(av_g, av_e)


@pytest.mark.cuda
def test_checkpoint_through_the_pinned_stage_is_the_states_file(
        tmp_path, monkeypatch):
    """npz checkpoints of a state on the card go through a device snapshot
    and pinned buffers that a side stream fills (``checkpoint.HostStage``).
    With each copy on the side stream held back ~0.1 s, the first save's
    copy lands after the next runner call has overwritten the state's
    storage, the second save's snapshot waits for it, and the writer waits
    for each. Each file, and ``save_checkpoint()``'s at step 0, is byte for
    byte the one ``checkpoint.save`` writes from ``f.cpu()`` of the same
    state, and a Simulation resumed from the first continues bit for
    bit."""
    import contextlib
    import os
    import time

    from tpulbm_torch.sim import checkpoint as ckpt
    from tpulbm_torch.sim.simulation import Simulation

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    mask = np.random.RandomState(9).rand(200, 136) < 0.1
    p = LBMParams(nx=136, ny=200, max_iters=96, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    ref = Simulation(p, mask, device="cuda")
    want = {0: (ref.f.cpu().numpy(), ref.av_vels[:0].copy())}
    for _ in range(2):
        ref.run(n_steps=32)
        want[ref.step_count] = (ref.f.cpu().numpy(),
                                ref.av_vels[:ref.step_count].copy())
    side = torch.cuda.stream

    @contextlib.contextmanager
    def held(stream):
        with side(stream):
            torch.cuda._sleep(200_000_000)
            yield

    monkeypatch.setattr(torch.cuda, "stream", held)
    sim = Simulation(p, mask, device="cuda")
    sim.save_checkpoint(tmp_path / "ck")
    sim.run(n_steps=64, checkpoint_every=32,
            checkpoint_dir=str(tmp_path / "ck"))
    for step, (f, av) in want.items():
        name = os.path.basename(
            ckpt.save(tmp_path / "plain", step, f, av, sim.params))
        assert (tmp_path / "ck" / name).read_bytes() == (
            tmp_path / "plain" / name).read_bytes(), step
    resumed = Simulation(p, mask, device="cuda")
    resumed.restore_checkpoint(tmp_path / "ck" / "ckpt_00000032.npz")
    resumed.run(n_steps=32)
    assert torch.equal(resumed.f, ref.f)
    assert resumed.av_vels[:64].tobytes() == ref.av_vels[:64].tobytes()
