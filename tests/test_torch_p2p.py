"""The cuda-p2p ring (``ops.ring_p2p``, ``dist.runner.make_p2p_runner``,
kernel K6 ``csrc/ring_p2p.cu``) on the CPU: against the JAX package's
``--backend pallas-rdma`` (``pallas_resident_rdma`` and
``pallas_kstep_rdma`` in interpret mode on the 8-device virtual CPU mesh of
conftest.py), against the port's own ``cuda`` ring, and an eager model of
K6's flag protocol.

The shards lie on the CPU, so ``p2p_chunks`` takes its plain version,
``p2p_chunks_ref`` (K6 runs only on the card; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the same plain version and
the ``cuda`` ring there).

Tolerances, the tiers of test_torch_ring: against the JAX package (both
pair-symmetric), up to 19 steps f atol 1e-7 and av rtol 1e-4; 40 and 120
steps (the 200-step tier) f atol 5e-7 and av rtol 1e-4 (XLA-CPU rounding
against strict float32). Against the port's ``cuda`` ring on the CPU,
whose plain ``ring_chunk`` runs the same per-shard arithmetic: state and
sums bitwise. The model: bitwise the plain version, and no stale read.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.core.params import LBMParams as JParams
from tpulbm.dist.mesh import get_mesh as j_get_mesh
from tpulbm.dist.runner import _make_resident_rdma_runner
from tpulbm.dist.runner import make_runner as j_make_runner
from tpulbm.ops import pallas_kstep_rdma, pallas_resident_rdma
from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY, NSPEEDS
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner, sharding
from tpulbm_torch.dist.mesh import get_mesh
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import _build, kstep_tile, ring_p2p, step_torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data"


def _deck(name="128x128"):
    p = read_params(DATA / f"input_{name}.params")
    mask, n_free = read_obstacles(DATA / f"obstacles_{name}.dat", p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _case(ny, nx, seed):
    """A seeded 10 % random mask and a 1 % perturbation of the rest state
    (numpy)."""
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.1
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    f0 = (initial_state(p).numpy()
          * (1 + 0.01 * rng.rand(9, ny, nx))).astype(np.float32)
    return p, mask, f0


def _perturbed(p, seed):
    rng = np.random.RandomState(seed)
    return (initial_state(p).numpy()
            * (1 + 0.01 * rng.rand(9, p.ny, p.nx))).astype(np.float32)


def _run(make, p, mask, f0, n_steps, n_shards, calls=1):
    """A ring runner (make(p, n_steps, mesh)) on CPU shards, called
    ``calls`` times in a row, each on the last one's output: (the shards,
    the av series of every call) as numpy."""
    mesh = get_mesh(n_shards, device="cpu")
    run = make(p, n_steps, mesh)
    shards, obst = sharding.shard_rows(torch.tensor(f0), torch.tensor(mask),
                                       mesh)
    avs = []
    for _ in range(calls):
        shards, av = run(shards, obst)
        avs.append(av)
    return (sharding.gather_rows(shards, "cpu").numpy(),
            torch.cat(avs).numpy())


def _p2p(max_outer=ring_p2p.MAX_OUTER):
    def make(p, n_steps, mesh):
        return runner.make_p2p_runner(p, n_steps, mesh, max_outer=max_outer)
    return make


def _cuda_ring(p, n_steps, mesh):
    return runner.make_ring_runner(p, n_steps, mesh, kstep_tile.ring_chunk)


def _close(got, want, f_atol):
    (f, av), (f_ref, av_ref) = got, want
    assert f.shape == f_ref.shape and av.shape == av_ref.shape
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=f_atol)
    np.testing.assert_allclose(av, av_ref, rtol=1e-4)


@pytest.mark.parametrize("n_shards,n_steps", [(2, 16), (4, 40), (8, 19)])
def test_p2p_matches_jax_resident_rdma(n_shards, n_steps):
    """The cases of tests/test_pallas_resident_rdma.py on the 128^2 deck
    (two chunks in one call, five, and a 3-step remainder), from a
    perturbed state: the p2p runner against --backend pallas-rdma, which
    the JAX package sends to pallas_resident_rdma (a 64-, 32- or 16-row
    shard fits its VMEM) and the remainder to the ppermute K-step kernel."""
    p, mask = _deck()
    assert pallas_resident_rdma.supported(p.ny // n_shards, p.nx,
                                          min(8, n_steps), n_shards)
    f0 = _perturbed(p, 21 + n_shards)
    jrun = j_make_runner(JParams(**dataclasses.asdict(p)), n_steps,
                         j_get_mesh(n_devices=n_shards), backend="pallas-rdma")
    f_j, av_j = jrun(jnp.asarray(f0), jnp.asarray(mask))
    _close(_run(_p2p(), p, mask, f0, n_steps, n_shards),
           (np.asarray(f_j), np.asarray(av_j)),
           1e-7 if n_steps <= 19 else 5e-7)


def test_p2p_cross_call_parity_handoff_matches_jax():
    """tests/test_pallas_resident_rdma.py::test_cross_call_parity_handoff:
    120 steps over 2 shards, 3 chunks a launch (an odd count, so the slot
    parity flips between launches) in 5 launches, against the JAX
    package's resident-rdma runner with max_outer_per_call=3; and the same
    run as 5 runner calls of 24 steps (each call's first chunk reads the
    neighbours' states, the epochs go on)."""
    p, mask = _deck()
    f0 = _perturbed(p, 31)
    jrun = _make_resident_rdma_runner(JParams(**dataclasses.asdict(p)), 120,
                                      j_get_mesh(n_devices=2),
                                      max_outer_per_call=3)
    f_j, av_j = jrun(jnp.asarray(f0), jnp.asarray(mask))
    want = (np.asarray(f_j), np.asarray(av_j))
    got = _run(_p2p(3), p, mask, f0, 120, 2)
    _close(got, want, 5e-7)
    calls = _run(_p2p(3), p, mask, f0, 24, 2, calls=5)
    assert np.array_equal(calls[0], got[0])
    assert np.array_equal(calls[1], got[1])


def test_p2p_matches_jax_kstep_rdma_on_a_256_row_shard():
    """A 512 x 256 grid over 2 shards of 256 rows: too large for
    pallas_resident_rdma's VMEM (64K cells a shard > 48K), so the JAX
    package's pallas-rdma runs pallas_kstep_rdma, one launch a chunk
    (n_outer = 1); 16 steps of a perturbed state with a random mask."""
    p, mask, f0 = _case(512, 256, 41)
    assert not pallas_resident_rdma.supported(256, 256, 8, 2)
    assert pallas_kstep_rdma.supported(256, 256, 8, 2)
    jrun = j_make_runner(JParams(**dataclasses.asdict(p)), 16,
                         j_get_mesh(n_devices=2), backend="pallas-rdma")
    f_j, av_j = jrun(jnp.asarray(f0), jnp.asarray(mask))
    _close(_run(_p2p(1), p, mask, f0, 16, 2),
           (np.asarray(f_j), np.asarray(av_j)), 1e-7)


@pytest.mark.parametrize("n_shards,n_steps,max_outer", [
    (3, 45, 64),     # 342/341/341-like uneven rows, a 5-step remainder
    (5, 45, 2),      # launches of 2 chunks (odd epochs at each start)
    (3, 16, 1),      # one chunk a launch
    (2, 7, 64),      # one chunk of 7 steps, no remainder
])
def test_p2p_runner_is_bitwise_the_cuda_ring(n_shards, n_steps, max_outer):
    """The p2p runner against the cuda ring (make_ring_runner with
    ring_chunk, plain on the CPU) on 128 x 256 rows split unevenly: state
    and av series bitwise, also over three calls in a row."""
    p, mask = _deck("128x256")
    f0 = _perturbed(p, 40 + n_shards)
    got = _run(_p2p(max_outer), p, mask, f0, n_steps, n_shards, calls=3)
    want = _run(_cuda_ring, p, mask, f0, n_steps, n_shards, calls=3)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_p2p_chunks_ref_slots_by_parity():
    """p2p_chunks_ref's landing slots: after a chunk at epoch e, slot
    (e + 1) % 2 of shard d's lo holds shard d - 1's last k rows and its hi
    shard d + 1's first k rows; slot e % 2 is left alone; chunk 0 with pull0
    reads the states, not the slots (they hold NaN here)."""
    p, mask, f0 = _case(48, 40, 7)
    mesh = get_mesh(3, device="cpu")
    states, obst = sharding.shard_rows(torch.tensor(f0), torch.tensor(mask),
                                       mesh)
    rows, offsets = sharding.ring_rows(p.ny, 3)
    k = 5
    ex = ring_p2p.Exchange(mesh, rows, p.nx)
    for buf in ex.land_lo + ex.land_hi:
        buf.fill_(float("nan"))
    full = torch.tensor(mask, dtype=torch.float32)
    bands = [full[torch.arange(o - k, o + h + k) % p.ny]
             for o, h in zip(offsets, rows)]
    bases = [(o - k) % p.ny for o in offsets]
    f, _ = ring_p2p.p2p_chunks_ref(states, bands, ex.land_lo, ex.land_hi, p,
                                   k, 1, 4, bases, True)
    assert all(torch.isfinite(g).all() for g in f)
    for d in range(3):
        lo = ring_p2p.slot(ex.land_lo[d], 1, k, p.nx)
        hi = ring_p2p.slot(ex.land_hi[d], 1, k, p.nx)
        assert torch.equal(lo, f[d - 1][:, -k:])
        assert torch.equal(hi, f[(d + 1) % 3][:, :k])
        assert torch.isnan(ex.land_lo[d][0]).all()
    # chunk 1 (epoch 5) reads slot 1, and gives the ring's next chunk
    g, _ = ring_p2p.p2p_chunks_ref(f, bands, ex.land_lo, ex.land_hi, p, k, 1,
                                   5, bases, False)
    want, _ = ring_p2p.p2p_chunks_ref(f, bands, ex.land_lo, ex.land_hi, p, k,
                                      1, 5, bases, True)
    assert all(torch.equal(a, b) for a, b in zip(g, want))


def test_outer_per_launch_and_the_table():
    """Chunks a launch: 64, but 32 for an 8192^2 shard of 4 (16 MiB of
    partials); the table of a launch, the tile graph's record, the limits
    and the counter words are csrc/ring_p2p.cu's, the counters between
    the error word and the flags of both modes' exchange blocks."""
    assert ring_p2p.outer_per_launch([256] * 4, 1024, 8) == 64
    assert ring_p2p.outer_per_launch([2048] * 4, 8192, 8) == 32
    assert ring_p2p.outer_per_launch([8192], 8192, 8) == 8
    src = (_build.CSRC / "ring_p2p.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWords") == len(ring_p2p.TABLE)
    assert const("kMaxOuter") == ring_p2p.MAX_OUTER
    assert const("kMaxLocal") == ring_p2p.MAX_LOCAL
    assert const("kRec") == ring_p2p.REC
    assert const("kRecDeps") == ring_p2p.REC_DEPS == len(ring_p2p.HEADER)
    assert const("kPeerShift") == ring_p2p.PEER_SHIFT
    assert const("kMaxPeers") == ring_p2p.MAX_PEERS
    assert const("kPushRemote") == ring_p2p.PUSH_REMOTE
    assert const("kReadRemote") == ring_p2p.READ_REMOTE
    tile_src = (_build.CSRC / "tile_step.cuh").read_text()
    assert f"constexpr int kTile = {ring_p2p.TILE};" in tile_src
    for i, name in enumerate(ring_p2p.TABLE):
        field = re.sub(r"(\w+?)(\d)$", r"\1[\2]", name)
        assert re.search(rf"s\.{re.escape(field)} = [^;]*"
                         rf"(ptr\({i}\)|t\[{i}\])", src), (i, name)
    words = ("kCtaNs", "kWaitNs", "kRemoteNs", "kLaunches", "kFillNs",
             "kNextN", "kAheadN")
    assert len(words) == len(ring_p2p.WAIT_WORDS)
    for i, word in enumerate(words):
        assert re.search(rf"\b{word} = {i}\b", src), word
    for layout, _ in (ring_p2p.block_layout([256] * 4, [0, 1], 1024),
                      ring_p2p.torus_block_layout([0, 1], 64, 64)):
        assert layout["error"] == 0 and layout["waits"] % 8 == 0
        assert 4 <= layout["waits"] == ring_p2p.WAITS_AT
        assert layout["waits"] + 8 * len(words) <= layout["flags"]


def test_fill_word_is_the_kernels_and_has_its_place():
    """The grid kind's word of waits for the rows it loads: fill_ns fifth in
    WAIT_WORDS, csrc/ring_p2p.cu's kFillNs at the same index (the words
    before it where they were), added into only where the launch is the
    grid kind's (ring and torus mode leave it 0), from the stepping warps'
    count that wave_step.cuh's step_stream returns; its word lies between
    the error word and the flags in the ring's and the torus's exchange
    blocks, and inside the grid kind's words tensor."""
    src = (_build.CSRC / "ring_p2p.cu").read_text()
    wave = (_build.CSRC / "wave_step.cuh").read_text()
    assert ring_p2p.WAIT_WORDS[:4] == ("cta_ns", "wait_ns", "remote_ns",
                                       "launches")
    assert ring_p2p.WAIT_WORDS.index("fill_ns") == 4
    assert re.search(r"constexpr int kFillNs = 4;", src)
    assert re.search(r"if constexpr \(kGrid\)\s+atomicAdd\(L\.p\.waits "
                     r"\+ kFillNs, [^;]*waited\[2\]", src)
    assert re.search(r"waited\[2\] = fill;", src)
    assert re.search(r"unsigned long long step_stream\(", wave)
    assert re.search(r"\bfill \+= clock64\(\) - c0;", wave)
    assert "return fill;" in wave
    at = ring_p2p.WAITS_AT + 8 * ring_p2p.WAIT_WORDS.index("fill_ns")
    for layout, _ in (ring_p2p.block_layout([2048] * 4, [0, 1, 2, 3], 8192),
                      ring_p2p.torus_block_layout([0, 1, 2, 3], 4096, 4096)):
        assert layout["error"] + 4 <= layout["waits"] <= at
        assert at + 8 <= layout["flags"]
    ex = ring_p2p.GridExchange(torch.device("cpu"), 64, 64)
    assert ex.words.dtype == torch.int64
    assert at + 8 <= ex.words.numel() * 8 == (
        ring_p2p.WAITS_AT + 8 * len(ring_p2p.WAIT_WORDS))
    assert ex.counted.shape == (len(ring_p2p.WAIT_WORDS),)


def test_ahead_words_are_the_kernels_and_have_their_place():
    """Ring and torus mode's counts of the producer's look-ahead: next_n
    and ahead_n after fill_ns in WAIT_WORDS, csrc/ring_p2p.cu's kNextN and
    kAheadN at the same indices. produce leaves the items it took after
    the first (its loop's count, n) in waited[2] and counts those it issued
    only after the item before was stored (after wait, not under the step:
    the have branch counts nothing) in waited[0] from bit kLateShift, above
    its wait cycles; finish adds n to next_n and n less that count to
    ahead_n, and the cycles below the bit to wait_ns, only where the launch
    is not the grid kind's (its produce_stream counts neither: both 0, its
    waited[0] all cycles); both words lie between the error word and the
    flags in the ring's and the torus's exchange blocks, and inside the
    grid kind's words tensor."""
    src = (_build.CSRC / "ring_p2p.cu").read_text()
    assert ring_p2p.WAIT_WORDS[4:] == ("fill_ns", "next_n", "ahead_n")
    assert re.search(r"constexpr int kNextN = 5;", src)
    assert re.search(r"constexpr int kAheadN = 6;", src)
    assert re.search(r"constexpr int kLateShift = 40;", src)
    produce = src[src.index("void produce("):src.index("void finish(")]
    assert re.search(r"int n = 0;[^\n]*\n(.*\n){1,8}\s*for \(;; \+\+n\)",
                     produce)
    assert "if (have) issue(nt, st ^ 1);" in produce
    assert re.search(r"if \(!wait\(nt\)\) \{\s*stop\(st \^ 1\);\s*break;"
                     r"\s*\}\s*wait_cyc \+= 1ull << kLateShift;\s*"
                     r"issue\(nt, st \^ 1\);", produce)
    assert produce.count("kLateShift") == 2   # the comment's and the count
    assert re.search(r"waited\[0\] = wait_cyc;\s*waited\[1\] = remote_cyc;"
                     r"\s*waited\[2\] = n;", produce)
    finish = src[src.index("void finish("):src.index("void p2p_body(")]
    assert re.search(r"wait_cyc =\s*kGrid \? waited\[0\] : waited\[0\] & "
                     r"kCycles;", finish)
    assert re.search(r"late = kGrid \? 0 : waited\[0\] >> kLateShift;",
                     finish)
    assert re.search(r"atomicAdd\(L\.p\.waits \+ kWaitNs, [^;]*wait_cyc \* "
                     r"ns\)\);", finish)
    assert re.search(r"if constexpr \(kGrid\)\s+atomicAdd\(L\.p\.waits "
                     r"\+ kFillNs, [^;]*;\s*else \{\s*"
                     r"atomicAdd\(L\.p\.waits \+ kNextN, waited\[2\]\);\s*"
                     r"atomicAdd\(L\.p\.waits \+ kAheadN, waited\[2\] - "
                     r"late\);", finish)
    stream = src[src.index("void produce_stream("):
                 src.index("void grid_body(")]
    assert "kLateShift" not in stream
    at = ring_p2p.WAITS_AT + 8 * ring_p2p.WAIT_WORDS.index("ahead_n")
    assert at == ring_p2p.WAITS_AT + 8 * ring_p2p.WAIT_WORDS.index(
        "next_n") + 8
    for layout, _ in (ring_p2p.block_layout([2048] * 4, [0, 1, 2, 3], 8192),
                      ring_p2p.torus_block_layout([0, 1, 2, 3], 4096, 4096)):
        assert layout["waits"] < at and at + 8 <= layout["flags"]
    ex = ring_p2p.GridExchange(torch.device("cpu"), 64, 64)
    assert ex.words.numel() * 8 == at + 8


def test_count_waits_adds_fill_ns_per_card(monkeypatch):
    """_count_waits, as Exchange.check and GridExchange.check call it: what
    each word gained since the last read, fill_ns, next_n and ahead_n too,
    into WAITS of the card's index."""
    monkeypatch.setattr(ring_p2p, "WAITS", {})
    first = np.array([1000, 10, 0, 1, 300, 40, 30], dtype=np.uint64)
    counted = ring_p2p._count_waits(0, first, np.zeros(7, dtype=np.uint64))
    second = np.array([3000, 30, 0, 2, 700, 90, 80], dtype=np.uint64)
    ring_p2p._count_waits(0, second, counted)
    assert ring_p2p.WAITS == {0: dict(cta_ns=3000, wait_ns=30, remote_ns=0,
                                      launches=2, fill_ns=700, next_n=90,
                                      ahead_n=80)}


def test_p2p_route(capsys):
    """make_runner's route for cuda-p2p: over several processes of one host
    it takes the p2p ring and prints nothing (refused here on the CPU, as
    the cuda backend is); where the ring crosses hosts it prints the
    fallback line and takes the cuda ring; on one device the JAX package's
    line; on a 2-D mesh a refusal; a mesh with another process's shard
    needs the process group."""

    class Transport:
        world = 2

        def __init__(self, hosts):
            self.hosts = hosts

        def places(self):
            return [(d // 2, d % 2, f"GPU-{d}", host)
                    for d, host in enumerate(self.hosts)]

    p, _ = _deck()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        runner.make_runner(p, 10, "cuda-p2p", "cpu",
                           mesh=get_mesh(4, device="cpu"),
                           transport=Transport(["h0"] * 4))
    assert "falling back" not in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs a CUDA device"):
        runner.make_runner(p, 10, "cuda-p2p", "cpu",
                           mesh=get_mesh(4, device="cpu"),
                           transport=Transport(["h0", "h0", "h1", "h1"]))
    err = capsys.readouterr().err
    assert ("cuda-p2p unsupported across hosts (shard 1 of process 0 on h0, "
            "shard 2 of process 1 on h1: CUDA IPC does not cross hosts); "
            "falling back to the cuda ring") in err
    with pytest.raises(ValueError, match="needs a CUDA device"):
        runner.make_runner(p, 10, "cuda-p2p", "cpu",
                           mesh=get_mesh(4, device="cpu"))
    assert "falling back" not in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs a CUDA device"):
        runner.make_runner(p, 10, "cuda-p2p", "cpu",
                           mesh=get_mesh(1, device="cpu"))
    assert "falling back to the single-device route" in (
        capsys.readouterr().err)
    with pytest.raises(ValueError, match="cuda-p2p"):
        runner.make_runner(p, 10, "cuda-p2p", "cpu",
                           mesh=[[torch.device("cpu")] * 2] * 2)
    with pytest.raises(ValueError, match="owns shards 0-1"):
        runner.make_p2p_runner(p, 10, [torch.device("cpu"), None])


# An eager model of K6's flag protocol (csrc/ring_p2p.cu). Each card runs
# its launches in order; a launch's CTAs are two Python generators each, the
# stepping warps and the producer warp, interleaved by a seeded random
# scheduler with every other card's. The producer walks the CTA's items
# (chunk, shard, tile) chunk-major with the grid's stride, each chunk's
# walk starting one tile row further down as the kernel's ring mode and
# grid kind do (walk_record; the plain walk, record order in every chunk,
# is torus mode's), and does what the kernel's does: wait for the first
# item's flags and load its window into stage 0; then, while the stepping
# warps step tile n, poll the next item's flags and load its window into
# the other stage where they are done; wait until tile n is stored,
# release its flag; where the next window is not loaded yet, wait for its
# flags (after the release) and load it; after the last item, a stop. The
# stepping warps take the stages in turn, step the window, write the owned
# rows into the other state buffer and the edge rows into the neighbours'
# landing slots of the next epoch's parity, row by row, and signal the
# stage done. Loads go row by row too. A tile waits
# on the tiles of the host-built tile graph (ring_p2p.tile_graph, decoded
# from its records by graph_deps) unless a test gives another relation.
# Every cell of every buffer carries the epoch of the state it holds, and a
# load checks that each cell the tile's owned results depend on (the owned
# cells and k around them) holds the item's epoch: a stale or too-new value
# is recorded. Cells outside that cone are loaded as NaN, so a result that
# depended on them would not be bitwise the plain version's. MODEL_TILE is
# 8 (the kernel's is 32) to have many tiles on a small grid: the
# dependency rule needs only k <= the tile edge.
MODEL_TILE = 8
# Across processes, the most scheduler steps a process's host takes to
# reach a prologue (FlagModel.prologue)
HOST_DELAY = 500


def walk_record(c, i, items, rot):
    """The record that walk index i of chunk c takes (ring mode and the
    grid kind: rot the tiles or items of a tile row; 0 the plain walk)."""
    return (i + c * rot) % items


def model_deps(rows, nx, d, tile, k, t=MODEL_TILE, cross=True):
    """The per-tile rule of K6's first design, a superset of the cone:
    tile columns tx - 2 .. tx + 2 of tile rows ty - 1 .. ty + 1, the
    previous shard's last two tile rows (ty = 0) and the next shard's first
    (where rows within k of the tile pass the shard's end). ``cross=False``
    drops the other shards' (the variant the model must catch)."""
    n, h, tiles_x = len(rows), rows[d], -(-nx // t)
    ty, tx = divmod(tile, tiles_x)
    cols = [(tx + o) % tiles_x for o in (-2, -1, 0, 1, 2)]
    out = [(d, r * tiles_x + c) for r in (ty - 1, ty, ty + 1)
           if 0 <= r < -(-h // t) for c in cols]
    if not cross:
        return out
    if ty == 0:
        q = (d - 1) % n
        last = -(-rows[q] // t) - 1
        out += [(q, r * tiles_x + c) for r in (last, last - 1) if r >= 0
                for c in cols]
    y0 = ty * t
    if y0 + min(t, h - y0) + k > h:
        out += [((d + 1) % n, c) for c in cols]
    return out


def decode_graph(cards, rows, nx, k, t=MODEL_TILE):
    """ring_p2p.tile_graph's records of every card, decoded: {(shard,
    tile): [(shard, tile) it waits on, in record order]}, and {(shard,
    tile): its header}; checks that a record's dependencies on this card
    come first, then the others'."""
    graphs = ring_p2p.tile_graph(cards, rows, nx, k, t)
    of = {}
    for card, (recs, _) in graphs.items():
        local = [d for d in range(len(rows)) if cards[d] == card]
        for i, rec in enumerate(recs):
            of[card, i] = (local[rec[0]], int(rec[1]))
    deps, header = {}, {}
    mask = (1 << ring_p2p.PEER_SHIFT) - 1
    for card, (recs, peers) in graphs.items():
        assert peers[0] == card and len(set(peers)) == len(peers)
        for i, rec in enumerate(recs):
            n_local, n_remote = rec[7] & 255, rec[7] >> 8
            out = []
            for j in range(n_local + n_remote):
                e = int(rec[ring_p2p.REC_DEPS + j])
                peer = e >> ring_p2p.PEER_SHIFT
                assert (peer == 0) == (j < n_local)
                out.append(of[peers[peer], e & mask])
            deps[of[card, i]] = out
            header[of[card, i]] = dict(zip(ring_p2p.HEADER, map(int, rec)))
    return deps, header


def _shape(t):
    """A tile or item shape (rows, columns) from an edge or a pair."""
    return (t, t) if isinstance(t, int) else tuple(t)


def decode_grid(ny, nx, k, t=MODEL_TILE):
    """ring_p2p.grid_graph's records for items of shape t (an edge or
    (rows, columns)) decoded: ({item: [items it waits on, in record
    order]}, {item: its header}); every dependency a flag of this card."""
    deps, header = {}, {}
    for i, rec in enumerate(ring_p2p.grid_graph(ny, nx, k, _shape(t))):
        n_local, n_remote = rec[7] & 255, rec[7] >> 8
        assert n_remote == 0
        got = [int(e) for e in rec[ring_p2p.REC_DEPS:ring_p2p.REC_DEPS
                                   + n_local]]
        assert all(e >> ring_p2p.PEER_SHIFT == 0 for e in got)
        deps[i] = got
        header[i] = dict(zip(ring_p2p.HEADER, map(int, rec)))
    return deps, header


@functools.lru_cache(maxsize=None)
def _grid_relation(ny, nx, k, t):
    return decode_grid(ny, nx, k, t)[0]


def grid_graph_deps(rows, nx, d, tile, k, t):
    """The model's relation from the grid kind's graph (one shard, d = 0,
    of rows[0] rows; items of shape t)."""
    return [(0, u) for u in _grid_relation(rows[0], nx, k, _shape(t))[tile]]


def graph_deps(cards):
    """The model's relation from the tile graph of shards on ``cards``."""
    memo = {}

    def deps(rows, nx, d, tile, k, t):
        key = (tuple(rows), nx, k, t)
        if key not in memo:
            memo[key] = decode_graph(cards, rows, nx, k, t)[0]
        return memo[key][d, tile]
    return deps


def _band_steps(lo, mid, hi, obst_band, params, k, row_base):
    """ring_chunk_ref's arithmetic on a band lo | mid | hi: (mid's rows
    after k steps, per step the |u| of mid's rows)."""
    h = mid.shape[1]
    blocked = obst_band != 0
    f, speeds = torch.cat([lo, mid, hi], dim=1), []
    for s in range(k):
        rows = f.shape[1]
        b = blocked[s:s + rows]
        for j in range(rows):
            if (row_base + s + j) % params.ny == params.accel_row:
                f = step_torch.accelerate(f, b, params, row=j)
        pulled = [torch.roll(f[q, 1 - CY[q]:rows - 1 - CY[q]], CX[q], dims=1)
                  for q in range(NSPEEDS)]
        out, speed = physics.collide(pulled, b[1:rows - 1], params.omega,
                                     True)
        f = torch.stack(out)
        own = k - s - 1
        speeds.append(speed[own:own + h])
    return f, speeds


class FlagModel:
    """The buffers, tags and flags of a p2p ring of ``rows`` shards on
    ``cards`` (card of shard d), and its scheduler. ``deps`` (None: the
    tile graph's) is the relation a tile waits on; ``early_release``
    releases a tile's flag as soon as its window is loaded, before its
    stores (the variant the model must catch). ``processes``: the cards are
    (process, card) keys of several processes, and a launch whose first
    chunk would read the neighbours' states (pull0) is run as across
    processes (ring_p2p.Exchange.enter): a prologue on each card, after
    its launch before, pushes its shards' input edge rows into the
    neighbours' slots of the launch's first parity, and, with
    ``entry_order``, no card starts the launch before every card has
    pushed; its chunk 0 then reads the slots. ``grid``: the grid kind, one
    shard (the whole grid) on one card, its window rows wrapping into the
    state itself, no slots, no pushes and no pull0 (the relation, where
    ``deps`` is None, ring_p2p.grid_graph's). ``rotate``: each chunk's walk
    starts one tile or item row further down (the kernel's ring mode and
    grid kind; False: the plain walk, in the grid kind too). ``t``: the
    tiles' edge, or (rows, columns) of the grid kind's items."""

    def __init__(self, params, rows, offsets, cards, mask, states, k,
                 deps=None, t=MODEL_TILE, early_release=False,
                 processes=False, entry_order=True, grid=False, rotate=True):
        self.p, self.rows, self.offsets, self.cards = params, rows, offsets, cards
        self.k, self.t, self.grid = k, t, grid
        self.th, self.tw = _shape(t)
        if deps is None:
            deps = grid_graph_deps if grid else graph_deps(cards)
        self.deps = deps
        self.early_release = early_release
        self.processes, self.entry_order = processes, entry_order
        self.nx = params.nx
        self.tiles_x = -(-self.nx // self.tw)
        self.rot = self.tiles_x if rotate else 0
        n = len(rows)
        nan = float("nan")
        self.buf = [[s.clone(), torch.full_like(s, nan)] for s in states]
        self.tag = [[np.zeros((h, self.nx), int), np.full((h, self.nx), -1)]
                    for h in rows]
        self.cur = 0                 # the buffer holding the state
        self.slots = {side: [[torch.full((9, k, self.nx), nan)
                              for _ in range(2)] for _ in range(n)]
                      for side in ("lo", "hi")}
        self.slot_tag = {side: [[np.full((k, self.nx), -1) for _ in range(2)]
                                for _ in range(n)] for side in ("lo", "hi")}
        self.flags = [np.zeros(-(-h // self.th) * self.tiles_x, int)
                      for h in rows]
        full = torch.tensor(mask, dtype=torch.float32)
        self.bands = [full[torch.arange(o - k, o + h + k) % params.ny]
                      for o, h in zip(offsets, rows)]
        self.epoch = 0
        self.stale = []
        self.speed = {}

    def ntiles(self, d):
        return self.flags[d].size

    def ready(self, launch, item):
        c, d, tile = self.locate(launch, item)
        return all(self.flags[q][u] >= launch["base"] + c
                   for q, u in self.deps(self.rows, self.nx, d, tile,
                                         self.k, self.t))

    def locate(self, launch, item):
        c, r = divmod(item, launch["items"])
        r = walk_record(c, r, launch["items"], self.rot)
        for d in launch["shards"]:
            if r < self.ntiles(d):
                return c, d, r
            r -= self.ntiles(d)
        raise AssertionError(item)

    def source(self, launch, c, d, r):
        """(values (9, nx), tags (nx,)) of band row r - k ... of shard d at
        chunk c: shard row r (may be < 0 or >= h)."""
        h, k, e = self.rows[d], self.k, launch["base"] + c
        n = len(self.rows)
        if self.grid:
            r %= h
        if 0 <= r < h:
            b = launch["cur"] ^ (c % 2)
            return self.buf[d][b][:, r], self.tag[d][b][r]
        if launch["pull0"] and c == 0:
            q = (d - 1) % n if r < 0 else (d + 1) % n
            rr = self.rows[q] + r if r < 0 else r - h
            b = launch["cur"]
            return self.buf[q][b][:, rr], self.tag[q][b][rr]
        side, rr = ("lo", r + k) if r < 0 else ("hi", r - h)
        return (self.slots[side][d][e % 2][:, rr],
                self.slot_tag[side][d][e % 2][rr])

    def load(self, launch, item):
        """The window of the item's needed cone, row by row (a generator
        returning (c, d, tile, band (9, own + 2k, nx))); records a stale
        cell."""
        c, d, tile = self.locate(launch, item)
        k, th, tw, e = self.k, self.th, self.tw, launch["base"] + c
        ty, tx = divmod(tile, self.tiles_x)
        y0, x0 = ty * th, tx * tw
        own = min(th, self.rows[d] - y0)
        cols = np.arange(x0 - k, x0 + min(tw, self.nx - x0) + k) % self.nx
        band = torch.full((9, own + 2 * k, self.nx), float("nan"))
        for i, r in enumerate(range(y0 - k, y0 + own + k)):
            vals, tags = self.source(launch, c, d, r)
            band[:, i, cols] = vals[:, cols]
            if not (tags[cols] == e).all():
                self.stale.append((e, d, tile, r, sorted(set(tags[cols]))))
            yield "work"
        return c, d, tile, band

    def release(self, launch, item):
        """A tile's flag: the epoch it finished + 1."""
        c, d, tile = self.locate(launch, item)
        self.flags[d][tile] = launch["base"] + c + 1

    def step_store(self, launch, window):
        """Step the window's tile, write its owned cells and slabs row by
        row, record its speeds."""
        c, d, tile, band = window
        k, th, tw, n = self.k, self.th, self.tw, len(self.rows)
        e, h = launch["base"] + c, self.rows[d]
        ty, tx = divmod(tile, self.tiles_x)
        y0, x0 = ty * th, tx * tw
        own = min(th, h - y0)
        cols = slice(x0, x0 + min(tw, self.nx - x0))
        ob = self.bands[d][y0:y0 + own + 2 * k]
        f, speeds = _band_steps(band[:, :k], band[:, k:k + own],
                                band[:, k + own:], ob, self.p, k,
                                (self.offsets[d] - k + y0) % self.p.ny)
        yield "work"
        out = launch["cur"] ^ ((c + 1) % 2)
        for i in range(own):
            row = y0 + i
            self.buf[d][out][:, row, cols] = f[:, i, cols]
            self.tag[d][out][row, cols] = e + 1
            if self.grid:
                yield "work"
                continue
            if row >= h - k:
                q = (d + 1) % n
                self.slots["lo"][q][(e + 1) % 2][:, row - (h - k), cols] = (
                    f[:, i, cols])
                self.slot_tag["lo"][q][(e + 1) % 2][row - (h - k), cols] = e + 1
            if row < k:
                q = (d - 1) % n
                self.slots["hi"][q][(e + 1) % 2][:, row, cols] = f[:, i, cols]
                self.slot_tag["hi"][q][(e + 1) % 2][row, cols] = e + 1
            yield "work"
        maps = self.speed.setdefault((e, d), [torch.full((h, self.nx),
                                                         float("nan"))
                                              for _ in range(k)])
        for s in range(k):
            maps[s][y0:y0 + own, cols] = speeds[s][:, cols]

    def prologue(self, launch, card, pushed, delay):
        """The entry of a launch across processes on ``card`` (see the
        class): ``delay`` steps of the host before it issues the pushes
        (each process reaches its prologue at its own time), the pushes,
        row by row, then the entry order."""
        for _ in range(delay):
            yield "work"
        n, k, e, b = len(self.rows), self.k, launch["base"], launch["cur"]
        for d in [d for d in range(n) if self.cards[d] == card]:
            h = self.rows[d]
            for r in range(k):
                for side, q, row in (("lo", (d + 1) % n, h - k + r),
                                     ("hi", (d - 1) % n, r)):
                    self.slots[side][q][e % 2][:, r] = self.buf[d][b][:, row]
                    self.slot_tag[side][q][e % 2][r] = self.tag[d][b][row]
                    yield "work"
        pushed.add(card)
        while self.entry_order and len(pushed) < len(set(self.cards)):
            yield "wait"

    def resume(self, states):
        """The next call starts from ``states`` (a restored checkpoint) at
        the current epoch: the slots hold edges of a state that is gone."""
        nan = float("nan")
        self.buf = [[s.clone(), torch.full_like(s, nan)] for s in states]
        self.tag = [[np.full((h, self.nx), self.epoch),
                     np.full((h, self.nx), -1)] for h in self.rows]
        self.cur = 0
        for tags in self.slot_tag.values():
            for pair in tags:
                for t in pair:
                    t[:] = -2

    def stepping_warps(self, launch, cta):
        """The CTA's stepping warps: tile n from stage n % 2 once it is
        full, then the stage done (see the comment above)."""
        n = 0
        while True:
            st = n % 2
            while cta["full"][st] <= n // 2:
                yield "wait"
            window = cta["stage"][st]
            if window is None:
                return
            yield from self.step_store(launch, window)
            cta["done"][st] += 1
            n += 1

    def producer(self, launch, cta, b, grid):
        """The CTA's producer warp (see the comment above)."""
        total = launch["items"] * launch["n_outer"]
        items = list(range(b, total, grid))

        def fill(st, item):
            cta["stage"][st] = yield from self.load(launch, item)
            cta["full"][st] += 1
            if self.early_release:
                self.release(launch, item)

        while not self.ready(launch, items[0]):
            yield "wait"
        yield from fill(0, items[0])
        for n, item in enumerate(items):
            st, nxt = n % 2, item + grid
            have = False
            if nxt < total:
                while cta["done"][st] <= n // 2:
                    if self.ready(launch, nxt):
                        yield from fill(st ^ 1, nxt)
                        have = True
                        break
                    yield "wait"
            while cta["done"][st] <= n // 2:
                yield "wait"
            self.release(launch, item)
            if nxt >= total:
                cta["stage"][st ^ 1] = None
                cta["full"][st ^ 1] += 1
                return
            if not have:
                while not self.ready(launch, nxt):
                    yield "wait"
                yield from fill(st ^ 1, nxt)

    def call(self, launches, grid, rng):
        """One runner call: ``launches`` [(n_outer, pull0)] on every card,
        each card's in order (across processes, a pull0 launch after its
        prologue), the warps of all cards' current launches interleaved at
        random. Launch i's input is buffer ``cur`` of every shard, the
        runner's ping-pong. Raises on a deadlock."""
        n = len(self.rows)
        plan, base, cur = [], self.epoch, self.cur
        for n_outer, pull0 in launches:
            plan.append(dict(base=base, n_outer=n_outer, pull0=pull0,
                             cur=cur))
            base, cur = base + n_outer, cur ^ (n_outer % 2)
        entries = [set() for _ in plan]
        queues = {}
        for card in set(self.cards):
            queues[card] = []
            for i, launch in enumerate(plan):
                if self.processes and launch["pull0"]:
                    queues[card].append(("enter", i))
                    launch = dict(launch, pull0=False)
                queues[card].append(launch)
        running = {}

        def start(card):
            item = queues[card].pop(0)
            if isinstance(item, tuple):
                running[card] = [self.prologue(plan[item[1]], card,
                                               entries[item[1]],
                                               rng.randint(HOST_DELAY))]
                return
            shards = [d for d in range(n) if self.cards[d] == card]
            launch = dict(item, shards=shards,
                          items=sum(self.ntiles(d) for d in shards))
            total = launch["items"] * launch["n_outer"]
            warps = []
            for b in range(min(grid, total)):
                cta = dict(stage=[None, None], full=[0, 0], done=[0, 0])
                warps += [self.producer(launch, cta, b, grid),
                          self.stepping_warps(launch, cta)]
            running[card] = warps

        for card in sorted(queues):
            start(card)
        idle = 0
        while running:
            card = sorted(running)[rng.randint(len(running))]
            warps = running[card]
            j = rng.randint(len(warps))
            try:
                idle = idle + 1 if next(warps[j]) == "wait" else 0
            except StopIteration:
                warps.pop(j)
                idle = 0
                if not warps:
                    del running[card]
                    if queues[card]:
                        start(card)
            if idle > 20000:
                raise AssertionError("the model deadlocked")
        self.epoch, self.cur = base, cur

    def states(self):
        return [self.buf[d][self.cur] for d in range(len(self.rows))]


def _plain_calls(p, mask, states, rows, offsets, k, calls):
    """p2p_chunks_ref over the same calls (a list of states in place of a
    call: the next call starts from them): (states, per call and shard the
    sums)."""
    n = len(rows)
    nan = float("nan")
    lo = [torch.full((2, 9 * 8 * p.nx), nan) for _ in range(n)]
    hi = [torch.full((2, 9 * 8 * p.nx), nan) for _ in range(n)]
    full = torch.tensor(mask, dtype=torch.float32)
    bands = [full[torch.arange(o - k, o + h + k) % p.ny]
             for o, h in zip(offsets, rows)]
    bases = [(o - k) % p.ny for o in offsets]
    base, sums = 0, []
    for launches in calls:
        if isinstance(launches[0], torch.Tensor):
            states = launches
            continue
        for n_outer, pull0 in launches:
            states, s = ring_p2p.p2p_chunks_ref(states, bands, lo, hi, p, k,
                                                n_outer, base, bases, pull0)
            sums.append((base, n_outer, s))
            base += n_outer
    return states, sums


def _model_case(n_shards, cards, ny=44, nx=36, k=5, seed=3):
    p, mask, f0 = _case(ny, nx, seed)
    rows, offsets = sharding.ring_rows(ny, n_shards)
    states = [torch.tensor(f0[:, o:o + h]) for o, h in zip(offsets, rows)]
    return p, mask, rows, offsets, states, [cards[d % len(cards)]
                                            for d in range(n_shards)], k


# Calls of launches (n_outer, pull0): a call's first launch reads the
# neighbours' states, the next ones the slots; two calls, odd launches.
CALLS = [[(3, True), (1, False)], [(2, True), (3, False)]]


@pytest.mark.parametrize("n_shards,cards,grid,ny", [
    (2, ["a"], 1, 44), (2, ["a"], 2, 44), (3, ["a"], 7, 44),
    (3, ["a"], 29, 44), (3, ["a", "b"], 5, 44), (4, ["a", "b"], 3, 44),
    (3, ["a", "b", "c"], 11, 44),
    (3, ["a", "b"], 7, 51),   # 17-row shards: a last tile row of 1 row
    (2, ["a"], None, 44),     # one CTA a tile of a chunk
])
@pytest.mark.parametrize("rotate", [True, False], ids=["rotated", "plain"])
def test_flag_model_reads_nothing_stale_and_is_the_plain_version(
        n_shards, cards, grid, ny, rotate):
    """The model of K6 over 2-4 shards (ny x 36 grid, 8 x 8 model tiles,
    k = 5: ragged tile rows and a last tile column of 4 columns, so the
    slabs and the x margins reach across two tiles) on 1-3 cards, for grids
    of 1 CTA to every tile of a chunk, each chunk's walk rotated (ring
    mode's) or plain: it finishes, reads no stale cell, and ends bitwise
    equal to p2p_chunks_ref over the same calls, state and per-step sums
    (the speeds of every tile stitched and summed as the plain chunk sums
    them)."""
    p, mask, rows, offsets, states, on, k = _model_case(n_shards, cards,
                                                        ny=ny)
    model = FlagModel(p, rows, offsets, on, mask, states, k, rotate=rotate)
    total_tiles = sum(model.ntiles(d) for d in range(n_shards))
    rng = np.random.RandomState(n_shards * 100 + (grid or 0))
    for launches in CALLS:
        model.call(launches, grid or total_tiles, rng)
    assert model.stale == []
    want, sums = _plain_calls(p, mask, states, rows, offsets, k, CALLS)
    for a, b in zip(model.states(), want):
        assert torch.equal(a, b)
    for base, n_outer, s in sums:
        for d in range(n_shards):
            got = torch.stack([kstep_tile.rows_sum(
                model.speed[(base + c, d)][j], 0, rows[d])
                for c in range(n_outer) for j in range(k)])
            assert torch.equal(got, s[d])


def _resumed(states, seed=5):
    """A state handed to a call from elsewhere: ``states`` perturbed by
    0.1 % (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    return [s * torch.tensor(1 + 1e-3 * rng.rand(*s.shape),
                             dtype=torch.float32) for s in states]


def _run_model(model, calls, grid, seed):
    """The model over ``calls`` (a list of states in place of a call: the
    next call resumes from them), each call scheduled from ``seed``."""
    for launches in calls:
        if isinstance(launches[0], torch.Tensor):
            model.resume(launches)
        else:
            model.call(launches, grid, np.random.RandomState(seed))


def _caught(deps, grid, seeds=4, cards=("a", "b"), calls=None, **kw):
    """The seeds of 4 whose run of the model with ``deps`` read a stale
    cell or deadlocked: 3 shards of 17 rows on 2 cards (``CALLS``, or
    ``calls(states)``)."""
    caught = 0
    for seed in range(seeds):
        p, mask, rows, offsets, states, on, k = _model_case(3, list(cards),
                                                            ny=51)
        model = FlagModel(p, rows, offsets, on, mask, states, k, deps=deps,
                          **kw)
        try:
            _run_model(model, CALLS if calls is None else calls(states),
                       grid, seed)
        except AssertionError:
            caught += 1
            continue
        caught += bool(model.stale)
    return caught


# The tile graph's relation on _caught's cards, which the variants narrow
_GRAPH = graph_deps(["a", "b", "a"])


@pytest.mark.parametrize("rotate", [True, False], ids=["rotated", "plain"])
def test_flag_model_catches_a_missing_cross_shard_wait(rotate):
    """Without the waits on the other shards' tiles, the model reads a
    stale slab (or state): every seed, at 7 CTAs, either walk."""
    def no_cross(rows, nx, d, tile, k, t):
        return [(e, u) for e, u in _GRAPH(rows, nx, d, tile, k, t) if e == d]

    assert _caught(no_cross, 7, rotate=rotate) == 4


def _one_prev_row(rows, nx, d, tile, k, t):
    """Only the previous shard's last tile row (a 1-row last tile row
    holds fewer than k rows)."""
    q, tiles_x = (d - 1) % len(rows), -(-nx // t)
    last = -(-rows[q] // t) - 1
    return [(e, u) for e, u in _GRAPH(rows, nx, d, tile, k, t)
            if e != q or e == d or u // tiles_x == last]


def _three_cols(rows, nx, d, tile, k, t):
    """Tile columns tx - 1 .. tx + 1 only (a 4-column last tile column is
    narrower than k)."""
    tiles_x = -(-nx // t)
    tx = tile % tiles_x
    return [(e, u) for e, u in _GRAPH(rows, nx, d, tile, k, t)
            if (u % tiles_x - tx) % tiles_x in (0, 1, tiles_x - 1)]


@pytest.mark.parametrize("deps", [_one_prev_row, _three_cols])
@pytest.mark.parametrize("rotate,ctas", [(True, 28), (False, 29)],
                         ids=["rotated", "plain"])
def test_flag_model_catches_a_narrow_neighbourhood(deps, rotate, ctas):
    """The cone's reach past the next tile row or column is needed where the
    last tile row or column is narrower than k: without it, the model reads
    a stale cell (every seed, at 29 CTAs in the plain walk: with the
    producer's early loads, 20 CTAs caught _three_cols on 3 seeds of 4; at
    28 in the rotated walk, where a tile's neighbours lie further back: 29
    CTAs caught _three_cols there on 2 seeds of 4, 28 on 8 of 8)."""
    assert _caught(deps, ctas, rotate=rotate) == 4


@pytest.mark.parametrize("rotate", [True, False], ids=["rotated", "plain"])
def test_flag_model_catches_an_early_release(rotate):
    """A producer that releases a tile's flag once its window is loaded,
    before the stepping warps' stores: the model reads a stale cell (every
    seed, at 7 CTAs, either walk)."""
    assert _caught(None, 7, early_release=True, rotate=rotate) == 4


def _cross_calls(states):
    """Calls across processes: pull0 launches within a call (the
    remainder's, or the next call's first with no host step between), then
    a resumed state, whose edges no slot holds."""
    return [[(3, True), (1, False), (2, True)], _resumed(states),
            [(1, True), (2, False), (1, True)]]


@pytest.mark.parametrize("cards,grid,ny", [
    ([(0, "a"), (1, "a")], 3, 44),                          # 2 x 1, one card
    ([(0, "a"), (0, "a"), (1, "a"), (1, "a")], 7, 44),      # 2 x 2, one card
    ([(0, "a"), (0, "b"), (1, "c"), (1, "d")], 5, 44),      # 2 x 2, 4 cards
    ([(0, "a"), (1, "b"), (2, "c"), (3, "d")], 11, 51),     # 4 x 1
    ([(0, "a"), (1, "a"), (2, "b")], None, 51),
])
@pytest.mark.parametrize("rotate", [True, False], ids=["rotated", "plain"])
def test_flag_model_across_processes(cards, grid, ny, rotate):
    """The model of K6 across processes (cards keyed by (process, card),
    two processes on one card included), either walk: every pull0 launch
    runs the prologue's pushes and the entry order, and its chunk 0 reads
    the pushed slots; over calls with pull0 launches between others and a
    resumed state, it reads no stale cell and ends bitwise equal to
    p2p_chunks_ref, whose chunk 0 reads the neighbours' states, state and
    per-step sums."""
    n_shards = len(cards)
    p, mask, rows, offsets, states, on, k = _model_case(n_shards, cards,
                                                        ny=ny)
    model = FlagModel(p, rows, offsets, on, mask, states, k, processes=True,
                      rotate=rotate)
    total_tiles = sum(model.ntiles(d) for d in range(n_shards))
    calls = _cross_calls(states)
    _run_model(model, calls, grid or total_tiles, n_shards * 10 + (grid or 0))
    assert model.stale == []
    want, sums = _plain_calls(p, mask, states, rows, offsets, k, calls)
    for a, b in zip(model.states(), want):
        assert torch.equal(a, b)
    for base, n_outer, s in sums:
        for d in range(n_shards):
            got = torch.stack([kstep_tile.rows_sum(
                model.speed[(base + c, d)][j], 0, rows[d])
                for c in range(n_outer) for j in range(k)])
            assert torch.equal(got, s[d])


@pytest.mark.parametrize("rotate", [True, False], ids=["rotated", "plain"])
def test_flag_model_catches_a_prologue_without_the_entry_order(rotate):
    """Across processes, a card that starts a launch once its own pushes
    are done, without waiting for the other processes' pushes: chunk 0
    reads a slot before its neighbour's push (the first call's empty slot,
    or one that holds the edge of the state before a resume), a stale
    read: every seed, at 7 CTAs, either walk."""
    cards = [(0, "a"), (1, "a"), (1, "b")]
    assert _caught(None, 7, cards=cards, calls=_cross_calls, processes=True,
                   entry_order=False, rotate=rotate) == 4
    assert _caught(None, 7, cards=cards, calls=_cross_calls, processes=True,
                   rotate=rotate) == 0


def _brute_cone(rows, nx, k, t):
    """The cone by cells: per shard and tile (of shape t: an edge, or rows
    and columns), the tiles that own a cell within k cells (rows modulo the
    ring, columns modulo nx) of one of its own."""
    th, tw = _shape(t)
    ny, tiles_x = sum(rows), -(-nx // tw)
    owner = np.zeros((ny, nx), dtype=object)
    off = 0
    for d, h in enumerate(rows):
        for y in range(h):
            for x in range(nx):
                owner[off + y, x] = (d, (y // th) * tiles_x + x // tw)
        off += h
    out, off = [], 0
    for d, h in enumerate(rows):
        out.append([])
        for tile in range(-(-h // th) * tiles_x):
            ty, tx = divmod(tile, tiles_x)
            y0, x0 = off + ty * th, tx * tw
            ys = np.arange(y0 - k, y0 + min(th, h - ty * th) + k) % ny
            xs = np.arange(x0 - k, x0 + min(tw, nx - x0) + k) % nx
            out[d].append(sorted(set(owner[np.ix_(ys, xs)].ravel())))
        off += h
    return out


@pytest.mark.parametrize("n_shards,ny,nx,cards", [
    (2, 44, 36, ["a"]), (3, 51, 36, ["a", "b"]), (4, 70, 45, ["a", "b"]),
    (5, 83, 29, ["a", "b", "c"]), (6, 100, 60, ["a", "b", "c", "d"]),
    (7, 117, 33, ["a", "b", "c"]),
    # keyed by (process, card): 2 processes x 2 shards on one card, on four
    # cards, 4 x 1, and 3 processes of 2 shards on two cards
    (4, 70, 45, [(0, 0), (0, 0), (1, 0), (1, 0)]),
    (4, 70, 45, [(0, 0), (0, 1), (1, 2), (1, 3)]),
    (4, 83, 29, [(0, 0), (1, 1), (2, 2), (3, 3)]),
    (6, 100, 60, [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]),
])
@pytest.mark.parametrize("k", range(1, 9))
def test_tile_graph_is_the_cone(n_shards, ny, nx, cards, k):
    """The host-built tile graph, decoded from its records: every tile
    waits on exactly the tiles with owned cells within k of its own (by
    cells, _brute_cone), a symmetric relation within the first design's
    per-tile rule (model_deps); ragged shards (ring_rows' uneven split,
    8-row model tiles) and ragged last tile columns; its headers, the own
    flag at the record's index on its card, the duties (a push onto another
    card, a waiter on another card; a card of another process is another
    card, even the same physical one) and at most MAX_PEERS flag arrays a
    card's records name."""
    rows, _ = sharding.ring_rows(ny, n_shards)
    on = [cards[d % len(cards)] for d in range(n_shards)]
    t, tiles_x = MODEL_TILE, -(-nx // MODEL_TILE)
    deps, header = decode_graph(on, rows, nx, k)
    cone = _brute_cone(rows, nx, k, t)
    for d, h in enumerate(rows):
        for tile in range(-(-h // t) * tiles_x):
            got = deps[d, tile]
            assert sorted(got) == cone[d][tile]
            assert (d, tile) in got
            assert set(got) <= set(model_deps(rows, nx, d, tile, k, t))
            for e, u in got:
                assert (d, tile) in deps[e, u]
            hd = header[d, tile]
            ty, tx = divmod(tile, tiles_x)
            own = min(t, h - ty * t)
            assert (hd["tile"], hd["y0"], hd["x0"], hd["own_rows"],
                    hd["own_cols"]) == (tile, ty * t, tx * t, own,
                                        min(t, nx - tx * t))
            local = [q for q in range(n_shards) if on[q] == on[d]]
            assert local[hd["shard"]] == d
            n = n_shards
            push = ((ty * t + own > h - k and on[(d + 1) % n] != on[d])
                    or (ty * t < k and on[(d - 1) % n] != on[d]))
            waited = any(on[e] != on[d] for e, _ in got)
            assert hd["duties"] == (push * ring_p2p.PUSH_REMOTE
                                    + waited * ring_p2p.READ_REMOTE)
    for card, (recs, peers) in ring_p2p.tile_graph(on, rows, nx, k,
                                                   t).items():
        assert len(peers) <= ring_p2p.MAX_PEERS
        local = [q for q in range(n_shards) if on[q] == card]
        walk = [(d, u) for d in local for u in range(-(-rows[d] // t)
                                                      * tiles_x)]
        assert [(local[r[0]], r[1]) for r in recs] == walk


def test_tile_graph_at_the_kernel_tile():
    """At the kernel's 32 x 32 tiles and k = 8 on the 1024^2 deck over 4
    shards on two cards: the graph is the cone by cells, 9 tiles a tile
    (the first design's rule waited on up to 30)."""
    rows, on = [256] * 4, ["a", "b", "a", "b"]
    deps, _ = decode_graph(on, rows, 1024, 8, ring_p2p.TILE)
    cone = _brute_cone(rows, 1024, 8, ring_p2p.TILE)
    for d in range(4):
        for tile, want in enumerate(cone[d]):
            assert sorted(deps[d, tile]) == want
            assert len(want) == 9


def test_the_rotated_walk_waits_on_no_tile_of_its_round():
    """The benchmark's solve-1024-rows4 layout: 4 cards of one 256-row
    shard of the 1024^2 grid (8 x 32 kernel tiles), k = 8, 132 CTAs (an
    H100's SMs), one launch of 64 chunks. Over chunks 1-63, the items one
    of whose dependencies (in the chunk before, at its place in its own
    card's walk) lies in the item's round of CTAs (walk index // 132),
    being stepped beside it: in the plain walk 6,400 of 64,512 (9.9 %),
    each a shard's first tile row waiting across the seam on the previous
    card's last, which that card walked last; with each chunk's walk
    starting one tile row further down, the kernel's ring mode
    (csrc/ring_p2p.cu: walk_record's rule, rot the tiles of a tile row),
    none."""
    src = (_build.CSRC / "ring_p2p.cu").read_text()
    assert "if constexpr (kRing) r = (r + c * L.rot) % L.p.items;" in src
    assert "l.rot = tiles_x;" in src
    cards, items, ctas, n_outer = [0, 1, 2, 3], 8 * 32, 132, 64
    deps, _ = decode_graph(cards, [256] * 4, 1024, 8, ring_p2p.TILE)
    for rot, want in ((0, 6400), (32, 0)):
        at = [{walk_record(c, i, items, rot): c * items + i
               for i in range(items)} for c in range(n_outer)]
        hit = 0
        for c in range(1, n_outer):
            for (d, r), of in deps.items():
                same = [e for e, u in of
                        if at[c - 1][u] // ctas == at[c][r] // ctas]
                assert all(e != d for e in same)
                hit += bool(same)
        assert hit == want


# The grid kind (ring_p2p.grid_p2p_chunks, the one-card wide route): one
# shard, the whole periodic grid, on one card; its graph and the model on
# it. Calls of launches (n_outer, pull0): no pull0, odd and even launches.
GRID_CALLS = [[(3, False), (1, False)], [(2, False), (3, False)]]


# Item shapes of the model's grid (rows, columns): square 8 x 8 tiles, and
# tall and wide items (the kernel's items are up to 64 columns wide and as
# tall as the grid allows, ring_p2p.grid_item)
GRID_SHAPES = [(8, 8), (12, 4), (5, 12)]


@pytest.mark.parametrize("shape", GRID_SHAPES,
                         ids=[f"{h}x{w}" for h, w in GRID_SHAPES])
@pytest.mark.parametrize("ny,nx", [
    (44, 36), (51, 36), (51, 45),   # even, and ragged last tile rows, columns
    (6, 36), (8, 29),               # one tile row (6 rows: fewer than k)
    (44, 5), (44, 8),               # one tile column
    (7, 5),                         # one tile, its own neighbour every way
])
@pytest.mark.parametrize("k", range(1, 9))
def test_grid_graph_is_the_cone(ny, nx, k, shape):
    """The grid kind's item graph, decoded from its records: every item
    waits on exactly the items with owned cells within k of its own, both
    axes wrapping (by cells, _brute_cone of one shard of ny rows), itself
    included (a grid of one item row or column is its own neighbour across
    the wrap), a symmetric relation; headers in row-major walk order,
    duties 0, no flag of another card."""
    th, tw = shape
    tiles_x = -(-nx // tw)
    deps, header = decode_grid(ny, nx, k, shape)
    cone = _brute_cone([ny], nx, k, shape)[0]
    assert len(deps) == len(cone)
    for tile, want in enumerate(cone):
        assert sorted((0, u) for u in deps[tile]) == want
        assert tile in deps[tile]
        for u in deps[tile]:
            assert tile in deps[u]
        ty, tx = divmod(tile, tiles_x)
        assert header[tile] == dict(
            shard=0, tile=tile, y0=ty * th, x0=tx * tw,
            own_rows=min(th, ny - ty * th), own_cols=min(tw, nx - tx * tw),
            duties=0, counts=len(deps[tile]))


@pytest.mark.parametrize("shape", [(32, 32), None], ids=["tile", "item"])
def test_grid_graph_at_the_kernel_tile(shape):
    """At k = 8, the cone by cells at 1024^2 and on a ragged 100 x 130 grid,
    for K4's 32 x 32 tiles (9 a tile at 1024^2; at 100 x 130, a 4-row last
    tile row and a 2-column last tile column, a corner tile waits on 4 x 4)
    and for the kernel's items (ring_p2p.grid_item: 61 x 64 at 1024^2, 9
    an item; 8 x 16 at 100 x 130, a 4-row last item row and a 2-column
    last item column, the corner waits on 4 x 4 too)."""
    for ny, nx in ((1024, 1024), (100, 130)):
        t = shape or ring_p2p.grid_item(ny, nx)[:2]
        deps, _ = decode_grid(ny, nx, 8, t)
        cone = _brute_cone([ny], nx, 8, t)[0]
        for tile, want in enumerate(cone):
            assert sorted((0, u) for u in deps[tile]) == want
        if ny == 1024:
            assert {len(d) for d in deps.values()} == {9}
    assert len(deps[0]) == 16


def _plain_grid_calls(p, mask, f, k, calls):
    """grid_p2p_chunks_ref over the same calls: (the state, [(base,
    n_outer, the launch's sums)])."""
    obst = torch.tensor(mask, dtype=torch.float32)
    base, sums = 0, []
    for launches in calls:
        for n_outer, _ in launches:
            f, s = ring_p2p.grid_p2p_chunks_ref(f, obst, p, k, n_outer)
            sums.append((base, n_outer, s))
            base += n_outer
    return f, sums


def _grid_model(ny=51, nx=36, k=5, seed=3, shape=MODEL_TILE, **kw):
    """The model of the grid kind on a ny x nx grid (8 x 8 model tiles, or
    items of ``shape``; k = 5: at 51 x 36 a 3-row last tile row and a
    4-column last tile column, narrower than k), and its first state."""
    p, mask, f0 = _case(ny, nx, seed)
    state = torch.tensor(f0)
    return (FlagModel(p, [ny], [0], ["a"], mask, [state], k, grid=True,
                      t=shape, **kw), p, mask, state)


@pytest.mark.parametrize("shape", GRID_SHAPES,
                         ids=[f"{h}x{w}" for h, w in GRID_SHAPES])
@pytest.mark.parametrize("ny,nx,grid", [
    (51, 36, 1), (51, 36, 7), (51, 36, 29), (44, 36, None), (6, 36, 3),
    (44, 5, 4),
])
def test_flag_model_on_the_grid_graph(ny, nx, grid, shape):
    """The model of the grid kind (the whole grid one shard on one card,
    window rows wrapping into the state itself) on the grid graph, for
    grids of 1 CTA to every item of a chunk, grids of one item row (fewer
    rows than k) or column, items square, tall or wide: it finishes, reads
    no stale cell and ends bitwise equal to grid_p2p_chunks_ref over the
    same calls, state and per-step sums."""
    model, p, mask, state = _grid_model(ny, nx, shape=shape)
    rng = np.random.RandomState(ny * 100 + nx + (grid or 0))
    for launches in GRID_CALLS:
        model.call(launches, grid or model.ntiles(0), rng)
    assert model.stale == []
    want, sums = _plain_grid_calls(p, mask, state, model.k, GRID_CALLS)
    assert torch.equal(model.states()[0], want)
    for base, n_outer, s in sums:
        got = torch.stack([kstep_tile.rows_sum(
            model.speed[(base + c, 0)][j], 0, ny)
            for c in range(n_outer) for j in range(model.k)])
        assert torch.equal(got, s)


def _narrow_grid(axis):
    """The grid graph's relation cut to the tile rows (axis 0) or columns
    (1) next to the tile's own: where the last tile row or column is
    narrower than k, the cone reaches one further."""
    def deps(rows, nx, d, tile, k, t):
        th, tw = _shape(t)
        shape = (-(-rows[0] // th), -(-nx // tw))
        own = divmod(tile, shape[1])[axis]
        n = shape[axis]
        return [(e, u) for e, u in grid_graph_deps(rows, nx, d, tile, k, t)
                if (divmod(u, shape[1])[axis] - own) % n in (0, 1, n - 1)]
    return deps


def _caught_grid(deps, grid, seeds=4, **kw):
    """The seeds of 4 whose run of the grid kind's model (51 x 36 unless
    ``kw`` says otherwise, GRID_CALLS) with ``deps`` read a stale cell or
    deadlocked."""
    caught = 0
    for seed in range(seeds):
        model = _grid_model(deps=deps, **kw)[0]
        try:
            _run_model(model, GRID_CALLS, grid, seed)
        except AssertionError:
            caught += 1
            continue
        caught += bool(model.stale)
    return caught


@pytest.mark.parametrize("axis,nx,grid", [(0, 36, 26), (1, 44, 37)],
                         ids=["three_rows", "three_cols"])
def test_flag_model_on_the_grid_catches_a_narrow_neighbourhood(axis, nx,
                                                               grid):
    """On the grid graph, a relation cut to the next tile row or column
    each way reads a stale cell: every seed, the rows' cut on the 51 x 36
    grid at 26 CTAs (also at 25-28, 34 and 35), the columns' on a 51 x 44
    grid at 37 CTAs (its last tile column 4 wide; with each chunk's walk
    starting one tile row further down, a tile's neighbours lie further
    back in the walk, and fewer CTAs than these catch the cuts on some
    seeds only)."""
    assert _caught_grid(_narrow_grid(axis), grid, nx=nx) == 4


def test_flag_model_on_the_grid_catches_an_early_release():
    """On the grid graph, a producer that releases a tile's flag once its
    window is loaded reads a stale cell: every seed, at 13 CTAs (at 11 to
    29 alike)."""
    assert _caught_grid(None, 13, early_release=True) == 4


def test_grid_p2p_chunks_ref_is_k4s_plain_chain():
    """grid_p2p_chunks on CPU tensors (its plain version) over two
    launches of 3 and 2 chunks of 8 steps and a remainder launch of 5
    steps, on a ragged 100 x 130 grid: state and per-step sums bitwise
    K4's plain chain (tile_chunk_ref chunk by chunk); each launch's state
    in the buffer the kernel leaves it in (the spare after an odd count of
    chunks, the input after an even one), the other returned free."""
    p, mask, f0 = _case(100, 130, 7)
    obst = torch.tensor(mask, dtype=torch.float32)
    f, spare = torch.tensor(f0), torch.empty(9, 100, 130)
    want, got, sums = torch.tensor(f0), [], []
    for k, n in ((8, 3), (8, 2), (5, 1)):
        bufs = (f, spare)
        f, spare, s = ring_p2p.grid_p2p_chunks(f, spare, obst, p, k, n)
        assert f is bufs[n % 2] and spare is bufs[1 - n % 2]
        got.append(s)
        for _ in range(n):
            want, s_ref = kstep_tile.tile_chunk_ref(want, obst, p, k)
            sums.append(s_ref)
    assert torch.equal(f, want)
    assert torch.equal(torch.cat(got), torch.cat(sums))
