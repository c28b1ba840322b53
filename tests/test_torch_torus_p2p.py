"""The torus's in-kernel exchange (``ops.ring_p2p``'s torus mode:
``torus_graph``, ``torus_peers``, ``TorusExchange``,
``torus_p2p_chunks``; ``dist.runner.make_torus_p2p_runner`` and the route
``make_runner`` decides when it builds the runner; kernel
``csrc/ring_p2p.cu::lbm_torus_p2p``) on the CPU, in one process: against
the port's K4 torus route (the host's two-phase exchange and
``kstep_tile.torus_chunk`` a block and chunk), against the JAX package's
torus (``_make_runner_2d_kstep`` with the Pallas x_halo kernel in
interpret mode, and the ``jnp`` torus, on the 8-device virtual CPU mesh of
conftest.py), and an eager model of the kernel's flag protocol over
blocks. ``tests/test_torch_torus_p2p_multihost.py`` runs it across
processes.

The blocks lie on the CPU, so ``torus_p2p_chunks`` takes its plain
version, ``torus_p2p_chunks_ref`` (the kernel runs only on the card;
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold it against the
same plain version and bitwise against K4's torus mode there). Every input
comes from a deck, or from a numpy seed for a perturbed state and a random
mask.

Tolerances: against the port's K4 torus route, which runs the same
arithmetic a cell, state and sums bitwise. Against the JAX package, the
tiers of test_torch_torus: up to 25 steps f atol 1e-7 and av rtol 1e-4
(XLA-CPU rounding against strict float32). The model: bitwise the plain
version, and no stale read.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.core.params import LBMParams as JParams
from tpulbm.dist import sharding as jsharding
from tpulbm.dist.mesh import get_mesh_2d as j_get_mesh_2d
from tpulbm.dist.runner import _make_runner_2d_kstep
from tpulbm.dist.runner import make_runner as j_make_runner
from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY, NSPEEDS
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import multihost, runner, sharding
from tpulbm_torch.dist.mesh import get_mesh_2d
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import _build, kstep_tile, ring_p2p, step_torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data"
MODEL_TILE = 8      # the model's tile edge (the kernel's is 32)


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


def _jp(p):
    return JParams(**dataclasses.asdict(p))


def _run(make, p, mask, f0, dy, dx, calls=1):
    """A torus runner (make(mesh)) on CPU blocks, called ``calls`` times in
    a row, each on the last one's output: (the gathered state, the av
    series of every call)."""
    mesh = get_mesh_2d(dy, dx, device="cpu")
    run = make(mesh)
    blocks, obst = sharding.shard_blocks(torch.tensor(f0), torch.tensor(mask),
                                         mesh)
    avs = []
    for _ in range(calls):
        blocks, av = run(blocks, obst)
        avs.append(av)
    return sharding.gather_blocks(blocks, dy, dx, "cpu"), torch.cat(avs)


def _k4(p, n_steps):
    return lambda mesh: runner.make_torus_runner(p, n_steps, mesh,
                                                 kstep_tile.torus_chunk)


def _p2p(p, n_steps, max_outer=ring_p2p.MAX_OUTER):
    return lambda mesh: runner.make_torus_p2p_runner(p, n_steps, mesh,
                                                     max_outer=max_outer)


# --- the tile graph --------------------------------------------------------

def _brute_cone(dy, dx, h, w, k, t):
    """The cone by cells: per block and tile, the (block, tile)s that own a
    cell within k cells (both axes wrapping on the global grid) of one of
    its own."""
    ny, nx = dy * h, dx * w
    tx_n = -(-w // t)
    owner = np.zeros((ny, nx), dtype=object)
    for y in range(ny):
        for x in range(nx):
            i, yy = divmod(y, h)
            j, xx = divmod(x, w)
            owner[y, x] = (i * dx + j, (yy // t) * tx_n + xx // t)
    out = {}
    for b in range(dy * dx):
        i, j = divmod(b, dx)
        for tile in range(-(-h // t) * tx_n):
            ty, tx = divmod(tile, tx_n)
            y0, x0 = i * h + ty * t, j * w + tx * t
            ys = np.arange(y0 - k, y0 + min(t, h - ty * t) + k) % ny
            xs = np.arange(x0 - k, x0 + min(t, w - tx * t) + k) % nx
            out[b, tile] = sorted(set(owner[np.ix_(ys, xs)].ravel()))
    return out


def decode_torus_graph(cards, dy, dx, h, w, k, t=MODEL_TILE):
    """torus_graph's records of every card, decoded: {(block, tile):
    [(block, tile) it waits on]} and {(block, tile): its header}; checks
    that a record's dependencies on this card come first."""
    mesh2d = [cards[i * dx:(i + 1) * dx] for i in range(dy)]
    graphs = ring_p2p.torus_graph(mesh2d, h, w, k, t)
    nt = -(-h // t) * -(-w // t)
    of = {}
    for card, (recs, _) in graphs.items():
        local = [b for b in range(dy * dx) if cards[b] == card]
        for i, rec in enumerate(recs):
            of[card, i] = (local[rec[0]], int(rec[1]))
            assert i == rec[0] * nt + rec[1]     # its own flag's index
    deps, header = {}, {}
    mask = (1 << ring_p2p.PEER_SHIFT) - 1
    for card, (recs, peers) in graphs.items():
        assert peers[0] == card and len(set(peers)) == len(peers)
        assert len(peers) <= ring_p2p.MAX_TORUS_PEERS
        assert peers == ring_p2p.torus_peers(mesh2d)[card]
        for i, rec in enumerate(recs):
            n_local, n_remote = rec[7] & 255, rec[7] >> 8
            got = []
            for j in range(n_local + n_remote):
                e = int(rec[ring_p2p.REC_DEPS + j])
                peer = e >> ring_p2p.PEER_SHIFT
                assert (peer == 0) == (j < n_local)
                got.append(of[peers[peer], e & mask])
            deps[of[card, i]] = got
            header[of[card, i]] = dict(zip(ring_p2p.HEADER, map(int, rec)))
    return deps, header


GRAPH_CASES = [
    # (dy, dx, h, w, k, cards a block, t)
    (2, 2, 20, 20, 5, "a", MODEL_TILE),
    (2, 4, 12, 10, 5, "ab", MODEL_TILE),
    (4, 2, 10, 12, 3, "abcd", MODEL_TILE),
    (1, 8, 17, 6, 5, "ab", MODEL_TILE),
    (8, 1, 6, 17, 5, "a", MODEL_TILE),
    (2, 2, 32, 32, 8, "abcd", 32),        # 32-wide blocks: one kernel tile
    (4, 4, 32, 32, 8, "a", 32),
    (2, 2, 64, 64, 8, "ab", 32),          # 128^2 over 2x2
    (2, 4, 12, 10, 5, "abcdefgh", MODEL_TILE),   # 8 keys, 6 flag arrays
    (3, 3, 12, 12, 5, "abcdefghi", MODEL_TILE),  # 9 keys, 9 flag arrays
]


@pytest.mark.parametrize("dy,dx,h,w,k,cards,t", GRAPH_CASES)
def test_torus_graph_is_the_cone(dy, dx, h, w, k, cards, t):
    """torus_graph, decoded from its records: every tile waits on exactly
    the tiles with owned cells within k of its own by cells, across the
    wrap in both axes (_brute_cone), itself included, a symmetric relation;
    a tile at a block's corner waits on tiles of the x, y and diagonal
    neighbour blocks; its header, its own flag at its record's index and
    its duties (a push onto another card, a waiter on another card)."""
    on = [cards[b % len(cards)] for b in range(dy * dx)]
    deps, header = decode_torus_graph(on, dy, dx, h, w, k, t)
    cone = _brute_cone(dy, dx, h, w, k, t)
    tx_n = -(-w // t)
    for (b, tile), want in cone.items():
        got = deps[b, tile]
        assert sorted(got) == want and len(set(got)) == len(got)
        assert (b, tile) in got
        for e, u in got:
            assert (b, tile) in deps[e, u]
        ty, tx = divmod(tile, tx_n)
        y0, x0 = ty * t, tx * t
        own_r, own_c = min(t, h - y0), min(t, w - x0)
        hd = header[b, tile]
        assert (hd["tile"], hd["y0"], hd["x0"], hd["own_rows"],
                hd["own_cols"]) == (tile, y0, x0, own_r, own_c)
        rows = {0: True, 1: y0 + own_r > h - k, -1: y0 < k}
        cols = {0: True, 1: x0 + own_c > w - k, -1: x0 < k}
        push = any(rows[di] and cols[dj] and on[ring_p2p.torus_neighbour(
            b, di, dj, dy, dx)] != on[b] for _, di, dj in
            ring_p2p.TORUS_PUSHES)
        waited = any(on[e] != on[b] for e, _ in got)
        assert hd["duties"] == (push * ring_p2p.PUSH_REMOTE
                                + waited * ring_p2p.READ_REMOTE)
        for di in (-1, 1):
            for dj in (-1, 1):
                if rows[di] and cols[dj]:
                    diag = ring_p2p.torus_neighbour(b, di, dj, dy, dx)
                    assert any(e == diag for e, _ in got)


def test_torus_table_and_limits_are_the_kernels():
    """The table of a block, the neighbour and push orders and the limits
    are csrc/ring_p2p.cu's; a launch takes 64 chunks at 1024^2 over 2x2 and
    32 at 8192^2 (16 MiB of partials a block)."""
    src = (_build.CSRC / "ring_p2p.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[;,]", src).group(1))

    def enum(name):
        body = re.search(rf"enum {name} {{([^}}]*)}}", src).group(1)
        return [e.strip() for e in body.split(",")]

    assert const("kTorusWords") == len(ring_p2p.TORUS_TABLE)
    assert const("kMaxTorusLocal") == ring_p2p.MAX_TORUS_LOCAL
    assert const("kMaxTorusPeers") == ring_p2p.MAX_TORUS_PEERS == 16
    for name, first in (("kTObst", "obst"), ("kTState", "state0"),
                        ("kTPartials", "partials"), ("kTSums", "sums"),
                        ("kTIn", "in_w"), ("kTSlot", "xlo"),
                        ("kTPush", "to_e"), ("kTRowBase", "row_base")):
        assert const(name) == ring_p2p.TORUS_TABLE.index(first), name
    assert enum("Nbr") == [f"k{n.upper()}" for n in ring_p2p.NBR_NAMES]
    assert [ring_p2p.TORUS_TABLE[const("kTIn") + i]
            for i in range(8)] == [f"in_{n}" for n in ring_p2p.NBR_NAMES]
    assert enum("Push") == [f"kTo{n.upper()}" for n in ring_p2p.PUSH_NAMES]
    for (buf, di, dj), name in zip(ring_p2p.TORUS_PUSHES,
                                   ring_p2p.PUSH_NAMES):
        want = {(-1, 0): "n", (1, 0): "s", (0, -1): "w", (0, 1): "e",
                (-1, -1): "nw", (-1, 1): "ne", (1, -1): "sw",
                (1, 1): "se"}[di, dj]
        assert name == want
        assert buf == ("x" if di == 0 else "y") + ("lo" if (di or dj) > 0
                                                   else "hi")
    assert ring_p2p.outer_per_launch([512], 512, 8) == 64
    assert ring_p2p.outer_per_launch([4096], 4096, 8) == 32
    assert ring_p2p.outer_per_launch([64], 64, 8) == 64


# --- the plain version and the runner ---------------------------------------

def test_torus_p2p_chunks_ref_fills_the_slots_by_parity():
    """torus_p2p_chunks_ref over two runner calls (launches of 1 and 3
    chunks, then 2 and 1; each call's first reads the neighbours' states),
    the parity carried across them: the state and sums bitwise the chain of
    torus_chunk_ref that the K4 torus runner runs (its pieces from the
    host's two-phase exchange); after a chunk at epoch e, slot (e + 1) % 2
    of every buffer holds the neighbours' edges and corners of the new
    state, and slot e % 2 is left alone."""
    p, mask, f0 = _case(48, 40, 7)
    dy, dx, k = 2, 2, 5
    h, w = 24, 20
    mesh = get_mesh_2d(dy, dx, device="cpu")
    states, obst = sharding.shard_blocks(torch.tensor(f0),
                                         torch.tensor(mask), mesh)
    tr = runner.multihost.Transport(runner._flat(mesh))
    bands = runner._torus_mask_bands(tr, obst, {k}, dy, dx, h, w)[k]
    bases = [(b // dx * h - k) % p.ny for b in range(dy * dx)]
    ex = ring_p2p.TorusExchange(mesh, h, w)
    for land in ex.land:
        for buf in land.values():
            buf.fill_(float("nan"))
    f, sums, base = list(states), [], 0
    for launches in ([(1, True), (3, False)], [(2, True), (1, False)]):
        for n_outer, pull0 in launches:
            f, s = ring_p2p.torus_p2p_chunks_ref(
                f, bands, ex.land, p, k, n_outer, base, bases, pull0, dy, dx)
            sums.append(torch.stack(s))
            base += n_outer
            e = base - 1
            for b, want in enumerate(ring_p2p.torus_halos(f, dy, dx, k)):
                for name, piece in zip(ring_p2p.TORUS_BUFFERS, want):
                    size = h if name[0] == "x" else w
                    fn = ring_p2p.xslot if name[0] == "x" else ring_p2p.yslot
                    assert torch.equal(fn(ex.land[b][name], (e + 1) % 2, k,
                                          size), piece)
            if base == 1:     # slot 0 is not written at epoch 0
                assert all(torch.isnan(buf[0]).all() for land in ex.land
                           for buf in land.values())
    want, want_sums = list(states), []
    for _ in range(base):
        pieces = runner._torus_halos(tr, runner._torus_pieces(
            k, dy, dx, (9,), h, w), want, dy * dx)
        step = [kstep_tile.torus_chunk_ref(xlo, g, xhi, ylo, yhi, bands[b],
                                           p, k, bases[b])
                for b, (g, (xlo, xhi, ylo, yhi)) in enumerate(zip(want,
                                                                  pieces))]
        want = [g for g, _ in step]
        want_sums.append(torch.stack([s for _, s in step]))
    assert all(torch.equal(a, b) for a, b in zip(f, want))
    assert torch.equal(torch.cat(sums, 1), torch.cat(want_sums, 1))


@pytest.mark.parametrize("ny,nx,dy,dx,n_steps,max_outer", [
    (48, 64, 2, 2, 21, 64), (48, 64, 2, 2, 21, 1), (32, 40, 1, 4, 19, 2),
    (40, 24, 4, 1, 19, 3), (48, 64, 1, 1, 11, 64), (40, 30, 2, 3, 13, 64),
    (64, 64, 2, 4, 20, 2), (24, 64, 8, 1, 7, 64), (48, 48, 2, 2, 3, 64),
])
def test_torus_p2p_runner_is_bitwise_the_k4_torus_route(ny, nx, dy, dx,
                                                        n_steps, max_outer):
    """make_torus_p2p_runner on CPU blocks over two calls (launches of
    max_outer chunks, a remainder of another k, a call shorter than a
    chunk, 1x1, one row and one column of blocks, 3-row blocks) against
    the K4 torus runner (kstep_tile.torus_chunk, plain on the CPU): the
    blocks and the av series bitwise."""
    p, mask, f0 = _case(ny, nx, dy * 10 + dx)
    got = _run(_p2p(p, n_steps, max_outer), p, mask, f0, dy, dx, calls=2)
    want = _run(_k4(p, n_steps), p, mask, f0, dy, dx, calls=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dy,dx", [(2, 4), (1, 8), (4, 2)])
def test_torus_p2p_matches_jax_jnp_torus(dy, dx):
    """The p2p torus runner on the 128^2 deck against the JAX jnp torus
    (ppermute halos, per-step two-phase exchange), 25 steps from the rest
    state in launches of 2 chunks (three 8-step chunks and one of 1)."""
    p, mask = _deck()
    f0 = initial_state(p).numpy()
    run = j_make_runner(_jp(p), 25, mesh=j_get_mesh_2d(dy, dx), backend="jnp")
    f_j, av_j = run(jnp.asarray(f0), jnp.asarray(mask))
    f, av = _run(_p2p(p, 25, 2), p, mask, f0, dy, dx)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=0, atol=1e-7)
    np.testing.assert_allclose(av.numpy(), np.asarray(av_j), rtol=1e-4)


@pytest.mark.parametrize("n_steps", [10, 19])
def test_torus_p2p_matches_jax_x_halo_kernel(n_steps):
    """The p2p torus runner against _make_runner_2d_kstep, whose blocks run
    pallas_kstep._kernel with x_halo=True (interpret mode), in its
    production pair-symmetric form: a perturbed 32 x 256 grid over 2x2
    (16 x 128 blocks, the narrowest the TPU tier takes), 10 and 19 steps
    (remainders of 2 and 3 steps)."""
    p, mask, f0 = _case(32, 256, 9)
    mesh = j_get_mesh_2d(2, 2)
    run = _make_runner_2d_kstep(_jp(p), n_steps, mesh, k=8)
    f_s, o_s = jsharding.shard_arrays(mesh, jnp.asarray(f0),
                                      jnp.asarray(mask))
    f_j, av_j = run(f_s, o_s)
    f, av = _run(_p2p(p, n_steps, 1), p, mask, f0, 2, 2)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=0, atol=1e-7)
    np.testing.assert_allclose(av.numpy(), np.asarray(av_j), rtol=1e-4)


class _Transport:
    """A stand-in transport of several processes on hosts ``hosts``
    (``places``: process, card index, card UUID, host of each block);
    ``elsewhere``: the flag that ``any`` combines from the other
    processes."""

    def __init__(self, places, rank=0, local=(), elsewhere=False):
        self.world = len({pl[0] for pl in places})
        self.rank, self.local, self._places = rank, list(local), places
        self.elsewhere = elsewhere

    def places(self):
        return self._places

    def is_local(self, d):
        return d in self.local

    def any(self, flag):
        return bool(flag) or self.elsewhere


def _stand_ins(monkeypatch):
    """make_runner's torus runners replaced by stand-ins that record the
    route: ("p2p", mesh) or ("k4", the chunk function)."""
    taken = []
    monkeypatch.setattr(runner, "make_torus_p2p_runner",
                        lambda *a, **kw: taken.append(("p2p", a[2])))
    monkeypatch.setattr(runner, "make_torus_runner",
                        lambda *a, **kw: taken.append(("k4", a[3])))
    return taken


def test_torus_route(monkeypatch):
    """make_runner's route on a 2-D mesh: on CUDA devices the p2p torus
    runner, in one process and across processes (--multihost) on one host
    alike; the torch backend the plain torus; cuda-p2p still refused; on
    the CPU the cuda backend refused. (The CUDA meshes here are never
    touched: the runners are stand-ins.)"""
    taken = _stand_ins(monkeypatch)
    p, _ = _deck()
    cuda = [[torch.device("cuda", 0)] * 2] * 2
    for backend in ("cuda", "auto"):
        runner.make_runner(p, 10, backend, mesh=cuda)
    assert taken == [("p2p", cuda), ("p2p", cuda)]
    taken.clear()
    monkeypatch.setattr(multihost, "visible_cards",
                        lambda: {"uuid0", "uuid1"})
    places = [(b // 2, b % 2, f"uuid{b % 2}", "host") for b in range(4)]
    mesh = [[torch.device("cuda", 0), torch.device("cuda", 1)],
            [None, None]]
    runner.make_runner(p, 10, "cuda", mesh=mesh,
                       transport=_Transport(places, 0, [0, 1]))
    assert taken == [("p2p", mesh)]
    taken.clear()
    runner.make_runner(p, 10, "auto", "cpu", mesh=get_mesh_2d(2, 2, "cpu"))
    assert taken == [("k4", runner._plain_torus)]
    with pytest.raises(ValueError, match="cuda-p2p"):
        runner.make_runner(p, 10, "cuda-p2p", mesh=cuda)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        runner.make_runner(p, 10, "cuda", "cpu",
                           mesh=get_mesh_2d(2, 2, "cpu"))


def test_torus_peers_fit_every_layout_of_16_keys():
    """Over every dy, dx <= 8 and 1 to 16 card keys, block (i, j) on key
    (i dx + j) % keys (as get_mesh_2d places blocks on cards, and the
    global mesh blocks on (process, card)s): torus_graph names at most
    MAX_TORUS_PEERS flag arrays a card, exactly torus_peers's, and the
    route's limits pass; the most is 15 (3x6 over 15 keys), 9 at 3x3 over
    9 keys, 6 at 2x4 over 8."""
    most = {}
    for dy in range(1, 9):
        for dx in range(1, 9):
            for n in range(1, 17):
                keys2d = [[(0, (i * dx + j) % n) for j in range(dx)]
                          for i in range(dy)]
                graphs = ring_p2p.torus_graph(keys2d, 1, 1, 1, t=1)
                peers = ring_p2p.torus_peers(keys2d)
                assert {c: g[1] for c, g in graphs.items()} == peers
                most[dy, dx, n] = max(map(len, peers.values()))
                assert most[dy, dx, n] <= ring_p2p.MAX_TORUS_PEERS
                assert ring_p2p.torus_refusal(keys2d) == ""
    assert max(most.values()) == most[3, 6, 15] == 15
    assert most[3, 3, 9] == 9 and most[2, 4, 8] == 6
    assert most[2, 3, 6] == most[4, 2, 8] == most[4, 4, 8] == 6


def _keys_mesh(dy, dx, card):
    """A dy x dx mesh of stand-in CUDA devices, block b on cuda:card(b)."""
    return [[torch.device("cuda", card(i * dx + j)) for j in range(dx)]
            for i in range(dy)]


# (dy, dx, the card of block b) that torus mode takes in one process: 6,
# 8, 9, 15 and 16 card keys, 6 to 15 flag arrays a card
TORUS_MODE_LAYOUTS = [
    (2, 3, lambda b: b), (2, 4, lambda b: b), (4, 2, lambda b: b),
    (4, 4, lambda b: b % 8), (4, 4, lambda b: b), (3, 3, lambda b: b),
    (3, 6, lambda b: b % 15),
]


@pytest.mark.parametrize("dy,dx,card", TORUS_MODE_LAYOUTS)
def test_torus_route_takes_torus_mode_up_to_16_flag_arrays(
        monkeypatch, capsys, dy, dx, card):
    """Layouts past the ring's limit of 4 flag arrays a card (2x3 over 6 card
    keys, 2x4 and 4x2 over 8, 4x4 over 8 and 16, 3x3 over 9, 3x6 over 15):
    make_runner builds the p2p torus runner, and says nothing."""
    taken = _stand_ins(monkeypatch)
    p, _ = _deck()
    mesh = _keys_mesh(dy, dx, card)
    runner.make_runner(p, 10, "cuda", mesh=mesh)
    assert taken == [("p2p", mesh)]
    assert capsys.readouterr().err == ""


def test_torus_route_falls_back_past_the_limits(monkeypatch, capsys):
    """Past torus mode's limits make_runner builds K4's torus mode
    (torus_chunk over the transport) and names why on stderr, one line a
    runner: 17 flag arrays (a 6x6 torus over 35 cards, blocks (0, 0) and
    (3, 3) on one); 128 blocks on one card (1024^2 over 8x16 on one
    card); neighbour blocks on two hosts (across processes)."""
    taken = _stand_ins(monkeypatch)
    p, _ = _deck("1024x1024")
    spread = _keys_mesh(6, 6, lambda b: 0 if b in (0, 21) else b - (b > 21))
    keys = [[(0, d.index) for d in row] for row in spread]
    assert len(ring_p2p.torus_peers(keys)[0, 0]) == 17
    runner.make_runner(_case(96, 96, 1)[0], 10, "cuda", mesh=spread)
    err = capsys.readouterr().err
    assert "17 (process, card)s, at most 16" in err
    assert "falling back to K4's torus mode" in err
    assert len(err.splitlines()) == 1
    runner.make_runner(p, 10, "cuda", mesh=_keys_mesh(8, 16, lambda b: 0))
    err = capsys.readouterr().err
    assert "128 blocks on (process 0, cuda:0), at most 64 a card" in err
    assert "8x16 torus of 128x64 blocks" in err
    places = [(b // 2, 0, "uuid", f"host{b // 2}") for b in range(4)]
    mesh = [[torch.device("cuda", 0)] * 2, [None, None]]
    runner.make_runner(p, 10, "cuda", mesh=mesh,
                       transport=_Transport(places, 0, [0, 1]))
    err = capsys.readouterr().err
    assert "on host0" in err and "on host1" in err
    assert "CUDA IPC does not cross hosts" in err
    assert taken == [("k4", kstep_tile.torus_chunk)] * 3
    # 64 blocks on one card still take torus mode
    runner.make_runner(p, 10, "cuda", mesh=_keys_mesh(8, 8, lambda b: 0))
    assert taken[-1][0] == "p2p" and capsys.readouterr().err == ""


def test_torus_route_falls_back_where_a_neighbour_card_is_hidden(
        monkeypatch, capsys):
    """Across processes on one host, where a process cannot see the card
    of a neighbour block of another process (one card visible a process,
    as a per-rank CUDA_VISIBLE_DEVICES gives), its block cannot be mapped:
    make_runner builds K4's torus mode with one stderr line, in the process
    that cannot see it and, through the transport's ``any``, in every other
    process alike."""
    taken = _stand_ins(monkeypatch)
    p, _ = _deck()
    places = [(b // 2, 0, f"uuid{b // 2}", "host") for b in range(4)]
    mesh = [[torch.device("cuda", 0)] * 2, [None, None]]
    monkeypatch.setattr(multihost, "visible_cards", lambda: {"uuid0"})
    runner.make_runner(p, 10, "cuda", mesh=mesh,
                       transport=_Transport(places, 0, [0, 1]))
    err = capsys.readouterr().err
    assert "block 2 of process 1 lies on card uuid1, which process 0 " \
        "cannot see" in err
    assert "falling back to K4's torus mode" in err
    assert len(err.splitlines()) == 1
    monkeypatch.setattr(multihost, "visible_cards",
                        lambda: {"uuid0", "uuid1"})
    runner.make_runner(p, 10, "cuda", mesh=mesh,
                       transport=_Transport(places, 0, [0, 1],
                                            elsewhere=True))
    err = capsys.readouterr().err
    assert "not visible in another process" in err
    assert len(err.splitlines()) == 1
    assert taken == [("k4", kstep_tile.torus_chunk)] * 2
    runner.make_runner(p, 10, "cuda", mesh=mesh,
                       transport=_Transport(places, 0, [0, 1]))
    assert taken[-1] == ("p2p", mesh) and capsys.readouterr().err == ""


def test_torus_p2p_refuses_without_the_card():
    """The torus-mode launcher refuses CPU tensors before it touches nvcc;
    an exchange over another process's blocks holds this process's blocks'
    slots (the plain version's; across processes the kernel's blocks are
    mapped through CUDA IPC), and without a process group such a mesh is
    refused by the transport."""
    p, mask, f0 = _case(32, 32, 3)
    mesh = get_mesh_2d(2, 2, device="cpu")
    ex = ring_p2p.TorusExchange(mesh, 16, 16)
    blocks, obst = sharding.shard_blocks(torch.tensor(f0), torch.tensor(mask),
                                         mesh)
    bands = [torch.zeros(32, 32)] * 4
    _build.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ring_p2p._torus_launch(ex, blocks, [b.clone() for b in blocks],
                               bands, p, 8, 1, [0] * 4, True)
    assert _build.LAUNCHES["torus_p2p"] == 0
    cpu = torch.device("cpu")
    places = [(b // 2, -1, "", "host") for b in range(4)]
    ex = ring_p2p.TorusExchange([[cpu, cpu], [None, None]], 16, 16,
                                _Transport(places, 0, [0, 1]))
    assert ex.local == [0, 1] and len(ex.land) == 2
    with pytest.raises(ValueError, match="the mesh places shard"):
        ring_p2p.TorusExchange([[cpu, None]], 16, 16)


# --- a model of the kernel's flag protocol ---------------------------------
#
# An eager model of torus mode's schedule (csrc/ring_p2p.cu), as
# test_torch_p2p's model of the ring: each card runs its launches in order; a
# launch's CTAs are two Python generators each, the stepping warps and the
# producer warp, interleaved by a seeded random scheduler with every other
# card's. The producer walks the CTA's items (chunk, block, tile)
# chunk-major with the grid's stride, waits for the first item's flags and
# loads its window into stage 0; while the stepping warps step tile n, it
# polls the next item's flags and loads that window into the other stage
# where they are done; it waits until tile n is stored, releases its flag,
# and where the next window is not loaded yet waits for its flags and loads
# it. The stepping warps take the stages in turn, step the window, write the
# owned cells into the other state buffer and the pushes (TORUS_PUSHES, the
# cells each takes) into the neighbours' landing slots of the next epoch's
# parity, row by row, and signal the stage done. A window is loaded row by
# row from the pieces the kernel reads (the landing slots, or on a launch's
# first chunk with pull0 the neighbours' states), and every cell of every
# buffer carries the epoch of the state it holds: a loaded cell of another
# epoch is recorded as stale. The window is the owned tile and k cells
# around it: the cells the tile's results depend on.

def _tile_steps(band, obst, params, k, row_base):
    """torus_chunk_ref's arithmetic on a tile's band (9, r + 2k, c + 2k):
    (the tile after k steps, per step the |u| of its cells)."""
    r, c = band.shape[1] - 2 * k, band.shape[2] - 2 * k
    blocked = obst != 0
    f, speeds = band, []
    for s in range(k):
        rows, cols = f.shape[1:]
        b = blocked[s:s + rows, s:s + cols]
        for j in range(rows):
            if (row_base + s + j) % params.ny == params.accel_row:
                f = step_torch.accelerate(f, b, params, row=j)
        pulled = [f[q, 1 - CY[q]:rows - 1 - CY[q], 1 - CX[q]:cols - 1 - CX[q]]
                  for q in range(NSPEEDS)]
        out, speed = physics.collide(pulled, b[1:rows - 1, 1:cols - 1],
                                     params.omega, True)
        f = torch.stack(out)
        own = k - s - 1
        speeds.append(speed[own:own + r, own:own + c])
    return f, speeds


class TorusFlagModel:
    """The buffers, tags and flags of a p2p torus of dy x dx (h, w) blocks
    on ``cards`` (card of block b), and its scheduler. ``deps`` (None: the
    tile graph's) maps (block, tile) to the (block, tile)s it waits on;
    ``pushes(b)`` (None: TORUS_PUSHES, each to its neighbour) lists block
    b's pushes as (buffer, di, dj, destination block)."""

    def __init__(self, params, mask, states, dy, dx, cards, k, deps=None,
                 pushes=None, t=MODEL_TILE):
        self.p, self.dy, self.dx, self.cards, self.k, self.t = (
            params, dy, dx, cards, k, t)
        self.h, self.w = states[0].shape[1:]
        h, w, n = self.h, self.w, dy * dx
        self.kx = kstep_tile.col_margin(k)
        self.tx_n = -(-w // t)
        self.nt = -(-h // t) * self.tx_n
        if deps is None:
            deps = decode_torus_graph(cards, dy, dx, h, w, k, t)[0]
        self.deps = deps
        self.pushes = pushes or (lambda b: [
            (buf, di, dj, ring_p2p.torus_neighbour(b, di, dj, dy, dx))
            for buf, di, dj in ring_p2p.TORUS_PUSHES])
        nan = float("nan")
        self.buf = [[s.clone(), torch.full_like(s, nan)] for s in states]
        self.tag = [[np.zeros((h, w), int), np.full((h, w), -1)]
                    for _ in range(n)]
        self.cur = 0
        yw = w + 2 * self.kx
        shape = {"xlo": (h, self.kx), "xhi": (h, self.kx), "ylo": (k, yw),
                 "yhi": (k, yw)}
        self.slots = [{name: [torch.full((9, *shape[name]), nan)
                              for _ in range(2)] for name in shape}
                      for _ in range(n)]
        self.slot_tag = [{name: [np.full(shape[name], -1) for _ in range(2)]
                          for name in shape} for _ in range(n)]
        self.flags = [np.zeros(self.nt, int) for _ in range(n)]
        tr = runner.multihost.Transport([torch.device("cpu")] * n)
        obst = [torch.tensor(mask[i * h:(i + 1) * h, j * w:(j + 1) * w])
                for i in range(dy) for j in range(dx)]
        kx = self.kx
        bands = runner._torus_mask_bands(tr, obst, {k}, dy, dx, h, w)[k]
        self.bands = [m[:, kx - k:kx + w + k] for m in bands]
        self.epoch = 0
        self.stale = []
        self.speed = {}

    def locate(self, launch, item):
        c, r = divmod(item, launch["items"])
        return c, launch["blocks"][r // self.nt], r % self.nt

    def ready(self, launch, item):
        c, b, tile = self.locate(launch, item)
        return all(self.flags[e][u] >= launch["base"] + c
                   for e, u in self.deps[b, tile])

    def release(self, launch, item):
        c, b, tile = self.locate(launch, item)
        self.flags[b][tile] = launch["base"] + c + 1

    def source(self, launch, c, b, sr, cols):
        """(values (9, len(cols)), tags) of band row sr, band columns
        ``cols`` (unpadded: 0 is the block's column -k) of block b at chunk
        c, from the pieces the kernel reads."""
        h, w, k, kx = self.h, self.w, self.k, self.kx
        e = launch["base"] + c
        ry = 0 if sr < k else (1 if sr < k + h else 2)
        vals, tags = torch.empty(9, len(cols)), np.empty(len(cols), int)
        for m, bc in enumerate(cols):
            rx = 0 if bc < k else (1 if bc < k + w else 2)
            if (ry, rx) == (1, 1) or (launch["pull0"] and c == 0):
                g = ring_p2p.torus_neighbour(b, ry - 1, rx - 1, self.dy,
                                             self.dx)
                row = (h - k + sr, sr - k, sr - k - h)[ry]
                col = (w - k + bc, bc - k, bc - k - w)[rx]
                cur = launch["cur"] ^ (c % 2 if (ry, rx) == (1, 1) else 0)
                buf, tag = self.buf[g][cur], self.tag[g][cur]
            else:
                name = ("ylo", "xlo" if rx == 0 else "xhi", "yhi")[ry]
                row = (sr, sr - k, sr - k - h)[ry]
                col = (bc + kx - k if ry != 1 or rx == 0
                       else bc - k - w)
                buf = self.slots[b][name][e % 2]
                tag = self.slot_tag[b][name][e % 2]
            vals[:, m] = buf[:, row, col]
            tags[m] = tag[row, col]
        return vals, tags

    def load(self, launch, item):
        """The tile's window, its owned cells and k around them, row by row
        (a generator returning (c, b, tile, band)); records a stale cell."""
        c, b, tile = self.locate(launch, item)
        k, t, e = self.k, self.t, launch["base"] + c
        ty, tx = divmod(tile, self.tx_n)
        y0, x0 = ty * t, tx * t
        own_r, own_c = min(t, self.h - y0), min(t, self.w - x0)
        cols = list(range(x0, x0 + own_c + 2 * k))
        band = torch.empty(9, own_r + 2 * k, own_c + 2 * k)
        for i, sr in enumerate(range(y0, y0 + own_r + 2 * k)):
            vals, tags = self.source(launch, c, b, sr, cols)
            band[:, i] = vals
            if not (tags == e).all():
                self.stale.append((e, b, tile, sr, sorted(set(tags))))
            yield "work"
        return c, b, tile, band

    def step_store(self, launch, window):
        """Step the window's tile, write its owned cells and its pushes row
        by row, record its speeds."""
        c, b, tile, band = window
        h, w, k, kx, t = self.h, self.w, self.k, self.kx, self.t
        e = launch["base"] + c
        ty, tx = divmod(tile, self.tx_n)
        y0, x0 = ty * t, tx * t
        own_r, own_c = min(t, h - y0), min(t, w - x0)
        ob = self.bands[b][y0:y0 + own_r + 2 * k, x0:x0 + own_c + 2 * k]
        i = b // self.dx
        f, speeds = _tile_steps(band, ob, self.p, k,
                                (i * h - k + y0) % self.p.ny)
        yield "work"
        out = launch["cur"] ^ ((c + 1) % 2)
        cols = np.arange(x0, x0 + own_c)
        for r in range(own_r):
            row = y0 + r
            self.buf[b][out][:, row, x0:x0 + own_c] = f[:, r]
            self.tag[b][out][row, x0:x0 + own_c] = e + 1
            for buf, di, dj, dest in self.pushes(b):
                if (di == 1 and row < h - k) or (di == -1 and row >= k):
                    continue
                sel = {0: cols >= 0, 1: cols >= w - k, -1: cols < k}[dj]
                if not sel.any():
                    continue
                dcol = {0: kx + cols, 1: cols - (w - kx),
                        -1: (cols if di == 0 else kx + w + cols)}[dj][sel]
                drow = {0: row, 1: row - (h - k), -1: row}[di]
                slot = self.slots[dest][buf][(e + 1) % 2]
                slot[:, drow, dcol] = f[:, r, sel]
                self.slot_tag[dest][buf][(e + 1) % 2][drow, dcol] = e + 1
            yield "work"
        maps = self.speed.setdefault((e, b), [torch.full((h, w), float("nan"))
                                              for _ in range(k)])
        for s in range(k):
            maps[s][y0:y0 + own_r, x0:x0 + own_c] = speeds[s]

    def stepping_warps(self, launch, cta):
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
        total = launch["items"] * launch["n_outer"]
        items = list(range(b, total, grid))

        def fill(st, item):
            cta["stage"][st] = yield from self.load(launch, item)
            cta["full"][st] += 1

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
        """One runner call: ``launches`` [(n_outer, pull0)] on every card in
        order, the warps of all cards' current launches interleaved at
        random. Raises on a deadlock."""
        plan, base, cur = [], self.epoch, self.cur
        for n_outer, pull0 in launches:
            plan.append(dict(base=base, n_outer=n_outer, pull0=pull0,
                             cur=cur))
            base, cur = base + n_outer, cur ^ (n_outer % 2)
        queues = {card: list(plan) for card in set(self.cards)}
        running = {}

        def start(card):
            launch = dict(queues[card].pop(0))
            launch["blocks"] = [b for b in range(len(self.cards))
                                if self.cards[b] == card]
            launch["items"] = len(launch["blocks"]) * self.nt
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
        return [self.buf[b][self.cur] for b in range(len(self.cards))]


# Calls of launches (n_outer, pull0): a call's first launch reads the
# neighbours' states, the next ones the slots; two calls, odd launches.
CALLS = [[(3, True), (1, False)], [(2, True), (2, False)]]


def _model_case(dy, dx, ny, nx, cards, seed=3, k=5):
    p, mask, f0 = _case(ny, nx, seed)
    mesh = get_mesh_2d(dy, dx, device="cpu")
    states, _ = sharding.shard_blocks(torch.tensor(f0), torch.tensor(mask),
                                      mesh)
    return p, mask, states, [cards[b % len(cards)] for b in range(dy * dx)], k


def _plain_calls(p, mask, states, dy, dx, k, calls):
    """torus_p2p_chunks_ref over the same calls: (states, [(base, n_outer,
    per block the sums)])."""
    h, w = states[0].shape[1:]
    mesh = get_mesh_2d(dy, dx, device="cpu")
    tr = runner.multihost.Transport(runner._flat(mesh))
    _, obst = sharding.shard_blocks(torch.zeros(9, p.ny, p.nx),
                                    torch.tensor(mask), mesh)
    bands = runner._torus_mask_bands(tr, obst, {k}, dy, dx, h, w)[k]
    bases = [(b // dx * h - k) % p.ny for b in range(dy * dx)]
    land = ring_p2p.TorusExchange(mesh, h, w).land
    base, sums = 0, []
    for launches in calls:
        for n_outer, pull0 in launches:
            states, s = ring_p2p.torus_p2p_chunks_ref(
                states, bands, land, p, k, n_outer, base, bases, pull0, dy,
                dx)
            sums.append((base, n_outer, s))
            base += n_outer
    return states, sums


@pytest.mark.parametrize("dy,dx,ny,nx,cards,grid", [
    (2, 2, 24, 40, "a", 1), (2, 2, 24, 40, "a", 5), (2, 2, 24, 40, "ab", 7),
    (2, 2, 24, 40, "abcd", None), (1, 4, 24, 40, "ab", 3),
    (4, 1, 48, 20, "a", 9), (2, 3, 24, 42, "abc", 11), (1, 1, 24, 20, "a", 2),
    (2, 4, 24, 48, "abcdef", 13), (3, 3, 36, 36, "abcdefghi", 17),
])
def test_flag_model_reads_nothing_stale_and_is_the_plain_version(
        dy, dx, ny, nx, cards, grid):
    """The model of torus mode over dy x dx blocks (8 x 8 model tiles,
    k = 5: ragged tile rows and columns, so the slabs and corners reach
    across two tiles; one row, one column and 1x1, where a block is its own
    neighbour) on 1-4 cards, 2x4 over 6 and 3x3 over 9 (6 and 9 flag
    arrays a card), for grids of 1 CTA to every tile of a chunk:
    it finishes, reads no stale cell, and ends bitwise equal to
    torus_p2p_chunks_ref over the same calls, state and per-step sums."""
    p, mask, states, on, k = _model_case(dy, dx, ny, nx, cards)
    model = TorusFlagModel(p, mask, states, dy, dx, on, k)
    rng = np.random.RandomState(dy * 100 + dx * 10 + (grid or 0))
    for launches in CALLS:
        model.call(launches, grid or model.nt * dy * dx, rng)
    assert model.stale == []
    want, sums = _plain_calls(p, mask, states, dy, dx, k, CALLS)
    for a, b in zip(model.states(), want):
        assert torch.equal(a, b)
    for base, n_outer, s in sums:
        for b in range(dy * dx):
            got = torch.stack([model.speed[(base + c, b)][j].clone().sum(
                dtype=torch.float32) for c in range(n_outer)
                for j in range(k)])
            assert torch.equal(got, s[b])


def _caught(dy, dx, ny, nx, grid, seeds=4, cards="ab", **kw):
    """The seeds of ``seeds`` whose run of the model (``kw``: its deps or
    pushes) read a stale cell or deadlocked."""
    caught = 0
    for seed in range(seeds):
        p, mask, states, on, k = _model_case(dy, dx, ny, nx, cards)
        model = TorusFlagModel(p, mask, states, dy, dx, on, k, **kw)
        try:
            for launches in CALLS:
                model.call(launches, grid, np.random.RandomState(seed))
        except AssertionError:
            caught += 1
            continue
        caught += bool(model.stale)
    return caught


def test_flag_model_catches_a_missing_diagonal_wait():
    """Without the waits on the diagonal neighbour blocks' tiles (a graph
    of the x and y neighbours and the block itself), a corner is read
    stale: every seed, 2x2 blocks on two cards, at 7 CTAs."""
    dy, dx, h, w, k = 2, 2, 12, 20, 5
    full = decode_torus_graph(list("abab"), dy, dx, h, w, k)[0]

    def diagonal(b, e):
        return e in {ring_p2p.torus_neighbour(b, di, dj, dy, dx)
                     for di in (-1, 1) for dj in (-1, 1)} - {
            ring_p2p.torus_neighbour(b, di, dj, dy, dx)
            for di, dj in ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))}

    deps = {key: [(e, u) for e, u in got if not diagonal(key[0], e)]
            for key, got in full.items()}
    assert deps != full
    assert _caught(dy, dx, dy * h, dx * w, 7, deps=deps) == 4


def test_flag_model_catches_a_missing_self_neighbour_push():
    """On one row of blocks a block is its own upper and lower neighbour:
    its first and last k rows go into its own y slots. Pushes that skip
    a neighbour that is the block itself (as a list of distinct
    neighbours would) leave those slots stale: every seed, 1x4 blocks, at
    5 CTAs."""
    dy, dx = 1, 4

    def pushes(b):
        return [(buf, di, dj, e) for buf, di, dj in ring_p2p.TORUS_PUSHES
                if (e := ring_p2p.torus_neighbour(b, di, dj, dy, dx)) != b]

    assert _caught(dy, dx, 24, 40, 5, pushes=pushes) == 4
