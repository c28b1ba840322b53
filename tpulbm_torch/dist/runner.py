"""The step-loop runners: one device, the 1-D ring of shards, and the 2-D
torus of blocks.

``make_runner(params, n_steps, backend, device, mesh=None)`` returns, on one
device, ``runner(f, obstacles) -> (f', av_vels)``: ``f`` the (9, ny, nx)
float32 state, ``obstacles`` the (ny, nx) bool mask, both on ``device``;
``av_vels`` the (n_steps,) float32 series on the same device, each step's
sum of |u| over free cells times ``free_cells_inv`` (params.py:32). The
series is read back by the caller once per runner call, never per step.

With a ``mesh`` (``dist.mesh.get_mesh``) of N >= 2 devices it returns the
ring runner, ``runner(shards, obst_shards) -> (shards', av_vels)``: the
lists of row shards of ``dist.sharding.shard_rows``, shard i on mesh[i];
``av_vels`` on mesh[0]. The ring is the counterpart of the JAX package's
``shard_map`` runners (tpulbm/dist/runner.py:110-1098,1870-1905): every
chunk of k <= 8 steps, each shard's last k rows go to the next shard's lo
slab and its first k rows to the previous shard's hi slab (the ``_ring_slabs``
of runner.py:110-128; the wrap is the periodic y boundary), and one
``kstep_tile.ring_chunk`` (K4 ring mode) steps each shard. k is the least of
8, the smallest shard's rows and the steps left. Each shard keeps its raw
per-step sums on its own device; they are added once after the loop, on
mesh[0], in shard order, and scaled by ``free_cells_inv`` (the deferred
``psum`` of runner.py:1884-1887, d2q9-bgk.c:367-374). Shards follow
``decompose_rows``, so any ny runs without padding.

With a 2-D ``mesh`` (``dist.mesh.get_mesh_2d``, a dy x dx nested list) it
returns the torus runner, ``runner(blocks, obst_blocks) -> (blocks',
av_vels)``: the row-major lists of blocks of ``dist.sharding.shard_blocks``,
block (i, j) on mesh[i][j]; ``av_vels`` on mesh[0][0]. It is the
counterpart of ``_make_runner_2d_kstep`` and, on the ``torch`` backend, of
the per-step ``_make_runner_2d`` (tpulbm/dist/runner.py:1213-1321,
1550-1624). Every chunk of k <= 8 steps runs the two-phase exchange of
runner.py:1255-1281: first each block's x slabs (the left neighbour's last k
columns, the right neighbour's first k), then its y slabs, the last and
first k rows of its row neighbours' x-extended bands (xlo | block | xhi), so
the corner cells ride along; then one ``kstep_tile.torus_chunk`` (K4 torus
mode) steps each block. k is the least of 8, h, w and the steps left. The
raw per-step sums stay on each block's device and are added once after the
loop, on mesh[0][0], in row-major block order, and scaled by
``free_cells_inv`` (the deferred ``psum(psum(av, ay), ax)`` of
runner.py:1307). The torus keeps the JAX package's even split. K4 takes
any block width, so the TPU's ``w >= 128`` / ``supported_x_halo`` gate
(runner.py:1532-1544), which picks between the Pallas and jnp tori there,
chooses no route here. The ``cuda`` backend runs ``make_torus_p2p_runner``,
the counterpart of the JAX runner's one program: K6's torus mode steps
every block of a card for up to ``ring_p2p.MAX_OUTER`` chunks in one
launch, the blocks handing their edges and corners to each other inside
the kernel (the same bits as the K4 torus runner's, which stays its
reference), in one process or across processes (through CUDA IPC
mappings). ``make_runner`` decides the route when it builds the runner:
where a card would hold more than ``ring_p2p.MAX_TORUS_LOCAL`` blocks,
where a card's blocks would wait on more than ``ring_p2p.MAX_TORUS_PEERS``
flag arrays (one a (process, card)), where neighbour blocks lie on
different hosts, or where a process cannot see the card of a neighbour
block of another process (every process takes the same route), it says
why on stderr and builds the K4 torus runner
(``kstep_tile.torus_chunk`` over the ``Transport``); a kernel that fails
raises, with no fallback.

Over several processes (``--multihost``) the ring's and the torus's mesh
is the global one (``dist.multihost``), ``None`` for another process's
shards, and a runner takes and returns this process's shards alone. A
``dist.multihost.Transport`` moves every halo piece (the mask bands' too):
a copy where both shards are in this process, as on one process, a P2P
message where not; the raw sums of every shard are gathered to every
process and added there in shard order, so the series is bitwise that of
one process driving every shard.

Each runner call is one span ``lbm.dist.call`` (``utils.profiling``), in
which the ring's and the K4 torus's host-issued exchange of a chunk is
``lbm.dist.exchange`` and the sums' addition ``lbm.dist.sums``; there is
no span a kernel launch.

Every runner takes ownership of its input, as the JAX runners do with
``donate_argnums=0``: a chunk writes its state into the storage that the
chunk before it read (``ops.kstep.output``), so a run holds two states,
the least with K4, whose output must lie apart from its source. The
caller must not read its input after the call.

Backends (the single-device route, ``kernel_plan``):

- ``cuda``: the hand-written kernels. A grid that passes
  ``resident_route`` runs ``resident.resident_chunk`` (K2) in chunks of
  ``resident.RESIDENT_K`` steps plus a remainder, as
  ``_make_resident_runner``. Every other grid runs K6's grid kind,
  ``ring_p2p.grid_p2p_chunks``: up to ``ring_p2p.MAX_OUTER`` 8-step chunks
  of the whole periodic grid in one persistent launch, its items handing
  off between chunks through epoch flags, then one launch of the
  remainder. The grid kind computes the state bits of K4's whole-grid
  chunks (``kstep_tile.tile_chunk``), which stay off the route as its
  reference (the per-step sums it adds in its own order);
  K1 (``kstep.skew_chunk``, ``kstep.kstep_chunk``) is on no route either:
  it is the one-pass-per-step kernel that ``chip_smoke.py`` holds K4
  against.
- ``torch``: the plain oracle ``ops.step_torch`` (canonical equilibrium, as
  the JAX package's ``jnp`` backend), on any device.
- ``auto``: ``cuda`` on a CUDA device, ``torch`` on the CPU.

On a ring, ``cuda`` copies the slabs on each device's compute stream (peer
copies between cards) and launches ``ring_chunk`` once per shard; ``torch``
runs its plain version (canonical equilibrium) per shard. ``cuda-p2p`` is
the counterpart of ``--backend pallas-rdma`` (``pallas_kstep_rdma``,
``pallas_resident_rdma``, whose slab exchange runs inside the kernel): on a
ring it runs ``make_p2p_runner``, one K6 launch (``ring_p2p.p2p_chunks``)
a card and process for up to ``ring_p2p.MAX_OUTER`` chunks of every shard
on it, the slabs handed between shards inside the kernel (between
processes through CUDA IPC mappings), and one host readback a runner call;
it computes the ``cuda`` ring's bits. As in the JAX package, on one device
it says so and runs the single-device route, and a 2-D mesh refuses it.
Where the ring crosses hosts (IPC does not) it says so and runs the
``cuda`` ring, as the JAX package does for a layout its rdma kernel cannot
serve (tpulbm/dist/runner.py:1709-1719).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.dist import multihost
from tpulbm_torch.dist.sharding import block_shape, ring_rows
from tpulbm_torch.ops import kstep, kstep_tile, resident, ring_p2p, step_torch
from tpulbm_torch.utils.profiling import span, spanned, totals

BACKENDS = ("auto", "cuda", "torch", "cuda-p2p")


def resolve_backend(backend: str, device) -> str:
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend in ("cuda", "cuda-p2p") and device.type != "cuda":
        raise ValueError(
            f"backend {backend!r} runs the CUDA kernels and needs a CUDA "
            f"device, got {device}")
    return backend


def _chunks(fn, k: int, n_steps: int, rem_fn=None) -> list:
    """[(fn, k, 1)] * (n_steps // k) plus [(rem_fn or fn, the remainder,
    1)]: a plan of one chunk a call."""
    n_full, rem = divmod(n_steps, k)
    return [(fn, k, 1)] * n_full + ([(rem_fn or fn, rem, 1)] if rem else [])


def _grouped(k: int, n_steps: int, per: int) -> list:
    """The launches of a kernel that runs up to ``per`` chunks of k steps a
    launch: [(k, chunks)], full launches of ``per`` chunks, one of the
    chunks left, then one of a single chunk of the n_steps % k steps
    left."""
    n_full, rem = divmod(n_steps, k)
    launches = [(k, per)] * (n_full // per)
    launches += [(k, n_full % per)] if n_full % per else []
    return launches + ([(rem, 1)] if rem else [])


def resident_route(ny: int, nx: int) -> bool:
    """Whether a one-card (ny, nx) grid runs on K2; every other grid runs
    on K6's grid kind. This is the JAX package's resident gate,
    ``pallas_resident.supported`` or ``supported_hbm``
    (tpulbm/ops/pallas_resident.py:35-60): 8/128-aligned grids of at most
    135K cells, whatever the step count. K2 takes any grid of at least h
    rows and columns a CTA; the gate is kept so that the port routes a grid
    to K2 exactly where the JAX router picks its resident tier."""
    return nx % 128 == 0 and ny % 8 == 0 and ny >= 8 and ny * nx <= 135 * 1024


def kernel_plan(params: LBMParams, n_steps: int) -> list:
    """The ``cuda`` backend's launches: [(fn, k, n), ...], n chunks of k
    steps a call of fn, covering n_steps. Where ``resident_route`` holds:
    K2's chunks (``resident.resident_chunk``, n = 1). Elsewhere: the grid
    kind of K6 (``ring_p2p.grid_p2p_chunks``), up to
    ``ring_p2p.grid_outer_per_launch`` chunks of 8 steps a launch, then one
    launch of the remainder."""
    if resident_route(params.ny, params.nx):
        return _chunks(resident.resident_chunk,
                       min(n_steps, resident.RESIDENT_K), n_steps)
    k = min(kstep_tile.TILE_K, n_steps)
    per = ring_p2p.grid_outer_per_launch(params.ny, params.nx, k)
    return [(ring_p2p.grid_p2p_chunks, kk, n)
            for kk, n in _grouped(k, n_steps, per)]


def _skew(f, obst_f, params, k):
    """K1's 8-step chunk as a plan's chunk function (off every route)."""
    return kstep.skew_chunk(f, obst_f, params)


# The chunk functions that write into a given ``out`` (K1's, off every
# route, allocate their own).
_TAKE_OUT = (kstep_tile.tile_chunk, resident.resident_chunk)


def run_plan(plan, f, obst_f, params: LBMParams):
    """Run the launches of ``plan`` ([(fn, k, n)], ``kernel_plan``'s) from
    state ``f``, which the run takes over: each launch writes into the
    storage that the launch before it read (the grid kind ping-pongs the
    two inside a launch). The grid kind's error word and wait counters are
    read once, after the last launch (``ring_p2p.GridExchange.check``).
    Returns (f', av_vels)."""
    sums, spare, grid = [], None, False
    for fn, k, n in plan:
        if fn is ring_p2p.grid_p2p_chunks:
            if spare is None:
                spare = torch.empty_like(f)
            f, spare, s = fn(f, spare, obst_f, params, k, n)
            grid = True
        elif fn in _TAKE_OUT:
            spare, (f, s) = f, fn(f, obst_f, params, k, out=spare)
        else:
            f, s = fn(f, obst_f, params, k)
        sums.append(s)
    if grid and f.device.type == "cuda":
        ring_p2p.grid_exchange(f.device, params.ny, params.nx).check()
    with span("lbm.dist.sums"):
        return f, step_torch.scale_sums(torch.cat(sums), params)


def make_runner(params: LBMParams, n_steps: int, backend: str = "auto",
                device="cuda", mesh: Sequence | None = None,
                transport=None) -> Callable:
    if mesh is not None and isinstance(mesh[0], (list, tuple)):
        if backend == "cuda-p2p":
            # as the JAX package refuses pallas-rdma (runner.py:1646-1650)
            raise ValueError(
                "backend='cuda-p2p' is not available on a 2-D mesh "
                "(use 'cuda', 'torch' or 'auto')")
        mesh = [[None if d is None else torch.device(d) for d in row]
                for row in mesh]
        backend = resolve_backend(backend, _first_local(mesh))
        if backend == "torch":
            return make_torus_runner(params, n_steps, mesh, _plain_torus,
                                     transport)
        tr = transport or multihost.Transport(_flat(mesh))
        why = _torus_refusal(mesh, tr)
        if why:
            dy, dx = len(mesh), len(mesh[0])
            h, w = block_shape(params.ny, params.nx, dy, dx)
            # in the style of the cuda-p2p fallbacks below
            print(f"tpulbm_torch: the torus's in-kernel exchange (K6's torus "
                  f"mode) unsupported for the {dy}x{dx} torus of {h}x{w} "
                  f"blocks ({why}); falling back to K4's torus mode with the "
                  f"host's exchange", file=sys.stderr, flush=True)
            return make_torus_runner(params, n_steps, mesh,
                                     kstep_tile.torus_chunk, tr)
        return make_torus_p2p_runner(params, n_steps, mesh, tr)
    if mesh is not None and len(mesh) > 1:
        mesh = _flat(mesh)
        if (backend == "cuda-p2p" and transport is not None
                and transport.world > 1):
            seam = _host_seam(transport.places())
            if seam:
                # in the style of the JAX package's fallback for pallas-rdma
                # (tpulbm/dist/runner.py:1709-1719)
                print(f"tpulbm_torch: cuda-p2p unsupported across hosts "
                      f"({seam}: CUDA IPC does not cross hosts); falling "
                      f"back to the cuda ring", file=sys.stderr, flush=True)
                backend = "cuda"
        backend = resolve_backend(backend, _first_local(mesh))
        if backend == "cuda-p2p":
            return make_p2p_runner(params, n_steps, mesh, transport)
        return make_ring_runner(
            params, n_steps, mesh,
            _plain_ring if backend == "torch" else kstep_tile.ring_chunk,
            transport)
    device = torch.device(device if mesh is None else mesh[0])
    if backend == "cuda-p2p":
        # The JAX package's route for pallas-rdma on one device
        # (tpulbm/dist/runner.py:1709-1719)
        print(f"tpulbm_torch: cuda-p2p unsupported for local shape "
              f"({params.ny}, {params.nx}) on 1 devices; falling back to the "
              f"single-device route", file=sys.stderr, flush=True)
        backend = "cuda"
    backend = resolve_backend(backend, device)

    def check_device(f, obstacles):
        for t in (f, obstacles):
            if t.device.type != device.type:
                raise ValueError(
                    f"runner built for backend {backend!r} on {device} got "
                    f"a tensor on {t.device}")

    if backend == "torch":
        @spanned("lbm.dist.call")
        def runner(f, obstacles):
            check_device(f, obstacles)
            return step_torch.run_steps(f, obstacles, params, n_steps)

        return runner

    plan = kernel_plan(params, n_steps)

    @spanned("lbm.dist.call")
    def runner(f, obstacles):
        check_device(f, obstacles)
        return run_plan(plan, f, obstacles.to(torch.float32), params)

    return runner


def _neighbour_pairs(n: int, mesh_shape=None) -> list:
    """(d, e) for each shard d and each neighbour e whose slots and flags
    its tiles reach: ring neighbours, or with ``mesh_shape`` (dy, dx) each
    torus block and its eight neighbours."""
    if mesh_shape is None:
        return [(d, (d + 1) % n) for d in range(n)]
    return [(b, ring_p2p.torus_neighbour(b, di, dj, *mesh_shape))
            for b in range(n) for di, dj in ring_p2p.NEIGHBOURS]


def _host_seam(places, mesh_shape=None) -> str:
    """The first pair of neighbours (``_neighbour_pairs``) on different
    hosts, as text, or "" (``places``: ``Transport.places``)."""
    what = "shard" if mesh_shape is None else "block"
    for d, e in _neighbour_pairs(len(places), mesh_shape):
        a, b = places[d], places[e]
        if a[3] != b[3]:
            return (f"{what} {d} of process {a[0]} on {a[3]}, {what} {e} of "
                    f"process {b[0]} on {b[3]}")
    return ""


def _torus_refusal(mesh2d, tr) -> str:
    """Why the torus over ``mesh2d`` cannot take K6's torus mode, or "":
    neighbour blocks on different hosts (CUDA IPC does not cross hosts), a
    limit of the kernel (``ring_p2p.torus_refusal`` over the blocks'
    (process, card) keys), or, in any process, a neighbour block of another
    process on a card that this process cannot see (its block must be
    mapped here); the same answer in every process."""
    dy, dx = len(mesh2d), len(mesh2d[0])
    if tr.world == 1:
        keys = [(0, d.index) for d in _flat(mesh2d)]
        return ring_p2p.torus_refusal([keys[i * dx:(i + 1) * dx]
                                       for i in range(dy)])
    places = tr.places()
    seam = _host_seam(places, (dy, dx))
    if seam:
        return f"{seam}: CUDA IPC does not cross hosts"
    keys = [tuple(pl[:2]) for pl in places]
    why = ring_p2p.torus_refusal([keys[i * dx:(i + 1) * dx]
                                  for i in range(dy)])
    if why:
        return why
    visible, hidden = multihost.visible_cards(), ""
    for d, e in _neighbour_pairs(len(places), (dy, dx)):
        if (tr.is_local(d) and not tr.is_local(e) and places[e][2]
                and places[e][2] not in visible):
            hidden = (f"block {e} of process {places[e][0]} lies on card "
                      f"{places[e][2]}, which process {tr.rank} cannot see "
                      f"(CUDA_VISIBLE_DEVICES="
                      f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
            break
    if tr.any(bool(hidden)):
        return hidden or ("a neighbour block's card is not visible in "
                          "another process")
    return ""


def _plain_ring(lo, shard, hi, obst_band, params, k, row_base, out=None):
    """The ``torch`` backend's shard step: the plain ring chunk with the
    canonical equilibrium, as ``step_torch.run_steps``."""
    f, sums = kstep_tile.ring_chunk_ref(lo, shard, hi, obst_band, params, k,
                                        row_base, pair_symmetric=False)
    return kstep.into(out, f), sums


def _plain_torus(xlo, block, xhi, ylo, yhi, obst_band, params, k, row_base,
                 out=None):
    """The ``torch`` backend's block step: the plain torus chunk with the
    canonical equilibrium, as ``step_torch.run_steps``."""
    f, sums = kstep_tile.torus_chunk_ref(xlo, block, xhi, ylo, yhi,
                                         obst_band, params, k, row_base,
                                         pair_symmetric=False)
    return kstep.into(out, f), sums


@spanned("lbm.dist.sums")
def _deferred_sum(sums, device, params: LBMParams, transport):
    """The local shards' lists of raw per-step sums and every other
    process's (``transport.all_gather``), added on ``device`` in shard order
    and scaled by ``free_cells_inv``: every process holds the same series,
    bitwise that of one process driving every shard."""
    av = None
    for s in transport.all_gather([torch.cat(s) for s in sums]):
        s = s.to(device)
        av = s if av is None else av + s
    return step_torch.scale_sums(av, params)


def _seconds(name: str) -> float:
    """The seconds of the spans named ``name`` in this process so far."""
    return totals().get(name, (0, 0.0))[1]


def _flat(mesh):
    """A ring's devices, or a torus's in row-major order; ``None`` stays
    ``None`` (another process's shard)."""
    rows = mesh if isinstance(mesh[0], (list, tuple)) else [mesh]
    return [None if d is None else torch.device(d) for row in rows
            for d in row]


def _first_local(mesh) -> torch.device:
    return next(d for d in _flat(mesh) if d is not None)


def make_ring_runner(params: LBMParams, n_steps: int, mesh: Sequence,
                     chunk_fn: Callable, transport=None) -> Callable:
    """The ring runner over ``mesh`` (see the module docstring).
    ``chunk_fn(lo, shard, hi, obst_band, params, k, row_base, out)`` steps
    one shard: ``kstep_tile.ring_chunk`` (which takes its plain version on
    CPU tensors) or ``_plain_ring``. ``transport``
    (``dist.multihost.Transport``, made from ``mesh`` where not given)
    moves the slabs; the runner takes and returns this process's shards."""
    mesh = _flat(mesh)
    tr = transport or multihost.Transport(mesh)
    n, ny, nx = len(mesh), params.ny, params.nx
    rows, offsets = ring_rows(ny, n)
    if n_steps < 1:
        raise ValueError(f"ring runner of {n_steps} steps")
    k_max = min(kstep_tile.TILE_K, min(rows), n_steps)
    plan = [k for _, k, _ in _chunks(None, k_max, n_steps)]
    slabs = {k: multihost.ring_pieces(k, n, (9,), nx) for k in set(plan)}
    local = tr.local

    @spanned("lbm.dist.call")
    def runner(shards, obst_shards):
        _check_shards(local, shards, obst_shards, rows, mesh, ny, nx)
        # Shard d's (h + 2 k_max, nx) mask band; a chunk of k steps takes
        # its rows [k_max - k, k_max + h + k).
        masks = _mask_bands(tr, obst_shards, k_max, n, nx)
        shards, spares = list(shards), [None] * len(local)
        sums = [[] for _ in local]
        for k in plan:
            with span("lbm.dist.exchange"):
                halo = tr.move(slabs[k],
                               multihost.by_shard(local, shards, n))
            new = []
            for j, d in enumerate(local):
                band = masks[j][k_max - k:k_max + rows[d] + k]
                f, s = chunk_fn(halo[2 * d], shards[j], halo[2 * d + 1],
                                band, params, k, (offsets[d] - k) % ny,
                                out=spares[j])
                new.append(f)
                sums[j].append(s)
            spares, shards = shards, new
        return shards, _deferred_sum(sums, tr.device, params, tr)

    return runner


def _check_shards(local, shards, obst_shards, rows, mesh, ny, nx):
    """A ring runner's input: this process's shards and masks, shard d of
    rows[d] rows on mesh[d]."""
    if len(shards) != len(local) or len(obst_shards) != len(local):
        raise ValueError(f"ring runner over {len(local)} local shards "
                         f"got {len(shards)} and {len(obst_shards)}")
    for d, f, o in zip(local, shards, obst_shards):
        if (f.shape != (9, rows[d], nx) or o.shape != (rows[d], nx)
                or f.device != mesh[d] or o.device != mesh[d]):
            raise ValueError(
                f"shard {d}: state {tuple(f.shape)} on {f.device}, mask "
                f"{tuple(o.shape)} on {o.device}; the ring wants rows "
                f"{rows[d]} of the ({ny}, {nx}) grid on {mesh[d]}")


def _mask_bands(tr, obst_shards, k: int, n: int, nx: int) -> list:
    """Each local shard's (h + 2k, nx) float mask band: its neighbours'
    k edge rows around its own."""
    obst_f = [o.to(torch.float32) for o in obst_shards]
    halo = tr.move(multihost.ring_pieces(k, n, (), nx),
                   multihost.by_shard(tr.local, obst_f, n))
    return [torch.cat([halo[2 * d], o, halo[2 * d + 1]])
            for d, o in zip(tr.local, obst_f)]


def make_p2p_runner(params: LBMParams, n_steps: int, mesh: Sequence,
                    transport=None,
                    max_outer: int = ring_p2p.MAX_OUTER) -> Callable:
    """The ``cuda-p2p`` ring over ``mesh``: the counterpart of
    ``_make_resident_rdma_runner`` (and ``_make_rdma_runner``) of
    tpulbm/dist/runner.py:946-1092, over one process or, with a
    ``transport`` of several (``dist.multihost``), a global mesh of every
    process's shards. The chunks are those of the ``cuda`` ring, k the
    least of 8, the smallest shard's rows and n_steps; each
    ``ring_p2p.p2p_chunks`` call (one K6 launch a card, or its plain
    version on CPU shards) runs up to ``max_outer`` of them
    (``ring_p2p.outer_per_launch`` may take fewer, for the partials'
    memory), and the n_steps % k remainder one more launch of that k. The
    first launch of a call and the remainder's read the neighbours' states
    for their first chunk (pull0; across processes the states' edge rows
    pushed into the slots first, ``ring_p2p.Exchange.enter``); every other
    chunk reads the landing slots that the chunk before filled, chosen by
    the parity of the epoch, which ``ring_p2p.Exchange`` carries across
    launches and calls. A call ends in ``Exchange.check``, which over
    several processes returns once no launch of the call runs on any. The
    sums are added as the ``cuda`` ring adds them: the same bits."""
    mesh = _flat(mesh)
    tr = transport or multihost.Transport(mesh)
    n, ny, nx = len(mesh), params.ny, params.nx
    rows, offsets = ring_rows(ny, n)
    if n_steps < 1 or max_outer < 1:
        raise ValueError(f"p2p ring runner of {n_steps} steps, "
                         f"{max_outer} chunks a launch")
    k = min(kstep_tile.TILE_K, min(rows), n_steps)
    launches = _grouped(k, n_steps, min(
        max_outer, ring_p2p.outer_per_launch(rows, nx, k)))
    opened = _seconds("lbm.dist.ipc_open")
    ex = ring_p2p.Exchange(mesh, rows, nx, tr)
    if ex.world > 1 and ex.mesh[ex.local[0]].type == "cuda":
        ms = (_seconds("lbm.dist.ipc_open") - opened) * 1e3
        print(f"tpulbm_torch: cuda-p2p over {ex.world} processes: "
              f"{len(ex.opened)} exchange blocks of other processes opened "
              f"in {ms:.1f} ms", file=sys.stderr, flush=True)

    @spanned("lbm.dist.call")
    def runner(shards, obst_shards):
        _check_shards(tr.local, shards, obst_shards, rows, mesh, ny, nx)
        masks = _mask_bands(tr, obst_shards, k, n, nx)
        bands = {kk: [m[k - kk:k + rows[d] + kk]
                      for d, m in zip(tr.local, masks)]
                 for kk, _ in launches}
        ex.barrier()
        states = list(shards)
        spares = [torch.empty_like(f) for f in states]
        sums = [[] for _ in states]
        for i, (kk, outer) in enumerate(launches):
            states, spares, s = ring_p2p.p2p_chunks(
                ex, states, spares, bands[kk], params, kk, outer,
                [(offsets[d] - kk) % ny for d in tr.local],
                pull0=i == 0 or kk != k)
            for j, sj in enumerate(s):
                sums[j].append(sj)
        ex.check()
        return states, _deferred_sum(sums, tr.device, params, tr)

    return runner


def _torus_pieces(k: int, dy: int, dx: int, lead: tuple, h: int, w: int):
    """The two phases of the torus's exchange for a chunk of k steps
    (runner.py:1255-1281), as ``Transport.move`` pieces. x first, from the
    blocks: block b's xlo is its left neighbour's last k columns in the last
    k of ``col_margin(k)``, its xhi its right neighbour's first k in the
    first (the rest zeros). Then y, from each block's x-extended band
    (xlo, block, xhi): block b's ylo is its upper neighbour's last k rows,
    its yhi its lower neighbour's first k, corners included."""
    kx = kstep_tile.col_margin(k)

    def xlo(t):
        return F.pad(t[..., -k:], (kx - k, 0))

    def xhi(t):
        return F.pad(t[..., :k], (0, kx - k))

    def ylo(band):
        return torch.cat([p[..., -k:, :] for p in band], dim=-1)

    def yhi(band):
        return torch.cat([p[..., :k, :] for p in band], dim=-1)

    x, y = [], []
    for b in range(dy * dx):
        i, j = divmod(b, dx)
        x += [(i * dx + (j - 1) % dx, b, (*lead, h, kx), xlo),
              (i * dx + (j + 1) % dx, b, (*lead, h, kx), xhi)]
        y += [(((i - 1) % dy) * dx + j, b, (*lead, k, w + 2 * kx), ylo),
              (((i + 1) % dy) * dx + j, b, (*lead, k, w + 2 * kx), yhi)]
    return x, y


def _torus_halos(tr, pieces, g, n: int):
    """The exchange of a chunk (``_torus_pieces``) over this process's
    blocks ``g`` (states or float masks): [(xlo, xhi, ylo, yhi)] per local
    block, on its device."""
    x_pieces, y_pieces = pieces
    x = tr.move(x_pieces, multihost.by_shard(tr.local, g, n))
    bands = [(x[2 * b], blk, x[2 * b + 1]) for b, blk in zip(tr.local, g)]
    y = tr.move(y_pieces, multihost.by_shard(tr.local, bands, n))
    return [(x[2 * b], x[2 * b + 1], y[2 * b], y[2 * b + 1])
            for b in tr.local]


def make_torus_runner(params: LBMParams, n_steps: int, mesh2d: Sequence,
                      chunk_fn: Callable, transport=None) -> Callable:
    """The torus runner over the dy x dx ``mesh2d`` (see the module
    docstring). ``chunk_fn(xlo, block, xhi, ylo, yhi, obst_band, params, k,
    row_base, out)`` steps one block: ``kstep_tile.torus_chunk`` (which
    takes its plain version on CPU tensors) or ``_plain_torus``.
    ``transport`` as for the ring; the runner takes and returns this
    process's blocks."""
    dy, dx = len(mesh2d), len(mesh2d[0])
    devs = _flat(mesh2d)
    if len(devs) != dy * dx:
        raise ValueError(f"a torus mesh is a full dy x dx grid, got rows of "
                         f"{[len(row) for row in mesh2d]}")
    tr = transport or multihost.Transport(devs)
    n, ny, nx = dy * dx, params.ny, params.nx
    h, w = block_shape(ny, nx, dy, dx)
    if n_steps < 1:
        raise ValueError(f"torus runner of {n_steps} steps")
    plan = [k for _, k, _ in _chunks(None, min(kstep_tile.TILE_K, h, w,
                                               n_steps), n_steps)]
    pieces = {k: _torus_pieces(k, dy, dx, (9,), h, w) for k in set(plan)}
    local = tr.local

    @spanned("lbm.dist.call")
    def runner(blocks, obst_blocks):
        _check_blocks(local, blocks, obst_blocks, devs, h, w, ny, nx)
        masks = _torus_mask_bands(tr, obst_blocks, set(plan), dy, dx, h, w)
        blocks, spares = list(blocks), [None] * len(local)
        sums = [[] for _ in local]
        for k in plan:
            with span("lbm.dist.exchange"):
                halos = _torus_halos(tr, pieces[k], blocks, n)
            new = []
            for j, (b, (xlo, xhi, ylo, yhi)) in enumerate(zip(local, halos)):
                f, s = chunk_fn(xlo, blocks[j], xhi, ylo, yhi, masks[k][j],
                                params, k, (b // dx * h - k) % ny,
                                out=spares[j])
                new.append(f)
                sums[j].append(s)
            spares, blocks = blocks, new
        return blocks, _deferred_sum(sums, tr.device, params, tr)

    return runner


def _check_blocks(local, blocks, obst_blocks, devs, h, w, ny, nx):
    """A torus runner's input: this process's blocks and masks, block b of
    (h, w) cells on devs[b]."""
    if len(blocks) != len(local) or len(obst_blocks) != len(local):
        raise ValueError(f"torus runner over {len(local)} local blocks got "
                         f"{len(blocks)} and {len(obst_blocks)}")
    for b, f, o in zip(local, blocks, obst_blocks):
        if (f.shape != (9, h, w) or o.shape != (h, w)
                or f.device != devs[b] or o.device != devs[b]):
            raise ValueError(
                f"block {b}: state {tuple(f.shape)} on {f.device}, mask "
                f"{tuple(o.shape)} on {o.device}; the torus wants ({h}, {w}) "
                f"blocks of the ({ny}, {nx}) grid on {devs[b]}")


def _torus_mask_bands(tr, obst_blocks, ks, dy: int, dx: int, h: int,
                      w: int) -> dict:
    """{k: each local block's (h + 2k, w + 2 col_margin(k)) float mask band}
    for each k of ``ks``: the torus's exchange on the float masks (the
    float blocks are freed before the first chunk)."""
    obst_f = [o.to(torch.float32) for o in obst_blocks]
    masks = {}
    for k in ks:
        halos = _torus_halos(tr, _torus_pieces(k, dy, dx, (), h, w), obst_f,
                             dy * dx)
        masks[k] = [torch.cat([ylo, torch.cat([xlo, o, xhi], dim=-1), yhi],
                              dim=-2)
                    for o, (xlo, xhi, ylo, yhi) in zip(obst_f, halos)]
    return masks


def make_torus_p2p_runner(params: LBMParams, n_steps: int, mesh2d: Sequence,
                          transport=None,
                          max_outer: int = ring_p2p.MAX_OUTER) -> Callable:
    """The torus on the ``cuda`` backend: the counterpart of
    ``_make_runner_2d_kstep`` (tpulbm/dist/runner.py:1213-1321), one
    program for the whole run, over one process or, with a ``transport`` of
    several (``dist.multihost``), a global mesh of every process's blocks.
    Each ``ring_p2p.torus_p2p_chunks`` call runs up to ``max_outer`` chunks
    of this process's blocks (``outer_per_launch`` may take fewer, for the
    partials' memory) in one torus-mode launch of K6 a card, the blocks
    handing their edge columns, edge rows and corners to each other inside
    the kernel (through peer memory across cards, CUDA IPC mappings across
    processes); or, on CPU blocks, its plain version (the other processes'
    pieces through the transport). The chunks are those of
    ``make_torus_runner``: k the least of 8, h, w and n_steps, and the
    n_steps % k remainder one more launch of that k. The first launch of a
    call and the remainder's read the neighbours' states for their first
    chunk (pull0; across processes the states' edges and corners pushed
    into the slots first, ``ring_p2p.TorusExchange.enter``); every other
    chunk reads the landing slots that the chunk before filled, by the
    parity of the epoch, which ``ring_p2p.TorusExchange`` carries across
    launches and calls. A call ends in ``Exchange.check`` (a wait of the
    kernel that ran out raises; over several processes it returns once no
    launch of the call runs on any). The mask bands are built once a call,
    and the sums are added as ``make_torus_runner`` adds them: its bits,
    state and av series."""
    dy, dx = len(mesh2d), len(mesh2d[0])
    devs = _flat(mesh2d)
    if len(devs) != dy * dx:
        raise ValueError(f"a torus mesh is a full dy x dx grid, got rows of "
                         f"{[len(row) for row in mesh2d]}")
    ny, nx = params.ny, params.nx
    h, w = block_shape(ny, nx, dy, dx)
    if n_steps < 1 or max_outer < 1:
        raise ValueError(f"p2p torus runner of {n_steps} steps, {max_outer} "
                         f"chunks a launch")
    tr = transport or multihost.Transport(devs)
    local = tr.local
    k = min(kstep_tile.TILE_K, h, w, n_steps)
    launches = _grouped(k, n_steps, min(
        max_outer, ring_p2p.outer_per_launch([h], w, k)))
    opened = _seconds("lbm.dist.ipc_open")
    ex = ring_p2p.TorusExchange([devs[i * dx:(i + 1) * dx]
                                 for i in range(dy)], h, w, tr)
    if ex.world > 1 and ex.mesh[local[0]].type == "cuda":
        ms = (_seconds("lbm.dist.ipc_open") - opened) * 1e3
        print(f"tpulbm_torch: the torus over {ex.world} processes: "
              f"{len(ex.opened)} exchange blocks of other processes opened "
              f"in {ms:.1f} ms", file=sys.stderr, flush=True)

    @spanned("lbm.dist.call")
    def runner(blocks, obst_blocks):
        _check_blocks(local, blocks, obst_blocks, devs, h, w, ny, nx)
        masks = _torus_mask_bands(tr, obst_blocks, {kk for kk, _ in launches},
                                  dy, dx, h, w)
        ex.barrier()
        states = list(blocks)
        spares = [torch.empty_like(f) for f in states]
        sums = [[] for _ in states]
        for i, (kk, outer) in enumerate(launches):
            states, spares, s = ring_p2p.torus_p2p_chunks(
                ex, states, spares, masks[kk], params, kk, outer,
                [(b // dx * h - kk) % ny for b in local],
                pull0=i == 0 or kk != k)
            for j, sj in enumerate(s):
                sums[j].append(sj)
        ex.check()
        return states, _deferred_sum(sums, tr.device, params, tr)

    return runner
