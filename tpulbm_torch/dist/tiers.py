"""Which kernel family a single-device grid runs on, as the JAX package
routes it.

``family(ny, nx, n_steps)`` follows the single-device order of
``tpulbm.dist.runner.make_runner`` (runner.py:1720-1801) and names the
family of its tier; ``dist.runner.kernel_plan`` maps each family to the
port's kernel that computes the same function:

- ``"resident"``: the VMEM-resident tiers, ``pallas_resident._kernel`` and
  its HBM-edge variant ``_kernel_hbm``: K2 (``ops.resident``);
- ``"fused"``: the 1-D skew and 1-D K-step tiers, and every fallback below
  the 2-D tiers (padded rows, extended columns, one step per call): K6's
  grid kind (``ops.ring_p2p.grid_p2p_chunks``), many chunks a launch, the
  bits of K4's whole-grid chunks (K4 and K1, which computes the same
  function one step a launch, stay off the route);
- ``"tile"``: the wide tiers, the lane-folded skew, the 2-D skew, the 2-D
  K-step and the band-major K-step: K6's grid kind.

The predicates are copies of the JAX package's, in plain integer Python
(the port imports nothing of ``tpulbm``). Their budgets are TPU VMEM
budgets: they decide the route so that the two packages run every deck
through the same function chunk for chunk, not anything about the H100.

The 2-D torus (``--mesh-shape``) is routed by ``dist.runner.make_runner``
alone, whatever the block shape: K6's torus mode, or K4's torus mode where
the torus passes K6's limits or crosses hosts. The JAX package's torus
gate (``w >= 128`` and ``pallas_kstep.supported_x_halo``,
runner.py:1532-1544), which chooses between its Pallas and jnp tori, has
no counterpart here.
"""

from __future__ import annotations

from typing import Optional

K = 8   # steps per chunk of the skew tiers (SKEW_K, FOLD_K)


def resident_supported(ny: int, nx: int) -> bool:
    """pallas_resident.supported or supported_hbm (pallas_resident.py:35-60):
    8/128-aligned grids of at most 135K cells."""
    return nx % 128 == 0 and ny % 8 == 0 and ny >= 8 and ny * nx <= 135 * 1024


def skew_block_rows(h: int, nx: int) -> Optional[int]:
    """pallas_kstep_skew.pick_block_rows."""
    best = None
    for by in range(24, min(h // 2, 512) + 1, 8):
        if h % by == 0 and (by + 8) * nx <= 61440:
            best = by
    return best


def skew_supported(h: int, nx: int) -> bool:
    """pallas_kstep_skew.supported at k = 8."""
    by = skew_block_rows(h, nx) if h % 8 == 0 else None
    return nx % 128 == 0 and by is not None and h // by >= 2 and h >= 4 * K


def _fold_block_rows(hf: int, w: int, F: int) -> Optional[int]:
    """pallas_kstep_skew_fold.pick_by."""
    slab = 4 * F - 2
    pad = -(-slab // 8) * 8
    best = None
    for by in range(-(-max(8, slab) // 8) * 8, min(hf // 2, 512) + 1, 8):
        if by % F == 0 and hf % by == 0 and (by + pad) * w <= 61440:
            best = by
    return best


def fold_supported(ny: int, nx: int, F: int) -> bool:
    """pallas_kstep_skew_fold.supported at k = 8."""
    if F not in (1, 2, 4, 8) or nx % F:
        return False
    w, hf, slide = nx // F, ny * F, 2 * F - 1
    if w % 128 or (8 * slide) % F:
        return False
    by = _fold_block_rows(hf, w, F)
    band_side = -(-(8 * slide // F + K) // 4) * 4   # fix_band_side
    return (by is not None and hf // by >= 2 and ny >= 2 * band_side
            and hf >= 2 * K * slide + by)


def pick_fold(ny: int, nx: int) -> Optional[int]:
    """pallas_kstep_skew_fold.pick_fold."""
    for F in (2, 4, 8):
        if nx % F == 0 and nx // F <= 1536 and fold_supported(ny, nx, F):
            return F
    return None


def skew2d_supported(h: int, nx: int) -> bool:
    """pallas_kstep_skew2d.supported at k = 8 (pick_tile is not None)."""
    if nx % 128 or nx < 256 or h % 8 or h < 4 * K:
        return False
    return any(h % by == 0 and nx % bx == 0 and (by + 8) * (bx + 256) <= 56 * 1024
               for by in range(24, min(h // 2, 256) + 1, 8)
               for bx in range(256, min(nx, 2048) + 1, 128))


def kstep_supported(h: int, nx: int, k: int) -> bool:
    """pallas_kstep.supported: 1-D row blocks of whole rows."""
    return (1 <= k <= 8 and nx % 128 == 0 and h >= k
            and any(h % by == 0 and (by + 16) * nx <= 48 * 1024
                    for by in range(8, min(h, 512) + 1, 8)))


def kstep2d_supported(h: int, nx: int, k: int) -> bool:
    """pallas_kstep2d.supported. It admits every shape that
    pallas_kstep_bands.supported admits (both need nx % 128 == 0 and an
    8-multiple divisor of h; bands also needs two bands, so nx >= 256), so
    the bands tier never decides a route here."""
    return (1 <= k <= 8 and nx % 128 == 0 and nx >= 256 and h >= k
            and any(h % by == 0 and nx % bx == 0
                    and (by + 16) * (bx + 256) <= 64 * 1024
                    for by in range(8, min(h, 256) + 1, 8)
                    for bx in range(128, min(nx, 2048) + 1, 128)))


def family(ny: int, nx: int, n_steps: int) -> str:
    """The kernel family of the tier the JAX package's single-device router
    picks for an (ny, nx) grid run for n_steps: "resident", "fused" or
    "tile" (see the module docstring)."""
    if resident_supported(ny, nx):
        return "resident"
    k = min(8, n_steps)
    rem = n_steps % K
    rem_ok = (rem == 0 or kstep_supported(ny, nx, rem)
              or kstep2d_supported(ny, nx, rem))
    if n_steps >= K and rem_ok and skew_supported(ny, nx):
        return "fused"
    if n_steps >= K and pick_fold(ny, nx) is not None:
        return "tile"
    if n_steps >= K and rem_ok and skew2d_supported(ny, nx):
        return "tile"
    if kstep_supported(ny, nx, k):
        return "fused"
    if kstep2d_supported(ny, nx, k):
        return "tile"
    return "fused"
