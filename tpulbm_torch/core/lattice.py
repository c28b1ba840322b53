"""D2Q9 lattice constants.

Velocity numbering follows the reference solver's stencil diagram
(d2q9-bgk.c:7-13)::

    6 2 5
     \\|/
    3-0-1
     /|\\
    7 4 8

with rows (axis ``y``) increasing northwards (d2q9-bgk.c:30-41). In all array
code the state tensor is ``f[k, y, x]`` — channel-major SoA, so the last
(lane) dimension is ``x``.
"""

import numpy as np

NSPEEDS = 9

# x/y components of each discrete velocity c_k.
CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)

# Opposite-direction permutation used for bounce-back at obstacles
# (the 1<->3, 2<->4, 5<->7, 6<->8 swap of d2q9-bgk.c:687-695).
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)

# Lattice weights as exact float32 values (d2q9-bgk.c:499-501).
W0 = np.float32(4.0) / np.float32(9.0)
W1 = np.float32(1.0) / np.float32(9.0)
W2 = np.float32(1.0) / np.float32(36.0)
WEIGHTS = np.array([W0, W1, W1, W1, W1, W2, W2, W2, W2], dtype=np.float32)

# Inverse square of the lattice speed of sound, 1/c_s^2 = 3 (d2q9-bgk.c:497).
IC_SQ = np.float32(3.0)
# c_s^2 itself, used for the pressure field p = rho * c_s^2 (d2q9-bgk.c:1040).
C_SQ = np.float32(1.0) / np.float32(3.0)


def _check() -> None:
    assert sum(CX) == 0 and sum(CY) == 0
    for k in range(NSPEEDS):
        o = OPP[k]
        assert CX[o] == -CX[k] and CY[o] == -CY[k], k
        assert OPP[o] == k


_check()
