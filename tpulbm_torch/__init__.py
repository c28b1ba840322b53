"""tpulbm_torch — the D2Q9-BGK lattice-Boltzmann solver on PyTorch and
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``tpulbm`` (JAX and Pallas), laid out like it: each module here
has its counterpart at the same path there. The state is the same SoA
``(9, ny, nx)`` float32 tensor. On a CUDA device the step loop runs the
kernels of ``csrc/`` (built with nvcc at first use, see ``ops._build``);
``ops.step_torch`` is the plain PyTorch oracle on any device. The package
imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

__all__ = ["LBMParams", "initial_state", "Simulation", "__version__"]

_LAZY = {"LBMParams": "tpulbm_torch.core.params",
         "initial_state": "tpulbm_torch.core.state",
         "Simulation": "tpulbm_torch.sim.simulation"}


def __getattr__(name):
    # imported on first use, so that a module that needs no torch (the
    # launcher, dist/launch.py) starts without importing it
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
