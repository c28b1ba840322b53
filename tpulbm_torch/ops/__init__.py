__all__ = ["accelerate", "collide_stream", "lbm_step", "run_steps"]


def __getattr__(name):
    # imported on first use (see tpulbm_torch/__init__.py)
    if name in __all__:
        from tpulbm_torch.ops import step_torch

        return getattr(step_torch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
