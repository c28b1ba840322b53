__all__ = ["make_runner"]


def __getattr__(name):
    # imported on first use (see tpulbm_torch/__init__.py)
    if name == "make_runner":
        from tpulbm_torch.dist.runner import make_runner

        return make_runner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
