"""Validation harness (py3 port of the reference checker).

``check_results`` is re-exported lazily: eagerly importing
``tpulbm_torch.validation.check`` here would leave it in ``sys.modules`` before
``python -m tpulbm_torch.validation.check`` (the acceptance command) executes
it, making runpy emit a RuntimeWarning about
re-executing an already-imported module.
"""

__all__ = ["check_results"]


def __getattr__(name):
    if name == "check_results":
        from tpulbm_torch.validation.check import check_results

        return check_results
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
