"""idle_ckpt.ckpt (%, sim: the checkpoint path; moves mlups): the share of
the traced sub-window of whole checkpointing runner calls in which the
card ran nothing while the host's innermost program span was one of the
checkpoint path's (``lbm.ckpt.*``: the main thread's host copies of the
state and the history prefix and their hand-off to the writer thread,
and its joins of that thread), averaged over the cell's cards. The writer
thread opens no span. None where the program records no ``lbm.ckpt.``
span there (a tree before them)."""

from lbmbench import spans

PREFIX = "lbm.ckpt."


def read(run):
    found = spans.program_spans(run.session) if run.session else []
    if not any(name.startswith(PREFIX) for name, _, _ in found):
        return None
    return spans.idle_share(run, PREFIX)
