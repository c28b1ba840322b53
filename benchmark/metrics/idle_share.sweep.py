"""idle_share.sweep (%, the device layer; moves sweep_mlups): the share of
the traced sub-window of whole solves in which a card ran nothing, no
kernel, copy or memset, averaged over the cell's cards."""


def read(run):
    s = run.session
    if not s.device:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
