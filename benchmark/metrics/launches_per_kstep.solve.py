"""launches_per_kstep.solve (launches/kstep; the ops and dist layers, the
host's issue; moves mlups): the device operations (kernels, copies,
memsets) of the traced sub-window, summed over the cards, per 1,000
lattice steps of its whole runner calls. No kernel is named, so a renamed
or merged kernel still counts."""


def read(run):
    s = run.session
    if not s.device or not s.steps:
        return None
    return len(s.device) / (s.steps / 1000.0)
