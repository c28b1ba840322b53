"""runner_build_ms.sweep (ms, the dist layer; moves sweep_mlups): the
program's span ``lbm.dist.make_runner`` (the route, the plan and the
runner's state, built in a Simulation's first ``run``) summed over the
traced sub-window's whole solves, over their number. None where the
program records no span."""

from lbmbench import spans


def read(run):
    return spans.ms_per_unit(run, {"lbm.dist.make_runner"})
