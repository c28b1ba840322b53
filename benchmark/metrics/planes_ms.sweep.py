"""planes_ms.sweep (ms, the diag layer; moves sweep_mlups): the program's
span ``lbm.diag.planes`` (``write_outputs``' output planes on the device,
their readback and gather) summed over the traced sub-window's whole
solves, over their number. None where the program records no span."""

from lbmbench import spans


def read(run):
    return spans.ms_per_unit(run, {"lbm.diag.planes"})
