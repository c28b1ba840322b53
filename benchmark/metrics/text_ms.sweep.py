"""text_ms.sweep (ms, the io layer; moves sweep_mlups): the program's spans
``lbm.io.final_state`` and ``lbm.io.av_vels`` (the text writers of
``final_state.dat`` and ``av_vels.dat``) summed over the traced
sub-window's whole solves, over their number. None where the program
records no span."""

from lbmbench import spans


def read(run):
    return spans.ms_per_unit(run, {"lbm.io.final_state", "lbm.io.av_vels"})
