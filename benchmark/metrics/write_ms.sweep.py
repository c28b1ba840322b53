"""write_ms.sweep (ms, the io and diag layers; moves sweep_mlups): the wall
time of ``write_outputs()`` (the output planes on the device, their
readback and the text writers), the harness's span ``write``, the mean
over the solves of the window."""


def read(run):
    times = [t for name, t in run.spans if name == "write"]
    return 1e3 * sum(times) / len(times) if times else None
