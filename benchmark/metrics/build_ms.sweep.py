"""build_ms.sweep (ms, the sim layer; moves sweep_mlups): the wall time of
``Simulation(...)`` and ``settle()``, the harness's span ``build``, the
mean over the solves of the window."""


def read(run):
    times = [t for name, t in run.spans if name == "build"]
    return 1e3 * sum(times) / len(times) if times else None
