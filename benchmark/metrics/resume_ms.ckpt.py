"""resume_ms.ckpt (ms, sim: restore; moves mlups): the wall time of the
resume in set-up, the harness's span ``resume``: a new ``Simulation`` of
the deck, ``settle()`` and ``restore_checkpoint`` of the newest checkpoint
(its read from disk and its upload). None where the run made no resume."""


def read(run):
    times = [t for name, t in run.spans if name == "resume"]
    return 1e3 * sum(times) / len(times) if times else None
