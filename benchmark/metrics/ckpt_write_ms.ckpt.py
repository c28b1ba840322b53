"""ckpt_write_ms.ckpt (ms, sim/checkpoint.py: the writer thread; moves
mlups): the writer thread's mean time a checkpoint, ``write_ns / saves``
of the program's ``tpulbm_torch.sim.checkpoint.STATS``: the npz file
written and renamed, then retention's deletions, timed by
``perf_counter_ns`` inside the thread. The program's own clock readings
over every checkpoint of the run, the warm-up calls' too. None where the
program keeps no such counter (a tree before it) or wrote no checkpoint."""


def read(run):
    try:
        from tpulbm_torch.sim import checkpoint
    except ImportError:
        return None
    stats = getattr(checkpoint, "STATS", None)
    if not stats or not stats.get("saves"):
        return None
    return stats["write_ns"] / stats["saves"] / 1e6
