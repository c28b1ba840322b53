"""A plain reader of the program's npz checkpoints, and the rule of which
of them a run leaves behind.

Plain numpy, independent of the program: it imports nothing of
``tpulbm_torch`` (nor JAX) and reads a checkpoint by its documented form,
``ckpt_%08d.npz`` with the keys ``step`` (int64), ``f`` (the (9, ny, nx)
float32 state), ``av_vels`` (the float32 history of the steps taken) and
``params`` (the deck as JSON). A name that does not end in exactly
``.npz`` after the step, such as a write's ``….npz.tmp.npz``, is no
complete checkpoint.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

NAME = re.compile(r"ckpt_(\d{8,})\.npz")


def read(path) -> dict:
    """``step``, ``f``, ``av_vels`` and ``params`` of one checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        return {"step": int(z["step"]), "f": z["f"],
                "av_vels": z["av_vels"],
                "params": json.loads(str(z["params"]))}


def listing(directory) -> tuple:
    """({step: path} of the complete checkpoints under ``directory``, the
    other names there)."""
    found, other = {}, []
    for name in sorted(os.listdir(directory)):
        m = NAME.fullmatch(name)
        if m:
            found[int(m.group(1))] = os.path.join(directory, name)
        else:
            other.append(name)
    return found, other


def expected_steps(runs, every: int, keep=None) -> list:
    """The steps whose checkpoints remain after ``runs``, each a (start,
    end) of one ``run()`` with ``checkpoint_every=every`` into one
    directory: a run saves at each multiple of ``every`` in (start, end]
    and at its end; retention keeps the ``keep`` newest (None: all)."""
    saved = set()
    for start, end in runs:
        saved.update(range((start // every + 1) * every, end + 1, every))
        saved.add(end)
    steps = sorted(saved)
    return steps if keep is None else steps[-keep:]
