"""Iteration-level training checkpoints (the port's copy of
``predictionio_tpu/workflow/checkpoint.py``: numpy only, so snapshots
written by either package resume in the other).

An improvement over the reference (SURVEY.md §5: "No mid-training
checkpoint"): factor snapshots between training segments let an
interrupted `pio train` resume from the last saved iteration instead of
restarting. Snapshots are .npz files with a step-numbered name; the
directory is the unit of one training run.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

_FNAME = re.compile(r"^step_(\d+)\.npz$")


class FactorCheckpointer:
    """save(step, arrays) / latest() -> (step, arrays) | None."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = _FNAME.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, arrays: Dict[str, np.ndarray]) -> str:
        """Atomic write (tmp + rename) so a crash mid-save never leaves a
        truncated snapshot as `latest`."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, self._path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        for old in self.steps()[: -self.keep] if self.keep else []:
            try:
                os.unlink(self._path(old))
            except OSError:
                pass
        return self._path(step)

    def latest(self) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        steps = self.steps()
        if not steps:
            return None
        step = steps[-1]
        with np.load(self._path(step)) as z:
            return step, {k: z[k] for k in z.files}

    def clear(self) -> None:
        for step in self.steps():
            try:
                os.unlink(self._path(step))
            except OSError:
                pass


def run_checkpoint_dir(instance_id: str) -> str:
    """Conventional checkpoint location for a training run."""
    base = os.path.expanduser(os.environ.get("PIO_FS_BASEDIR", "~/.pio_store"))
    return os.path.join(base, "checkpoints", instance_id)


def latest_step_in(directory: str) -> Optional[int]:
    """Newest snapshot step in ``directory``, or None. Unlike
    FactorCheckpointer this never creates the directory — it's the
    side-effect-free probe the auto-resume scan runs over every
    candidate crashed run."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    steps = [int(m.group(1)) for m in map(_FNAME.match, names) if m]
    return max(steps) if steps else None
