"""Rotating train-state checkpoints on plain files, the port's counterpart of
``univl_tpu/checkpoint/manager.py``'s orbax ``RotatingCheckpointManager``.

Each save writes ``<directory>/<step>/train_state.pt`` with its metrics in
the JSON sidecar (``checkpoint/io.py``). After a save the manager keeps the
``max_to_keep`` latest steps and, with ``best_metric``, the best step by
that metric (``best_mode`` "max" or "min"; a save whose metrics lack the
key ranks last). A save at a step that exists replaces it. With
``async_save`` a save copies the state to the host and returns, and the
write and the rotation go on on a background thread
(``checkpoint/io.py:CheckpointWriter``); the next save, ``restore``,
``restore_latest`` and ``wait`` wait for it first, and a failed write raises
there.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np

from univl_tpu_torch.checkpoint.io import (
    TRAIN_STATE,
    CheckpointWriter,
    read_metadata,
    restore_checkpoint,
    save_checkpoint,
)


def _coerce_metric(v):
    """numpy scalars (and 0-d arrays) to Python numbers for the JSON sidecar;
    bools, strings, None and dicts pass through."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, float, np.integer, np.floating)) or getattr(v, "ndim", None) == 0:
        try:
            return float(v)
        except (TypeError, ValueError):
            return v
    return v


class RotatingCheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, best_metric: Optional[str] = None,
                 best_mode: str = "max", async_save: bool = False):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode {best_mode!r}: choose max or min")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        self.writer = CheckpointWriter(async_save)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), TRAIN_STATE)

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(self._path(int(d)) + ".json"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if self.best_metric is None:
            return None
        sign = 1.0 if self.best_mode == "max" else -1.0

        def score(step):
            v = (read_metadata(self._path(step)) or {}).get(self.best_metric)
            return -np.inf if v is None else sign * float(v)

        steps = self.all_steps()
        return max(steps, key=lambda s: (score(s), s)) if steps else None

    def save(self, step: int, state: Mapping[str, Any], metrics: Optional[Dict] = None) -> bool:
        """``state`` at ``step`` (replacing a save at the same step, once the
        write in flight, which may be that step's, is done), then the
        rotation."""
        metrics = {k: _coerce_metric(v) for k, v in (metrics or {}).items()}
        self.writer.submit(self._write, state, step, metrics)
        return True

    def _write(self, state, step: int, metrics: Dict) -> None:
        save_checkpoint(self._path(step), state, metadata=metrics)
        keep = set(self.all_steps()[-self.max_to_keep:])
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for s in self.all_steps():
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)))

    def wait(self) -> None:
        """Block until the write in flight is on disk."""
        self.writer.wait()

    def restore(self, step: int):
        """(state, metrics) of ``step``."""
        self.wait()
        return restore_checkpoint(self._path(step))

    def restore_latest(self):
        """(state, metrics, step) of the latest step; (None, None, None) in
        an empty directory."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None, None
        state, meta = self.restore(step)
        return state, meta, step
