"""Profiling hooks, the port's copy of ``univl_tpu/utils/profiling.py``.

  - trace(log_dir, device): a context manager around ``torch.profiler``,
    the counterpart of JAX's ``trace`` (``jax.profiler``): a Chrome trace of
    the block under ``log_dir``, one file per process
  - StepTrace: the window of training steps that ``--profile_dir`` traces
    (``cli/common.py:run_train_epochs``), on a ``torch.profiler.schedule``
  - StepTimer: host-side EMA step time and throughput (the Time/step lines)

A trace is ``<log_dir>/rank<r>.<ms>.pt.trace.json`` (what
``torch.profiler.tensorboard_trace_handler(log_dir, worker_name=f"rank{r}")``
writes): open it in Perfetto (ui.perfetto.dev) or TensorBoard's profiler
plugin. It holds the host's activity, and on a CUDA device the card's
kernels, copies and fills, those of CUDA graph replays included. A trace
that cannot be written raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerAction, ProfilerActivity

STEP_RANGE = "train_step#"  # a traced step's range: STEP_RANGE + its global step


def activities(device) -> list:
    """The host's activity, and the card's on a CUDA device."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def write_trace(prof, log_dir: str, rank: int = 0) -> str:
    """``prof``'s Chrome trace as ``<log_dir>/rank<rank>.<ms>.pt.trace.json``;
    returns its path. Raises when the file is not there after the export."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"rank{rank}.{time.time_ns() // 10**6}.pt.trace.json")
    prof.export_chrome_trace(path)
    if not os.path.isfile(path) or os.path.getsize(path) == 0:
        raise OSError(f"the profiler wrote no trace at {path}")
    return path


@contextlib.contextmanager
def trace(log_dir: str, device="cpu", rank: int = 0):
    """Trace the block with ``torch.profiler``; the trace is written when the
    block ends, also when it raises."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities(device))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        write_trace(prof, log_dir, rank)


WARMUP_STEPS = 1  # its records discarded: it takes what CUPTI loses at a session's start
ACTIVE_STEPS = 5  # JAX's traced steps


class StepTrace:
    """The traced steps of a training run, JAX's ``jax.profiler`` window of
    ``run_train_epochs`` (``univl_tpu/cli/common.py:611-665``): a
    ``torch.profiler`` session under ``torch.profiler.schedule(wait=0,
    warmup=WARMUP_STEPS, active=ACTIVE_STEPS, repeat=1)``, opened the step
    before the first traced one. The warmup step takes the records CUPTI
    loses at a session's start, so the active steps are whole.
    ``step(global_step)`` wraps one training step: an active step is one
    range, ``train_step#<global step>``, and on a CUDA device the card is
    synchronized at its end, so each step's kernels lie within its range.
    The schedule moves on after each step; ``done`` after the last active
    step. ``close()`` ends the session and writes the active steps traced so
    far; a session that traced none writes nothing."""

    def __init__(self, log_dir: str, device, rank: int = 0):
        self.log_dir, self.device, self.rank = log_dir, torch.device(device), rank
        self.traced = 0  # active steps run
        os.makedirs(log_dir, exist_ok=True)
        self._prof = torch.profiler.profile(
            activities=activities(self.device),
            schedule=torch.profiler.schedule(wait=0, warmup=WARMUP_STEPS, active=ACTIVE_STEPS,
                                             repeat=1))
        # the steps' own ranges carry the global step; the profiler's
        # ProfilerStep#<n> would count from the warmup
        self._prof.record_steps = False
        self._prof.start()

    @property
    def done(self) -> bool:
        return self.traced == ACTIVE_STEPS

    @contextlib.contextmanager
    def step(self, global_step: int):
        """One training step of the window."""
        recording = self._prof.current_action in (ProfilerAction.RECORD,
                                                  ProfilerAction.RECORD_AND_SAVE)
        with (torch.profiler.record_function(f"{STEP_RANGE}{global_step}") if recording
              else contextlib.nullcontext()):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.traced += recording
        self._prof.step()

    def close(self) -> Optional[str]:
        """End the session and write the active steps traced so far;
        returns the trace's path, or None when no step was traced."""
        self._prof.stop()
        return write_trace(self._prof, self.log_dir, self.rank) if self.traced else None


class StepTimer:
    """EMA step time + items/sec. Call tick(n_items) once per step."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._last: Optional[float] = None
        self.total_items = 0
        self.total_time = 0.0

    def tick(self, n_items: int = 0) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema
            )
            self.total_time += dt
            self.total_items += n_items
        self._last = now
        return self.ema

    @property
    def items_per_sec(self) -> float:
        return self.total_items / self.total_time if self.total_time > 0 else 0.0
