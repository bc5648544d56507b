"""Host-side step timing, the port's copy of ``univl_tpu/utils/profiling.py:StepTimer``.

The JAX package's ``trace`` helper wraps ``jax.profiler``; its counterpart
here is ``torch.profiler``, used directly.
"""

from __future__ import annotations

import time
from typing import Optional


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
