"""Straggler detection and step-level fault tolerance (the port of
``repro.dist.straggler``; pure Python, copied so that both packages flag
the same steps).

``StragglerDetector`` keeps a running mean of per-step wall time and flags
steps that take ``factor``x longer than typical; the assembly search's
slice executor records its flags in the rung's event log.  ``retry_step``
wraps one step with restore-and-replay semantics for device loss.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List


class StepTimer:
    """``with StepTimer() as t: ...`` then read ``t.dt`` (seconds)."""

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        self.dt = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.dt = time.perf_counter() - self._t0


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps slower than ``factor`` x the running mean.

    ``warmup`` observations establish the baseline before any flagging;
    flagged steps do not pollute the running mean (a 10x outlier must not
    raise the bar for the next one).
    """

    warmup: int = 10
    factor: float = 3.0
    events: List[dict] = dataclasses.field(default_factory=list)
    _count: int = 0
    _mean: float = 0.0

    def observe(self, step: int, dt: float) -> bool:
        if self._count < self.warmup:
            self._count += 1
            self._mean += (dt - self._mean) / self._count
            return False
        if dt > self.factor * self._mean:
            self.events.append({"step": step, "dt": dt, "mean": self._mean})
            return True
        self._count += 1
        self._mean += (dt - self._mean) / self._count
        return False


def retry_step(step_fn: Callable[[], Any], restore_fn: Callable[[], Any],
               max_retries: int = 3) -> Any:
    """Run ``step_fn``; on failure call ``restore_fn`` and replay, up to
    ``max_retries`` total retries."""
    attempts = 0
    while True:
        try:
            return step_fn()
        except Exception:  # noqa: BLE001 — device loss / preemption
            attempts += 1
            if attempts > max_retries:
                raise
            restore_fn()
