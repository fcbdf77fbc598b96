"""Per-lane failure supervision primitives (the port of
``repro.serve.supervision``, pure Python).

The fleet (serve/fleet.py) drives these; they hold no references to
engines or executors, so they stay trivially testable and the policy is
a frozen value object that can live in configs and bench matrices.

Failure lifecycle for one lane:

1. A dispatch raises (executor exception / lost device) or the oldest
   in-flight block blows the deadline.  The fleet calls
   ``CircuitBreaker.record_failure`` and schedules a retry after
   exponential backoff (``ResiliencePolicy.backoff_s``).
2. After ``breaker_threshold`` consecutive failures the breaker trips
   OPEN: new arrivals for the tenant are shed/deferred through the
   admission path (reason ``"quarantined"``), and the fleet attempts
   graceful degradation — re-planning the lane onto a surviving
   backend×placement (device loss → remeshed survivors, anything else →
   the layered fallback backend).  A successful re-plan moves the
   breaker to HALF_OPEN so the very next queued block probes the new
   executor.
3. OPEN also decays to HALF_OPEN on its own after ``breaker_cooldown_s``
   (the transient-fault path: nothing was re-planned, the old executor
   gets one probe).  A successful retire closes the breaker and stamps
   the incident's recovery time; a failed probe re-opens it.

Bit-identity makes degradation safe: every backend×placement of the
same artifact computes identical codes (``backends/placement.py``), so answers
produced after a re-plan are indistinguishable from the original
executor's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ResiliencePolicy", "CircuitBreaker", "FailureEvent", "DegradeEvent"]


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Knobs for the fleet's failure supervision.

    deadline_s          max age of an in-flight block before it is
                        abandoned and retried (None disables deadlines).
    max_retries         per-request attempt cap; a request that fails
                        more times than this after degradation has run
                        out of fallbacks and the fleet raises.
    backoff_base_s /    retry n (1-based) waits base * factor**(n-1)
    backoff_factor      before the lane may dispatch again.
    breaker_threshold   consecutive failures before the breaker trips.
    breaker_cooldown_s  OPEN → HALF_OPEN decay time.
    fallback_backend    layered backend degradation re-plans onto when
                        the placed/fused executor keeps failing ("take"
                        is the reference executor — always available).
    """

    deadline_s: Optional[float] = None
    max_retries: int = 4
    backoff_base_s: float = 0.002
    backoff_factor: float = 2.0
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.05
    fallback_backend: str = "take"

    def __post_init__(self) -> None:
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        if self.max_retries < 0 or self.breaker_threshold < 1:
            raise ValueError("max_retries >= 0 and breaker_threshold >= 1")
        if self.backoff_base_s < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff_base_s >= 0 and backoff_factor >= 1")
        if self.breaker_cooldown_s < 0:
            raise ValueError("breaker_cooldown_s must be >= 0")

    def backoff_s(self, consecutive_failures: int) -> float:
        """Backoff before the next dispatch after the Nth consecutive
        failure (1-based)."""
        n = max(1, int(consecutive_failures))
        return self.backoff_base_s * self.backoff_factor ** (n - 1)


class CircuitBreaker:
    """Three-state breaker: CLOSED → OPEN → HALF_OPEN → CLOSED.

    Pure state machine over an external clock (``now`` passed in, so the
    fleet's fault-injector clock drives cooldowns deterministically).
    OPEN quarantines the lane: arrivals are shed and dispatch is gated.
    HALF_OPEN lets queued work through as the probe; the next retire
    outcome decides."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.trips = 0

    def state(self, now: float) -> str:
        """Current state, decaying OPEN → HALF_OPEN once the cooldown has
        passed (reading the state performs the decay)."""
        if self._state == self.OPEN and now - self.opened_at >= self.cooldown_s:
            self._state = self.HALF_OPEN
        return self._state

    def allow_dispatch(self, now: float) -> bool:
        """May the lane dispatch a block right now?  CLOSED: yes.
        HALF_OPEN: yes (that dispatch is the probe).  OPEN: no."""
        return self.state(now) != self.OPEN

    def record_failure(self, now: float) -> bool:
        """Count one failure; returns True when this failure TRIPS the
        breaker (crossed the threshold, or a failed HALF_OPEN probe)."""
        self.consecutive_failures += 1
        state = self.state(now)
        if state == self.HALF_OPEN or (state == self.CLOSED and
                                       self.consecutive_failures >= self.threshold):
            self._state = self.OPEN
            self.opened_at = now
            self.trips += 1
            return True
        return False

    def record_success(self) -> None:
        """A retire completed: close from any state."""
        self._state = self.CLOSED
        self.consecutive_failures = 0

    def force_half_open(self, now: float) -> None:
        """Degradation installed a fresh executor: skip the cooldown and
        let the next queued block probe it immediately."""
        self._state = self.HALF_OPEN
        self.opened_at = now


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One detected lane failure (exception / deadline / device loss)."""

    model_id: str
    kind: str            # "exception" | "deadline" | "device_loss"
    detail: str
    t: float
    consecutive: int     # breaker's consecutive-failure count after this


@dataclasses.dataclass(frozen=True)
class DegradeEvent:
    """One graceful degradation: the lane re-planned onto a surviving
    backend×placement.  ``shards`` counts placement slots (0 =
    unplaced)."""

    model_id: str
    reason: str
    from_backend: str
    to_backend: str
    from_shards: int
    to_shards: int
    t: float
    plan_reason: str = ""   # elastic.plan_serving_remesh's verdict, if any

    def summary(self) -> dict:
        return {
            "model_id": self.model_id,
            "reason": self.reason,
            "backend": f"{self.from_backend}->{self.to_backend}",
            "shards": f"{self.from_shards}->{self.to_shards}",
        }
