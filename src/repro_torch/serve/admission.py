"""Admission control: per-tenant SLO budgets for the fleet tier (the port
of ``repro.serve.admission``, pure Python).

A tenant declares a :class:`TenantSLO`; every ``submit`` to the fleet runs
through :meth:`AdmissionController.decide` BEFORE any work is queued:

  * **queue budget** (``max_queue``): rows beyond the tenant's queue-depth
    budget are shed or deferred — a burst cannot grow an unbounded backlog
    whose tail latency is already lost.
  * **latency budget** (``p99_budget_us``): once the tenant's observed p99
    *request* latency (submit -> result, queue wait included) exceeds its
    budget, new load is shed/deferred until the pump works the percentile
    back under budget.  Shedding the new arrivals (not the queued work) is
    deliberate: queued requests are already paid for, and rejecting at the
    door is the only action that actually reduces p99.

Policies: ``"shed"`` rejects over-budget rows outright (the caller sees
them in :class:`AdmissionDecision.shed` and the tenant's ``shed`` counter);
``"defer"`` parks them in the tenant's deferred queue, which the fleet
drains back into the engine once the tenant is under budget again — no
request is lost, it just waits out the storm.

The controller is deliberately stateless (pure function of the tenant's
live stats + SLO) so decisions are reproducible in tests and the fleet
can swap policies per tenant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

POLICIES = ("shed", "defer")


@dataclasses.dataclass(frozen=True)
class TenantSLO:
    """Per-tenant service-level objective.

    ``None`` fields are unconstrained; ``TenantSLO()`` admits everything
    (the default for tenants registered without an SLO).
    """

    p99_budget_us: Optional[float] = None   # request-latency budget
    max_queue: Optional[int] = None         # queued-row budget
    policy: str = "shed"                    # over-budget rows: shed | defer

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {self.policy!r}; "
                f"known: {POLICIES}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.p99_budget_us is not None and self.p99_budget_us <= 0:
            raise ValueError("p99_budget_us must be > 0, got "
                             f"{self.p99_budget_us}")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    accept: int
    shed: int
    defer: int
    reason: str                  # "ok" | "p99" | "queue" | "quarantined"

    @property
    def admitted_all(self) -> bool:
        return self.shed == 0 and self.defer == 0


class AdmissionController:
    """Pure SLO arithmetic; the fleet owns the queues it acts on."""

    def decide(self, *, n: int, queue_depth: int,
               p99_us: float, slo: Optional[TenantSLO]
               ) -> AdmissionDecision:
        """Split ``n`` arriving rows into accept/shed/defer.

        ``queue_depth`` is the tenant's current queued+deferred rows and
        ``p99_us`` its observed request p99 (0.0 until a window exists —
        a cold tenant is never throttled by the latency budget)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if slo is None or n == 0:
            return AdmissionDecision(n, 0, 0, "ok")
        if slo.p99_budget_us is not None and p99_us > slo.p99_budget_us:
            # over latency budget: back-pressure ALL new arrivals
            return self._reject(0, n, slo, "p99")
        if slo.max_queue is not None:
            room = max(0, slo.max_queue - queue_depth)
            if room < n:
                return self._reject(room, n - room, slo, "queue")
        return AdmissionDecision(n, 0, 0, "ok")

    @staticmethod
    def _reject(accept: int, over: int, slo: TenantSLO,
                reason: str) -> AdmissionDecision:
        if slo.policy == "defer":
            return AdmissionDecision(accept, 0, over, reason)
        return AdmissionDecision(accept, over, 0, reason)

    def quarantine(self, *, n: int, slo: Optional[TenantSLO]
                   ) -> AdmissionDecision:
        """The circuit-breaker door: while a tenant's lane
        breaker is OPEN, *all* new arrivals are rejected through the same
        shed/defer machinery the SLO budgets use — a ``"defer"`` tenant's
        rows park in the deferred queue and drain once the lane recovers,
        a ``"shed"`` (or SLO-less) tenant's rows are refused at the door.
        Accepting zero rows is the point: queueing onto a lane that is
        known-broken only manufactures timed-out requests."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if n == 0:
            return AdmissionDecision(0, 0, 0, "quarantined")
        if slo is not None and slo.policy == "defer":
            return AdmissionDecision(0, 0, n, "quarantined")
        return AdmissionDecision(0, n, 0, "quarantined")

    def may_drain_deferred(self, *, queue_depth: int, p99_us: float,
                           slo: Optional[TenantSLO]) -> int:
        """How many deferred rows may re-enter the queue right now (the
        re-admission mirror of :meth:`decide`): none while over the p99
        budget, up to the queue headroom otherwise."""
        if slo is None:
            return 1 << 30
        if slo.p99_budget_us is not None and p99_us > slo.p99_budget_us:
            return 0
        if slo.max_queue is not None:
            return max(0, slo.max_queue - queue_depth)
        return 1 << 30
