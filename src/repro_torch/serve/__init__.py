"""Serving layer of the port (``repro.serve``).

``engine``/``sampling`` serve the LM substrate; ``lut_engine``
micro-batches one folded LUT artifact; the fleet tier (``fleet``,
``registry``, ``admission``) operates many artifacts in one process with
smoke-checked hot swaps, an LRU executor cache and per-tenant SLOs; the
resilience layer (``faults``, ``supervision``) adds deterministic fault
injection, per-request deadlines, per-lane circuit breakers and graceful
backend×placement degradation.
"""
from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionDecision, TenantSLO)
from repro_torch.serve.faults import (DeviceLost, DrainTimeout,
                                      ExecutorFault, FaultClock,
                                      FaultInjector, FaultPlan, FaultSpec,
                                      InjectedFault)
from repro_torch.serve.fleet import FleetStats, LUTFleet
from repro_torch.serve.registry import (ExecutorCache, Reference, SwapEvent,
                                        TenantRegistry, make_reference,
                                        smoke_check)
from repro_torch.serve.supervision import (CircuitBreaker, DegradeEvent,
                                           FailureEvent, ResiliencePolicy)

__all__ = [
    "AdmissionController", "AdmissionDecision", "TenantSLO",
    "FleetStats", "LUTFleet",
    "ExecutorCache", "Reference", "SwapEvent", "TenantRegistry",
    "make_reference", "smoke_check",
    "DeviceLost", "DrainTimeout", "ExecutorFault", "FaultClock",
    "FaultInjector", "FaultPlan", "FaultSpec", "InjectedFault",
    "CircuitBreaker", "DegradeEvent", "FailureEvent", "ResiliencePolicy",
]
