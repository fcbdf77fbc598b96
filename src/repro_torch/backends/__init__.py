"""Pluggable lookup-execution backends (the port of ``repro.backends``).

    from repro_torch import backends
    be = backends.resolve()              # $REPRO_LUT_BACKEND or 'take'
    plan = backends.plan_for(net, be)    # cached per FoldedNetwork
    out = be.run(plan, codes)

Built-ins: ``take`` / ``onehot`` / ``pallas`` (per layer; ``pallas`` is the
hand-written lookup kernel) and ``fused`` (the whole cascade in one kernel).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.backends.base import (BackendCapabilities, ExecutionPlan,
                                       LookupBackend)
from repro_torch.backends.registry import (available, default_backend, get,
                                           register, resolve, unregister)

# importing the builtin modules registers them; layered first so
# available() leads with the 'take' oracle
from repro_torch.backends import layered as _layered  # noqa: F401,E402
from repro_torch.backends import fused as _fused      # noqa: F401,E402

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.folding import FoldedNetwork

__all__ = [
    "BackendCapabilities", "ExecutionPlan", "LookupBackend", "available",
    "default_backend", "get", "register", "resolve", "unregister",
    "make_plan", "plan_for",
]


def make_plan(net: "FoldedNetwork", backend: LookupBackend) -> ExecutionPlan:
    """``backend.plan(net)`` stamped with the backend's ``plan_format``."""
    plan = backend.plan(net)
    plan.meta.setdefault("plan_format", backend.plan_format)
    return plan


def plan_for(net: "FoldedNetwork", backend: LookupBackend) -> ExecutionPlan:
    """Plan ``backend`` over ``net``, memoized on the network instance; a
    cached plan of another ``plan_format`` is re-planned."""
    cache = getattr(net, "_plan_cache", None)
    if cache is None:
        cache = net._plan_cache = {}
    plan = cache.get(backend.name)
    if plan is None or plan.meta.get("plan_format") != backend.plan_format:
        plan = cache[backend.name] = make_plan(net, backend)
    return plan
