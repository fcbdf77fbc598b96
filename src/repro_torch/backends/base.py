"""The lookup-backend contract (the port of ``repro.backends.base``).

A backend executes the folded cascade in two steps: an offline ``plan``
(layout decisions and buffer packing, in numpy, once per network) and a hot
``run`` on tensors.  ``ExecutionPlan`` keeps JSON-serializable ``meta`` and
numpy ``buffers`` so artifacts carry plans in the reference's format; the
tensors a run needs on a device are derived from the buffers once and
cached on the plan (never persisted).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.folding import FoldedNetwork


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """Static description of a backend.

    ``needs_pallas`` keeps the reference's field name; in the port it means
    that the backend runs a hand-written kernel on the card.
    """

    name: str
    fused: bool
    needs_pallas: bool
    description: str = ""


@dataclasses.dataclass
class ExecutionPlan:
    """A planned cascade: static metadata + packed constant buffers."""

    backend: str
    meta: Dict[str, Any]
    buffers: Dict[str, np.ndarray]
    _derived: Dict[tuple, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def derived(self, device: torch.device, key: str,
                build: Callable[[], Any]) -> Any:
        """``build()`` once per (device, key), then the cached result."""
        k = (str(torch.device(device)), key)
        if k not in self._derived:
            self._derived[k] = build()
        return self._derived[k]

    def tensor(self, key: str, device: torch.device) -> torch.Tensor:
        """Buffer ``key`` as a tensor on ``device`` (copied once)."""
        return self.derived(device, "buffer:" + key, lambda: torch.tensor(
            self.buffers[key], device=device))


class LookupBackend(abc.ABC):
    """One way of executing a folded L-LUT cascade."""

    name: str = "?"
    plan_format: str = "v1"
    persist_plan: bool = True

    @abc.abstractmethod
    def capabilities(self) -> BackendCapabilities:
        """Static :class:`BackendCapabilities` description."""

    @abc.abstractmethod
    def plan(self, net: "FoldedNetwork") -> ExecutionPlan:
        """Offline planning in numpy: folded network -> ExecutionPlan."""

    @abc.abstractmethod
    def run(self, plan: ExecutionPlan, codes: torch.Tensor) -> torch.Tensor:
        """Input codes ``[batch, in_features]`` int32 -> final-layer codes
        ``[batch, units_last]`` int32, on the device of ``codes``."""

    def migrate_plan(self, plan: ExecutionPlan,
                     net: "FoldedNetwork") -> Optional[ExecutionPlan]:
        """Upgrade a persisted plan of an older ``plan_format``; ``None``
        (the default) forces a fresh plan."""
        return None


def require_mappings(net: "FoldedNetwork", who: str) -> None:
    """Planning needs the learned mappings on the net."""
    if net.mappings is None and any(not s.assemble for s in net.cfg.layers):
        raise ValueError(
            f"{who}: FoldedNetwork has no mappings; re-fold with "
            "fold_network(params, cfg)")
