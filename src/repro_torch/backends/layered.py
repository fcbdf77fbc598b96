"""Per-layer backends: one ``ops.lut_lookup`` per layer.

``take`` gathers (the bit-exactness oracle), ``onehot`` contracts a one-hot
tensor with the table, ``pallas`` launches kernel K3 on a CUDA tensor (its
plain version on a CPU tensor).  The plan is a verbatim extraction of the
per-layer tables and mappings, so it is not persisted.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.backends.base import (BackendCapabilities, ExecutionPlan,
                                       LookupBackend, require_mappings)
from repro_torch.backends.registry import register


class LayeredBackend(LookupBackend):
    """Cascade executed layer by layer via ``kernels.ops.lut_lookup``."""

    plan_format = "layered-v1"
    persist_plan = False

    def __init__(self, impl: str):
        """``impl`` is the ``ops.lut_lookup`` name, also the registry name."""
        self._impl = impl
        self.name = impl

    def capabilities(self) -> BackendCapabilities:
        """Describe this per-layer execution strategy."""
        desc = {
            "take": "per-layer torch.gather of table[u, addr] (the oracle)",
            "onehot": "per-layer one-hot x table contraction in float32",
            "pallas": "per-layer hand-written CUDA lookup kernel (K3)",
        }[self._impl]
        return BackendCapabilities(name=self.name, fused=False,
                                   needs_pallas=self._impl == "pallas",
                                   description=desc)

    def plan(self, net) -> ExecutionPlan:
        """Verbatim extraction of the per-layer tables + mappings."""
        require_mappings(net, f"{self.name}.plan")
        cfg = net.cfg
        layers = []
        buffers: Dict[str, np.ndarray] = {}
        for l, spec in enumerate(cfg.layers):
            layers.append({"units": spec.units, "fan_in": spec.fan_in,
                           "bits": cfg.in_bits(l), "assemble": spec.assemble})
            buffers[f"table_{l}"] = np.asarray(net.tables[l].cpu(), np.int32)
            if not spec.assemble:
                buffers[f"mapping_{l}"] = np.asarray(net.mappings[l].cpu(),
                                                     np.int32)
        return ExecutionPlan(backend=self.name,
                             meta={"impl": self._impl, "layers": layers},
                             buffers=buffers)

    def run(self, plan: ExecutionPlan, codes: torch.Tensor) -> torch.Tensor:
        """Mapping gather -> ``quant.pack_address`` -> one lookup per layer."""
        from repro_torch.core import quant
        from repro_torch.kernels import ops
        dev = codes.device
        for l, lm in enumerate(plan.meta["layers"]):
            if lm["assemble"]:
                ci = codes.reshape(codes.shape[0], lm["units"], lm["fan_in"])
            else:
                mp = plan.derived(dev, f"index_{l}", lambda l=l: plan.tensor(
                    f"mapping_{l}", dev).to(torch.int64))
                ci = codes[:, mp]
            addr = quant.pack_address(ci, lm["bits"], lm["fan_in"])
            codes = ops.lut_lookup(plan.tensor(f"table_{l}", dev), addr,
                                   impl=plan.meta["impl"])
        return codes


register("take", lambda: LayeredBackend("take"))
register("onehot", lambda: LayeredBackend("onehot"))
register("pallas", lambda: LayeredBackend("pallas"))
