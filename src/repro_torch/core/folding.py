"""Folded inference over L-LUT tables (the inference half of
``repro.core.folding``; folding itself is not ported yet).

``FoldedNetwork`` owns the tables, the learned mappings and the two boundary
quantizers, as tensors on one device.  Folded inference packs codes into
addresses and looks them up, layer after layer, through a registered
lookup backend (``repro_torch.backends``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core import quant
from repro_torch.core.assemble import AssembleConfig


@dataclasses.dataclass
class FoldedNetwork:
    """Tables ``[units, 2^(b_in*F)]`` int32 per layer, mappings ``[units,
    F]`` int32 per mapping layer (``None`` for assemble layers), and the
    input/output quantizer parameters (``{"log_scale": float}``)."""

    cfg: AssembleConfig
    tables: List[torch.Tensor]
    in_q: dict
    out_q: dict
    mappings: Optional[List[Optional[torch.Tensor]]] = None

    @property
    def device(self) -> torch.device:
        """The device the tables live on."""
        return self.tables[0].device

    def num_entries(self) -> int:
        """Total table entries over all layers."""
        return int(sum(t.shape[0] * t.shape[1] for t in self.tables))


def folded_apply_codes(net: FoldedNetwork, x,
                       *, lut_impl: Optional[str] = None) -> torch.Tensor:
    """Folded inference: ``[batch, in_features]`` floats -> final codes.

    ``lut_impl`` names a registered backend (``None`` resolves
    ``$REPRO_LUT_BACKEND`` or ``take``); the plan is memoized on ``net``.
    """
    from repro_torch import backends

    be = backends.resolve(lut_impl)
    x = torch.as_tensor(x, dtype=torch.float32).to(net.device)
    codes = quant.quantize_codes(net.in_q, net.cfg.input_quant_spec(), x)
    return be.run(backends.plan_for(net, be), codes)


def folded_logits(net: FoldedNetwork, x,
                  *, lut_impl: Optional[str] = None) -> torch.Tensor:
    """Folded inference returning the dequantized final-layer values."""
    codes = folded_apply_codes(net, x, lut_impl=lut_impl)
    cfg = net.cfg
    return quant.dequantize_codes(net.out_q,
                                  cfg.quant_spec(len(cfg.layers) - 1), codes)
