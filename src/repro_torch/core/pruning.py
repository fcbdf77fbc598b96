"""Hardware-aware structured pruning (``repro.core.pruning``).

After dense pre-training with the group-lasso regularizer, keep the top-``F``
inputs per unit by group norm: these are the learned mappings the sparse
model re-trains with.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import subnet
from repro_torch.core.assemble import AssembleConfig, LUTNet


@torch.no_grad()
def select_mappings(dense: LUTNet, cfg: AssembleConfig
                    ) -> List[Optional[torch.Tensor]]:
    """Top-``F`` inputs per unit from the dense model's saliency scores:
    one int32 ``[rows, fan_in]`` table per mapping layer (sorted
    ascending), None for assemble layers.

    Ties go to the lower input index, as ``jax.lax.top_k`` breaks them: a
    stable descending sort, then the first ``F``.
    """
    mappings: List[Optional[torch.Tensor]] = []
    for l, spec in enumerate(cfg.layers):
        if spec.assemble:
            mappings.append(None)
            continue
        sal = subnet.input_saliency(dense.layers[l].subnet)
        idx = torch.sort(sal, dim=-1, descending=True, stable=True).indices
        top = torch.sort(idx[:, :spec.fan_in], dim=-1).values
        mappings.append(top.to(torch.int32))
    return mappings


def mapping_coverage(mappings: List[Optional[torch.Tensor]],
                     cfg: AssembleConfig) -> List[float]:
    """Fraction of the previous layer's outputs used at each mapping
    layer."""
    return [len(set(m.reshape(-1).tolist())) / cfg.prev_width(l)
            for l, m in enumerate(mappings) if m is not None]
