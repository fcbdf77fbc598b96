"""Don't-care analysis of folded L-LUT tables (the port of
``repro.core.dontcare``), a post-folding pass.

After folding, many LUT addresses are *unreachable*: the upstream quantizers
and tree structure only ever produce a subset of the 2^{beta*F} codes.
Synthesis tools exploit unreachable entries as don't-cares to shrink the
P-LUT decomposition, which is why the paper's measured LUT counts sit below
the structural model (e.g. NID: 91 measured vs 186 structural).

This pass:
  1. propagates representative inputs (the training set) through the folded
     network, recording the set of addresses each L-LUT actually receives,
  2. reports per-layer reachability (observed / possible addresses),
  3. estimates the don't-care-optimized P-LUT count by shrinking each
     unit's effective address width to ceil(log2(observed)), a first-order
     model of re-encoding/ROM compaction.

The lookup is the ``take`` gather, as in the reference, on the folded
network's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from repro_torch.backends.base import require_mappings
from repro_torch.core import hwcost, quant
from repro_torch.core.folding import FoldedNetwork
from repro_torch.kernels import ops as lut_ops


@dataclasses.dataclass
class DontCareReport:
    """Reachable addresses per layer and the LUT counts with and without
    the unreachable entries."""

    per_layer_possible: List[int]
    per_layer_observed: List[float]   # mean over units
    structural_luts: int
    optimized_luts: int

    @property
    def lut_reduction(self) -> float:
        """Structural over optimized LUT count."""
        return self.structural_luts / max(self.optimized_luts, 1)


def analyze(net: FoldedNetwork, x) -> DontCareReport:
    """Reachability of ``net``'s tables from ``x`` ``[n, in_features]``
    (representative inputs, e.g. the training set)."""
    require_mappings(net, "analyze")
    cfg = net.cfg
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(net.device)
    codes = quant.quantize_codes(net.in_q, cfg.input_quant_spec(), x)
    observed_frac: List[float] = []
    possible: List[int] = []
    structural = 0
    optimized = 0
    for l, spec in enumerate(cfg.layers):
        if spec.assemble:
            ci = codes.reshape(codes.shape[0], spec.units, spec.fan_in)
        else:
            ci = codes[:, net.mappings[l].long()]
        addr = quant.pack_address(ci, cfg.in_bits(l), spec.fan_in)
        n_possible = 2 ** (cfg.in_bits(l) * spec.fan_in)
        possible.append(n_possible)
        addr_np = addr.cpu().numpy()
        per_unit_observed = [len(np.unique(addr_np[:, u]))
                             for u in range(spec.units)]
        observed_frac.append(float(np.mean(per_unit_observed)) / n_possible)

        k_full = cfg.lut_addr_bits(l)
        structural += spec.units * spec.bits * hwcost.plut_per_bit(k_full)
        for obs in per_unit_observed:
            k_eff = max(1, math.ceil(math.log2(max(obs, 2))))
            optimized += spec.bits * hwcost.plut_per_bit(min(k_eff, k_full))

        codes = lut_ops.lut_lookup(net.tables[l], addr, impl="take")
    return DontCareReport(per_layer_possible=possible,
                          per_layer_observed=observed_frac,
                          structural_luts=structural,
                          optimized_luts=optimized)
