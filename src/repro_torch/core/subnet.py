"""Sub-networks hidden inside L-LUTs (``repro.core.subnet``).

One *unit* is one L-LUT and one small MLP ``F -> N -> ... -> N -> 1``
whose whole computation is later absorbed into a lookup table (folding).
A layer holds ``units`` such MLPs side by side, so every parameter carries a
leading ``[units]`` axis and each affine stage is one call of
:func:`repro_torch.kernels.ops.unit_affine` (kernel K4 on the card).

Skip connections (paper §III): every ``S`` affine layers an activation-free
affine bypass joins the target layer's pre-activation.  PolyLUT-style units
expand their inputs into monomials up to ``poly_degree`` first.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core import quant
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SubnetSpec:
    """Static shape of the MLP hidden inside each L-LUT of one layer."""

    fan_in: int          # F: number of (quantized) inputs per unit
    width: int           # N: hidden width
    depth: int           # L: number of hidden layers (0 => LogicNets-style)
    skip_step: int = 2   # S: affine bypass every S affine layers (0 => off)
    out_dim: int = 1     # outputs per unit (1 for standard L-LUTs)
    poly_degree: int = 1  # >1 => PolyLUT-style monomial expansion of inputs

    @property
    def n_affine(self) -> int:
        """Number of affine stages (hidden layers plus the output)."""
        return self.depth + 1

    def skip_edges(self) -> Tuple[Tuple[int, int], ...]:
        """``(source stage input, destination stage)`` of each bypass."""
        if self.skip_step <= 0:
            return ()
        return tuple((dst - self.skip_step, dst)
                     for dst in range(self.skip_step, self.n_affine,
                                      self.skip_step))


def monomial_indices(fan_in: int, degree: int) -> List[Tuple[int, ...]]:
    """All monomials of ``fan_in`` variables with total degree 1..``degree``,
    as tuples of variable indices (with repetition)."""
    feats: List[Tuple[int, ...]] = []
    for d in range(1, degree + 1):
        feats.extend(itertools.combinations_with_replacement(range(fan_in), d))
    return feats


def expanded_fan_in(spec: SubnetSpec) -> int:
    """Input width of the first affine after monomial expansion."""
    if spec.poly_degree <= 1:
        return spec.fan_in
    return len(monomial_indices(spec.fan_in, spec.poly_degree))


def _dims(spec: SubnetSpec) -> Sequence[Tuple[int, int]]:
    """``(in, out)`` of every affine stage, after monomial expansion."""
    f = expanded_fan_in(spec)
    if spec.depth == 0:
        return [(f, spec.out_dim)]
    return ([(f, spec.width)] + [(spec.width, spec.width)] * (spec.depth - 1)
            + [(spec.width, spec.out_dim)])


class Subnet(nn.Module):
    """The per-unit MLPs of one layer: ``w``/``b``/``skip_w`` batched over
    units, and a batch-norm over the unit outputs."""

    def __init__(self, w: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
                 skip_w: Sequence[torch.Tensor], bn: quant.BatchNorm):
        """Hold the given tensors as parameters (``bn`` as a submodule)."""
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(t) for t in w])
        self.b = nn.ParameterList([nn.Parameter(t) for t in b])
        self.skip_w = nn.ParameterList([nn.Parameter(t) for t in skip_w])
        self.bn = bn


def init_subnet(gen: torch.Generator, spec: SubnetSpec, units: int,
                device=None) -> Subnet:
    """He-initialized parameters batched over ``units``, drawn from ``gen``
    (a CPU generator) and then moved to ``device``."""
    dims = _dims(spec)
    w, b, skip_w = [], [], []
    for din, dout in dims:
        w.append((torch.randn((units, din, dout), generator=gen)
                  * math.sqrt(2.0 / din)).to(device))
        b.append(torch.zeros((units, dout), device=device))
    for src, dst in spec.skip_edges():
        din, dout = dims[src][0], dims[dst][1]
        skip_w.append((torch.randn((units, din, dout), generator=gen)
                       * math.sqrt(1.0 / din)).to(device))
    return Subnet(w, b, skip_w, quant.init_batchnorm(units, device=device))


def expand_poly(spec: SubnetSpec, x: torch.Tensor) -> torch.Tensor:
    """PolyLUT monomial expansion: ``[..., F] -> [..., n_monomials]``."""
    if spec.poly_degree <= 1:
        return x
    feats = []
    for idxs in monomial_indices(spec.fan_in, spec.poly_degree):
        m = x[..., idxs[0]]
        for i in idxs[1:]:
            m = m * x[..., i]
        feats.append(m)
    return torch.stack(feats, dim=-1)


def apply_subnet(sn: Subnet, spec: SubnetSpec, x: torch.Tensor, *,
                 activation: bool, training: bool = False) -> torch.Tensor:
    """Run the batched subnets: x ``[batch, units, F]`` (dequantized inputs)
    or rows that every unit reads, ``[batch, F]`` (dense mode, the fold's
    enumeration) -> ``[batch, units, out_dim]`` pre-quantization outputs.
    Shared rows reach K4 as they are, in the first affine and in a bypass
    that reads the subnet input, so no ``[batch, units, F]`` tensor or
    gradient is built.

    When ``training`` the BN running statistics in ``sn.bn`` are refreshed.
    ``activation`` applies ReLU to the output; hidden stages always do.  A
    hidden stage with no incoming bypass has its ReLU fused into K4.
    """
    x = expand_poly(spec, x)
    hidden_inputs = [x]             # input of affine stage i
    h = x
    edges = {dst: (k, src) for k, (src, dst) in enumerate(spec.skip_edges())}
    n = spec.n_affine
    for i in range(n):
        hidden = i < n - 1
        if hidden and i not in edges:
            h = ops.unit_affine(h, sn.w[i], sn.b[i], activate=True)
            hidden_inputs.append(h)
            continue
        z = ops.unit_affine(h, sn.w[i], sn.b[i])
        if i in edges:
            k, src = edges[i]
            z = z + ops.unit_affine(hidden_inputs[src], sn.skip_w[k])
        if hidden:
            h = torch.relu(z)
            hidden_inputs.append(h)
        else:
            h = z
    # batch-norm per unit (statistics per unit, not per out_dim element)
    if spec.out_dim == 1:
        out = quant.batchnorm_apply(sn.bn, h[..., 0],
                                    training=training)[..., None]
    else:
        mean_in = h.mean(dim=-1)
        y = quant.batchnorm_apply(sn.bn, mean_in, training=training)
        out = h + (y - mean_in)[..., None]
    return torch.relu(out) if activation else out


def l2_group_penalty(sn: Subnet) -> torch.Tensor:
    """Group lasso over the first affine's per-input weight groups: the sum
    over (unit, input) of ``||w0[u, i, :]||`` (PolyLUT's regularizer)."""
    w0 = sn.w[0]
    return torch.sqrt(torch.sum(w0 * w0, dim=-1) + 1e-12).sum()


def input_saliency(sn: Subnet) -> torch.Tensor:
    """Per-(unit, input) group norms, the pruning score ``[units, fan_in]``
    (plus the norms of a bypass that reads the subnet input)."""
    w0 = sn.w[0]
    s = torch.sqrt(torch.sum(w0 * w0, dim=-1))
    for sw in sn.skip_w:
        if sw.shape[1] == w0.shape[1]:
            s = s + torch.sqrt(torch.sum(sw * sw, dim=-1))
    return s
