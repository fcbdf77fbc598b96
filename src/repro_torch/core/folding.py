"""Sub-network -> L-LUT conversion by exhaustive enumeration, and folded
inference (``repro.core.folding``).

After training, every unit's computation between two quantization
boundaries is a function of ``F`` codes of ``b_in`` bits.  :func:`fold_layer`
evaluates the trained subnets on all ``2^(b_in*F)`` inputs (in chunks of
4096 addresses, each a ``[chunk, units, F]`` batch through kernel K4 on the
card) and stores the output codes: that table is the L-LUT.  Folding uses
the same deployed quantizer as :func:`~repro_torch.core.assemble.apply_codes`,
so folded inference equals it code for code.

``FoldedNetwork`` owns the tables, the learned mappings and the two boundary
quantizers, as tensors on one device.  Folded inference packs codes into
addresses and looks them up, layer after layer, through a registered
lookup backend (``repro_torch.backends``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import assemble, quant, subnet
from repro_torch.core.assemble import AssembleConfig, LUTNet

_ENUM_CHUNK = 4096  # enumeration batch (keeps peak memory bounded)


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


def _enumerate(cfg: AssembleConfig, l: int, in_q,
               eval_chunk) -> torch.Tensor:
    """Run ``eval_chunk`` on the dequantized inputs of every address of
    layer ``l``, as rows shared by the layer's units (``[chunk, F]``, K4's
    dense route); returns ``[rows, n_codes]`` int32."""
    spec = cfg.layers[l]
    b_in = cfg.in_bits(l)
    n_codes = 2 ** (b_in * spec.fan_in)
    in_spec = cfg.input_quant_spec() if l == 0 else cfg.quant_spec(l - 1)
    dev = in_q.log_scale.device
    pieces = []
    for start in range(0, n_codes, _ENUM_CHUNK):
        addr = torch.arange(start, min(start + _ENUM_CHUNK, n_codes),
                            dtype=torch.int32, device=dev)
        x = quant.dequantize_codes(in_q, in_spec,
                                   quant.unpack_address(addr, b_in,
                                                        spec.fan_in))
        pieces.append(eval_chunk(x))
    return torch.cat(pieces, dim=0).t().contiguous().to(torch.int32)


def _in_q(net: LUTNet, l: int) -> quant.Quantizer:
    return net.in_q if l == 0 else net.layers[l - 1].out_q


@torch.no_grad()
def fold_layer(net: LUTNet, cfg: AssembleConfig, l: int) -> torch.Tensor:
    """Enumerate one layer's units -> int32 table ``[units, 2^(b_in*F)]``."""
    layer = net.layers[l]
    out_spec = cfg.quant_spec(l)

    def eval_chunk(xi):
        out = subnet.apply_subnet(layer.subnet, cfg.subnet_spec(l), xi,
                                  activation=cfg.has_activation(l))
        return quant.quantize_codes(layer.out_q, out_spec, out[..., 0])

    return _enumerate(cfg, l, _in_q(net, l), eval_chunk)


@torch.no_grad()
def _fold_branch(net: LUTNet, cfg: AssembleConfig, l: int) -> torch.Tensor:
    """Branch tables of an additive layer ``[units*add_terms, 2^(b_in*F)]``:
    activation-free and quantized through the ``add_q`` boundary, exactly
    the lowered branch layer (``assemble.lower_additive``)."""
    layer = net.layers[l]
    add_spec = cfg.add_quant_spec(l)

    def eval_chunk(xi):
        out = subnet.apply_subnet(layer.subnet, cfg.subnet_spec(l), xi,
                                  activation=False)
        return quant.quantize_codes(layer.add_q, add_spec, out[..., 0])

    return _enumerate(cfg, l, _in_q(net, l), eval_chunk)


@torch.no_grad()
def _fold_combiner(net: LUTNet, cfg: AssembleConfig, l: int) -> torch.Tensor:
    """Combiner table of an additive layer ``[units, 2^(add_bits*add_terms)]``:
    the dequantize-sum-activate-quantize semantics of the branch boundary,
    the same row for every unit."""
    spec = cfg.layers[l]
    layer = net.layers[l]
    add_spec = cfg.add_quant_spec(l)
    addr = torch.arange(2 ** (spec.add_bits * spec.add_terms),
                        dtype=torch.int32, device=net.device)
    codes = quant.unpack_address(addr, spec.add_bits, spec.add_terms)
    out = quant.dequantize_codes(layer.add_q, add_spec, codes).sum(dim=-1)
    if cfg.has_activation(l):
        out = torch.relu(out)
    row = quant.quantize_codes(layer.out_q, cfg.quant_spec(l), out)
    return row[None, :].repeat(spec.units, 1).to(torch.int32)


def fold_network(net: LUTNet, cfg: AssembleConfig) -> FoldedNetwork:
    """Fold every layer, on the parameters' device.  Additive layers are
    lowered here: the result carries ``assemble.lower_additive(cfg)`` with
    a branch table and a combiner table per additive layer."""
    tables: List[torch.Tensor] = []
    mappings: List[Optional[torch.Tensor]] = []
    for l, spec in enumerate(cfg.layers):
        mapping = net.layers[l].mapping
        if spec.add_terms > 1:
            tables += [_fold_branch(net, cfg, l), _fold_combiner(net, cfg, l)]
            mappings += [mapping.to(torch.int32), None]
        else:
            tables.append(fold_layer(net, cfg, l))
            mappings.append(None if spec.assemble
                            else mapping.to(torch.int32))
    return FoldedNetwork(
        cfg=assemble.lower_additive(cfg), tables=tables,
        in_q={"log_scale": net.in_q.log_scale.item()},
        out_q={"log_scale": net.layers[-1].out_q.log_scale.item()},
        mappings=mappings)


def tables_to_numpy(net: FoldedNetwork) -> List[np.ndarray]:
    """The tables as numpy arrays."""
    return [t.cpu().numpy() for t in net.tables]


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
