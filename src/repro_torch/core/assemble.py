"""NeuraLUT-Assemble networks (``repro.core.assemble``): layer specs and
their rules, the parameters as ``nn.Module`` objects, and the forward passes.

A network is a sequence of LUT layers.  ``assemble=False`` ("mapping")
layers read ``F`` inputs chosen by a learned mapping; ``assemble=True``
layers read the contiguous slice ``[i*F, (i+1)*F)`` of the previous layer.
Every layer's output is quantized to ``bits``; a layer feeding an assemble
layer (with ``tree_skips``) and the final layer emit signed codes, the
others ReLU'd unsigned codes.  The field names match the reference so the
JSON config embedded in an artifact round-trips between the two packages.

Parameters live in :class:`LUTNet` (``in_q`` and one :class:`Layer` per
layer holding ``subnet``, ``out_q``, ``add_q`` for additive layers and the
int32 ``mapping`` buffer of sparse mapping layers).  :func:`param_tree`
lays them out as the reference's pytree, whose leaf order (dict keys
sorted, lists in order) :func:`tree_leaves` reproduces; the optimizer and
the saved toolflow state both walk that order.  :func:`params_from_reference`
and :func:`params_to_reference` carry weights across the two packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.core import quant, subnet
from repro_torch.core.quant import QuantSpec
from repro_torch.core.subnet import SubnetSpec


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One LUT layer: ``units`` L-LUTs of ``fan_in`` inputs, ``bits`` out.

    ``add_terms > 1`` makes additive wide-input units, lowered to a branch
    layer plus an assemble combiner by :func:`lower_additive`.
    """

    units: int
    fan_in: int
    bits: int
    assemble: bool
    add_terms: int = 1
    add_bits: int = 0


@dataclasses.dataclass(frozen=True)
class AssembleConfig:
    """A whole network: input boundary, layers and subnet hyperparameters."""

    in_features: int
    input_bits: int
    layers: Tuple[LayerSpec, ...]
    subnet_width: int = 16
    subnet_depth: int = 2
    skip_step: int = 2
    tree_skips: bool = True
    input_signed: bool = True
    poly_degree: int = 1

    def __post_init__(self):
        """Check the structural rules the reference enforces."""
        prev = self.in_features
        for i, l in enumerate(self.layers):
            if l.assemble:
                if l.units * l.fan_in != prev:
                    raise ValueError(
                        f"layer {i}: assemble needs units*fan_in == prev "
                        f"({l.units}*{l.fan_in} != {prev})")
                if l.add_terms > 1:
                    raise ValueError(
                        f"layer {i}: additive units need a mapping layer "
                        "(assemble layers have fixed regular sparsity)")
            elif l.fan_in > prev:
                raise ValueError(f"layer {i}: fan_in {l.fan_in} > prev {prev}")
            if l.add_terms > 1:
                if l.add_bits < 1:
                    raise ValueError(
                        f"layer {i}: add_terms={l.add_terms} needs "
                        "add_bits >= 1 (the branch-sum boundary width)")
                if not self.tree_skips:
                    raise ValueError(
                        f"layer {i}: additive units require tree_skips=True")
            prev = l.units

    def subnet_spec(self, l: int, *, dense: bool = False) -> SubnetSpec:
        """The MLP inside each unit of layer ``l`` (a mapping layer reads
        the whole previous layer in ``dense`` mode)."""
        fan_in = self.layers[l].fan_in
        if dense and not self.layers[l].assemble:
            fan_in = self.prev_width(l)
        return SubnetSpec(fan_in=fan_in, width=self.subnet_width,
                          depth=self.subnet_depth, skip_step=self.skip_step,
                          poly_degree=self.poly_degree)

    def prev_width(self, l: int) -> int:
        """Width of the layer feeding layer ``l``."""
        return self.in_features if l == 0 else self.layers[l - 1].units

    def lut_addr_bits(self, l: int) -> int:
        """Address bits of layer ``l``'s physical (branch) LUTs."""
        return self.in_bits(l) * self.layers[l].fan_in

    def mapping_rows(self, l: int) -> int:
        """Mapping rows / subnet units of layer ``l``: one per (unit,
        branch) pair for additive layers."""
        return self.layers[l].units * max(self.layers[l].add_terms, 1)

    def add_quant_spec(self, l: int) -> QuantSpec:
        """The branch-sum boundary of an additive layer (signed)."""
        return QuantSpec(self.layers[l].add_bits, signed=True)

    def has_activation(self, l: int) -> bool:
        """ReLU at the output of layer ``l``?"""
        if l == len(self.layers) - 1:
            return False
        if self.tree_skips and self.layers[l + 1].assemble:
            return False
        return True

    def quant_spec(self, l: int) -> QuantSpec:
        """Output boundary of layer ``l`` (unsigned after a ReLU)."""
        return QuantSpec(self.layers[l].bits, signed=not self.has_activation(l))

    def input_quant_spec(self) -> QuantSpec:
        """The network's input boundary."""
        return QuantSpec(self.input_bits, signed=self.input_signed)

    def in_bits(self, l: int) -> int:
        """LUT input bit-width seen by layer ``l``."""
        return self.input_bits if l == 0 else self.layers[l - 1].bits

    def has_additive(self) -> bool:
        """Whether any layer has additive wide-input units."""
        return any(l.add_terms > 1 for l in self.layers)


def lower_additive(cfg: AssembleConfig) -> AssembleConfig:
    """Rewrite additive layers into a branch mapping layer followed by an
    assemble combiner; identity (returns ``cfg``) when none is additive."""
    if not cfg.has_additive():
        return cfg
    layers: List[LayerSpec] = []
    for spec in cfg.layers:
        if spec.add_terms > 1:
            layers.append(LayerSpec(units=spec.units * spec.add_terms,
                                    fan_in=spec.fan_in, bits=spec.add_bits,
                                    assemble=False))
            layers.append(LayerSpec(units=spec.units, fan_in=spec.add_terms,
                                    bits=spec.bits, assemble=True))
        else:
            layers.append(spec)
    return dataclasses.replace(cfg, layers=tuple(layers))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One layer's parameters: its subnets, output quantizer, branch-sum
    quantizer (additive layers) and learned mapping (sparse mapping
    layers, an int32 ``[rows, fan_in]`` buffer; None otherwise)."""

    def __init__(self, sn: subnet.Subnet, out_q: quant.Quantizer,
                 add_q: Optional[quant.Quantizer] = None,
                 mapping: Optional[torch.Tensor] = None):
        """Hold the given modules and the mapping buffer."""
        super().__init__()
        self.subnet = sn
        self.out_q = out_q
        self.add_q = add_q
        self.register_buffer("mapping", mapping)


class LUTNet(nn.Module):
    """A whole network's parameters: the input quantizer and the layers."""

    def __init__(self, in_q: quant.Quantizer, layers: Sequence[Layer]):
        """Hold the input quantizer and the layers."""
        super().__init__()
        self.in_q = in_q
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.in_q.log_scale.device


def init(seed: int, cfg: AssembleConfig, *, dense: bool = False,
         mappings: Optional[Sequence[Optional[Any]]] = None,
         device=None) -> LUTNet:
    """Fresh parameters drawn from a CPU ``torch.Generator`` seeded by
    ``seed`` and then moved to ``device`` (CUDA by default), so a card run
    and a CPU run start from the same numbers.

    ``dense=True`` builds the pre-training model whose mapping layers read
    the whole previous layer.  ``mappings[l]`` is an int ``[rows, fan_in]``
    table for mapping layers of the sparse model; a missing one is drawn at
    random (the "w/o Learned Mappings" ablation) from its own generator.
    """
    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(seed)
    map_gen = torch.Generator().manual_seed(seed + 1_000_003)
    layers = []
    for l, spec in enumerate(cfg.layers):
        sn = subnet.init_subnet(gen, cfg.subnet_spec(l, dense=dense),
                                cfg.mapping_rows(l), device=dev)
        add_q = (quant.init_quant(cfg.add_quant_spec(l), device=dev)
                 if spec.add_terms > 1 else None)
        mapping = None
        if not dense and not spec.assemble:
            if mappings is not None and mappings[l] is not None:
                m = mappings[l]
                mapping = (m if isinstance(m, torch.Tensor)
                           else torch.from_numpy(np.array(m))).to(torch.int32)
                if tuple(mapping.shape) != (cfg.mapping_rows(l), spec.fan_in):
                    raise ValueError(f"layer {l}: mapping shape "
                                     f"{tuple(mapping.shape)}")
            else:
                mapping = random_mapping(map_gen, cfg, l)
            mapping = mapping.to(dev)
        layers.append(Layer(sn, quant.init_quant(cfg.quant_spec(l),
                                                 device=dev),
                            add_q=add_q, mapping=mapping))
    return LUTNet(quant.init_quant(cfg.input_quant_spec(), device=dev), layers)


def random_mapping(gen: torch.Generator, cfg: AssembleConfig,
                   l: int) -> torch.Tensor:
    """Random fan-in selection ``[rows, fan_in]`` int32 (without
    replacement unless the previous layer is narrower than ``fan_in``)."""
    spec = cfg.layers[l]
    prev, rows = cfg.prev_width(l), cfg.mapping_rows(l)
    if prev < spec.fan_in:
        return torch.randint(0, prev, (rows, spec.fan_in), generator=gen,
                             dtype=torch.int32)
    order = torch.rand((rows, prev), generator=gen).argsort(dim=1)
    return order[:, :spec.fan_in].to(torch.int32)


def param_tree(net: LUTNet) -> dict:
    """The reference's parameter pytree (nested dicts and lists) with this
    network's own tensors as leaves."""
    layers = []
    for layer in net.layers:
        sn = layer.subnet
        d = {"subnet": {"w": list(sn.w), "b": list(sn.b),
                        "skip_w": list(sn.skip_w),
                        "bn": {"gamma": sn.bn.gamma, "beta": sn.bn.beta,
                               "mean": sn.bn.mean, "var": sn.bn.var}},
             "out_q": {"log_scale": layer.out_q.log_scale}}
        if layer.add_q is not None:
            d["add_q"] = {"log_scale": layer.add_q.log_scale}
        if layer.mapping is not None:
            d["mapping"] = layer.mapping
        layers.append(d)
    return {"in_q": {"log_scale": net.in_q.log_scale}, "layers": layers}


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists and
    tuples in order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def leaves(net: LUTNet) -> List[torch.Tensor]:
    """The network's tensors in the reference's leaf order."""
    return tree_leaves(param_tree(net))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def params_to_reference(net: LUTNet, *, population: bool = False) -> dict:
    """The reference's parameter pytree as numpy arrays (float32 leaves,
    int32 mappings).  ``population=True`` takes a stacked population
    (:func:`stack_population`) to the reference's vmapped form: every leaf
    with a leading ``[P]`` candidate axis."""
    tree = _map_tree(lambda t: t.detach().cpu().numpy().copy(),
                     param_tree(net))
    if population:
        p = population_size(net)
        for d in tree["layers"]:
            d["subnet"] = _map_tree(
                lambda a: a.reshape((p, a.shape[0] // p) + a.shape[1:]),
                d["subnet"])
    return tree


def params_from_reference(tree: dict, *, device=None,
                          population: bool = False) -> LUTNet:
    """Build a :class:`LUTNet` on ``device`` (CUDA by default) from the
    reference's parameter pytree (nested dicts and lists of arrays).
    ``population=True`` reads the vmapped form of a population (a leading
    ``[P]`` axis on every leaf) into a stacked population."""
    dev = _device.resolve(device)
    if population:
        tree = dict(tree, layers=[dict(d, subnet=_map_tree(
            lambda a: np.asarray(a).reshape(
                (-1,) + np.asarray(a).shape[2:]), d["subnet"]))
            for d in tree["layers"]])

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def q(d):
        return quant.Quantizer(t(np.asarray(d["log_scale"], np.float32)))

    layers = []
    for d in tree["layers"]:
        s = d["subnet"]
        bn = quant.BatchNorm(len(np.asarray(s["bn"]["gamma"])), device=dev)
        with torch.no_grad():
            for k in ("gamma", "beta", "mean", "var"):
                getattr(bn, k).copy_(t(s["bn"][k]))
        sn = subnet.Subnet([t(a) for a in s["w"]], [t(a) for a in s["b"]],
                           [t(a) for a in s.get("skip_w", [])], bn)
        layers.append(Layer(
            sn, q(d["out_q"]), add_q=q(d["add_q"]) if "add_q" in d else None,
            mapping=(t(np.asarray(d["mapping"], np.int32)) if "mapping" in d
                     else None)))
    return LUTNet(q(tree["in_q"]), layers)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def gather_layer_inputs(cfg: AssembleConfig, layer: Layer, l: int,
                        h: torch.Tensor) -> torch.Tensor:
    """``[batch, prev] -> [batch, rows, fan_in]``."""
    spec = cfg.layers[l]
    if spec.assemble:
        return h.reshape(h.shape[0], spec.units, spec.fan_in)
    return h[:, layer.mapping.long()]


# ---------------------------------------------------------------------------
# populations: many candidates of one shape as one network
# ---------------------------------------------------------------------------
#
# The assembly search trains a group of P candidates that share every
# parameter shape (``search.space.shape_signature``) at once.  The port
# stacks them along the unit axis: layer l's subnets hold P * rows units,
# candidate p's in rows [p * rows, (p + 1) * rows), so each affine stage of
# the whole group is one K4 launch of the per-unit route.  Quantizer
# log-scales are [P] tensors and mappings [P, rows, fan_in].  Activations
# are batch-major, [batch, P, width], so a layer's gathered inputs
# [batch, P * rows, fan_in] are contiguous and reach K4 without a copy.


def stack_population(nets: Sequence[LUTNet]) -> LUTNet:
    """One population network from P networks of one shape, candidate p
    being ``nets[p]`` (on their device)."""
    def q(qs):
        return quant.Quantizer(torch.stack([x.log_scale.detach()
                                            for x in qs]))

    def cat(ts):
        return torch.cat([t.detach() for t in ts])

    layers = []
    for l, layer in enumerate(nets[0].layers):
        sns = [n.layers[l].subnet for n in nets]
        bn = quant.BatchNorm(sum(s.bn.gamma.shape[0] for s in sns),
                             device=nets[0].device)
        with torch.no_grad():
            for k in ("gamma", "beta", "mean", "var"):
                getattr(bn, k).copy_(cat([getattr(s.bn, k) for s in sns]))
        sn = subnet.Subnet(
            [cat([s.w[i] for s in sns]) for i in range(len(sns[0].w))],
            [cat([s.b[i] for s in sns]) for i in range(len(sns[0].b))],
            [cat([s.skip_w[i] for s in sns])
             for i in range(len(sns[0].skip_w))], bn)
        mapping = (None if layer.mapping is None else
                   torch.stack([n.layers[l].mapping for n in nets]))
        layers.append(Layer(
            sn, q([n.layers[l].out_q for n in nets]),
            add_q=(None if layer.add_q is None
                   else q([n.layers[l].add_q for n in nets])),
            mapping=mapping))
    return LUTNet(q([n.in_q for n in nets]), layers)


def population_size(net: LUTNet) -> int:
    """Candidates in a stacked population (its input log-scale's length)."""
    if net.in_q.log_scale.dim() != 1:
        raise ValueError("not a stacked population (scalar log-scale)")
    return int(net.in_q.log_scale.shape[0])


def population_member(net: LUTNet, i: int) -> LUTNet:
    """A copy of candidate ``i`` of a stacked population as a network of
    its own."""
    tree = params_to_reference(net, population=True)
    return params_from_reference(_map_tree(lambda a: a[i], tree),
                                 device=net.device)


class _GatherColumns(torch.autograd.Function):
    """``h[:, idx]`` whose gradient is a fixed-order sum, not an indexed
    accumulation: ``inv`` lists, for each column of h, the positions of
    ``idx`` that read it (padded with ``len(idx)``, a zero column), so the
    backward gives the same bits on every run and every stream (an
    accumulating ``index_put_`` on CUDA adds in launch order)."""

    @staticmethod
    def forward(ctx, h, idx, inv):
        """Columns ``idx`` of ``h [batch, width]``."""
        ctx.save_for_backward(inv)
        return h[:, idx]

    @staticmethod
    def backward(ctx, dy):
        """Each column's gradient, summed over its readers in order."""
        inv, = ctx.saved_tensors
        pad = torch.cat([dy, dy.new_zeros((dy.shape[0], 1))], dim=1)
        return pad[:, inv].sum(-1), None, None


def _gather_plan(layer: Layer, width: int):
    """(flat column index, inverse) of a population's mapping layer, built
    once and kept on the layer."""
    plan = getattr(layer, "_gather_plan", None)
    if plan is None:
        m = layer.mapping.long()
        p = m.shape[0]
        idx = (m + width * torch.arange(p, device=m.device)[:, None, None]
               ).reshape(-1)
        order = torch.argsort(idx, stable=True)
        counts = torch.bincount(idx, minlength=p * width)
        starts = torch.cumsum(counts, 0) - counts
        sorted_idx = idx[order]
        rank = torch.arange(idx.numel(), device=m.device) - starts[sorted_idx]
        inv = torch.full((p * width, max(int(counts.max()), 1)), idx.numel(),
                         dtype=torch.long, device=m.device)
        inv[sorted_idx, rank] = order
        plan = (idx, inv)
        layer._gather_plan = plan
    return plan


def gather_population_inputs(cfg: AssembleConfig, layer: Layer, l: int,
                             h: torch.Tensor) -> torch.Tensor:
    """``[batch, P, prev] -> [batch, P * rows, fan_in]``, candidate p's
    units reading candidate p's activations."""
    spec = cfg.layers[l]
    b, p, width = h.shape
    if spec.assemble:
        return h.reshape(b, p * spec.units, spec.fan_in)
    idx, inv = _gather_plan(layer, width)
    out = _GatherColumns.apply(h.reshape(b, p * width), idx, inv)
    return out.view(b, -1, spec.fan_in)


def apply(net: LUTNet, cfg: AssembleConfig, x: torch.Tensor, *,
          training: bool = False, dense: bool = False,
          bn_batch_stats: bool = True) -> torch.Tensor:
    """Forward pass: x ``[batch, in_features]`` -> logits ``[batch,
    n_out]``.  When ``training`` the BN running statistics are refreshed
    in ``net``; ``bn_batch_stats=False`` trains with frozen-stats BN (the
    recurrent-cell mode, ``repro_torch.stream``)."""
    h = quant.fake_quant(net.in_q, cfg.input_quant_spec(), x)
    for l, spec in enumerate(cfg.layers):
        layer = net.layers[l]
        # dense mode: the shared rows themselves, so that K4 reads them once
        # and its gradient is [batch, prev], never [batch, rows, prev]
        xi = h if dense and not spec.assemble else \
            gather_layer_inputs(cfg, layer, l, h)
        additive = spec.add_terms > 1
        out = subnet.apply_subnet(
            layer.subnet, cfg.subnet_spec(l, dense=dense), xi,
            activation=False if additive else cfg.has_activation(l),
            training=training, bn_batch_stats=bn_batch_stats)[..., 0]
        if additive:
            # PolyLUT-Add boundary: quantize each branch, sum pre-activation
            out = quant.fake_quant(layer.add_q, cfg.add_quant_spec(l), out)
            out = out.reshape(out.shape[0], spec.units, spec.add_terms).sum(-1)
            if cfg.has_activation(l):
                out = torch.relu(out)
        h = quant.fake_quant(layer.out_q, cfg.quant_spec(l), out)
    return h


@torch.no_grad()
def apply_codes(net: LUTNet, cfg: AssembleConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Eval forward returning the integer output codes ``[batch, n_out]``
    through the deployed (hard) quantizer, which folding shares."""
    in_spec = cfg.input_quant_spec()
    x = torch.as_tensor(x, dtype=torch.float32).to(net.device)
    codes = quant.quantize_codes(net.in_q, in_spec, x)
    h = quant.dequantize_codes(net.in_q, in_spec, codes)
    for l, spec in enumerate(cfg.layers):
        layer = net.layers[l]
        xi = gather_layer_inputs(cfg, layer, l, h)
        additive = spec.add_terms > 1
        out = subnet.apply_subnet(
            layer.subnet, cfg.subnet_spec(l), xi,
            activation=False if additive else cfg.has_activation(l))[..., 0]
        if additive:
            aqs = cfg.add_quant_spec(l)
            bc = quant.quantize_codes(layer.add_q, aqs, out)
            out = quant.dequantize_codes(layer.add_q, aqs, bc)
            out = out.reshape(out.shape[0], spec.units, spec.add_terms).sum(-1)
            if cfg.has_activation(l):
                out = torch.relu(out)
        qs = cfg.quant_spec(l)
        codes = quant.quantize_codes(layer.out_q, qs, out)
        h = quant.dequantize_codes(layer.out_q, qs, codes)
    return codes


def group_lasso(net: LUTNet, cfg: AssembleConfig) -> torch.Tensor:
    """Hardware-aware structured regularizer of the dense phase: the sum of
    first-stage group norms over the mapping layers."""
    total = torch.zeros((), device=net.device)
    for l, spec in enumerate(cfg.layers):
        if not spec.assemble:
            total = total + subnet.l2_group_penalty(net.layers[l].subnet)
    return total


def logits_to_scores(cfg: AssembleConfig, h: torch.Tensor) -> torch.Tensor:
    """Final layer output -> class scores (the identity)."""
    del cfg
    return h
