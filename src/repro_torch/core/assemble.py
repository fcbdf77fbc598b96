"""Config half of ``repro.core.assemble``: layer specs and their rules.

A network is a sequence of LUT layers.  ``assemble=False`` ("mapping")
layers read ``F`` inputs chosen by a learned mapping; ``assemble=True``
layers read the contiguous slice ``[i*F, (i+1)*F)`` of the previous layer.
Every layer's output is quantized to ``bits``; a layer feeding an assemble
layer (with ``tree_skips``) and the final layer emit signed codes, the
others ReLU'd unsigned codes.  The field names match the reference so the
JSON config embedded in an artifact round-trips between the two packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.quant import QuantSpec


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

    def prev_width(self, l: int) -> int:
        """Width of the layer feeding layer ``l``."""
        return self.in_features if l == 0 else self.layers[l - 1].units

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
