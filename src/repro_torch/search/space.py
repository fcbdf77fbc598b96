"""Candidate space of the hardware-aware assembly search (the port of
``repro.search.space``; pure Python on ``AssembleConfig``, so both packages
generate the same candidates, in the same order, with the same recorded
rejections).

A *candidate* is one `AssembleConfig` derived from a task's base design by
turning the paper's assembly knobs (§III): per-layer fan-in, unit counts
(tree head width), subnet depth, skip-connection placement, and beta
(mixed-precision bit-widths).  Every candidate passes the hardware validity
rules before it is ever trained:

  * structural: `AssembleConfig.__post_init__` (assemble layers must tile
    the previous layer, mapping fan-in bounded by the previous width);
  * LUT input budget: every layer's address width `in_bits * fan_in` must
    fit the physical K budget (`SearchBudget.max_addr_bits`; the paper's
    designs max out at 12);
  * folding tractability: total table entries `sum units * 2^k` capped so
    exhaustive enumeration and the fused backend's packed buffer stay
    small enough to build.

Rejected candidates are *recorded*, not silently dropped — the driver
reports them so a shrunken space is observable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core import assemble as assemble_mod
from repro_torch.core import quant
from repro_torch.core.assemble import AssembleConfig


@dataclasses.dataclass(frozen=True)
class SearchBudget:
    """Knobs of one search run: candidate count, rungs, promotion, limits."""

    n_candidates: int = 16        # cap on the generated candidate set
    rungs: Tuple[int, ...] = (30, 80)   # short-horizon steps per rung
    keep: float = 0.5             # survivor fraction per rung
    promote: int = 4              # candidates given full Toolflow training
    min_frontier: int = 3         # keep promoting until the frontier has this
    max_promote_extra: int = 3    # hard cap on extra promotions beyond that
    pretrain_steps: int = 60      # full-training (promotion) budget
    retrain_steps: int = 150
    lasso: float = 1e-4
    lr: float = 5e-3
    batch_size: int = 256
    train_rows: int = 4096
    eval_rows: int = 1024
    seed: int = 0
    max_addr_bits: int = 12       # K budget: LUT address bits per layer
    max_table_entries: int = 4 << 20  # folding / fused-packing tractability
    pipeline_every: int = 3       # hwcost scoring strategy
    # population slicing (the distributed path; =1 trains whole groups).
    # >1 also defines the single-device *identity reference*: bit-identical
    # survivors are guaranteed between runs that execute the same slice
    # programs, and slicing is what fixes those programs.
    population_slices: int = 1
    # HGQ-LUT-style learned-beta relaxation knobs (learn_beta candidates)
    beta_penalty: float = 0.05    # area-proxy weight in the rung loss
    beta_lr: float = 0.05         # SGD rate on the relaxed bit-widths

    @classmethod
    def smoke(cls) -> "SearchBudget":
        """CI-smoke budget: the whole search in ~a minute per task."""
        return cls(n_candidates=12, rungs=(16,), promote=3, min_frontier=3,
                   max_promote_extra=2, pretrain_steps=30, retrain_steps=60,
                   train_rows=1024, eval_rows=512)


@dataclasses.dataclass(frozen=True)
class Candidate:
    name: str            # human-readable knob description, e.g. "beta+1"
    cfg: AssembleConfig
    # train this candidate with the differentiable bit-width relaxation
    # (quant.beta_bounds); rounded to the integer grid at promotion time
    learn_beta: bool = False


def validate(cfg: AssembleConfig, budget: SearchBudget) -> Optional[str]:
    """Hardware validity of one candidate; returns a reason or None (valid).

    Structural errors are raised by ``AssembleConfig`` itself at
    construction — this checks the *budget* rules on a well-formed config.
    Additive layers are validated in their LOWERED form, so both the branch
    LUTs (in_bits * fan_in) and the combiner (add_bits * add_terms) must
    fit the K budget and the folding cap — the hardware never sees the
    un-lowered layer.
    """
    cfg = assemble_mod.lower_additive(cfg)
    entries = 0
    for l in range(len(cfg.layers)):
        k = cfg.lut_addr_bits(l)
        if k > budget.max_addr_bits:
            return (f"layer {l}: {k} address bits exceeds the "
                    f"K={budget.max_addr_bits} LUT input budget")
        entries += cfg.layers[l].units * (1 << k)
    if entries > budget.max_table_entries:
        return (f"{entries} total table entries exceed the folding cap "
                f"{budget.max_table_entries}")
    return None


def _with_layers(cfg: AssembleConfig, layers) -> AssembleConfig:
    return dataclasses.replace(cfg, layers=tuple(layers))


def _beta_delta(cfg: AssembleConfig, d: int) -> AssembleConfig:
    """Shift every hidden layer's bit-width by ``d`` (logits bits fixed)."""
    last = len(cfg.layers) - 1
    layers = [spec if l == last else
              dataclasses.replace(spec, bits=max(1, min(8, spec.bits + d)))
              for l, spec in enumerate(cfg.layers)]
    return _with_layers(cfg, layers)


def _fan_delta(cfg: AssembleConfig, d: int) -> AssembleConfig:
    """Shift every *mapping* layer's fan-in by ``d`` (assemble layers are
    tied to the previous width and stay put)."""
    layers = []
    prev = cfg.in_features
    for spec in cfg.layers:
        if spec.assemble:
            layers.append(spec)
        else:
            f = max(1, min(prev, spec.fan_in + d))
            layers.append(dataclasses.replace(spec, fan_in=f))
        prev = spec.units
    return _with_layers(cfg, layers)


def _head_scale(cfg: AssembleConfig, num: int, den: int
                ) -> Optional[AssembleConfig]:
    """Scale the first (mapping) layer's unit count by num/den, re-tiling
    the following assemble layer's fan-in — the paper's tree-width knob."""
    if len(cfg.layers) < 2:
        return None
    l0, l1 = cfg.layers[0], cfg.layers[1]
    if l0.assemble or not l1.assemble:
        return None
    if (l0.units * num) % den:
        return None
    u0 = l0.units * num // den
    if u0 < 1 or u0 % l1.units:
        return None
    layers = list(cfg.layers)
    layers[0] = dataclasses.replace(l0, units=u0)
    layers[1] = dataclasses.replace(l1, fan_in=u0 // l1.units)
    return _with_layers(cfg, layers)


def _additive(cfg: AssembleConfig, budget: SearchBudget
              ) -> Optional[AssembleConfig]:
    """First mapping layer -> two summed K-input branches (PolyLUT-Add,
    arXiv 2406.04910): effective fan-in 2F at the cost of a branch layer
    plus a tiny combiner instead of a 2^(b*2F)-entry table."""
    if not cfg.tree_skips:
        return None
    for l, spec in enumerate(cfg.layers):
        if not spec.assemble:
            ab = min(max(spec.bits, 2) + 1,
                     max(budget.max_addr_bits // 2, 1), 6)
            layers = list(cfg.layers)
            layers[l] = dataclasses.replace(spec, add_terms=2, add_bits=ab)
            return _with_layers(cfg, layers)
    return None


def apply_rounded_beta(cfg: AssembleConfig, beta_rounded) -> AssembleConfig:
    """Rewrite the hidden layers' bit-widths from a rounded learned beta
    ([n_layers-1] ints); the logits width stays fixed (it was never
    relaxed)."""
    last = len(cfg.layers) - 1
    layers = [spec if l == last else
              dataclasses.replace(spec, bits=int(beta_rounded[l]))
              for l, spec in enumerate(cfg.layers)]
    return _with_layers(cfg, layers)


def round_and_validate(cfg: AssembleConfig, beta, budget: SearchBudget
                       ) -> Tuple[Optional[AssembleConfig], Optional[str]]:
    """Snap a learned beta onto the integer grid and re-run the hardware
    rules on the resulting config.

    Returns (rounded_cfg, None) when the rounded widths still satisfy the
    K budget and folding cap, else (None, reason).  The driver records the
    reason on the result — a relaxation that drifted somewhere unbuildable
    is an observable rejection, never a silent drop."""
    new_cfg = apply_rounded_beta(cfg, quant.round_beta(beta))
    reason = validate(new_cfg, budget)
    if reason is not None:
        return None, "post-rounding: " + reason
    return new_cfg, None


def generate_candidates(base: AssembleConfig, budget: SearchBudget
                        ) -> Tuple[List[Candidate], List[Tuple[str, str]]]:
    """Enumerate, validate, and dedupe the candidate set around ``base``.

    Returns (candidates, rejected) where ``rejected`` is a list of
    (name, reason) for every variant the validity rules excluded.
    ``base`` itself is always first (it is valid by assumption: it's the
    paper's own design point).
    """
    raw: List[Tuple[str, AssembleConfig, bool]] = [("base", base, False)]

    def add(name: str, cfg: Optional[AssembleConfig],
            learn_beta: bool = False) -> None:
        if cfg is not None:
            raw.append((name, cfg, learn_beta))

    for d in (1, 2, 3):
        if d != base.subnet_depth:
            add(f"depth{d}", dataclasses.replace(base, subnet_depth=d))
    for s in (0, 2):
        if s != base.skip_step:
            add(f"skip{s}", dataclasses.replace(base, skip_step=s))
    for d in (-1, 1):
        add(f"beta{d:+d}", _beta_delta(base, d))
    for d in (-1, 1):
        try:
            add(f"fanin{d:+d}", _fan_delta(base, d))
        except ValueError:
            pass
    for num, den, tag in ((1, 2, "head/2"), (2, 1, "head*2")):
        try:
            add(tag, _head_scale(base, num, den))
        except ValueError:
            pass
    # the wider space: additive wide-input units and the learned-beta
    # relaxation (both imported from PAPERS.md; see module docstring)
    add("add2", _additive(base, budget))
    try:
        add("add2,fanin+1", _additive(_fan_delta(base, 1), budget))
    except ValueError:
        pass
    add("lbeta", base, learn_beta=True)
    try:
        add("lbeta,fanin+1", _fan_delta(base, 1), learn_beta=True)
    except ValueError:
        pass
    # pairwise combinations widen the beta/topology cross-section; they
    # reuse the single-knob transforms so validity is re-checked below
    for bname, bcfg, blb in list(raw[1:]):
        if blb or bname.startswith(("beta", "add2")):
            continue
        for d in (-1, 1):
            try:
                add(f"{bname},beta{d:+d}", _beta_delta(bcfg, d))
            except ValueError:
                pass

    out: List[Candidate] = []
    rejected: List[Tuple[str, str]] = []
    seen = set()
    for name, cfg, learn_beta in raw:
        if (cfg, learn_beta) in seen:
            continue
        seen.add((cfg, learn_beta))
        reason = validate(cfg, budget)
        if reason is not None:
            rejected.append((name, reason))
        elif len(out) < budget.n_candidates:
            out.append(Candidate(name=name, cfg=cfg, learn_beta=learn_beta))
        else:
            rejected.append((name, "over the n_candidates budget"))
    return out, rejected


def shape_signature(cfg: AssembleConfig) -> tuple:
    """Everything that fixes parameter shapes AND the traced program
    structure — candidates with equal signatures differ only in bit-widths
    and train as one stacked group (``lut_trainer.train_population``).
    ``add_terms`` is shape-affecting (branch subnets multiply the unit
    count); ``add_bits`` is bounds-only and deliberately excluded."""
    return (cfg.in_features,
            tuple((l.units, l.fan_in, l.assemble, l.add_terms)
                  for l in cfg.layers),
            cfg.subnet_width, cfg.subnet_depth, cfg.skip_step,
            cfg.tree_skips, cfg.poly_degree, cfg.input_signed)


__all__ = ["SearchBudget", "Candidate", "validate", "generate_candidates",
           "shape_signature", "apply_rounded_beta", "round_and_validate"]
