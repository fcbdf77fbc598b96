"""AdamW and the SGDR / cosine schedules (``repro.train.optim``).

The module's own update rule, not ``torch.optim``: like the reference it
updates *every* float leaf of the parameter tree, the BN running
statistics included (their gradient is zero, so they only decay by
``lr * weight_decay``), counts every float leaf in the global-norm clip, and
leaves integer leaves (learned mappings) alone.  The caller hands over the
leaves in the reference's order (``assemble.leaves``) with their gradients
(None for a leaf without one, which counts as zero).  Updates are in place.

Leaves may be ``DTensor``s (the meshed train step's): the global norm then
sums every shard of every leaf once, as the reference's global leaves do,
and the update runs on each rank's own shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import act_sharding


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """Hyperparameters of AdamW; ``schedule`` maps the step to an lr
    factor."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    schedule: Optional[Callable[[int], float]] = None


class AdamWState(NamedTuple):
    """Step count and the first/second moments, one per leaf (None for an
    integer leaf)."""

    step: int
    m: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    """Zero moments for every float leaf."""
    zeros = [torch.zeros_like(p, dtype=torch.float32) if _is_float(p)
             else None for p in params]
    return AdamWState(step=0, m=zeros,
                      v=[None if z is None else z.clone() for z in zeros])


def global_norm(tensors: Sequence[Optional[torch.Tensor]], *,
                population: int = 0) -> torch.Tensor:
    """``sqrt(sum of squares)`` over the float tensors, in float32; with
    ``population=P`` one norm per candidate ``[P]``, each tensor's leading
    axis holding the candidates' blocks in order."""
    if population:
        sq = [torch.sum(torch.square(t.to(torch.float32).reshape(
            population, -1)), dim=1)
            for t in tensors if t is not None and _is_float(t)]
        return torch.sqrt(torch.sum(torch.stack(sq), dim=0))
    sq = [act_sharding.full(torch.sum(torch.square(t.to(torch.float32))))
          for t in tensors if t is not None and _is_float(t)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Sequence[torch.Tensor],
                 grads: Sequence[Optional[torch.Tensor]],
                 state: AdamWState, *,
                 population: int = 0) -> Tuple[AdamWState, dict]:
    """One AdamW step on ``params`` in place; returns the new state and
    ``{"grad_norm", "lr"}`` (tensors on the parameters' device).

    ``population=P`` steps a stacked population (``assemble.
    stack_population``) as the reference's ``vmap`` of this update does:
    the gradient is clipped by each candidate's own global norm, never by
    the group's, so one candidate's gradient does not scale another's.
    Every candidate steps every time, so one step count serves them all."""
    step = state.step + 1
    grads = [None if not _is_float(p) else
             (torch.zeros_like(p) if g is None else g)
             for p, g in zip(params, grads)]
    gnorm = global_norm(grads, population=population)
    scale = torch.ones_like(gnorm)
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = np.float32(cfg.lr)
    if cfg.schedule is not None:
        lr = lr * np.float32(cfg.schedule(step))
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    lr = float(lr)
    for p, g, m, v in zip(params, grads, state.m, state.v):
        if g is None:
            continue
        p, g, m, v = (act_sharding.local(t) for t in (p, g, m, v))
        g = g.to(torch.float32)
        g = (g.reshape(population, -1) * scale[:, None]).view_as(g) \
            if population else g * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        p.copy_((p32 - lr * (delta + cfg.weight_decay * p32)).to(p.dtype))
    return (AdamWState(step=step, m=state.m, v=state.v),
            {"grad_norm": gnorm, "lr": lr})


def sgdr_schedule(t0: int, t_mult: int = 2, lr_min_frac: float = 0.01,
                  warmup: int = 0) -> Callable[[int], float]:
    """Cosine annealing with warm restarts: step -> lr factor in
    ``[lr_min_frac, 1]``; the first period is ``t0`` steps, each next one
    ``t_mult`` times longer."""
    starts = [0]
    length = t0
    for _ in range(24):
        starts.append(starts[-1] + length)
        length *= t_mult
    starts_arr = np.asarray(starts, np.float32)

    def schedule(step: int) -> float:
        s = np.float32(step)
        idx = int(np.sum(starts_arr <= s)) - 1
        period = np.float32(t0) * np.float32(t_mult) ** np.float32(idx)
        frac = np.clip((s - starts_arr[idx]) / max(period, np.float32(1.0)),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(lr_min_frac) + np.float32(1 - lr_min_frac) \
            * np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi)
                                                        * frac))
        if warmup > 0:
            cos = cos * min(np.float32(1.0), s / np.float32(warmup))
        return float(np.float32(cos))

    return schedule


def cosine_schedule(total_steps: int, warmup: int = 0,
                    lr_min_frac: float = 0.1) -> Callable[[int], float]:
    """One cosine decay over ``total_steps`` to ``lr_min_frac``."""
    def schedule(step: int) -> float:
        s = np.float32(step)
        frac = np.clip(s / np.float32(total_steps), np.float32(0.0),
                       np.float32(1.0))
        cos = np.float32(lr_min_frac) + np.float32(1 - lr_min_frac) \
            * np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi)
                                                        * frac))
        if warmup > 0:
            cos = cos * min(np.float32(1.0), s / np.float32(warmup))
        return float(np.float32(cos))
    return schedule
