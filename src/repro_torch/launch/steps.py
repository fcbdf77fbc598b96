"""Step builders (``repro.launch.steps``, the half that runs on one device):
the shapes of the cells, model init, and the train, prefill and decode
steps; :class:`StateCodec` gives the training state the reference's
checkpoint trees.

The reference also builds abstract argument trees, sharding specs and a
jitted cell for its dry run (``abstract_*``, ``*_spec_tree``,
``build_cell``); they come with the distribution slice (ROADMAP A.14d).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import lm, whisper
from repro_torch.models.config import ArchConfig
from repro_torch.train import losses, optim


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input shape of a cell: sequence, global batch, kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (cfg, shape) is a cell (DESIGN.md §5 skip table), and why
    not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode reserved for "
                       "sub-quadratic archs (SWA/SSM/hybrid)")
    return True, ""


def init_fn(cfg: ArchConfig):
    """``init(generator, device=None)`` -> f32 random weights of ``cfg``
    (whisper's or the LM's), on CUDA unless ``device`` says else."""
    mod = whisper if cfg.is_enc_dec else lm

    def init(generator: torch.Generator, device=None) -> nn.Module:
        return mod.init_params(cfg, generator, device)
    return init


def train_leaves(params: nn.Module) -> List[nn.Parameter]:
    """The parameters in the reference's tree order (``lm.leaves``): the
    order the optimizer's state and global norm follow."""
    return [p for _, _, p in lm.leaves(params)]


def opt_init(params: nn.Module) -> optim.AdamWState:
    """Zero AdamW state for :func:`train_leaves`."""
    return optim.adamw_init(train_leaves(params))


def make_loss_fn(cfg: ArchConfig, *, aux_weight: float = 0.01):
    """``loss(params, batch) -> (total, loss, count)``: the chunked
    cross-entropy of ``batch["labels"]`` (``loss``, over ``count`` tokens)
    plus ``aux_weight`` times the MoE aux loss (``total``).  ``batch``
    holds int ``tokens`` and ``labels [B, S]`` on the model's device
    (whisper: ``audio_embed [B, S_enc, D]`` too)."""
    def loss_fn(params, batch):
        if cfg.is_enc_dec:
            hidden, aux = whisper.forward_train(
                params, cfg, batch["audio_embed"], batch["tokens"])
            head = params.lm_head
        else:
            hidden, aux = lm.forward_train(params, cfg, batch["tokens"])
            head = lm.head_matrix(params, cfg)
        loss, count = losses.chunked_cross_entropy(
            hidden, head, batch["labels"], vocab=cfg.vocab,
            chunk=cfg.loss_chunk)
        return loss + aux_weight * aux, loss, count
    return loss_fn


def value_and_grad(loss_fn, params: nn.Module, batch: Dict[str, Any]):
    """``((total, loss, count), grads)``: ``loss_fn``'s value and the
    gradient of ``total`` with respect to :func:`train_leaves` (None for a
    leaf the loss does not reach); makes ``params`` trainable."""
    leaves = train_leaves(lm.trainable(params))
    with torch.enable_grad():
        total, loss, count = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return (total.detach(), loss.detach(), count), grads


def make_train_step(cfg: ArchConfig, *,
                    opt_cfg: Optional[optim.AdamWConfig] = None,
                    aux_weight: float = 0.01):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    :func:`make_loss_fn`'s loss, its gradient with respect to the f32
    masters (:func:`value_and_grad`), and one AdamW update in place.
    Metrics: ``loss``, ``total_loss``, ``tokens``, ``grad_norm``, ``lr``."""
    ocfg = opt_cfg or optim.AdamWConfig(lr=3e-4, weight_decay=0.1)
    loss_fn = make_loss_fn(cfg, aux_weight=aux_weight)

    def train_step(params, opt_state, batch):
        (total, loss, count), grads = value_and_grad(loss_fn, params, batch)
        opt_state, om = optim.adamw_update(ocfg, train_leaves(params), grads,
                                           opt_state)
        metrics = {"loss": loss, "total_loss": total, "tokens": count, **om}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, context: int):
    """``prefill(params, tokens[, audio_embed]) -> (logits, cache)``."""
    if cfg.is_enc_dec:
        def prefill_step(params, tokens, audio_embed):
            return whisper.prefill(params, cfg, audio_embed, tokens, context)
    else:
        def prefill_step(params, tokens):
            return lm.prefill(params, cfg, tokens, context)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode(params, cache, tokens) -> (logits, cache)``."""
    mod = whisper if cfg.is_enc_dec else lm

    def decode_step(params, cache, tokens):
        return mod.decode_step(params, cfg, cache, tokens)
    return decode_step


class StateCodec:
    """(model, AdamW state) as the reference's checkpoint tree and back:
    ``(params, AdamWState(step, m, v))`` with per-layer leaves stacked
    ``[L, ...]`` (keys ``0/embed``, ``0/blocks/attn/wq``, ``1/.step``,
    ``1/.m/embed``, ...), so that either package restores the other's
    checkpoint.  Restoring copies into the model and the moments in
    place."""

    def to_tree(self, params: nn.Module, opt_state: optim.AdamWState) -> Any:
        """The reference's (params, AdamW state) tree of tensors."""
        meta = [(path, layer) for path, layer, _ in lm.leaves(params)]

        def nest(ts):
            return lm.nest(meta, [t.detach() for t in ts], torch.stack)
        return (nest(train_leaves(params)),
                optim.AdamWState(step=np.int32(opt_state.step),
                                 m=nest(opt_state.m), v=nest(opt_state.v)))

    @torch.no_grad()
    def from_tree(self, tree: Any, params: nn.Module,
                  opt_state: optim.AdamWState
                  ) -> Tuple[nn.Module, optim.AdamWState]:
        """``params`` and ``opt_state`` holding ``tree``'s values."""
        p_tree, o_tree = tree

        def at(node, path, layer):
            for key in path:
                node = node[key]
            return node if layer is None else node[layer]

        for i, (path, layer, p) in enumerate(lm.leaves(params)):
            p.copy_(at(p_tree, path, layer))
            opt_state.m[i].copy_(at(o_tree.m, path, layer))
            opt_state.v[i].copy_(at(o_tree.v, path, layer))
        return params, optim.AdamWState(step=int(o_tree.step), m=opt_state.m,
                                        v=opt_state.v)


def batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy or tensors) as tensors on ``device``: int token
    arrays as int64, float arrays as f32."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        out[k] = t.to(device, torch.float32 if t.is_floating_point()
                      else torch.int64)
    return out
