"""Step builders (``repro.launch.steps``): the shapes of the cells, model
init, and the train, prefill and decode steps; :class:`StateCodec` gives
the training state the reference's checkpoint trees.

The distribution half builds a (architecture x shape x mesh) cell: the
abstract arguments (meta tensors: no storage), their spec trees
(``dist.sharding``), and :func:`build_cell`'s step over ``DTensor``
arguments.  A meshed step runs the model on each rank's local tensors,
its slice of the batch over the data-parallel axes, tensor parallel
(``lm.tp_view``, every family): each block computes on this rank's weight
shards over ``model``, with its own q heads (``tp``; ``tp (q whole)``
where the heads do not split evenly, see :func:`design`), the residual
sharded on ``embed``, the head and the loss on its vocabulary columns.

Gradients come back reduced over the data-parallel axes (and, for a
replicated leaf, over ``model``) and placed as their parameters, and
AdamW steps each rank's shards (:func:`make_mesh_train_step`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.dist import act_sharding, sharding as shd
from repro_torch.dist.sharding import Spec
from repro_torch.models import attention, lm, whisper
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


def make_loss_parts(cfg: ArchConfig):
    """``parts(params, batch) -> (loss, count, aux)``: the chunked
    cross-entropy of ``batch["labels"]`` (``loss``, the mean over ``count``
    tokens) and the MoE aux loss (0 for other families).  ``batch`` holds
    int ``tokens`` and ``labels [B, S]`` on the model's device (whisper:
    ``audio_embed [B, S_enc, D]`` too)."""
    def parts(params, batch):
        if cfg.is_enc_dec:
            hidden, aux = whisper.forward_train(
                params, cfg, batch["audio_embed"], batch["tokens"])
        else:
            hidden, aux = lm.forward_train(params, cfg, batch["tokens"])
        head = lm.head_matrix(params, cfg)
        loss, count = losses.chunked_cross_entropy(
            hidden, head, batch["labels"], vocab=cfg.vocab,
            chunk=cfg.loss_chunk, vocab_start=act_sharding.vocab_start(
                cfg.padded_vocab, head.shape[-1]))
        return loss, count, aux
    return parts


def make_loss_fn(cfg: ArchConfig, *, aux_weight: float = 0.01):
    """``loss(params, batch) -> (total, loss, count)``: the chunked
    cross-entropy (``loss``, over ``count`` tokens) plus ``aux_weight``
    times the MoE aux loss (``total``); see :func:`make_loss_parts`."""
    parts = make_loss_parts(cfg)

    def loss_fn(params, batch):
        loss, count, aux = parts(params, batch)
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
    place.  Sharded (``DTensor``) leaves are written whole (gathering is a
    collective: every rank calls :meth:`to_tree`) and restored as each
    rank's chunk, so a checkpoint does not depend on the mesh."""

    def to_tree(self, params: nn.Module, opt_state: optim.AdamWState) -> Any:
        """The reference's (params, AdamW state) tree of tensors."""
        meta = [(path, layer) for path, layer, _ in lm.leaves(params)]

        def nest(ts):
            return lm.nest(meta, [shd.full(t.detach()) for t in ts],
                           torch.stack)
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

        def put(dst, value):
            shd.local(dst).copy_(shd.local_like(value, dst))

        for i, (path, layer, p) in enumerate(lm.leaves(params)):
            put(p, at(p_tree, path, layer))
            put(opt_state.m[i], at(o_tree.m, path, layer))
            put(opt_state.v[i], at(o_tree.v, path, layer))
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


# ---------------------------------------------------------------------------
# distribution: abstract arguments, spec trees, meshed steps, cells
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig, *, serve: bool = False) -> nn.Module:
    """``cfg``'s parameters on the meta device (no storage): f32, or bf16
    throughout for serving (deployments load bf16 weights)."""
    model = shd.abstract_model(cfg)
    return model.to(torch.bfloat16) if serve else model


# AdamW state of meta parameters is meta: the reference's name
abstract_opt_state = opt_init


param_spec_tree = shd.param_specs


def opt_spec_tree(cfg: ArchConfig, pspecs: Any) -> optim.AdamWState:
    """AdamW state specs: the moments as the parameters, the step
    replicated."""
    return optim.AdamWState(step=Spec(), m=pspecs, v=pspecs)


def batch_structs(cfg: ArchConfig, shape: ShapeSpec
                  ) -> Dict[str, torch.Tensor]:
    """A train batch of ``shape`` on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    out = {"tokens": torch.empty((b, s), dtype=torch.int64, device=meta),
           "labels": torch.empty((b, s), dtype=torch.int64, device=meta)}
    if cfg.is_enc_dec:
        out["audio_embed"] = torch.empty((b, s, cfg.d_model), device=meta)
    return out


def batch_specs(cfg: ArchConfig, mesh) -> Dict[str, Spec]:
    """Batch rows over the data-parallel axes."""
    dp = shd.dp_axes(mesh)
    out = {"tokens": Spec(dp, None), "labels": Spec(dp, None)}
    if cfg.is_enc_dec:
        out["audio_embed"] = Spec(dp, None, None)
    return out


abstract_cache = shd.abstract_cache


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta stand-ins for every model input of the cell."""
    if shape.kind == "train":
        return batch_structs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind == "prefill":
        out = {"tokens": torch.empty((b, s), dtype=torch.int64, device=meta)}
        if cfg.is_enc_dec:
            out["audio_embed"] = torch.empty((b, s, cfg.d_model),
                                             device=meta)
        return out
    return {"tokens": torch.empty((b, 1), dtype=torch.int64, device=meta),
            "cache": abstract_cache(cfg, b, s)}


cache_spec_tree = shd.cache_specs


def _with_rules(fn, mesh):
    """``fn`` with the activation rules of ``mesh`` active while it runs."""
    def wrapped(*args, **kw):
        with act_sharding.activation_rules(mesh):
            return fn(*args, **kw)
    wrapped.__wrapped__ = fn
    return wrapped


def design(cfg: ArchConfig, mesh) -> str:
    """How a meshed step of ``cfg`` computes over ``model``: ``tp`` (each
    rank its weight shards and its own q heads: RWKV's heads of its time
    mix) or ``tp (q whole)`` (the same, q gathered whole: ``wq`` is not
    split, or its heads do not split evenly, see
    ``attention.local_heads``)."""
    size = act_sharding.axis_sizes(mesh).get("model", 1)
    if cfg.family == "ssm":     # RWKV: wr [d, d], heads of d / n_heads
        split = shd.is_sharded((cfg.d_model, cfg.d_model))
        local = cfg.n_heads % size == 0
    else:
        spec = lm.attn_spec(cfg)
        split = shd.is_sharded((cfg.d_model, spec.n_heads * spec.head_dim))
        local = attention.local_heads(spec, size)
    if size == 1 or (split and local):
        return "tp"
    return "tp (q whole)"


def _dp_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the data-parallel axes of ``mesh``."""
    from torch.distributed import _functional_collectives as funcol
    for a in shd.dp_axes(mesh):
        if act_sharding.axis_sizes(mesh)[a] > 1:
            t = funcol.wait_tensor(funcol.all_reduce(
                t, "sum", mesh.get_group(a)))
    return t


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """A global batch (the same on every rank) as ``DTensor``s whose rows
    are split over the data-parallel axes, each rank keeping its own."""
    dp = shd.dp_axes(mesh)
    return {k: shd.distribute(v, mesh, Spec(dp, *([None] * (v.dim() - 1))))
            for k, v in batch.items()}


def make_mesh_train_step(cfg: ArchConfig, mesh, *,
                         opt_cfg: Optional[optim.AdamWConfig] = None,
                         aux_weight: float = 0.01):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``mesh``: ``params`` and the AdamW moments are ``DTensor``s placed
    by the sharding rules (:func:`shd.distribute_params`), the batch
    ``DTensor``s split over the data-parallel axes (:func:`shard_batch`).

    Each rank computes the loss of its rows through ``lm.tp_view``: on
    its weight shards, the head's vocabulary columns and the loss reduced
    over ``model``.  Its objective is its share of the global one (its
    token sum over the global count, its rows' aux mean over the global
    rows), so the gradients summed over the data-parallel axes (and over
    ``model`` for a replicated leaf, where each rank's part is its heads'
    and columns') are those of the unmeshed step: a sharded leaf's come
    back already placed on its shards.  Metrics are the global ``loss``,
    ``total_loss``, ``tokens``, ``grad_norm`` and ``lr``, the same on every
    rank.  Parameters update in place."""
    ocfg = opt_cfg or optim.AdamWConfig(lr=3e-4, weight_decay=0.1)
    parts = make_loss_parts(cfg)

    def train_step(params, opt_state, batch):
        local = {k: shd.local(v) for k, v in batch.items()}
        leaves = train_leaves(lm.trainable(params))
        rows_l = torch.tensor(float(local["tokens"].shape[0]),
                              device=local["tokens"].device)
        with act_sharding.activation_rules(mesh), torch.enable_grad():
            loss_l, count_l, aux_l = parts(lm.tp_view(params), local)
            count = _dp_sum(count_l.detach(), mesh)
            rows = _dp_sum(rows_l, mesh)
            objective = loss_l * (count_l / count) \
                + aux_weight * aux_l * (rows_l / rows)
            grads = torch.autograd.grad(objective, leaves, allow_unused=True)
        grads = [None if g is None else
                 g.redistribute(p.device_mesh, p.placements)
                 for p, g in zip(leaves, grads)]
        loss = _dp_sum(loss_l.detach() * count_l, mesh) / count
        aux = _dp_sum(aux_l.detach() * rows_l, mesh) / rows
        opt_state, om = optim.adamw_update(ocfg, leaves, grads, opt_state)
        metrics = {"loss": loss, "total_loss": loss + aux_weight * aux,
                   "tokens": count, **om}
        return params, opt_state, metrics

    return train_step


def _batch_dim(cfg: ArchConfig, key: str) -> Optional[int]:
    """The batch axis of a step input or output (``None``: no batch)."""
    if key in ("pos", "slot_pos"):
        return None if cfg.is_enc_dec else 0
    if key in ("tokens", "labels", "audio_embed", "logits"):
        return 0
    return 1


def _compute_placements(mesh, dim: Optional[int], split: bool) -> List:
    from torch.distributed.tensor import Replicate, Shard
    dp = shd.dp_axes(mesh)
    return [Shard(dim) if split and dim is not None and a in dp
            else Replicate() for a in act_sharding.axis_names(mesh)]


def _to_compute(t: torch.Tensor, mesh, dim: Optional[int],
                split: bool) -> torch.Tensor:
    """This rank's rows of a ``DTensor`` input (all rows when the batch is
    not split)."""
    return t.redistribute(mesh, _compute_placements(mesh, dim, split)) \
        .to_local()


def _from_compute(t: torch.Tensor, mesh, dim: Optional[int], split: bool,
                  spec: Spec, whole: Optional[Tuple[int, ...]] = None):
    """A rank's output rows as the ``DTensor`` the cell's ``spec`` asks.
    ``whole``: the global shape of a tensor whose last dim ``t`` holds
    this rank's piece of over ``model`` (tensor-parallel logits; ``t``'s
    own shape but the batch otherwise)."""
    from torch.distributed.tensor import DTensor, Shard
    pl = _compute_placements(mesh, dim, split)
    if whole is None:
        d = DTensor.from_local(t, mesh, pl, run_check=False)
    else:
        model = act_sharding.axis_names(mesh).index("model")
        pl[model] = Shard(t.dim() - 1)
        d = DTensor.from_local(t, mesh, pl, run_check=False, shape=whole,
                               stride=torch.empty(whole,
                                                  device="meta").stride())
    return d.redistribute(mesh, shd.placements(mesh, spec))


def _serve_step(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """The prefill or decode step of a cell over ``DTensor`` arguments:
    each rank runs its rows (every row when the batch does not divide the
    data-parallel axes) through ``lm.tp_view``, the outputs placed as the
    reference's out shardings (logits ``(dp, model)``: a tensor-parallel
    step's come out as this rank's vocabulary columns; the cache by its
    specs, k and v whole on every rank of ``model``)."""
    b = shape.global_batch
    split = shd.batch_divides(mesh, b)
    dp = shd.dp_axes(mesh)
    cspecs = cache_spec_tree(cfg, mesh, b)
    logits_spec = Spec(dp if split else None, "model")

    def outputs(logits, cache):
        whole = None
        if logits.shape[-1] != cfg.padded_vocab:
            whole = (b, cfg.padded_vocab)
        return (_from_compute(logits, mesh, 0, split, logits_spec, whole),
                {k: _from_compute(v, mesh, _batch_dim(cfg, k), split,
                                  cspecs[k]) for k, v in cache.items()})

    if shape.kind == "prefill":
        step = make_prefill_step(cfg, shape.seq_len)

        def prefill(params, tokens, *audio):
            ins = [_to_compute(t, mesh, 0, split) for t in (tokens, *audio)]
            return outputs(*step(lm.tp_view(params), *ins))
        return prefill
    step = make_decode_step(cfg)

    def decode(params, cache, tokens):
        local = {k: _to_compute(v, mesh, _batch_dim(cfg, k), split)
                 for k, v in cache.items()}
        return outputs(*step(lm.tp_view(params), local,
                             _to_compute(tokens, mesh, 0, split)))
    return decode


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               opt_cfg: Optional[optim.AdamWConfig] = None):
    """``(step, args)`` of one (arch x shape x mesh) cell: the step runs
    under ``mesh``'s activation rules on ``DTensor`` arguments placed as
    the reference's in-shardings, and ``args`` are those arguments on the
    meta device (parameters f32 for training, bf16 for serving; the decode
    token spec falls back to replicated when the batch does not divide).
    Real arguments of the same placements run the same step
    (:func:`shd.distribute_params`, :func:`opt_init`, :func:`shard_batch`);
    ``opt_cfg`` is the train step's AdamW (the reference's default
    otherwise)."""
    params = shd.distribute_params(
        abstract_params(cfg, serve=shape.kind != "train"), mesh)
    dp = shd.dp_axes(mesh)
    b = shape.global_batch
    if shape.kind == "train":
        fn = _with_rules(make_mesh_train_step(cfg, mesh, opt_cfg=opt_cfg),
                         mesh)
        return fn, (params, opt_init(params),
                    shard_batch(batch_structs(cfg, shape), mesh))
    fn = _with_rules(_serve_step(cfg, shape, mesh), mesh)
    split = shd.batch_divides(mesh, b)
    if shape.kind == "prefill":
        ins = input_specs(cfg, shape)
        args = [shd.distribute(ins["tokens"], mesh, Spec(dp, None))]
        if cfg.is_enc_dec:
            args.append(shd.distribute(ins["audio_embed"], mesh,
                                       Spec(dp, None, None)))
        return fn, (params, *args)
    cspecs = cache_spec_tree(cfg, mesh, b)
    cache = {k: shd.distribute(v, mesh, cspecs[k])
             for k, v in abstract_cache(cfg, b, shape.seq_len).items()}
    tok = torch.empty((b, 1), dtype=torch.int64, device="meta")
    tok_spec = Spec(dp, None) if split else Spec(None, None)
    return fn, (params, cache, shd.distribute(tok, mesh, tok_spec))
