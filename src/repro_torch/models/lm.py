"""The causal LM (``repro.models.lm``) for the ``dense`` and ``vlm``
families: prefill (through the flash kernel K5), ring-cache decode, and the
training forward (forward only).

Parameters live in f32 in an :class:`LM` module, one :class:`Block` per
layer; a Python loop over the blocks takes the place of the reference's
``lax.scan`` over stacked ``[L, ...]`` leaves.  The reference casts the
blocks to the compute type on every call; the port makes that copy once
(:func:`compute_copy`, done when a serving engine is built), and every
function also accepts the f32 module and casts at use, with the same
numbers.  ``moe``, ``ssm``, ``hybrid`` and ``audio`` are not ported yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models import attention, ffn, layers
from repro_torch.models.attention import AttnSpec, KVCache
from repro_torch.models.config import ArchConfig

PORTED_FAMILIES = ("dense", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (the "
            f"port runs {', '.join(PORTED_FAMILIES)})")


# ---------------------------------------------------------------------------
# spec builders
# ---------------------------------------------------------------------------

def attn_spec(cfg: ArchConfig, *, causal: bool = True) -> AttnSpec:
    """The attention spec of ``cfg``."""
    return AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        causal=causal, window=cfg.window, rope_theta=cfg.rope_theta)


def ffn_spec(cfg: ArchConfig) -> ffn.FFNSpec:
    """The feed-forward spec of ``cfg``."""
    return ffn.FFNSpec(d_model=cfg.d_model, d_ff=cfg.d_ff, act=cfg.act,
                       gated=cfg.gated_ffn)


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The working type of ``cfg`` (bf16 or f32)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One transformer layer: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, ln1: torch.Tensor, attn: attention.Attention,
                 ln2: torch.Tensor, ffn_: ffn.FFN):
        """Hold the given norms and submodules."""
        super().__init__()
        self.ln1, self.ln2 = _param(ln1), _param(ln2)
        self.attn, self.ffn = attn, ffn_


class LM(nn.Module):
    """The model: ``embed [padded_vocab, d]``, the blocks, ``final_norm``
    and, unless the embeddings are tied, ``lm_head [d, padded_vocab]``."""

    def __init__(self, embed: torch.Tensor, blocks: List[Block],
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        """Hold the given tensors and blocks."""
        super().__init__()
        self.embed = _param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random f32 weights drawn from ``generator`` on ``device`` (CUDA by
    default; the generator must live there).  The reference's init rules;
    its numbers differ (``jax.random`` is not ``torch.Generator``)."""
    _check_family(cfg)
    dev = _device.resolve(device)
    vp, d = cfg.padded_vocab, cfg.d_model
    embed = torch.empty((vp, d), device=dev).normal_(generator=generator)
    embed.mul_(0.02)
    lm_head = None if cfg.tie_embeddings else layers.he_init(
        generator, (d, vp), device=dev)
    blocks = [Block(torch.ones(d, device=dev),
                    attention.init_attention(generator, attn_spec(cfg),
                                             device=dev),
                    torch.ones(d, device=dev),
                    ffn.init_ffn(generator, ffn_spec(cfg), device=dev))
              for _ in range(cfg.n_layers)]
    return LM(embed, blocks, torch.ones(d, device=dev), lm_head)


def _rebuild(cfg: ArchConfig, get: Callable[[str], torch.Tensor], device,
             dtype: torch.dtype) -> LM:
    """An :class:`LM` on ``device`` whose tensor at each parameter path
    (``"embed"``, ``"blocks.3.attn.wq"``, ...) is ``get(path)`` cast to
    ``dtype``; ``final_norm`` stays f32, as the reference never casts it."""
    def fill(module: nn.Module, prefix: str) -> nn.Module:
        for name, p in module.named_parameters():
            p.copy_(get(f"{prefix}.{name}"))
        return module

    def t(path: str, dt=dtype) -> torch.Tensor:
        return get(path).to(device=device, dtype=dt)

    blocks = [Block(t(f"blocks.{l}.ln1"),
                    fill(attention.Attention(attn_spec(cfg), device=device,
                                             dtype=dtype), f"blocks.{l}.attn"),
                    t(f"blocks.{l}.ln2"),
                    fill(ffn.FFN(ffn_spec(cfg), device=device, dtype=dtype),
                         f"blocks.{l}.ffn"))
              for l in range(cfg.n_layers)]
    return LM(t("embed"), blocks, t("final_norm", torch.float32),
              None if cfg.tie_embeddings else t("lm_head"))


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


@torch.no_grad()
def compute_copy(model: LM, cfg: ArchConfig, device=None) -> LM:
    """``model`` with its blocks, embeddings and head in the compute type on
    ``device`` (the model's own by default): the copy the reference makes
    on every call (``_cast_blocks`` and the head's cast), made once.  The
    model itself when nothing changes."""
    dt = compute_dtype(cfg)
    dev = model.embed.device if device is None else torch.device(device)
    if model.embed.dtype == dt and _same_device(dev, model.embed.device):
        return model
    return _rebuild(cfg, model.get_parameter, dev, dt)


def params_to_reference(model: LM) -> dict:
    """The reference's parameter pytree as numpy f32 arrays, per-layer
    leaves stacked on a leading ``[L]`` axis."""
    def np_(t):
        return t.detach().float().cpu().numpy()

    tree: Dict = {"embed": np_(model.embed),
                  "final_norm": np_(model.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = np_(model.lm_head)
    blocks: Dict = {"attn": {}, "ffn": {}}
    for name, _ in model.blocks[0].named_parameters():
        stacked = np.stack([np_(b.get_parameter(name)) for b in model.blocks])
        if "." in name:
            sub, leaf = name.split(".")
            blocks[sub][leaf] = stacked
        else:
            blocks[name] = stacked
    tree["blocks"] = blocks
    return tree


@torch.no_grad()
def params_from_reference(tree: dict, cfg: ArchConfig, device=None) -> LM:
    """An f32 :class:`LM` on ``device`` (CUDA by default) from the
    reference's parameter pytree (nested dicts of arrays, per-layer leaves
    stacked ``[L, ...]``)."""
    _check_family(cfg)
    dev = _device.resolve(device)

    def get(path: str) -> torch.Tensor:
        parts = path.split(".")
        if parts[0] != "blocks":
            return torch.from_numpy(np.array(tree[path], np.float32))
        node = tree["blocks"]
        for key in parts[2:]:
            node = node[key]
        return torch.from_numpy(np.array(node[int(parts[1])], np.float32))

    return _rebuild(cfg, get, dev, torch.float32)


# ---------------------------------------------------------------------------
# blocks, embeddings, head
# ---------------------------------------------------------------------------

def _norm(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # block norms are cast to the working type first, as the reference's
    # _cast_blocks does before its layer scan
    return layers.rms_norm(x, w.to(x.dtype), plus_one=cfg.norm_plus_one)


def _block_train(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                 positions: range, freqs: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, x, blk.ln1)
    x = x + attention.attention_train(blk.attn, attn_spec(cfg), h, positions,
                                      freqs)
    return x + ffn.apply_ffn(blk.ffn, ffn_spec(cfg), _norm(cfg, x, blk.ln2))


def _block_prefill(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                   positions: range, freqs: torch.Tensor, context: int
                   ) -> Tuple[torch.Tensor, KVCache]:
    h = _norm(cfg, x, blk.ln1)
    attn_out, kv = attention.attention_prefill(blk.attn, attn_spec(cfg), h,
                                               positions, freqs, context)
    x = x + attn_out
    x = x + ffn.apply_ffn(blk.ffn, ffn_spec(cfg), _norm(cfg, x, blk.ln2))
    return x, kv


def _block_decode(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                  pos: torch.Tensor, freqs: torch.Tensor, kv: KVCache,
                  slot_pos: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    h = _norm(cfg, x, blk.ln1)
    attn_out, kv_new = attention.attention_decode(
        blk.attn, attn_spec(cfg), h, pos, freqs, kv, slot_pos)
    x = x + attn_out
    x = x + ffn.apply_ffn(blk.ffn, ffn_spec(cfg), _norm(cfg, x, blk.ln2))
    return x, kv_new


def _embed(model: LM, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    return layers.embed_lookup(model.embed, tokens, dtype=compute_dtype(cfg),
                               scale=scale)


def final_hidden(model: LM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm of hidden states ``x``."""
    return layers.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)


def logits_at(model: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """h ``[..., D]`` -> ``[..., padded_vocab]`` f32 logits, the padded
    entries at -1e30."""
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (h @ head.to(compute_dtype(cfg))).float()
    if cfg.padded_vocab != cfg.vocab:
        mask = torch.zeros(cfg.padded_vocab, device=logits.device)
        mask[cfg.vocab:] = -1e30
        logits = logits + mask
    return logits


def _freqs(cfg: ArchConfig, device) -> torch.Tensor:
    return layers.rope_freqs(cfg.head_dim_, cfg.rope_theta, device=device)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward_train(model: LM, cfg: ArchConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (final hidden ``[B, S, D]``, aux loss 0).
    Forward only: K5 has no backward in this port yet."""
    _check_family(cfg)
    x = _embed(model, cfg, tokens)
    positions = range(tokens.shape[1])
    freqs = _freqs(cfg, tokens.device)
    for blk in model.blocks:
        x = _block_train(cfg, blk, x, positions, freqs)
    return final_hidden(model, cfg, x), torch.zeros((), device=x.device)


def init_decode_cache(model: LM, cfg: ArchConfig, batch: int,
                      context: int) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache on the model's device: per-row ``pos [B]`` and
    ``slot_pos [B, W]`` (-1: empty slot), ``kv_k``/``kv_v [L, B, Hkv, W,
    hd]`` in the compute type."""
    _check_family(cfg)
    dev = model.embed.device
    w = attention.cache_length(attn_spec(cfg), context)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, w, cfg.head_dim_)
    dt = compute_dtype(cfg)
    return {"pos": torch.zeros(batch, dtype=torch.int32, device=dev),
            "kv_k": torch.zeros(shape, dtype=dt, device=dev),
            "kv_v": torch.zeros(shape, dtype=dt, device=dev),
            "slot_pos": torch.full((batch, w), -1, dtype=torch.int32,
                                   device=dev)}


@torch.inference_mode()
def prefill(model: LM, cfg: ArchConfig, tokens: torch.Tensor, context: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens ``[B, S]`` -> (last-token logits ``[B, padded_vocab]``, decode
    cache).  Each layer's attention is one K5 launch on the card."""
    _check_family(cfg)
    b, s = tokens.shape
    x = _embed(model, cfg, tokens)
    positions = range(s)
    freqs = _freqs(cfg, tokens.device)
    ks, vs = [], []
    for blk in model.blocks:
        x, kv = _block_prefill(cfg, blk, x, positions, freqs, context)
        ks.append(kv.k)
        vs.append(kv.v)
    w = attention.cache_length(attn_spec(cfg), context)
    cache = {"pos": torch.full((b,), s, dtype=torch.int32,
                               device=tokens.device),
             "kv_k": torch.stack(ks), "kv_v": torch.stack(vs),
             "slot_pos": attention.cache_positions(
                 s, w, device=tokens.device).repeat(b, 1)}
    return logits_at(model, cfg, final_hidden(model, cfg, x[:, -1])), cache


@torch.inference_mode()
def decode_step(model: LM, cfg: ArchConfig, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens ``[B, 1]`` -> (logits ``[B, padded_vocab]``, a new cache).
    ``cache["pos"]`` is ``[B]``: every row decodes at its own position."""
    _check_family(cfg)
    pos = cache["pos"]
    x = _embed(model, cfg, tokens)
    freqs = _freqs(cfg, tokens.device)
    w = cache["kv_k"].shape[3]
    # per-row ring-slot update: row b stamps its own slot pos[b] % w
    hit = (torch.arange(w, dtype=torch.int32, device=pos.device)[None, :]
           == (pos % w)[:, None])
    slot_pos = torch.where(hit, pos[:, None], cache["slot_pos"])
    ks, vs = [], []
    for l, blk in enumerate(model.blocks):
        x, kv = _block_decode(cfg, blk, x, pos, freqs,
                              KVCache(cache["kv_k"][l], cache["kv_v"][l]),
                              slot_pos)
        ks.append(kv.k)
        vs.append(kv.v)
    new_cache = dict(cache, kv_k=torch.stack(ks), kv_v=torch.stack(vs),
                     slot_pos=slot_pos, pos=pos + 1)
    return logits_at(model, cfg, final_hidden(model, cfg, x[:, -1])), \
        new_cache
