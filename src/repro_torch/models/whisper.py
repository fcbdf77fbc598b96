"""Whisper's encoder-decoder backbone, the ``audio`` family
(``repro.models.whisper``).

The conv/mel frontend is a stub, as in the reference: callers pass
precomputed frame embeddings ``[B, S_enc, D]``.  The transformer is
whisper's: sinusoidal encoder positions, learned decoder positions, pre-LN
blocks, a GELU non-gated FFN, bidirectional encoder attention (one
non-causal K5 launch a layer on the card), causal decoder self-attention
(K5 at prefill, the ring-cache einsum at decode) and cross-attention over
the encoder states (one non-causal K5 launch a layer, at Sq = 1 when
decoding).

Decoding is lock-step: one scalar position for every row, a ring cache
``[W]`` of positions, and the cross K/V computed once at prefill from the
encoder output.  The reference casts each weight to the compute type where
it is used (every use, final norms included); the port casts the whole
model once (:func:`compute_copy`), with the same numbers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models import attention, ffn, layers, lm
from repro_torch.models.attention import AttnSpec, KVCache
from repro_torch.models.config import ArchConfig

MAX_TARGET_POSITIONS = 32_768


def attn_spec(cfg: ArchConfig, *, causal: bool) -> AttnSpec:
    """Whisper's attention: biased projections, no rope."""
    return AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                    qkv_bias=True, causal=causal, rope=False)


def ffn_spec(cfg: ArchConfig) -> ffn.FFNSpec:
    """Whisper's FFN: GELU, not gated."""
    return ffn.FFNSpec(d_model=cfg.d_model, d_ff=cfg.d_ff, act="gelu",
                       gated=False)


def _check(cfg: ArchConfig) -> None:
    if not cfg.is_enc_dec:
        raise ValueError(f"{cfg.name} is not an encoder-decoder (models.lm "
                         "runs it)")


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class EncoderBlock(nn.Module):
    """One encoder layer: ``ln1``/``ln1_b``, ``attn``, ``ln2``/``ln2_b``,
    ``ffn`` (uninitialised until filled)."""

    def __init__(self, cfg: ArchConfig, device, dtype):
        """Allocate the weights on ``device`` in ``dtype``."""
        super().__init__()
        d = cfg.d_model
        for name in ("ln1", "ln1_b", "ln2", "ln2_b"):
            setattr(self, name, _param((d,), device, dtype))
        self.attn = attention.Attention(attn_spec(cfg, causal=False),
                                        device=device, dtype=dtype)
        self.ffn = ffn.FFN(ffn_spec(cfg), device=device, dtype=dtype)


class DecoderBlock(nn.Module):
    """One decoder layer: three pre-norms, ``self_attn``, ``cross_attn``,
    ``ffn`` (uninitialised until filled)."""

    def __init__(self, cfg: ArchConfig, device, dtype):
        """Allocate the weights on ``device`` in ``dtype``."""
        super().__init__()
        d = cfg.d_model
        for name in ("ln1", "ln1_b", "ln2", "ln2_b", "ln3", "ln3_b"):
            setattr(self, name, _param((d,), device, dtype))
        self.self_attn = attention.Attention(attn_spec(cfg, causal=True),
                                             device=device, dtype=dtype)
        self.cross_attn = attention.Attention(attn_spec(cfg, causal=False),
                                              device=device, dtype=dtype)
        self.ffn = ffn.FFN(ffn_spec(cfg), device=device, dtype=dtype)


class Whisper(nn.Module):
    """The model under the reference's names: ``embed``, ``dec_pos``,
    ``lm_head``, the final norms, and the ``enc`` / ``dec`` layer lists."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        """Allocate every weight of ``cfg`` on ``device`` in ``dtype``."""
        super().__init__()
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = _param((vp, d), device, dtype)
        self.dec_pos = _param((MAX_TARGET_POSITIONS, d), device, dtype)
        self.lm_head = _param((d, vp), device, dtype)
        for name in ("final_norm", "final_norm_b", "enc_final_norm",
                     "enc_final_norm_b"):
            setattr(self, name, _param((d,), device, dtype))
        self.enc = nn.ModuleList(EncoderBlock(cfg, device, dtype)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecoderBlock(cfg, device, dtype)
                                 for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Whisper:
    """Random f32 weights by the reference's rules (embeddings N(0, 0.02),
    decoder positions N(0, 0.01), He projections, unit norms, zero biases)
    from ``generator`` on ``device`` (CUDA by default)."""
    _check(cfg)
    dev = _device.resolve(device)
    m = Whisper(cfg, dev)
    for name, p in m.named_parameters():
        leaf = name.split(".")[-1]
        if name in ("embed", "dec_pos"):
            p.normal_(generator=generator).mul_(
                0.02 if name == "embed" else 0.01)
        elif leaf in ("lm_head", "wq", "wk", "wv", "wo", "w_up", "w_down"):
            p.copy_(layers.he_init(generator, p.shape, device=dev))
        elif leaf.startswith("ln") and not leaf.endswith("_b") or \
                leaf in ("final_norm", "enc_final_norm"):
            p.fill_(1.0)
        else:                        # norm shifts and projection biases
            p.zero_()
    return m


def params_to_reference(model: Whisper) -> dict:
    """The reference's parameter pytree as numpy f32 arrays (``enc`` and
    ``dec`` leaves stacked on a leading layer axis)."""
    tree = {name: p.detach().float().cpu().numpy()
            for name, p in model.named_parameters() if "." not in name}
    tree["enc"] = lm.stack_layers(model.enc)
    tree["dec"] = lm.stack_layers(model.dec)
    return tree


@torch.no_grad()
def params_from_reference(tree: dict, cfg: ArchConfig,
                          device=None) -> Whisper:
    """An f32 :class:`Whisper` on ``device`` (CUDA by default) from the
    reference's parameter pytree."""
    _check(cfg)
    return lm.fill(Whisper(cfg, _device.resolve(device)),
                   lm.tree_getter(tree))


@torch.no_grad()
def compute_copy(model: Whisper, cfg: ArchConfig, device=None) -> Whisper:
    """``model`` in the compute type on ``device`` (its own by default):
    every weight cast once, as the reference casts each at its use; the
    model itself when nothing changes."""
    dt = lm.compute_dtype(cfg)
    dev = model.embed.device if device is None else torch.device(device)
    if model.embed.dtype == dt and lm.same_device(dev, model.embed.device):
        return model
    return lm.fill(Whisper(cfg, dev, dt), model.get_parameter)


def _ln(x: torch.Tensor, blk: nn.Module, name: str) -> torch.Tensor:
    return layers.layer_norm(x, getattr(blk, name), getattr(blk, name + "_b"))


@torch.inference_mode()
def encode(model: Whisper, cfg: ArchConfig, audio_embed: torch.Tensor
           ) -> torch.Tensor:
    """audio_embed ``[B, S_enc, D]`` (the stub frontend's output) -> the
    encoder states ``[B, S_enc, D]`` in the compute type."""
    _check(cfg)
    model = compute_copy(model, cfg)
    dt = lm.compute_dtype(cfg)
    _, s, d = audio_embed.shape
    x = audio_embed.to(dt) + layers.sinusoidal_positions(
        s, d, device=audio_embed.device).to(dt)[None]
    spec = attn_spec(cfg, causal=False)
    positions = range(s)
    for blk in model.enc:
        x = x + attention.attention_train(blk.attn, spec, _ln(x, blk, "ln1"),
                                          positions, None)
        x = x + ffn.apply_ffn(blk.ffn, ffn_spec(cfg), _ln(x, blk, "ln2"))
    return layers.layer_norm(x, model.enc_final_norm, model.enc_final_norm_b)


def _decoder_embed(model: Whisper, cfg: ArchConfig, tokens: torch.Tensor,
                   pos_offset) -> torch.Tensor:
    dt = lm.compute_dtype(cfg)
    x = layers.embed_lookup(model.embed, tokens, dtype=dt)
    pos = pos_offset + torch.arange(tokens.shape[1], device=tokens.device)
    return x + model.dec_pos[pos].to(dt)[None]


@torch.inference_mode()
def cross_kv(model: Whisper, cfg: ArchConfig, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V: ``[L, B, Hkv, S_enc, hd]`` x2."""
    model = compute_copy(model, cfg)
    spec = attn_spec(cfg, causal=False)
    kvs = [attention.project_kv(blk.cross_attn, spec, enc_out)
           for blk in model.dec]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def _logits(model: Whisper, cfg: ArchConfig, x_last: torch.Tensor
            ) -> torch.Tensor:
    h = layers.layer_norm(x_last, model.final_norm, model.final_norm_b)
    return lm.mask_padded_vocab(
        cfg, (h @ model.lm_head.to(lm.compute_dtype(cfg))).float())


def _decoder(model: Whisper, cfg: ArchConfig, x: torch.Tensor,
             ck: torch.Tensor, cv: torch.Tensor, self_attn
             ) -> Tuple[torch.Tensor, List]:
    """The decoder stack; ``self_attn(blk, l, h) -> (out, extra)`` is the
    self-attention of layer l (train, prefill or decode)."""
    cross_spec = attn_spec(cfg, causal=False)
    extras = []
    for l, blk in enumerate(model.dec):
        out, extra = self_attn(blk, l, _ln(x, blk, "ln1"))
        extras.append(extra)
        x = x + out
        x = x + attention.cross_attention(blk.cross_attn, cross_spec,
                                          _ln(x, blk, "ln2"), ck[l], cv[l])
        x = x + ffn.apply_ffn(blk.ffn, ffn_spec(cfg), _ln(x, blk, "ln3"))
    return x, extras


@torch.inference_mode()
def forward_train(model: Whisper, cfg: ArchConfig, audio_embed: torch.Tensor,
                  tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decoder hidden states ``[B, S_dec, D]`` and a zero
    aux loss (forward only)."""
    model = compute_copy(model, cfg)
    ck, cv = cross_kv(model, cfg, encode(model, cfg, audio_embed))
    x = _decoder_embed(model, cfg, tokens, 0)
    spec = attn_spec(cfg, causal=True)
    positions = range(tokens.shape[1])
    x, _ = _decoder(model, cfg, x, ck, cv, lambda blk, l, h: (
        attention.attention_train(blk.self_attn, spec, h, positions, None),
        None))
    h = layers.layer_norm(x, model.final_norm, model.final_norm_b)
    return h, torch.zeros((), device=x.device)


def init_decode_cache(model: Whisper, cfg: ArchConfig, batch: int,
                      context: int) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache: scalar ``pos``, ``slot_pos [context]``,
    self-attention ``kv_k``/``kv_v [L, B, Hkv, context, hd]`` and cross
    ``cross_k``/``cross_v [L, B, Hkv, enc_context, hd]``."""
    dev = model.embed.device
    dt = lm.compute_dtype(cfg)
    L, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    z = lambda n: torch.zeros((L, batch, hk, n, hd), dtype=dt,  # noqa: E731
                              device=dev)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "kv_k": z(context), "kv_v": z(context),
            "slot_pos": torch.full((context,), -1, dtype=torch.int32,
                                   device=dev),
            "cross_k": z(cfg.enc_context), "cross_v": z(cfg.enc_context)}


@torch.inference_mode()
def prefill(model: Whisper, cfg: ArchConfig, audio_embed: torch.Tensor,
            tokens: torch.Tensor, context: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode ``audio_embed``, then prefill the decoder with ``tokens [B,
    S]`` -> (last-token logits ``[B, padded_vocab]``, decode cache)."""
    model = compute_copy(model, cfg)
    ck, cv = cross_kv(model, cfg, encode(model, cfg, audio_embed))
    s = tokens.shape[1]
    x = _decoder_embed(model, cfg, tokens, 0)
    spec = attn_spec(cfg, causal=True)
    positions = range(s)
    x, kvs = _decoder(model, cfg, x, ck, cv, lambda blk, l, h: (
        attention.attention_prefill(blk.self_attn, spec, h, positions, None,
                                    context)))
    cache = {"pos": torch.tensor(s, dtype=torch.int32, device=tokens.device),
             "kv_k": torch.stack([kv.k for kv in kvs]),
             "kv_v": torch.stack([kv.v for kv in kvs]),
             "slot_pos": attention.cache_positions(s, context,
                                                   device=tokens.device),
             "cross_k": ck, "cross_v": cv}
    return _logits(model, cfg, x[:, -1]), cache


@torch.inference_mode()
def decode_step(model: Whisper, cfg: ArchConfig,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens ``[B, 1]`` -> (logits ``[B, padded_vocab]``, a new cache), every
    row at the cache's one position."""
    model = compute_copy(model, cfg)
    pos = cache["pos"]
    x = _decoder_embed(model, cfg, tokens, pos)
    spec = attn_spec(cfg, causal=True)
    w = cache["kv_k"].shape[3]
    slot_pos = cache["slot_pos"].clone()
    slot_pos[pos % w] = pos
    x, kvs = _decoder(model, cfg, x, cache["cross_k"], cache["cross_v"],
                      lambda blk, l, h: attention.attention_decode(
                          blk.self_attn, spec, h, pos, None,
                          KVCache(cache["kv_k"][l], cache["kv_v"][l]),
                          slot_pos))
    new_cache = dict(cache, kv_k=torch.stack([kv.k for kv in kvs]),
                     kv_v=torch.stack([kv.v for kv in kvs]),
                     slot_pos=slot_pos, pos=pos + 1)
    return _logits(model, cfg, x[:, -1]), new_cache
