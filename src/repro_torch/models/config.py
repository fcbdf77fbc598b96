"""Architecture configuration (``repro.models.config``), copied field for
field so that a config compares equal across the two packages.

One frozen dataclass describes any member of the supported families
(dense / moe / ssm / hybrid / audio enc-dec / vlm); family-specific fields
are unused elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Hyperparameters of one architecture (see ``configs/lm_archs.py``)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention details
    qkv_bias: bool = False          # qwen2
    qk_norm: bool = False           # chameleon
    window: Optional[int] = None    # SWA (mixtral, hymba attn branch)
    rope_theta: float = 10_000.0
    # ffn details
    act: str = "silu"
    gated_ffn: bool = True
    # norm / embedding details
    norm_plus_one: bool = False     # gemma RMSNorm (1 + w)
    embed_scale: bool = False       # gemma scales embeddings by sqrt(d)
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2             # d_inner = expand * d_model (hybrid branch)
    rwkv_chunk: int = 64
    # enc-dec (whisper)
    encoder_layers: int = 0
    enc_context: int = 1536         # stub audio frames at decode time
    # numerics / lowering
    dtype: str = "bfloat16"
    remat: bool = True
    remat_group: int = 1
    flash_block_k: int = 512
    loss_chunk: int = 512
    # paper-technique integration (LUT-folded router for MoE archs)
    lut_router: bool = False

    @property
    def head_dim_(self) -> int:
        """The head width: ``head_dim`` or ``d_model // n_heads``."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """The vocabulary rounded up to a multiple of 256."""
        return layers.pad_vocab(self.vocab)

    @property
    def is_enc_dec(self) -> bool:
        """Encoder-decoder (whisper)."""
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        """No attention layers (the ssm family)."""
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May run the long-context cell (ssm, hybrid or windowed)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        h, hk, hd = self.n_heads, self.n_kv_heads, self.head_dim_
        attn = d * hd * (h + 2 * hk) + h * hd * d
        ffn = d * f * (3 if self.gated_ffn else 2)
        if self.n_experts:
            ffn = ffn * self.n_experts + d * self.n_experts
        if self.family == "ssm":  # rwkv6
            attn = 5 * d * d + 2 * d * 64 + 64 * 5 * d
            ffn = 2 * d * f + d * d
        if self.family == "hybrid":
            di = self.ssm_expand * d
            attn += d * 2 * di + di * d + 2 * di * self.ssm_state
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = attn + ffn + 2 * d
        total = L * per_layer + emb
        if self.is_enc_dec:
            total += self.encoder_layers * per_layer + attn * self.n_layers
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        full_ffn = d * f * (3 if self.gated_ffn else 2) * self.n_experts
        active_ffn = d * f * (3 if self.gated_ffn else 2) * self.top_k
        return int(self.n_params() - L * (full_ffn - active_ffn))
