"""The ten LM architectures (``repro.configs.lm_archs``), copied entry for
entry: ``get(name)`` is the full size, ``smoke(name)`` a reduced variant of
the same family for CPU tests.  ``models.lm`` runs every family but
``audio`` (whisper), which ``models.whisper`` runs."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig


def _smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduce any config to CPU-smoke scale, preserving family traits."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16 if cfg.head_dim else None,
        d_ff=128,
        vocab=128,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        window=min(cfg.window, 16) if cfg.window else None,
        encoder_layers=2 if cfg.encoder_layers else 0,
        enc_context=16 if cfg.encoder_layers else cfg.enc_context,
        rwkv_chunk=8,
        flash_block_k=32,
        loss_chunk=16,
        remat_group=1,
    )


QWEN2_72B = ArchConfig(
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True, act="silu",
    rope_theta=1_000_000.0, remat_group=8)       # [arXiv:2407.10671; hf]

GEMMA_2B = ArchConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048, n_heads=8,
    n_kv_heads=1, head_dim=256, d_ff=16384, vocab=256000, act="gelu",
    norm_plus_one=True, embed_scale=True, tie_embeddings=True)
                                                 # [arXiv:2403.08295; hf]

INTERNLM2_20B = ArchConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544, act="silu",
    rope_theta=1_000_000.0)                      # [arXiv:2403.17297; hf]

MINITRON_4B = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=9216, vocab=256000,
    act="relu2", gated_ffn=False)                # [arXiv:2407.14679; hf]

WHISPER_SMALL = ArchConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, act="gelu",
    gated_ffn=False, encoder_layers=12, enc_context=1536)
                                                 # [arXiv:2212.04356]

MIXTRAL_8X22B = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768, n_experts=8,
    top_k=2, window=4096, act="silu")            # [arXiv:2401.04088; hf]

DBRX_132B = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab=100352, n_experts=16, top_k=4,
    act="silu")                                  # [hf:databricks/dbrx-base]

RWKV6_7B = ArchConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, n_heads=64,
    n_kv_heads=64, d_ff=14336, vocab=65536)      # [arXiv:2404.05892; hf]

CHAMELEON_34B = ArchConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True,
    act="silu")                                  # [arXiv:2405.09818]

HYMBA_1_5B = ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32001,
    ssm_state=16, window=1024, act="silu")       # [arXiv:2411.13676; hf]


ARCHS = {c.name: c for c in [
    QWEN2_72B, GEMMA_2B, INTERNLM2_20B, MINITRON_4B, WHISPER_SMALL,
    MIXTRAL_8X22B, DBRX_132B, RWKV6_7B, CHAMELEON_34B, HYMBA_1_5B]}


def get(name: str) -> ArchConfig:
    """The full-size config of architecture ``name``."""
    return ARCHS[name]


def smoke(name: str) -> ArchConfig:
    """The CPU-smoke variant of architecture ``name``."""
    return _smoke(ARCHS[name])
