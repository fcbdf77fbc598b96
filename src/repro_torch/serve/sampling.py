"""Sampling for the serving engine (``repro.serve.sampling``): greedy,
temperature, top-k and nucleus (top-p).

``sample_np`` is the reference's host-side numpy function, copied: from the
same logits and the same ``np.random.Generator`` it gives the same tokens.
``sample_torch`` is the device-side variant (the reference's
``sample_jax``) with an explicit ``torch.Generator``; its random draws
differ from JAX's, and greedy is the argmax.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request samples its tokens."""

    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled
    top_p: float = 1.0           # 1.0 => disabled


def sample_np(logits: np.ndarray, params: SamplingParams,
              rng: np.random.Generator) -> int:
    """logits ``[vocab]`` -> token id (host-side)."""
    if params.temperature <= 0:
        return int(np.argmax(logits))
    logits = logits.astype(np.float64) / params.temperature
    if params.top_k > 0:
        kth = np.partition(logits, -params.top_k)[-params.top_k]
        logits = np.where(logits < kth, -np.inf, logits)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    if params.top_p < 1.0:
        order = np.argsort(-probs)
        csum = np.cumsum(probs[order])
        cutoff = np.searchsorted(csum, params.top_p) + 1
        mask = np.zeros_like(probs)
        mask[order[:cutoff]] = 1.0
        probs = probs * mask
        probs /= probs.sum()
    return int(rng.choice(len(probs), p=probs))


def sample_torch(logits: torch.Tensor, params: SamplingParams,
                 generator: torch.Generator) -> torch.Tensor:
    """logits ``[B, vocab]`` -> ``[B]`` token ids (device-side)."""
    if params.temperature <= 0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / params.temperature
    if params.top_k > 0:
        kth = torch.topk(scaled, params.top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p
        k_idx = torch.sum(csum < params.top_p, dim=-1, keepdim=True)
        k_idx = k_idx.clamp(max=scaled.shape[-1] - 1)   # jnp clamps too
        threshold = torch.gather(sorted_logits, -1, k_idx)
        scaled = torch.where(scaled < threshold, -torch.inf, scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
