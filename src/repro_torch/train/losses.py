"""Losses and accuracies of the LUT-model classifiers
(``repro.train.losses``; the LM's chunked loss waits for the LM substrate)."""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``[B, C]`` logits against int labels ``[B]``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    gold = torch.gather(logp, 1, labels.to(torch.int64)[:, None])[:, 0]
    return -torch.mean(gold)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose arg-max equals the label."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels).to(
        torch.float32))


def binary_cross_entropy(logit: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss of one logit per row (``[B]`` or ``[B, 1]``).

    Quantized logits are often exactly 0, so the gradient there follows
    JAX's: ``maximum`` passes half (``torch.maximum`` with a tensor bound
    does, ``clamp`` would pass all) and ``abs`` has slope +1 (``where``;
    ``torch.abs`` has 0).
    """
    logit = logit.reshape(logit.shape[0]).to(torch.float32)
    lab = labels.to(torch.float32)
    zero = torch.zeros((), dtype=logit.dtype, device=logit.device)
    abs_logit = torch.where(logit >= 0, logit, -logit)
    return torch.mean(torch.maximum(logit, zero) - logit * lab
                      + torch.log1p(torch.exp(-abs_logit)))


def binary_accuracy(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose ``logit > 0`` equals the 0/1 label."""
    pred = (logit.reshape(logit.shape[0]) > 0).to(torch.int32)
    return torch.mean((pred == labels).to(torch.float32))
