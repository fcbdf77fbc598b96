"""Losses (``repro.train.losses``): the LM's vocab-chunked cross-entropy,
and the losses and accuracies of the LUT-model classifiers.

The LM loss never holds the ``[B, S, vocab]`` logits: it walks sequence
chunks, each computing its logits and log-sum-exp and adding its summed
NLL, so the live logits are ``B x chunk x padded_vocab`` f32 (2.1 GB at
gemma-2b's 4 x 512 x 256,000).  Each chunk runs under
``torch.utils.checkpoint``, the counterpart of the reference's
``nothing_saveable`` policy: autograd keeps no chunk's logits, and the
backward recomputes one chunk at a time.

On a tensor-parallel view the head holds this rank's vocabulary columns
(``vocab_start``): each chunk's logits are this rank's, and its maximum,
sum of exponentials and label logit are reduced over ``model``
(``act_sharding.max_model`` / ``sum_model``), the reference's
vocabulary-sharded logits without a gather.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import act_sharding

IGNORE = -1  # label value that is masked out


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, lab: torch.Tensor,
               vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed NLL and token count of one chunk: h ``[B, C, D]``, head
    ``[D, Vp]`` in h's type, lab ``[B, C]``."""
    logits = (h @ head).float()                               # [B, C, Vp]
    vp = head.shape[-1]
    if vp != vocab:      # padded vocab columns
        pad = torch.arange(vp, device=h.device) >= vocab
        logits = torch.where(pad, torch.full((), -1e30, device=h.device),
                             logits)
    lse = torch.logsumexp(logits, dim=-1)                     # [B, C]
    gold = logits.gather(-1, lab.clamp(0, vocab - 1).long()[..., None])
    mask = (lab != IGNORE).float()
    return ((lse - gold[..., 0]) * mask).sum(), mask.sum()


def _chunk_nll_sharded(h: torch.Tensor, head: torch.Tensor,
                       lab: torch.Tensor, vocab: int, start: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_chunk_nll` with ``head`` this rank's columns ``[D, Vr]``
    from ``start``: the log-sum-exp and the label's logit summed over
    ``model`` (the shift, the maximum over ``model``, taken outside the
    graph), so every rank holds the chunk's NLL and its gradient reaches
    this rank's logits."""
    logits = (h @ head).float()                               # [B, C, Vr]
    cols = torch.arange(start, start + head.shape[-1], device=h.device)
    logits = torch.where(cols >= vocab, torch.full((), -1e30,
                                                   device=h.device), logits)
    shift = act_sharding.max_model(logits.amax(-1))           # [B, C]
    sumexp = torch.exp(logits - shift[..., None]).sum(-1)
    lse = shift + torch.log(act_sharding.sum_model(sumexp))
    idx = lab.clamp(0, vocab - 1).long() - start
    mine = (idx >= 0) & (idx < head.shape[-1])
    gold = logits.gather(-1, idx.clamp(0, head.shape[-1] - 1)[..., None])
    gold = act_sharding.sum_model(torch.where(mine, gold[..., 0], 0.0))
    mask = (lab != IGNORE).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, vocab: int,
                          chunk: int = 512,
                          vocab_start: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden ``[B, S, D]``; head ``[D, Vp]``; labels ``[B, S]`` int.

    Returns (mean NLL over the labels that are not :data:`IGNORE`, their
    count), both f32 scalars.  S is padded to a multiple of the chunk with
    ignored labels; the padded vocab columns are masked to -1e30; an
    ignored label's gold index is clipped into range and its NLL masked.
    With ``vocab_start`` the head is this rank's columns of the padded
    vocabulary from that column, under a mesh's rules: the form reduced
    over ``model`` (every rank of ``model`` returns the same loss).
    """
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE)
    head_c = head.to(hidden.dtype)
    grad = torch.is_grad_enabled()
    total = torch.zeros((), device=hidden.device)
    count = torch.zeros((), device=hidden.device)
    fn, extra = (_chunk_nll, ()) if vocab_start is None else \
        (_chunk_nll_sharded, (vocab_start,))
    for i in range(0, hidden.shape[1], chunk):
        args = (hidden[:, i:i + chunk], head_c, labels[:, i:i + chunk], vocab,
                *extra)
        nll, n = checkpoint(fn, *args, use_reentrant=False) \
            if grad else fn(*args)
        total = total + nll
        count = count + n
    return total / torch.clamp(count, min=1.0), count


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
