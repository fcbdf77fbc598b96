"""Token pipeline for LM training (``repro.data.tokens``): deterministic,
shardable, offline.

A synthetic corpus (Zipfian unigrams mixed with a Markov bigram bias, so
that a model has something to learn) packed into fixed ``[batch, seq]``
examples with next-token labels.  Each host draws only its own
data-parallel shard (``host_slice``).  The generator calls are the
reference's, in its order, so both packages draw the same tokens.

The sampler draws one ``choice(vocab, p=unigram)`` per position; at a
256,000-token vocabulary that is host time of the order of a second a
``4 x 1,025`` batch, which a training loop on the card waits for.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    """Vocabulary, sequence length, global batch and seed of a corpus."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bigram_tables: int = 64


def _zipf_probs(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    return (p / p.sum()).astype(np.float64)


class SyntheticCorpus:
    """Deterministic Markov-flavoured token sampler."""

    def __init__(self, cfg: TokenPipelineConfig):
        """Draw the bigram bias tables from ``cfg.seed``."""
        self.cfg = cfg
        g = np.random.default_rng(cfg.seed)
        self.unigram = _zipf_probs(cfg.vocab)
        # state = token % bigram_tables; each state biases 32 random tokens
        self.bias_idx = g.integers(0, cfg.vocab, (cfg.bigram_tables, 32))
        self.bias_w = 8.0

    def sample_batch(self, step: int, batch: int) -> np.ndarray:
        """``[batch, seq_len + 1]`` int64 tokens of ``step`` (a function of
        the seed and the step only, so a replayed step draws them again)."""
        cfg = self.cfg
        g = np.random.default_rng(cfg.seed + 1000 + step)
        out = np.empty((batch, cfg.seq_len + 1), np.int64)
        out[:, 0] = g.choice(cfg.vocab, size=(batch,), p=self.unigram)
        for t in range(1, cfg.seq_len + 1):
            state = out[:, t - 1] % cfg.bigram_tables
            # with p = 0.5 follow the bigram bias, else the unigram
            follow = g.random(batch) < 0.5
            choice_bias = self.bias_idx[state, g.integers(0, 32, batch)]
            choice_uni = g.choice(cfg.vocab, size=(batch,), p=self.unigram)
            out[:, t] = np.where(follow, choice_bias, choice_uni)
        return out

    def batches(self, *, host_index: int = 0, host_count: int = 1,
                steps: int = 1_000_000
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(tokens, labels) int32 ``[global_batch // host_count, seq_len]``
        of this host's rows, step after step."""
        cfg = self.cfg
        per_host = cfg.global_batch // host_count
        for step in range(steps):
            full = self.sample_batch(step, cfg.global_batch)
            mine = full[host_index * per_host:(host_index + 1) * per_host]
            yield mine[:, :-1].astype(np.int32), mine[:, 1:].astype(np.int32)
