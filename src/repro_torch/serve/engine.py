"""Batched LM serving engine (``repro.serve.engine``): continuous batching
of prefill and decode.

* a fixed decode batch of ``slots``; each new request is prefilled alone
  (one K5 launch per layer on the card) and its cache is spliced into a
  free slot of the batched ring cache;
* every tick runs one batched decode step for all active slots, and the
  logits come to the host once per tick for sampling;
* a request that hits EOS or ``max_tokens`` frees its slot at once.

Positions are per slot (``cache["pos"] [B]``, ``cache["slot_pos"] [B, W]``),
so requests with different prompt lengths share one decode batch.  The
engine runs on CUDA unless ``device`` says else, on a compute-type copy of
the weights made once when it is built.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.serve.sampling import SamplingParams, sample_np


@dataclasses.dataclass
class Request:
    """One generation request and its output tokens."""

    rid: int
    prompt: np.ndarray            # [S] int32
    max_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def sampling(self) -> SamplingParams:
        """The request's sampling parameters."""
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p)


@dataclasses.dataclass
class EngineStats:
    """Counts of the reference's engine, and host wall times (ms, each
    ending with the logits on the host) of every prefill and decode tick."""

    prefills: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    prefill_ms: List[float] = dataclasses.field(default_factory=list,
                                                compare=False)
    decode_ms: List[float] = dataclasses.field(default_factory=list,
                                               compare=False)


class ServeEngine:
    """Continuous-batching prefill/decode driver over ``models.lm``."""

    def __init__(self, cfg: ArchConfig, params: lm.LM, *, slots: int = 4,
                 context: int = 512, rng_seed: int = 0, device=None):
        """Serve ``params`` (an f32 :class:`~repro_torch.models.lm.LM`) with
        ``slots`` decode rows and a ring cache of ``context`` positions."""
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.params = lm.compute_copy(params, cfg, self.device)
        self.slots = slots
        self.context = context
        self.free = list(range(slots))
        self.active: Dict[int, Request] = {}
        with torch.inference_mode():
            self.cache = lm.init_decode_cache(self.params, cfg, slots,
                                              context)
        self.stats = EngineStats()
        self._rng = np.random.default_rng(rng_seed)

    # -- slot management -----------------------------------------------------
    @torch.inference_mode()
    def submit(self, req: Request) -> bool:
        """Prefill a request into a free slot. Returns False if full."""
        if not self.free:
            return False
        slot = self.free.pop()
        t0 = time.perf_counter()
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                                 device=self.device)
        logits, rcache = lm.prefill(self.params, self.cfg, tokens,
                                    self.context)
        _splice_cache(self.cache, rcache, slot)
        logits_np = logits.cpu().numpy()
        self.stats.prefill_ms.append((time.perf_counter() - t0) * 1e3)
        self.stats.prefills += 1
        req.out_tokens.append(self._sample(logits_np[0], req))
        self.active[slot] = req
        return True

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        return sample_np(logits[: self.cfg.vocab], req.sampling, self._rng)

    @torch.inference_mode()
    def tick(self) -> None:
        """One batched decode step for all active slots."""
        if not self.active:
            return
        tokens = np.zeros((self.slots, 1), np.int32)
        for slot, req in self.active.items():
            tokens[slot, 0] = req.out_tokens[-1]
        t0 = time.perf_counter()
        logits, self.cache = lm.decode_step(
            self.params, self.cfg, self.cache,
            torch.as_tensor(tokens, device=self.device))
        logits_np = logits.cpu().numpy()
        self.stats.decode_ms.append((time.perf_counter() - t0) * 1e3)
        self.stats.decode_steps += 1
        finished = []
        for slot, req in self.active.items():
            tok = self._sample(logits_np[slot], req)
            req.out_tokens.append(tok)
            self.stats.tokens_out += 1
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.out_tokens) >= req.max_tokens:
                req.done = True
                finished.append(slot)
        for slot in finished:
            del self.active[slot]
            self.free.append(slot)

    def run(self, requests: List[Request], max_ticks: int = 10_000
            ) -> List[Request]:
        """Serve ``requests`` to completion; returns them in finishing
        order."""
        pending = list(requests)
        done: List[Request] = []
        for _ in range(max_ticks):
            while pending and self.free:
                self.submit(pending.pop(0))
            if not self.active and not pending:
                break
            before = dict(self.active)
            self.tick()
            done.extend(r for r in before.values() if r.done)
        return done


def _splice_cache(batched: Dict[str, torch.Tensor],
                  single: Dict[str, torch.Tensor], slot: int) -> None:
    """Write a batch-1 prefill cache into slot ``slot`` of the batched cache,
    in place (the reference builds a new cache): ``kv_k``/``kv_v [L, B,
    ...]`` on axis 1, ``pos [B]`` and ``slot_pos [B, W]`` on axis 0."""
    for key, val in single.items():
        if key in ("pos", "slot_pos"):
            batched[key][slot] = val[0]
        else:
            batched[key][:, slot] = val[:, 0]
