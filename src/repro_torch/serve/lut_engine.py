"""Micro-batching inference engine for compiled LUT networks.

Requests queue up; every tick drains up to ``block`` of them, pads to the
fixed block shape and runs one cascade (quantize -> backend -> dequantize)
for the whole block.  ``depth`` is the number of blocks in flight: 1 is
synchronous, 2+ dispatches block N+1 while block N still runs and retires
the oldest block only once ``depth`` are outstanding (or at :meth:`drain`).

On a CUDA network a dispatch fills a pinned host buffer, copies it to the
card without blocking, launches the cascade on the current stream, copies
codes and logits back into pinned host buffers with ``non_blocking=True``
and records a ``torch.cuda.Event``; retiring a block synchronizes that
event.  On the CPU the engine is synchronous.

**Cell mode** (``cell=``, a :class:`~repro_torch.stream.cell.CompiledStreamCell`):
the block function is the folded recurrent step.  Each request carries its
state codes in (``submit(state=)``) and gets its next-state codes back
(``next_state``); the pinned slots hold a state-in and a next-state-out
column beside the rows, and a request's next state is read from its slot
only after the block's event has completed.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backends
from repro_torch.pipeline import CompiledLUTNetwork


class DrainTimeout(RuntimeError):
    """A drain wait exceeded its timeout; names the stuck block."""

    def __init__(self, message: str, *, scope: Optional[str] = None,
                 requests: int = 0, age_s: float = 0.0):
        """Record the scope, the stuck block's size and its age."""
        super().__init__(message)
        self.scope = scope
        self.requests = int(requests)
        self.age_s = float(age_s)


@dataclasses.dataclass
class LUTRequest:
    """One input row and, once retired, its codes and logits."""

    rid: int
    x: np.ndarray
    codes: Optional[np.ndarray] = None
    logits: Optional[np.ndarray] = None
    done: bool = False
    attempts: int = 0
    # wall-clock admission time, stamped by the stream router for its step
    # latency; 0.0 = unstamped
    t_submit: float = 0.0
    # cell mode: the state codes this step consumes, the next-state codes
    # it produced, and the stream the step belongs to
    state: Optional[np.ndarray] = None       # [n_state] int32
    next_state: Optional[np.ndarray] = None  # [n_state] int32
    stream_id: Optional[object] = None


LATENCY_WINDOW = 10_000


@dataclasses.dataclass
class LUTEngineStats:
    """Counters and the per-tick wall latency window."""

    ticks: int = 0
    requests: int = 0
    rows_padded: int = 0
    tick_latencies_us: "collections.deque[float]" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))

    def latency_us(self, pct: float) -> float:
        """Percentile of per-tick wall latency in us (0.0 when empty)."""
        if not self.tick_latencies_us:
            return 0.0
        return float(np.percentile(np.asarray(self.tick_latencies_us), pct))

    def summary(self) -> dict:
        """Flat JSON-ready snapshot."""
        return {
            "ticks": self.ticks,
            "requests": self.requests,
            "rows_padded": self.rows_padded,
            "p50_tick_us": round(self.latency_us(50), 1),
            "p99_tick_us": round(self.latency_us(99), 1),
            "latency_window": len(self.tick_latencies_us),
        }


class _Slot:
    """Pinned host staging for one in-flight block on a CUDA network (with
    a state-in and a next-state-out column in cell mode, ``n_state > 0``)."""

    def __init__(self, block: int, in_features: int, n_out: int,
                 n_state: int = 0):
        """Pinned buffers for a block of ``block`` rows."""
        pinned = dict(pin_memory=True)
        self.x = torch.zeros((block, in_features), dtype=torch.float32,
                             **pinned)
        self.codes = torch.empty((block, n_out), dtype=torch.int32, **pinned)
        self.logits = torch.empty((block, n_out), dtype=torch.float32,
                                  **pinned)
        self.state = self.next_state = None
        if n_state:
            self.state = torch.zeros((block, n_state), dtype=torch.int32,
                                     **pinned)
            self.next_state = torch.empty((block, n_state),
                                          dtype=torch.int32, **pinned)
        self.done: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        """Block until the last block staged here has been copied back."""
        if self.done is not None:
            self.done.synchronize()


class LUTEngine:
    """Double-buffered micro-batching engine over one planned backend, or
    over a stream cell's folded step (``cell=``)."""

    def __init__(self, net: CompiledLUTNetwork, *, block: int = 256,
                 backend: Optional[str] = None, depth: int = 1,
                 cell=None, mesh=None, placement=None):
        """Plan ``backend`` (default: the network's) for blocks of
        ``block`` rows with up to ``depth`` blocks in flight.  ``cell`` is a
        :class:`~repro_torch.stream.cell.CompiledStreamCell` wrapping
        ``net`` (cell mode).  Meshes and placements are not ported yet and
        raise."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if mesh is not None or placement is not None:
            raise NotImplementedError(
                "LUTEngine over a device mesh or placement is not ported yet "
                "(ROADMAP A.11)")
        self.net = net
        self._block = int(block)
        self._depth = int(depth)
        self.queue: Deque[LUTRequest] = collections.deque()
        self.stats = LUTEngineStats()
        self._next_rid = 0
        self._now = time.perf_counter
        # (requests, codes, logits, next state, t_dispatch, slot), oldest
        # first; on the card the arrays are None and come from the slot
        self._inflight: Deque[Tuple] = collections.deque()
        self._cell = cell
        self._n_state = 0
        if cell is not None:
            # cell mode: the block function is the folded recurrent step
            if net is not cell.net:
                raise ValueError("cell= must wrap the engine's net")
            self._in_features = cell.cell.n_in
            self._n_state = cell.cell.n_state
            self._zero_state = cell.cell.zero_state_code()
            step = cell.raw_step(backend)
            self._backend = backends.resolve(backend or net.backend).name
            self._fwd = step
            n_out = cell.cell.n_out
        else:
            self._in_features = net.cfg.in_features
            executor = net.compile_backend(backend or net.backend)
            self._backend = executor.backend
            self._fwd = executor.codes_and_logits
            n_out = net.cfg.layers[-1].units
        self._cuda = net.device.type == "cuda"
        self._slots: List[_Slot] = []
        self._next_slot = 0
        if self._cuda:
            self._slots = [_Slot(self._block, self._in_features, n_out,
                                 self._n_state)
                           for _ in range(self._depth)]

    @property
    def cell(self):
        """The CompiledStreamCell in cell mode, else None."""
        return self._cell

    @property
    def block(self) -> int:
        """Rows per dispatched block (fixed at construction)."""
        return self._block

    @block.setter
    def block(self, _value):
        """Refuse: the block size is planned once."""
        raise AttributeError(
            "LUTEngine.block is fixed at construction; build a new engine "
            "instead")

    @property
    def backend(self) -> str:
        """The planned backend's name (fixed at construction)."""
        return self._backend

    @backend.setter
    def backend(self, _value):
        """Refuse: the backend is planned once."""
        raise AttributeError(
            "LUTEngine.backend is fixed at construction; build a new engine "
            "instead")

    @property
    def depth(self) -> int:
        """Maximum blocks in flight."""
        return self._depth

    @property
    def inflight(self) -> int:
        """Blocks dispatched but not yet retired."""
        return len(self._inflight)

    # -- queueing ------------------------------------------------------------
    def submit(self, x: np.ndarray, *, state: Optional[np.ndarray] = None,
               stream_id=None) -> LUTRequest:
        """Enqueue one input row; returns the request handle.  In cell mode
        ``state`` is the step's state codes (default: the initial state)."""
        if self._cell is not None and state is None:
            state = np.full((self._n_state,), self._zero_state, np.int32)
        req = LUTRequest(rid=self._next_rid, x=np.asarray(x, np.float32),
                         state=state, stream_id=stream_id)
        self._next_rid += 1
        self.queue.append(req)
        self.stats.requests += 1
        return req

    def submit_many(self, xs: np.ndarray, *,
                    states: Optional[np.ndarray] = None) -> List[LUTRequest]:
        """Enqueue every row of ``xs`` with one dtype conversion.  In cell
        mode ``states`` (``[n, n_state]`` codes, default the initial state)
        ride along."""
        xs = np.asarray(xs, np.float32)
        base = self._next_rid
        if self._cell is not None:
            if states is None:
                states = np.full((len(xs), self._n_state), self._zero_state,
                                 np.int32)
            else:
                states = np.asarray(states, np.int32)
            reqs = [LUTRequest(rid=base + i, x=row, state=s)
                    for i, (row, s) in enumerate(zip(xs, states))]
        else:
            reqs = [LUTRequest(rid=base + i, x=row)
                    for i, row in enumerate(xs)]
        self._next_rid += len(reqs)
        self.queue.extend(reqs)
        self.stats.requests += len(reqs)
        return reqs

    # -- the pump ------------------------------------------------------------
    def _fill_state(self, sb: np.ndarray, batch: List[LUTRequest]) -> None:
        n = len(batch)
        sb[:n] = [req.state for req in batch]
        sb[n:] = self._zero_state

    def _launch(self, batch: List[LUTRequest]):
        """Run one padded block; returns (codes, logits, next state or
        None) as numpy and no slot on the CPU, or no arrays and the slot on
        the card."""
        n = len(batch)
        if not self._cuda:
            xb = np.zeros((self._block, self._in_features), np.float32)
            xb[:n] = [req.x for req in batch]
            if self._cell is None:
                codes, logits = self._fwd(torch.from_numpy(xb))
                return codes.numpy(), logits.numpy(), None, None
            sb = np.empty((self._block, self._n_state), np.int32)
            self._fill_state(sb, batch)
            codes, logits, s_next = self._fwd(torch.from_numpy(xb),
                                              torch.from_numpy(sb))
            return codes.numpy(), logits.numpy(), s_next.numpy(), None
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        slot.wait()
        xb = slot.x.numpy()
        xb[:n] = [req.x for req in batch]
        xb[n:] = 0.0
        x_dev = slot.x.to(self.net.device, non_blocking=True)
        if self._cell is None:
            codes, logits = self._fwd(x_dev)
        else:
            self._fill_state(slot.state.numpy(), batch)
            s_dev = slot.state.to(self.net.device, non_blocking=True)
            codes, logits, s_next = self._fwd(x_dev, s_dev)
            slot.next_state.copy_(s_next, non_blocking=True)
        slot.codes.copy_(codes, non_blocking=True)
        slot.logits.copy_(logits, non_blocking=True)
        slot.done = torch.cuda.Event()
        slot.done.record()
        return None, None, None, slot

    def dispatch_block(self) -> List[LUTRequest]:
        """Pad up to ``block`` queued requests and launch the cascade
        without waiting for the result; returns the dispatched requests.
        If the launch raises, the requests go back to the front of the
        queue in order before the exception propagates."""
        batch: List[LUTRequest] = []
        while self.queue and len(batch) < self._block:
            batch.append(self.queue.popleft())
        if not batch:
            return batch
        t0 = self._now()
        try:
            codes, logits, s_next, slot = self._launch(batch)
        except BaseException:
            for req in batch:
                req.attempts += 1
            self.queue.extendleft(reversed(batch))
            raise
        self._inflight.append((batch, codes, logits, s_next, t0, slot))
        self.stats.rows_padded += self._block - len(batch)
        self.stats.ticks += 1
        return batch

    def oldest_age(self) -> float:
        """Seconds since the oldest in-flight block was dispatched."""
        if not self._inflight:
            return 0.0
        return self._now() - self._inflight[0][4]

    def abandon_oldest(self) -> List[LUTRequest]:
        """Give up on the oldest in-flight block without waiting: requeue
        its requests at the front (attempts incremented) and return them."""
        if not self._inflight:
            return []
        batch = self._inflight.popleft()[0]
        for req in batch:
            req.attempts += 1
        self.queue.extendleft(reversed(batch))
        return batch

    def retire_oldest(self) -> List[LUTRequest]:
        """Wait on the oldest in-flight block, fan its results out to the
        requests and return them ([] when nothing is in flight)."""
        if not self._inflight:
            return []
        batch, codes, logits, s_next, _t0, slot = self._inflight.popleft()
        if slot is not None:
            # the block's event covers every copy back, next state included:
            # nothing of the slot is read before it has completed
            slot.wait()
            n = len(batch)
            codes = slot.codes[:n].numpy().copy()
            logits = slot.logits[:n].numpy().copy()
            if slot.next_state is not None:
                s_next = slot.next_state[:n].numpy().copy()
        for req, c, lg in zip(batch, list(codes), list(logits)):
            req.codes = c
            req.logits = lg
            req.done = True
        if s_next is not None:
            for req, s in zip(batch, list(s_next)):
                req.next_state = s
        return batch

    def tick(self) -> int:
        """Dispatch one block; retire the oldest once ``depth`` blocks are
        in flight.  Returns the number of requests completed this tick."""
        t0 = time.perf_counter()
        dispatched = len(self.dispatch_block()) if self.queue else 0
        completed = 0
        while len(self._inflight) > self._depth - 1:
            completed += len(self.retire_oldest())
        if dispatched or completed:
            self.stats.tick_latencies_us.append(
                (time.perf_counter() - t0) * 1e6)
        return completed

    def drain(self, timeout: Optional[float] = None) -> int:
        """Retire every in-flight block.  With ``timeout``, raise
        :class:`DrainTimeout` instead of waiting on a block that is already
        older than ``timeout`` seconds."""
        completed = 0
        while self._inflight:
            if timeout is not None:
                age = self.oldest_age()
                if age > timeout:
                    batch = self._inflight[0][0]
                    raise DrainTimeout(
                        f"drain timed out: oldest in-flight block on "
                        f"'engine' ({len(batch)} requests, backend "
                        f"{self._backend!r}) is {age:.3f}s old "
                        f"(timeout {timeout:.3f}s)",
                        scope=None, requests=len(batch), age_s=age)
            completed += len(self.retire_oldest())
        return completed

    def run(self, xs: np.ndarray) -> np.ndarray:
        """Submit every row of ``xs``, tick until the queue is empty, drain.
        Returns logits ``[len(xs), n_out]`` in submission order."""
        reqs = self.submit_many(xs)
        while self.queue:
            self.tick()
        self.drain()
        return np.stack([r.logits for r in reqs])
