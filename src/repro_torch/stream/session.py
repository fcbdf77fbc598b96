"""Per-stream persistent state and the continuous-batching stream router
(the port of ``repro.stream.session``).

A *stream* is a long-lived sequence of steps against one
:class:`~repro_torch.stream.cell.CompiledStreamCell`.  Its only cross-step
footprint is ``n_state`` integer codes, so one process holds state for very
many streams:

  * :class:`StreamStore`: stream id -> packed state codes, stored at the
    narrowest unsigned dtype the in-boundary admits (uint8 for <= 8-bit
    state) and widened to int32 only at dispatch.
  * :class:`StreamRouter`: drives a cell-mode
    :class:`~repro_torch.serve.lut_engine.LUTEngine`, admitting at most one
    outstanding step per stream (the recurrence is sequential per stream)
    while packing steps of different streams into full blocks.  On retire
    the next-state codes are written back and the stream's next queued step
    becomes admissible.

The fleet's stream lane (:meth:`repro_torch.serve.fleet.LUTFleet.open_stream`)
serves streams beside stateless tenants on the same machinery.
"""
from __future__ import annotations

import collections
import time
from typing import TYPE_CHECKING, Deque, Dict, List, Optional

import numpy as np

from repro_torch.stream import cell as cell_mod
from repro_torch.stream.cell import CompiledStreamCell

if TYPE_CHECKING:  # pragma: no cover - typing only
    # the serving package imports this module (the fleet's stream lane),
    # so the engine is imported where the router builds one
    from repro_torch.serve.lut_engine import LUTEngine


def state_dtype(levels: int):
    """Narrowest unsigned dtype holding codes in ``[0, levels)``."""
    if levels <= 2 ** 8:
        return np.uint8
    if levels <= 2 ** 16:
        return np.uint16
    return np.int32


class StreamStore:
    """stream id -> packed per-stream state codes (host numpy)."""

    def __init__(self, cell: CompiledStreamCell):
        """An empty store for streams of ``cell``."""
        self.cell = cell
        self._dtype = state_dtype(cell.cell.in_spec().levels)
        self._zero = cell.cell.zero_state_code()
        self._state: Dict[object, np.ndarray] = {}

    def __len__(self) -> int:
        """Open streams."""
        return len(self._state)

    def __contains__(self, stream_id) -> bool:
        """Whether ``stream_id`` is open."""
        return stream_id in self._state

    def stream_ids(self) -> List:
        """Ids of the open streams, in opening order."""
        return list(self._state)

    @property
    def nbytes(self) -> int:
        """Bytes of live state."""
        return sum(s.nbytes for s in self._state.values())

    def open(self, stream_id) -> None:
        """Open a stream at the initial state."""
        if stream_id in self._state:
            raise ValueError(f"stream {stream_id!r} already open")
        self._state[stream_id] = np.full(
            (self.cell.cell.n_state,), self._zero, self._dtype)

    def get(self, stream_id) -> np.ndarray:
        """Current state codes, widened to int32 for dispatch."""
        return self._state[stream_id].astype(np.int32)

    def put(self, stream_id, codes) -> None:
        """Store a stream's next state codes."""
        self._state[stream_id] = np.asarray(codes).astype(self._dtype)

    def close(self, stream_id) -> np.ndarray:
        """Drop the stream; returns its final state codes (int32)."""
        return self._state.pop(stream_id).astype(np.int32)

    def migrate(self, new_cell: CompiledStreamCell) -> str:
        """Re-point the store at a new cell version (hot swap).  Returns
        the migration mode: ``"carried"``, ``"requantized"`` (every live
        state re-quantized in one pass) or ``"drained+reset"`` (another
        state width: every live stream restarts from the initial state)."""
        mode = cell_mod.state_migration_mode(self.cell, new_cell)
        old = self.cell
        self.cell = new_cell
        self._dtype = state_dtype(new_cell.cell.in_spec().levels)
        self._zero = new_cell.cell.zero_state_code()
        if mode is None:
            for sid in self._state:
                self._state[sid] = np.full(
                    (new_cell.cell.n_state,), self._zero, self._dtype)
            return "drained+reset"
        if mode == "requantized" and self._state:
            sids = list(self._state)
            stacked = np.stack([self._state[s] for s in sids]).astype(
                np.int32)
            moved = cell_mod.migrate_state_codes(old, new_cell,
                                                 stacked).cpu().numpy()
            for sid, row in zip(sids, moved):
                self._state[sid] = row.astype(self._dtype)
        elif mode == "carried":
            for sid in self._state:
                self._state[sid] = self._state[sid].astype(self._dtype)
        return mode


class StreamSession:
    """Caller-facing handle for one stream: its id, completed requests (in
    step order) and its final state once closed."""

    def __init__(self, stream_id):
        """A session with no steps yet."""
        self.stream_id = stream_id
        self.steps: List = []          # completed LUTRequest handles
        self.final_state: Optional[np.ndarray] = None

    @property
    def closed(self) -> bool:
        """Whether the stream was closed and its state dropped."""
        return self.final_state is not None

    def codes(self) -> np.ndarray:
        """``[steps, n_out]`` int32 output codes in step order."""
        return np.stack([r.codes for r in self.steps])

    def logits(self) -> np.ndarray:
        """``[steps, n_out]`` dequantized outputs in step order."""
        return np.stack([r.logits for r in self.steps])


class StreamRouter:
    """Continuous batching over many stateful streams on one engine.

    Per-stream order is held with a busy set: a stream has at most one step
    in flight, and its next queued step is admitted only after the step in
    flight retires and writes its state back.  Blocks fill across streams,
    so concurrency, not per-stream depth, keeps the block function busy.
    Each step's latency from admission to retirement is kept in
    ``step_latencies_us``.
    """

    def __init__(self, cell: CompiledStreamCell, *, block: int = 256,
                 backend: Optional[str] = None, mesh=None, placement=None,
                 depth: int = 1, engine: Optional[LUTEngine] = None):
        """Serve ``cell`` on ``engine`` or on a new cell-mode engine of
        ``block`` rows, ``backend``, ``depth`` and placement (``mesh`` or
        ``placement``)."""
        from repro_torch.serve.lut_engine import LATENCY_WINDOW, LUTEngine
        self.cell = cell
        self.engine = engine if engine is not None else LUTEngine(
            cell.net, cell=cell, block=block, backend=backend, depth=depth,
            mesh=mesh, placement=placement)
        if self.engine.cell is not cell:
            raise ValueError("engine was built for a different cell")
        self.store = StreamStore(cell)
        self.sessions: Dict[object, StreamSession] = {}
        self.step_latencies_us: "collections.deque[float]" = \
            collections.deque(maxlen=LATENCY_WINDOW)
        self._pending: Dict[object, Deque[np.ndarray]] = {}
        self._busy: set = set()
        self._closing: set = set()

    # -- stream lifecycle ----------------------------------------------------
    def open(self, stream_id) -> StreamSession:
        """Open a stream at the initial state; returns its session."""
        self.store.open(stream_id)
        self.sessions[stream_id] = StreamSession(stream_id)
        self._pending[stream_id] = collections.deque()
        return self.sessions[stream_id]

    def close(self, stream_id) -> StreamSession:
        """Mark a stream closed.  Steps already fed still complete; the
        state is dropped (and ``final_state`` stamped) once the stream is
        idle.  Returns the session handle."""
        if stream_id not in self.store and stream_id not in self.sessions:
            raise KeyError(f"unknown stream {stream_id!r}")
        self._closing.add(stream_id)
        self._finalize_closed()
        return self.sessions[stream_id]

    def feed(self, stream_id, xs) -> StreamSession:
        """Queue one step (``[n_in]``) or many (``[T, n_in]``) for a
        stream.  Steps run strictly in feed order."""
        if stream_id in self._closing:
            raise ValueError(f"stream {stream_id!r} is closing")
        xs = np.asarray(xs, np.float32)
        if xs.ndim == 1:
            xs = xs[None]
        self._pending[stream_id].extend(xs)
        return self.sessions[stream_id]

    # -- the pump ------------------------------------------------------------
    def _admit(self) -> int:
        """Move at most one pending step per idle stream into the engine
        queue, with its current state attached."""
        admitted = 0
        now = time.perf_counter()
        for sid, pend in self._pending.items():
            if not pend or sid in self._busy:
                continue
            req = self.engine.submit(pend.popleft(),
                                     state=self.store.get(sid),
                                     stream_id=sid)
            req.t_submit = now
            self._busy.add(sid)
            admitted += 1
        return admitted

    def _retire(self) -> int:
        batch = self.engine.retire_oldest()
        now = time.perf_counter()
        for req in batch:
            sid = req.stream_id
            self.store.put(sid, req.next_state)
            self._busy.discard(sid)
            self.sessions[sid].steps.append(req)
            self.step_latencies_us.append((now - req.t_submit) * 1e6)
        self._finalize_closed()
        return len(batch)

    def _finalize_closed(self) -> None:
        done = [sid for sid in self._closing
                if sid not in self._busy and not self._pending.get(sid)]
        for sid in done:
            self.sessions[sid].final_state = self.store.close(sid)
            self._pending.pop(sid, None)
            self._closing.discard(sid)

    def tick(self) -> int:
        """Admit, dispatch one block, retire down to the pipeline depth.
        Returns the steps completed."""
        self._admit()
        if self.engine.queue:
            self.engine.dispatch_block()
        completed = 0
        while self.engine.inflight > self.engine.depth - 1:
            completed += self._retire()
        return completed

    def pending_steps(self) -> int:
        """Steps fed but not yet completed."""
        return (sum(len(p) for p in self._pending.values())
                + len(self.engine.queue) + len(self._busy))

    def pump(self, max_ticks: int = 1_000_000) -> int:
        """Tick until every fed step has completed, then drain."""
        completed = 0
        for _ in range(max_ticks):
            if not self.pending_steps():
                return completed
            completed += self.tick()
            while self.engine.inflight and not self.engine.queue:
                completed += self._retire()
        raise RuntimeError(f"router did not go idle in {max_ticks} ticks")

    def latency_us(self, pct: float) -> float:
        """Percentile of per-step latency (admission to retirement) in us
        over the last ``LATENCY_WINDOW`` steps (0.0 when empty)."""
        if not self.step_latencies_us:
            return 0.0
        return float(np.percentile(np.asarray(self.step_latencies_us), pct))

    def run_sequences(self, sequences: Dict[object, np.ndarray]
                      ) -> Dict[object, StreamSession]:
        """Open a stream per key, feed its ``[T, n_in]`` sequence, pump to
        completion and close.  Returns the sessions."""
        for sid, xs in sequences.items():
            if sid not in self.sessions:
                self.open(sid)
            self.feed(sid, xs)
        self.pump()
        for sid in sequences:
            self.close(sid)
        return {sid: self.sessions[sid] for sid in sequences}
