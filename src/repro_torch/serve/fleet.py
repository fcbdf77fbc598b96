"""Multi-tenant LUT serving fleet: one process, many artifacts, SLO-aware
(the port of ``repro.serve.fleet``).

``CompiledLUTNetwork`` artifacts are tiny and self-contained — the whole
point of the paper's folding step — so a single process can host a *fleet*
of them.  :class:`LUTFleet` is that tier:

  * **registry** (:mod:`repro_torch.serve.registry`): model-id -> versioned
    artifact with smoke-checked zero-downtime hot swaps and an LRU
    executor cache under a byte/entry budget.
  * **scheduler**: one engine lane per tenant (the double-buffered
    dispatch/retire machinery of :class:`~repro_torch.serve.lut_engine.LUTEngine`,
    driven externally), round-robined with **continuous cross-tenant
    batching** — every tick each tenant with queued rows dispatches one
    padded block without waiting, and blocks retire oldest-first across
    the WHOLE fleet once ``depth`` blocks are in flight.  A tenant with 3
    queued rows dispatches alongside one with 300 instead of behind it,
    and the device pipeline never empties at tenant boundaries (the
    aggregate-throughput win over N isolated engines — see
    ``benchmarks/torch_fleet_serving.py``).
  * **admission** (:mod:`repro_torch.serve.admission`): per-tenant p99/queue
    budgets, enforced at the door (shed) or absorbed (defer).

Per-tenant :class:`FleetStats` surface rows, queue depth, request-latency
p50/p99, shed/deferred counts the same way ``LUTEngineStats`` does for a
single engine; ``summary(model_id)`` adds version + swap history.

Hot swap contract: ``deploy`` mutates only the registry; each lane picks
the new version up at its next tick boundary — queued requests migrate to
the new engine, in-flight blocks retire on the engine that dispatched
them.  Zero requests dropped, zero answers from a half-installed version.

The fleet also *supervises* its lanes: a
:class:`~repro_torch.serve.supervision.ResiliencePolicy` adds per-request
deadlines (blown blocks are abandoned and recomputed — safe because every
backend is bit-identical and requests idempotent), bounded retry with
exponential backoff, a per-lane circuit breaker whose OPEN state
quarantines the tenant through the admission door, and graceful
degradation that re-plans a failing executor onto a surviving
backend×placement (device loss → the placement's surviving slots via
``dist/elastic.plan_serving_remesh``, anything else → the layered
fallback backend).  A :class:`~repro_torch.serve.faults.FaultInjector`
threads through every engine the fleet builds, so the whole failure
lifecycle is exercised deterministically by tests and
``benchmarks/torch_chaos_soak.py``.

Artifacts registered by path load onto the fleet's ``device`` (CUDA
unless the caller says ``"cpu"``); in-memory artifacts serve where they
live.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import backends
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionDecision, TenantSLO)
from repro_torch.serve.faults import DeviceLost, DrainTimeout, FaultInjector
from repro_torch.serve.lut_engine import (LATENCY_WINDOW, LUTEngine,
                                          LUTRequest)
from repro_torch.serve.registry import (ArtifactSource, ExecutorCache,
                                        Reference, SwapEvent, TenantRegistry)
from repro_torch.serve.supervision import (CircuitBreaker, DegradeEvent,
                                           FailureEvent, ResiliencePolicy)
from repro_torch.stream.cell import (CompiledStreamCell, migrate_state_codes,
                                     state_migration_mode)
from repro_torch.stream.session import StreamSession, StreamStore


@dataclasses.dataclass
class FleetStats:
    """Per-tenant serving counters (the fleet analogue of LUTEngineStats;
    latencies here are per-REQUEST submit->result, queue wait included —
    that is what a tenant's SLO is written against)."""

    requests: int = 0            # admitted rows
    completed: int = 0
    shed: int = 0
    deferred: int = 0            # rows that went through the deferred queue
    ticks: int = 0               # blocks dispatched for this tenant
    rows_padded: int = 0
    # resilience counters
    failures: int = 0            # detected dispatch/deadline failures
    deadline_hits: int = 0       # blocks abandoned past the deadline
    retries: int = 0             # failures answered with backoff+retry
    breaker_trips: int = 0       # CLOSED/HALF_OPEN -> OPEN transitions
    degrades: int = 0            # executor re-plans onto a fallback
    request_latencies_us: "collections.deque[float]" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))
    # incident recovery times (first failure -> next successful retire)
    recovery_s: "collections.deque[float]" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))

    def latency_us(self, pct: float) -> float:
        """Request-latency percentile over the window; 0.0 when empty."""
        if not self.request_latencies_us:
            return 0.0
        return float(np.percentile(
            np.asarray(self.request_latencies_us), pct))

    def recovery_p99_ms(self) -> float:
        """p99 incident recovery time in ms (0.0 with no incidents)."""
        if not self.recovery_s:
            return 0.0
        return float(np.percentile(np.asarray(self.recovery_s), 99)) * 1e3

    def summary(self) -> dict:
        """Flat JSON-ready snapshot (mirrors LUTEngineStats.summary)."""
        return {
            "requests": self.requests,
            "completed": self.completed,
            "shed": self.shed,
            "deferred": self.deferred,
            "ticks": self.ticks,
            "rows_padded": self.rows_padded,
            "p50_request_us": round(self.latency_us(50), 1),
            "p99_request_us": round(self.latency_us(99), 1),
            "latency_window": len(self.request_latencies_us),
            "failures": self.failures,
            "deadline_hits": self.deadline_hits,
            "retries": self.retries,
            "breaker_trips": self.breaker_trips,
            "degrades": self.degrades,
            "recovery_p99_ms": round(self.recovery_p99_ms(), 3),
            "incidents_recovered": len(self.recovery_s),
        }


class _TenantLane:
    """One tenant's serving lane: engine + deferred queue + stats."""

    def __init__(self, model_id: str, *, block: int,
                 backend: Optional[str], placement,
                 breaker: Optional[CircuitBreaker] = None):
        self.model_id = model_id
        self.block = block
        # backend/placement are the lane's CURRENT serving config — they
        # start at the registered values and graceful degradation rewrites
        # them (a later deploy keeps the degraded config; re-register to
        # restore the original plan)
        self.backend = backend
        self.placement = placement
        self.version = 0                 # forces engine build on first sync
        self.engine: Optional[LUTEngine] = None
        self.deferred: Deque[Tuple[np.ndarray, float]] = collections.deque()
        self.stats = FleetStats()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        # supervision state
        self.breaker = breaker if breaker is not None else CircuitBreaker(3, 0.05)
        self.not_before = 0.0            # retry-backoff gate (clock time)
        self.down_since: Optional[float] = None   # open incident start
        self.failure_log: List[FailureEvent] = []
        self.degrade_log: List[DegradeEvent] = []
        # stream (stateful) tenants: current cell + per-stream state,
        # pending steps (row, t_submit), busy set (one step in flight per
        # stream), sessions (completed steps in order), deferred closes
        self.cell: Optional[CompiledStreamCell] = None
        self.store: Optional[StreamStore] = None
        self.pending: Dict[object, Deque[Tuple[np.ndarray, float]]] = {}
        self.busy: set = set()
        self.sessions: Dict[object, StreamSession] = {}
        self.closing: set = set()

    def queue_depth(self) -> int:
        queued = len(self.engine.queue) if self.engine is not None else 0
        queued += sum(len(p) for p in self.pending.values())
        return queued + len(self.deferred)


class LUTFleet:
    """Many tenants, one pump.  See the module docstring for the model.

    ``depth`` is the GLOBAL in-flight block budget shared by all tenants
    (2 = double-buffered, the serving default); ``block`` the default
    per-tenant block size, overridable per :meth:`register`; ``min_fill``
    the batching-delay threshold (rows a lane must have queued before it
    dispatches — ``block`` trades latency for full-block throughput under
    arrival-driven pumping, see ``benchmarks/fleet_serving.py``).
    """

    def __init__(self, *, block: int = 256, depth: int = 2,
                 min_fill: int = 1,
                 registry: Optional[TenantRegistry] = None,
                 cache: Optional[ExecutorCache] = None,
                 admission: Optional[AdmissionController] = None,
                 policy: Optional[ResiliencePolicy] = None,
                 faults: Optional[FaultInjector] = None, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if min_fill < 1:
            raise ValueError(f"min_fill must be >= 1, got {min_fill}")
        if registry is not None and cache is not None:
            raise ValueError("pass either registry= or cache=, not both "
                             "(the registry owns its cache)")
        self.block = int(block)
        self.depth = int(depth)
        # failure supervision: always on (an unsupervised fleet would turn
        # any executor exception into a stuck tenant); the default policy
        # has no deadline, so latency behaviour is unchanged unless asked
        self.policy = policy if policy is not None else ResiliencePolicy()
        self._faults = faults
        # the injector's skewable clock drives deadlines/backoff/cooldown
        # so injected hangs resolve without real sleeping; without an
        # injector this is just perf_counter
        self._now = faults.clock.now if faults is not None else time.perf_counter
        # batching-delay policy: a lane dispatches only once it has
        # min_fill rows queued (or on a flush/drain).  1 = dispatch
        # whatever is queued every tick (lowest latency, the default);
        # block = full blocks only (highest throughput under per-arrival
        # pumping — every padded row is wasted lookup compute, since the
        # jitted block function always processes `block` rows)
        self.min_fill = int(min_fill)
        self.registry = (registry if registry is not None
                         else TenantRegistry(cache=cache, faults=faults,
                                             device=device))
        self.admission = admission or AdmissionController()
        self._lanes: Dict[str, _TenantLane] = {}
        # global retirement order: (lane, engine-that-dispatched), oldest
        # first — the engine ref keeps a swapped-out version alive exactly
        # until its last in-flight block retires
        self._order: Deque[Tuple[_TenantLane, LUTEngine]] = \
            collections.deque()
        self._rr = 0

    # -- tenant lifecycle ----------------------------------------------------
    def register(self, model_id: str, source: ArtifactSource, *,
                 reference: Optional[Reference] = None,
                 slo: Optional[TenantSLO] = None,
                 block: Optional[int] = None,
                 backend: Optional[str] = None,
                 mesh=None, placement=None) -> None:
        """Install version 1 of a tenant and open its serving lane.

        A :class:`~repro_torch.stream.cell.CompiledStreamCell` source (or an
        ``.npz`` carrying ``stream_cell`` metadata) opens a **stateful
        stream lane**: the lane's engine runs in cell mode and the
        stream APIs (:meth:`open_stream` / :meth:`submit_stream` /
        :meth:`close_stream`) become available."""
        if mesh is not None:
            if placement is not None:
                raise ValueError("pass either mesh= or placement=, not both")
            placement = backends.Placement(mesh)
        if isinstance(source, CompiledStreamCell):
            source = source.net     # extra_meta carries the cell split
        self.registry.register(model_id, source, reference=reference,
                               slo=slo)
        self._lanes[model_id] = _TenantLane(
            model_id, block=int(block or self.block), backend=backend,
            placement=placement,
            breaker=CircuitBreaker(self.policy.breaker_threshold,
                                   self.policy.breaker_cooldown_s))

    def deploy(self, model_id: str, source: ArtifactSource, *,
               reference: Optional[Reference] = None,
               strict: bool = False) -> SwapEvent:
        """Hot-swap a new artifact version (see TenantRegistry.deploy);
        the lane adopts a successful swap at its next tick boundary.

        For a stream tenant the lane migrates live per-stream state when
        it adopts the version (re-quantized or carried; incompatible
        state widths reset the streams) and stamps the mode onto the
        recorded :class:`SwapEvent` (``state_migration``)."""
        if isinstance(source, CompiledStreamCell):
            source = source.net
        return self.registry.deploy(model_id, source, reference=reference,
                                    strict=strict)

    def model_ids(self) -> List[str]:
        return list(self._lanes)

    # -- stats surface -------------------------------------------------------
    def stats(self, model_id: str) -> FleetStats:
        return self._lane(model_id).stats

    def queue_depth(self, model_id: str) -> int:
        return self._lane(model_id).queue_depth()

    @property
    def inflight(self) -> int:
        """Blocks dispatched fleet-wide but not yet retired."""
        return len(self._order)

    def summary(self, model_id: str) -> dict:
        """One tenant's full operational picture: FleetStats + live queue
        depth + serving version + rows/s + swap history."""
        lane = self._lane(model_id)
        entry = self.registry.get(model_id)
        out = lane.stats.summary()
        elapsed = ((lane.t_last - lane.t_first)
                   if lane.t_first is not None and lane.t_last is not None
                   else 0.0)
        out.update({
            "model_id": model_id,
            "version": entry.version,
            "queue_depth": lane.queue_depth(),
            "rows_per_s": (round(lane.stats.completed / elapsed, 1)
                           if elapsed > 0 else 0.0),
            "swap_history": [e.summary() for e in entry.history],
            "breaker": lane.breaker.state(self._now()),
            "degrade_history": [e.summary() for e in lane.degrade_log],
        })
        return out

    # -- submission ----------------------------------------------------------
    def submit_many(self, model_id: str, xs: np.ndarray
                    ) -> Tuple[List[LUTRequest], AdmissionDecision]:
        """Admit rows for one tenant.  Returns the accepted requests (in
        row order) and the admission decision; shed rows are simply not
        represented, deferred rows surface later through the same stats."""
        lane = self._lane(model_id)
        entry = self.registry.get(model_id)
        self._sync_lane(lane)
        xs = np.asarray(xs, np.float32)
        if xs.ndim != 2:
            raise ValueError(f"xs must be [n, in_features], got {xs.shape}")
        b_state = lane.breaker.state(self._now())
        if b_state == CircuitBreaker.OPEN or (
                b_state == CircuitBreaker.HALF_OPEN
                and lane.engine is not None and lane.engine.queue):
            # quarantined: the lane is mid-incident — reject at the door
            # through the tenant's shed/defer policy.
            # HALF_OPEN with queued rows still quarantines (the probe uses
            # the existing queue); an idle HALF_OPEN lane admits arrivals
            # so something exists to probe with
            decision = self.admission.quarantine(n=len(xs), slo=entry.slo)
        else:
            decision = self.admission.decide(
                n=len(xs), queue_depth=lane.queue_depth(),
                p99_us=self._p99_if_budgeted(lane, entry.slo), slo=entry.slo)
        now = time.perf_counter()
        if lane.t_first is None and (decision.accept or decision.defer):
            lane.t_first = now
        reqs: List[LUTRequest] = []
        if decision.accept:
            reqs = lane.engine.submit_many(xs[:decision.accept],
                                           t_submit=now)
        lane.stats.requests += decision.accept
        lane.stats.shed += decision.shed
        lane.stats.deferred += decision.defer
        if decision.defer:
            start = decision.accept
            lane.deferred.extend(
                (row, now) for row in xs[start:start + decision.defer])
        return reqs, decision

    def submit(self, model_id: str, x: np.ndarray
               ) -> Tuple[Optional[LUTRequest], AdmissionDecision]:
        """Single-row sugar over :meth:`submit_many`."""
        reqs, decision = self.submit_many(model_id,
                                          np.asarray(x, np.float32)[None])
        return (reqs[0] if reqs else None), decision

    # -- stateful streams ----------------------------------------------------
    def _stream_lane(self, model_id: str) -> _TenantLane:
        lane = self._lane(model_id)
        self._sync_lane(lane)
        if lane.cell is None:
            raise ValueError(f"model {model_id!r} is not a stream tenant "
                             "(register a CompiledStreamCell)")
        return lane

    def open_stream(self, model_id: str, stream_id, *,
                    state: Optional[np.ndarray] = None) -> StreamSession:
        """Open a persistent stream: its state (initially the zero state)
        lives with the lane until :meth:`close_stream`.

        ``state`` seeds the stream with existing state codes instead of
        the zero state — the failover-restore hook (``stream/replica.py``
        re-opens checkpointed streams on a standby with exactly the codes
        the primary had applied)."""
        lane = self._stream_lane(model_id)
        lane.store.open(stream_id)
        if state is not None:
            lane.store.put(stream_id, np.asarray(state, np.int32))
        lane.sessions[stream_id] = StreamSession(stream_id)
        lane.pending[stream_id] = collections.deque()
        return lane.sessions[stream_id]

    def submit_stream(self, model_id: str, stream_id,
                      xs: np.ndarray) -> StreamSession:
        """Feed one step (``[n_in]``) or many (``[T, n_in]``) to an open
        stream.  Steps run strictly in feed order, at most one in flight
        per stream; steps of different streams batch together."""
        lane = self._stream_lane(model_id)
        if stream_id in lane.closing:
            raise ValueError(f"stream {stream_id!r} is closing")
        xs = np.asarray(xs, np.float32)
        if xs.ndim == 1:
            xs = xs[None]
        now = time.perf_counter()
        if lane.t_first is None:
            lane.t_first = now
        lane.pending[stream_id].extend((row, now) for row in xs)
        lane.stats.requests += len(xs)
        return lane.sessions[stream_id]

    def close_stream(self, model_id: str, stream_id) -> StreamSession:
        """Mark a stream closed; already-fed steps still complete.  The
        state is dropped (``session.final_state`` stamped) once idle."""
        lane = self._stream_lane(model_id)
        if stream_id not in lane.sessions:
            raise KeyError(f"unknown stream {stream_id!r}")
        lane.closing.add(stream_id)
        self._finalize_closed(lane)
        return lane.sessions[stream_id]

    def _admit_streams(self, lane: _TenantLane) -> None:
        """One pending step per non-busy stream into the engine queue,
        with the stream's current state codes attached."""
        if lane.cell is None:
            return
        for sid, pend in lane.pending.items():
            if not pend or sid in lane.busy:
                continue
            x, t0 = pend.popleft()
            req = lane.engine.submit(x, state=lane.store.get(sid),
                                     stream_id=sid)
            req.t_submit = t0   # latency counts from submit_stream
            lane.busy.add(sid)

    def _writeback_streams(self, lane: _TenantLane, engine: LUTEngine,
                           batch: List[LUTRequest]) -> None:
        """Persist next-state codes after a cell-mode block retires.  A
        step that ran on a swapped-out engine version has its state
        mapped onto the CURRENT boundary before writeback (or discarded
        when the swap reset the streams)."""
        used = engine.cell
        for req in batch:
            sid = req.stream_id
            if sid is None or req.next_state is None:
                continue
            lane.busy.discard(sid)
            if sid in lane.sessions:
                lane.sessions[sid].steps.append(req)
            if sid not in lane.store:
                continue        # closed mid-flight
            s = req.next_state
            if used is not lane.store.cell:
                if state_migration_mode(used, lane.store.cell) is None:
                    continue    # swap reset this stream's state
                s = migrate_state_codes(used, lane.store.cell,
                                        s).cpu().numpy()
            lane.store.put(sid, s)
        self._finalize_closed(lane)

    def _finalize_closed(self, lane: _TenantLane) -> None:
        done = [sid for sid in lane.closing
                if sid not in lane.busy and not lane.pending.get(sid)]
        for sid in done:
            lane.sessions[sid].final_state = lane.store.close(sid)
            lane.pending.pop(sid, None)
            lane.closing.discard(sid)

    # -- the pump ------------------------------------------------------------
    def tick(self, *, flush: bool = False,
             timeout: Optional[float] = None) -> int:
        """One fleet tick: round-robin one block dispatch per tenant with
        work (continuous cross-tenant batching), then retire oldest-first
        until at most ``depth - 1`` blocks remain in flight.  Returns the
        number of requests completed.

        A lane below the ``min_fill`` batching threshold holds its rows
        for a fuller block unless ``flush=True`` (or :meth:`pump` detects
        that nothing else will arrive).

        Supervision: a dispatch that raises is absorbed into the lane's
        failure lifecycle (retry/breaker/degrade) instead of propagating;
        an in-flight block older than the policy deadline is abandoned
        and recomputed.  ``timeout`` (seconds, injector clock) bounds the
        retire wait — a block older than that raises a diagnostic
        :class:`DrainTimeout` naming the lane."""
        lanes = list(self._lanes.values())
        if lanes:
            # rotate the start so no tenant permanently dispatches first
            self._rr = (self._rr + 1) % len(lanes)
            lanes = lanes[self._rr:] + lanes[:self._rr]
        for lane in lanes:
            self._sync_lane(lane)
            self._drain_deferred(lane)
            self._admit_streams(lane)
            fill = 1 if flush else min(self.min_fill, lane.block)
            if len(lane.engine.queue) >= fill and self._may_dispatch(lane):
                try:
                    batch = lane.engine.dispatch_block()
                except Exception as exc:
                    # dispatch_block requeued the batch (exception-safe);
                    # route the failure through retry/breaker/degrade
                    self._on_lane_failure(lane, exc)
                    continue
                if self._faults is not None:
                    # lane_dispatch seam: slow_start skews the clock AFTER
                    # the block stamped its dispatch time, so its age
                    # already exceeds the stall when supervision looks
                    self._faults.lane_dispatch(scope=lane.model_id)
                lane.stats.ticks += 1
                lane.stats.rows_padded += lane.block - len(batch)
                self._order.append((lane, lane.engine))
        completed = 0
        while len(self._order) > self.depth - 1:
            completed += self._retire_one(timeout=timeout)
        return completed

    def drain(self, timeout: Optional[float] = None) -> int:
        """Retire every in-flight block (the only unconditional wait).
        ``timeout`` bounds each wait as in :meth:`tick`."""
        completed = 0
        while self._order:
            completed += self._retire_one(timeout=timeout)
        return completed

    def pump(self, max_ticks: int = 100_000,
             timeout: Optional[float] = None) -> int:
        """Tick until every queue (incl. deferred) is empty, then drain.
        Returns total requests completed; raises if ``max_ticks`` is hit
        (a wedged deferred queue is a bug, not a steady state).
        ``timeout`` bounds every blocking retire wait (DrainTimeout names
        the stuck lane)."""
        completed = 0
        for _ in range(max_ticks):
            if not any(l.queue_depth() for l in self._lanes.values()):
                return completed + self.drain(timeout=timeout)
            before = sum(l.stats.ticks for l in self._lanes.values())
            completed += self.tick(timeout=timeout)
            stalled = (before == sum(l.stats.ticks
                                     for l in self._lanes.values()))
            if stalled and any(l.queue_depth()
                               for l in self._lanes.values()):
                # nothing dispatched but work remains: every lane with
                # rows is below the min_fill threshold (or gated on a
                # deferred queue whose lane must go idle first, or backing
                # off / quarantined after a failure).  No more arrivals
                # come through pump(), so retire what's in flight and
                # flush the partial blocks instead of spinning.
                completed += self.drain(timeout=timeout)
                completed += self.tick(flush=True, timeout=timeout)
        raise RuntimeError(f"fleet did not go idle in {max_ticks} ticks")

    # -- internals -----------------------------------------------------------
    def _lane(self, model_id: str) -> _TenantLane:
        try:
            return self._lanes[model_id]
        except KeyError:
            raise KeyError(
                f"unknown model {model_id!r}; registered: "
                f"{sorted(self._lanes)}") from None

    def _sync_lane(self, lane: _TenantLane) -> None:
        """Adopt the registry's current version: build the new engine off
        the LRU executor cache and migrate queued (not in-flight) work.

        Stream lanes additionally migrate live per-stream state (store +
        queued step requests) onto the new version's in-boundary and stamp
        the migration mode onto the deploy's SwapEvent; in-flight steps
        retire on the engine that dispatched them and their next-state is
        mapped forward at writeback."""
        entry = self.registry.get(lane.model_id)
        if lane.version == entry.version:
            return
        sc = entry.net.extra_meta.get("stream_cell")
        if sc is not None:
            new_cell = CompiledStreamCell.from_network(entry.net,
                                                       like=lane.cell)
            # the cell owns its per-(backend, placement) step — the
            # registry's executor cache only covers feed-forward plans
            engine = LUTEngine(entry.net, block=lane.block, cell=new_cell,
                               backend=lane.backend,
                               placement=lane.placement,
                               faults=self._faults, scope=lane.model_id)
            if lane.store is None:
                lane.store = StreamStore(new_cell)
            else:
                mode = lane.store.migrate(new_cell)
                self._record_migration(entry, mode)
                self._migrate_queued_states(lane, new_cell, mode)
            lane.cell = new_cell
        else:
            ex = self.registry.executor(lane.model_id, backend=lane.backend,
                                        placement=lane.placement)
            engine = LUTEngine(entry.net, block=lane.block, executor=ex,
                               faults=self._faults, scope=lane.model_id)
        if lane.engine is not None and lane.engine.queue:
            engine.queue.extend(lane.engine.queue)
            lane.engine.queue.clear()
        lane.engine = engine
        lane.version = entry.version
        if lane.breaker.state(self._now()) != CircuitBreaker.CLOSED:
            # a deploy raced the lane's incident: the freshly adopted
            # version is a new executor — let it probe immediately rather
            # than waiting out a cooldown earned by the old one
            lane.breaker.force_half_open(self._now())
            lane.not_before = 0.0

    def _migrate_queued_states(self, lane: _TenantLane,
                               new_cell: CompiledStreamCell,
                               mode: str) -> None:
        """Queued (admitted, not dispatched) stream steps carry state
        codes captured on the OLD boundary; map them before they migrate
        to the new engine's queue."""
        if lane.engine is None or not lane.engine.queue:
            return
        zero = new_cell.cell.zero_state_code()
        for req in lane.engine.queue:
            if req.state is None:
                continue
            if mode == "drained+reset":
                req.state = np.full((new_cell.cell.n_state,), zero,
                                    np.int32)
            elif mode == "requantized":
                req.state = migrate_state_codes(
                    lane.cell, new_cell, req.state).cpu().numpy()

    @staticmethod
    def _record_migration(entry, mode: str) -> None:
        """Stamp the migration mode onto the deploy's SwapEvent (the last
        successful event that produced the adopted version)."""
        for i in range(len(entry.history) - 1, -1, -1):
            ev = entry.history[i]
            if ev.ok and ev.to_version == entry.version:
                entry.history[i] = dataclasses.replace(
                    ev, state_migration=mode)
                break

    @staticmethod
    def _p99_if_budgeted(lane: _TenantLane, slo: Optional[TenantSLO]
                         ) -> float:
        """The observed p99 only when a latency budget will read it: the
        percentile walks the whole latency window (up to LATENCY_WINDOW
        floats) and computing it per submit for unbudgeted tenants costs
        more than the fleet's entire scheduling overhead."""
        if slo is None or slo.p99_budget_us is None:
            return 0.0
        return lane.stats.latency_us(99)

    def _drain_deferred(self, lane: _TenantLane) -> None:
        if not lane.deferred:
            return
        entry = self.registry.get(lane.model_id)
        allowance = self.admission.may_drain_deferred(
            queue_depth=len(lane.engine.queue),
            p99_us=self._p99_if_budgeted(lane, entry.slo), slo=entry.slo)
        if not lane.engine.queue and not any(
                l is lane for l, _ in self._order):
            # the storm is definitionally over for an idle lane: re-admit
            # at least one block so deferred work cannot wedge on a stale
            # p99 window that nothing is refreshing
            allowance = max(allowance, lane.block)
        n = min(allowance, len(lane.deferred))
        if n <= 0:
            return
        rows = [lane.deferred.popleft() for _ in range(n)]
        reqs = lane.engine.submit_many(np.stack([r for r, _ in rows]))
        for req, (_, t0) in zip(reqs, rows):
            req.t_submit = t0   # latency counts from ORIGINAL arrival
        lane.stats.requests += n

    def _retire_one(self, timeout: Optional[float] = None) -> int:
        lane, engine = self._order[0]
        age = engine.oldest_age()
        if (self.policy.deadline_s is not None
                and age > self.policy.deadline_s):
            # deadline supervision: give up on the block without waiting,
            # requeue its rows (attempts bumped) and count the failure —
            # recomputation is safe because backends are bit-identical
            self._order.popleft()
            batch = engine.abandon_oldest()
            self._reclaim_batch(lane, engine, len(batch))
            lane.stats.deadline_hits += 1
            self._on_lane_failure(
                lane, None, kind="deadline",
                detail=f"block of {len(batch)} aged {age:.4f}s "
                       f"(deadline {self.policy.deadline_s:.4f}s)")
            return 0
        if timeout is not None and age > timeout:
            raise DrainTimeout(
                f"fleet wait timed out: oldest in-flight block on lane "
                f"{lane.model_id!r} (backend {engine.backend!r}) is "
                f"{age:.3f}s old (timeout {timeout:.3f}s); "
                f"{engine.inflight} block(s) in flight",
                scope=lane.model_id, age_s=age)
        self._order.popleft()
        batch = engine.retire_oldest()
        if engine.cell is not None:
            self._writeback_streams(lane, engine, batch)
        now = time.perf_counter()
        lane.t_last = now
        lane.stats.completed += len(batch)
        # one C-level extend, not a per-row append: this loop runs for
        # every served row and is the fleet's only per-row bookkeeping
        lane.stats.request_latencies_us.extend(
            (now - req.t_submit) * 1e6 for req in batch if req.t_submit)
        if batch:
            self._on_lane_success(lane)
        return len(batch)

    # -- failure supervision -------------------------------------------------
    def _may_dispatch(self, lane: _TenantLane) -> bool:
        """Breaker + retry-backoff gate in front of every lane dispatch."""
        now = self._now()
        return lane.breaker.allow_dispatch(now) and now >= lane.not_before

    def _reclaim_batch(self, lane: _TenantLane, engine: LUTEngine,
                       n: int) -> None:
        """An abandoned block's rows were requeued onto the engine that
        DISPATCHED them; if a swap/degrade raced, move them to the lane's
        current engine (mapping stream state across the boundary)."""
        if engine is lane.engine or lane.engine is None or n == 0:
            return
        moved = [engine.queue.popleft() for _ in range(n)]
        if lane.cell is not None and engine.cell is not lane.cell:
            mode = state_migration_mode(engine.cell, lane.cell)
            zero = lane.cell.cell.zero_state_code()
            for req in moved:
                if req.state is None:
                    continue
                if mode == "requantized":
                    req.state = migrate_state_codes(
                        engine.cell, lane.cell, req.state).cpu().numpy()
                elif mode != "carried":
                    req.state = np.full((lane.cell.cell.n_state,), zero,
                                        np.int32)
        lane.engine.queue.extendleft(reversed(moved))

    def _on_lane_success(self, lane: _TenantLane) -> None:
        """A retire completed: close the breaker and, if an incident was
        open, stamp its recovery time."""
        lane.breaker.record_success()
        lane.not_before = 0.0
        if lane.down_since is not None:
            lane.stats.recovery_s.append(self._now() - lane.down_since)
            lane.down_since = None

    def _on_lane_failure(self, lane: _TenantLane, exc: Optional[Exception],
                         *, kind: Optional[str] = None,
                         detail: str = "") -> None:
        """One detected failure: count it, back off, and trip the breaker
        into graceful degradation when the lane keeps failing."""
        now = self._now()
        if kind is None:
            kind = ("device_loss" if isinstance(exc, DeviceLost)
                    else "exception")
        lane.stats.failures += 1
        if lane.down_since is None:
            lane.down_since = now
        tripped = lane.breaker.record_failure(now)
        lane.failure_log.append(FailureEvent(
            model_id=lane.model_id, kind=kind,
            detail=detail or (str(exc) if exc is not None else kind), t=now,
            consecutive=lane.breaker.consecutive_failures))
        if kind == "device_loss":
            # a lost device stays lost: retrying the same placement cannot
            # succeed, re-plan immediately
            tripped = True
        if not tripped and lane.engine is not None and lane.engine.queue:
            # bounded retry: a request that has burned its attempt budget
            # escalates straight to re-planning instead of retrying again
            worst = max((r.attempts for r in lane.engine.queue), default=0)
            if worst > self.policy.max_retries:
                tripped = True
        if not tripped:
            lane.stats.retries += 1
            lane.not_before = now + self.policy.backoff_s(
                lane.breaker.consecutive_failures)
            return
        lane.stats.breaker_trips += 1
        if not self._degrade(lane, exc, kind):
            # nothing left to degrade to: fail loudly with the cause
            if exc is not None:
                raise exc
            raise RuntimeError(
                f"lane {lane.model_id!r} exhausted every fallback "
                f"({kind}; {lane.stats.failures} failures)")

    def _degrade(self, lane: _TenantLane, exc: Optional[Exception],
                 kind: str) -> bool:
        """Graceful degradation: re-plan the lane onto a surviving
        backend×placement.  Device loss with survivors re-meshes the same
        backend over the remaining devices (validated by
        ``elastic.plan_serving_remesh``); anything else — or no survivors
        — falls back to the layered reference backend, unplaced.  Returns
        False when the lane is already on the last-resort plan.

        Bit-identity across backends×placements is what makes this safe:
        the re-planned executor returns the exact codes the failed one
        would have."""
        from repro_torch.dist import elastic
        now = self._now()
        old_backend = (lane.engine.backend if lane.engine is not None
                       else (lane.backend or "?"))
        old_pl = lane.placement
        old_shards = old_pl.mesh.size if old_pl is not None else 0
        new_backend, new_pl, plan_reason = None, None, ""
        if (isinstance(exc, DeviceLost) and old_pl is not None
                and self._faults is not None):
            survivors = self._faults.alive_devices(old_pl)
            plan = elastic.plan_serving_remesh(old_shards, len(survivors),
                                              tenants=len(self._lanes))
            plan_reason = plan.reason
            if plan.ok and 0 < len(survivors) < old_shards:
                new_backend = lane.backend
                new_pl = dataclasses.replace(
                    old_pl, mesh=DeviceMesh(tuple(survivors),
                                            old_pl.mesh.axis_names))
        if new_pl is None:
            fb = self.policy.fallback_backend
            if old_backend == fb and old_pl is None:
                return False            # already at the last resort
            new_backend, new_pl = fb, None
        lane.backend, lane.placement = new_backend, new_pl
        self._rebuild_lane_engine(lane)
        ev = DegradeEvent(
            model_id=lane.model_id, reason=kind,
            from_backend=old_backend,
            to_backend=lane.engine.backend,
            from_shards=old_shards,
            to_shards=new_pl.mesh.size if new_pl is not None else 0,
            t=now, plan_reason=plan_reason)
        lane.degrade_log.append(ev)
        lane.stats.degrades += 1
        # the fresh executor probes immediately: HALF_OPEN without waiting
        # out the cooldown (arrivals stay quarantined until it succeeds
        # only while OPEN — a working probe closes the breaker)
        lane.breaker.force_half_open(now)
        lane.not_before = 0.0
        return True

    def _rebuild_lane_engine(self, lane: _TenantLane) -> None:
        """Swap the lane onto a fresh engine for its CURRENT registry
        version and (possibly degraded) backend×placement, migrating the
        queued rows; in-flight blocks still retire on the old engine."""
        entry = self.registry.get(lane.model_id)
        if lane.cell is not None:
            engine = LUTEngine(entry.net, block=lane.block, cell=lane.cell,
                               backend=lane.backend,
                               placement=lane.placement,
                               faults=self._faults, scope=lane.model_id)
        else:
            ex = self.registry.executor(lane.model_id, backend=lane.backend,
                                        placement=lane.placement)
            engine = LUTEngine(entry.net, block=lane.block, executor=ex,
                               faults=self._faults, scope=lane.model_id)
        if lane.engine is not None and lane.engine.queue:
            engine.queue.extend(lane.engine.queue)
            lane.engine.queue.clear()
        lane.engine = engine
