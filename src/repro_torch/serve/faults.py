"""Deterministic fault injection for the serving stack (the port of
``repro.serve.faults``; pure Python and numpy, so a seed gives the same
plan and the same fired-event log in both packages).

The resilience layer (deadlines, retries, circuit breakers, degradation,
stream failover) is only trustworthy if every failure mode it claims to
survive can be reproduced on demand.  This module is that harness: a
seedable :class:`FaultPlan` of :class:`FaultSpec` entries fired by a
:class:`FaultInjector` at three *seams* the serving stack already owns —
no monkeypatching, the engine/fleet/registry call the injector at the
seam themselves when one is configured:

``executor_call``
    inside ``LUTEngine.dispatch_block``, immediately before the planned
    executor (or stream cell) is invoked.  Kinds: ``exception`` (the
    executor raises :class:`ExecutorFault`), ``hang`` (the block appears
    wedged: the injector's :class:`FaultClock` jumps forward by
    ``stall_s`` so any deadline is blown without real sleeping), and
    ``device_loss`` (one slot of the engine's placement is marked dead
    and :class:`DeviceLost` raised — and *stays* dead: every later
    dispatch on a placement containing it re-raises until the fleet
    re-plans onto the survivors).

``lane_dispatch``
    inside ``LUTFleet``'s per-lane dispatch path, before the engine is
    asked for a block.  Kind: ``slow_start`` (a freshly adopted executor
    stalls on first dispatch — clock jump, same deadline mechanics).

``registry_load``
    inside ``TenantRegistry.deploy`` after a candidate artifact is read
    from disk.  Kind: ``corrupt_artifact`` (the low bit of the last LUT
    table is flipped, the exact corruption the bit-identity smoke check
    exists to catch — the deploy must be rejected and rolled back).

Faults are matched by *crossing count*: each seam keeps one counter per
``scope`` (the tenant/model id, or ``None`` for scope-blind specs) and a
spec fires on crossings ``[at, at + count)``.  With a fixed plan and a
single-threaded pump the whole failure schedule is reproducible, which
is what lets ``benchmarks/torch_chaos_soak.py`` commit recovery numbers and
lets tests assert exact recovery behaviour.

Timing uses :class:`FaultClock` — ``time.perf_counter`` plus an
injectable skew.  Real time always advances (backoff/cooldown still
expire naturally); injected hangs advance only the skew, so a "30 s
hang" costs microseconds of wall time while still blowing a 50 ms
deadline.  Engines and fleets built with an injector share its clock so
dispatch stamps and deadline checks agree.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "SEAMS",
    "InjectedFault",
    "ExecutorFault",
    "DeviceLost",
    "DrainTimeout",
    "FaultClock",
    "FaultSpec",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
]

FAULT_KINDS = ("exception", "hang", "device_loss", "slow_start", "corrupt_artifact")
SEAMS = ("executor_call", "lane_dispatch", "registry_load")

# each kind fires at exactly one seam — a plan is validated against this
_KIND_SEAM = {
    "exception": "executor_call",
    "hang": "executor_call",
    "device_loss": "executor_call",
    "slow_start": "lane_dispatch",
    "corrupt_artifact": "registry_load",
}


class InjectedFault(RuntimeError):
    """Base class for every fault the injector raises."""


class ExecutorFault(InjectedFault):
    """An injected executor exception (transient unless the plan repeats it)."""


class DeviceLost(InjectedFault):
    """A placement slot died.  ``device_ids`` lists the dead slot ids."""

    def __init__(self, message: str, device_ids: Tuple[int, ...] = ()):
        super().__init__(message)
        self.device_ids = tuple(device_ids)


class DrainTimeout(RuntimeError):
    """A drain/pump wait exceeded its timeout.

    Diagnostic, not silent: names the stuck scope (lane / model id), the
    oldest in-flight block's size and age, so the operator knows *which*
    tenant wedged rather than staring at a hung process.
    """

    def __init__(self, message: str, *, scope: Optional[str] = None,
                 requests: int = 0, age_s: float = 0.0):
        super().__init__(message)
        self.scope = scope
        self.requests = int(requests)
        self.age_s = float(age_s)


class FaultClock:
    """``time.perf_counter`` plus injectable skew.

    ``advance()`` models time passing without sleeping: an injected hang
    adds its stall to the skew, so deadline checks (which read this
    clock) see the block as ancient while the test finishes in
    microseconds.  Real time still flows underneath, so retry backoff
    and breaker cooldowns expire on their own.
    """

    def __init__(self) -> None:
        self._skew = 0.0

    @property
    def skew(self) -> float:
        return self._skew

    def now(self) -> float:
        return time.perf_counter() + self._skew

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clock only advances")
        self._skew += float(dt)
        return self.now()


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault.

    kind     one of FAULT_KINDS; determines the seam (see _KIND_SEAM).
    at       fire on the seam's Nth crossing for ``scope`` (0-based).
    scope    tenant/model id the spec targets; None matches any scope
             (counted on the seam's global counter).
    count    number of consecutive crossings that fire (>= 1) — e.g.
             ``count=3`` makes an exception persistent enough to trip a
             threshold-3 circuit breaker.
    stall_s  clock skew added by hang / slow_start faults.
    device   for device_loss: index into the placement's slot list
             (modulo its length) naming which slot dies.
    """

    kind: str
    at: int = 0
    scope: Optional[str] = None
    count: int = 1
    stall_s: float = 1.0
    device: int = 0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.at < 0 or self.count < 1:
            raise ValueError("FaultSpec needs at >= 0 and count >= 1")
        if self.stall_s < 0:
            raise ValueError("stall_s must be >= 0")

    @property
    def seam(self) -> str:
        return _KIND_SEAM[self.kind]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """Record of one fired fault (the injector keeps an append-only log)."""

    kind: str
    seam: str
    scope: Optional[str]
    crossing: int
    t: float


class FaultPlan:
    """An immutable schedule of :class:`FaultSpec` entries."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        by_seam: Dict[str, List[FaultSpec]] = {s: [] for s in SEAMS}
        for spec in self.specs:
            by_seam[spec.seam].append(spec)
        self._by_seam = {k: tuple(v) for k, v in by_seam.items()}

    def specs_for(self, seam: str) -> Tuple[FaultSpec, ...]:
        return self._by_seam.get(seam, ())

    def __len__(self) -> int:
        return len(self.specs)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPlan({list(self.specs)!r})"

    @classmethod
    def seeded(cls, seed: int, *, scopes: Sequence[str],
               kinds: Sequence[str] = ("exception", "hang", "slow_start"),
               n_faults: int = 8, max_at: int = 40, stall_s: float = 1.0,
               max_count: int = 1) -> "FaultPlan":
        """Deterministically sample a plan for the soak bench.

        Same seed → same plan, so a chaos soak run is replayable.  The
        default kinds are the ones that are safe to sprinkle anywhere;
        ``device_loss`` / ``corrupt_artifact`` change lane topology and
        are usually placed by hand in targeted scenarios.
        """
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds)
        scopes = tuple(scopes)
        if not kinds or not scopes:
            raise ValueError("seeded plan needs at least one kind and one scope")
        specs = []
        for _ in range(int(n_faults)):
            specs.append(FaultSpec(
                kind=kinds[int(rng.integers(len(kinds)))],
                at=int(rng.integers(max_at)),
                scope=scopes[int(rng.integers(len(scopes)))],
                count=int(rng.integers(1, max_count + 1)),
                stall_s=float(stall_s),
            ))
        return cls(specs)


class FaultInjector:
    """Fires a :class:`FaultPlan` at the serving seams.

    One injector is shared by a fleet and all its engines: it owns the
    :class:`FaultClock`, the per-(seam, scope) crossing counters, the
    set of dead device ids, and the log of fired :class:`FaultEvent`s.
    """

    def __init__(self, plan: Optional[FaultPlan] = None,
                 clock: Optional[FaultClock] = None):
        self.plan = plan if plan is not None else FaultPlan()
        self.clock = clock if clock is not None else FaultClock()
        self.events: List[FaultEvent] = []
        self.dead_devices: set = set()
        self._crossings: Dict[Tuple[str, Optional[str]], int] = {}

    # -- crossing bookkeeping -------------------------------------------------
    def _cross(self, seam: str, scope: Optional[str]) -> Optional[FaultSpec]:
        """Count one crossing of ``seam`` by ``scope``; return the spec to
        fire, if any.  Scoped specs match the scope's own counter; scope-None
        specs match the seam's global counter (counted across all scopes)."""
        hits = []
        key_scopes = (scope, None) if scope is not None else (None,)
        for key_scope in key_scopes:  # scoped specs take precedence over global
            key = (seam, key_scope)
            n = self._crossings.get(key, 0)
            self._crossings[key] = n + 1
            for spec in self.plan.specs_for(seam):
                if spec.scope != key_scope:
                    continue
                if spec.at <= n < spec.at + spec.count:
                    hits.append((spec, n))
        if not hits:
            return None
        spec, n = hits[0]
        self.events.append(FaultEvent(kind=spec.kind, seam=seam, scope=scope,
                                      crossing=n, t=self.clock.now()))
        return spec

    # -- seams ---------------------------------------------------------------
    def executor_call(self, scope: Optional[str] = None, placement=None) -> None:
        """The engine-side seam.  Raises / skews the clock per plan, and
        keeps lost devices lost for any placement that still uses them."""
        self.check_placement(placement, scope=scope)
        spec = self._cross("executor_call", scope)
        if spec is None:
            return
        if spec.kind == "exception":
            raise ExecutorFault(f"injected executor exception (scope={scope!r})")
        if spec.kind == "hang":
            # dispatch already stamped its start time; the skew makes the
            # block look stall_s old when the fleet checks its deadline
            self.clock.advance(spec.stall_s)
            return
        if spec.kind == "device_loss":
            ids = self._placement_device_ids(placement)
            if ids:
                dead = ids[spec.device % len(ids)]
                self.dead_devices.add(dead)
                raise DeviceLost(
                    f"injected device loss: device {dead} (scope={scope!r})",
                    device_ids=(dead,))
            # unplaced executor: its (only) device vanished — no survivors
            raise DeviceLost(f"injected device loss on unplaced executor (scope={scope!r})")

    def lane_dispatch(self, scope: Optional[str] = None) -> None:
        """The fleet-side seam, before a lane's engine dispatches."""
        spec = self._cross("lane_dispatch", scope)
        if spec is not None and spec.kind == "slow_start":
            self.clock.advance(spec.stall_s)

    def registry_load(self, scope: Optional[str], net):
        """The registry-side seam: may corrupt a freshly loaded artifact.

        Only ever handed networks the registry just parsed from disk, so
        flipping table bits in place cannot reach a caller-owned object.
        """
        spec = self._cross("registry_load", scope)
        if spec is not None and spec.kind == "corrupt_artifact":
            # the port's artifact keeps its folded tables as numpy int32
            t = np.array(net.tables[-1], copy=True)
            t ^= 1  # low-bit flip of every entry: valid codes, wrong answers
            net.tables[-1] = t
        return net

    # -- device-loss bookkeeping ---------------------------------------------
    @staticmethod
    def _placement_device_ids(placement) -> Tuple[int, ...]:
        if placement is None or getattr(placement, "mesh", None) is None:
            return ()
        return tuple(int(d.id) for d in placement.mesh.devices.flat)

    def check_placement(self, placement, scope: Optional[str] = None) -> None:
        """Raise :class:`DeviceLost` if ``placement`` uses a dead device."""
        if not self.dead_devices:
            return
        dead = tuple(i for i in self._placement_device_ids(placement)
                     if i in self.dead_devices)
        if dead:
            raise DeviceLost(
                f"placement uses lost device(s) {sorted(dead)} (scope={scope!r})",
                device_ids=dead)

    def alive_devices(self, placement) -> list:
        """The placement's slots that are still alive, in mesh order."""
        if placement is None or getattr(placement, "mesh", None) is None:
            return []
        return [d for d in placement.mesh.devices.flat
                if int(d.id) not in self.dead_devices]

    # -- reporting -----------------------------------------------------------
    def fired(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return len(self.events)
        return sum(1 for e in self.events if e.kind == kind)
