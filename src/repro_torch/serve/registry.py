"""Tenant registry: versioned ``CompiledLUTNetwork`` artifacts + executors
(the port of ``repro.serve.registry``).

The fleet tier hosts many self-contained ``.npz`` artifacts in one
process.  This module owns the two stateful pieces underneath it:

  * :class:`TenantRegistry` — model-id -> versioned artifact.  ``register``
    installs version 1; ``deploy`` loads a NEW version behind a
    **bit-identity smoke check** (the candidate must reproduce reference
    codes exactly before it is allowed to serve) and swaps it in
    atomically on success — on mismatch the incumbent keeps serving and
    the rejection lands in the tenant's swap history.  Every swap attempt
    (ok or rolled back) is a :class:`SwapEvent` in ``history(model_id)``.

  * :class:`ExecutorCache` — the per-(artifact version, backend, placement)
    executor cache, LRU-evicted under a configurable byte/entry budget.
    Executors are built OUTSIDE the artifact's own internal cache so that
    evicting an entry really drops the last registry-held reference (an
    old version's tables and device buffers become collectable once no
    engine still holds them).  Plans are still reused through
    ``net._plans``.

References (:class:`Reference`) are (inputs, expected codes) pairs.
``make_reference`` derives one from a known-good artifact with the ``take``
oracle backend; producers ship it alongside a deploy so the smoke check
catches artifacts corrupted after training (perturbed tables produce
different codes and are rejected).  A deploy without a reference still
self-checks: serving-backend codes must match the ``take`` oracle on the
candidate itself (catches plan/backend corruption, not table corruption).

Artifacts given as paths load onto the registry's ``device`` (CUDA unless
the caller says ``"cpu"``); a deploy candidate loads onto the device of
the version it replaces.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import backends
from repro_torch.pipeline import CompiledLUTNetwork, PlannedExecutor

ORACLE_BACKEND = "take"


# ---------------------------------------------------------------------------
# references + smoke check
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Reference:
    """Deterministic smoke-check anchor: inputs + expected integer codes."""

    x: np.ndarray        # [n, in_features] float32
    codes: np.ndarray    # [n, n_out] int32 (oracle-backend output)


def make_reference(net: CompiledLUTNetwork, *, n: int = 64,
                   seed: int = 0) -> Reference:
    """Reference codes of a KNOWN-GOOD artifact (``take`` oracle backend).

    Producers call this right after compiling/training, while the tables
    are trusted, and ship the result with every subsequent deploy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0,
                    (n, net.cfg.in_features)).astype(np.float32)
    codes = net.predict_codes(x, backend=ORACLE_BACKEND).cpu().numpy()
    return Reference(x=x, codes=codes)


def smoke_check(net: CompiledLUTNetwork, reference: Optional[Reference],
                *, backend: Optional[str] = None
                ) -> Tuple[bool, str, int]:
    """Bit-identity gate for a deploy candidate.

    Returns ``(ok, reason, rows_checked)``.  With a ``reference`` the
    candidate's serving-backend codes must equal the reference codes
    exactly; without one, the serving backend is cross-checked against the
    ``take`` oracle on self-generated inputs (weaker: consistent table
    corruption passes, backend/plan corruption does not)."""
    backend = backend or net.backend
    if reference is None:
        reference = make_reference(net)  # oracle codes of the candidate
        mode = "self-check"
    else:
        mode = "reference"
    got = net.predict_codes(reference.x, backend=backend).cpu().numpy()
    n = len(reference.x)
    if got.shape != reference.codes.shape:
        return False, (f"{mode}: shape {got.shape} != "
                       f"{reference.codes.shape}"), n
    bad = int((got != reference.codes).any(axis=-1).sum())
    if bad:
        return False, f"{mode}: {bad}/{n} reference rows mismatch", n
    return True, f"{mode}: {n} rows bit-identical", n


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One deploy attempt, successful or rolled back."""

    model_id: str
    from_version: int
    to_version: int          # == from_version when rolled back
    ok: bool
    reason: str
    rows_checked: int
    t: float                 # wall-clock time of the attempt
    # stateful (stream) tenants only: how live per-stream state moved
    # across the swap — "carried" / "requantized" / "drained+reset".
    # Stamped by the fleet lane when it adopts the version (DESIGN.md §10).
    state_migration: Optional[str] = None

    def summary(self) -> dict:
        out = {"from": self.from_version, "to": self.to_version,
               "ok": self.ok, "reason": self.reason,
               "rows_checked": self.rows_checked}
        if self.state_migration is not None:
            out["state_migration"] = self.state_migration
        return out


# ---------------------------------------------------------------------------
# LRU executor cache
# ---------------------------------------------------------------------------

def executor_cost_bytes(net: CompiledLUTNetwork) -> int:
    """Byte footprint proxy for one planned executor of ``net``: tables +
    mappings + every plan buffer held alive by the artifact (the host
    arrays, the same count as the reference's; device copies are one more
    of each per device).  Tables dominate for LUT networks."""
    n = sum(t.nbytes for t in net.tables)
    n += sum(m.nbytes for m in net.mappings if m is not None)
    for plan in net._plans.values():
        n += sum(b.nbytes for b in plan.buffers.values())
    return n


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0


class ExecutorCache:
    """LRU cache of planned executors keyed by (model, version, backend,
    placement).

    ``max_bytes`` / ``max_entries`` bound the registry-held working set;
    eviction drops the cache's reference only — engines already holding an
    executor keep running, and a re-request simply rebuilds (plans are
    reused off the artifact, so a rebuild never re-plans).
    """

    def __init__(self, max_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self.stats = CacheStats()
        # key -> (executor, nbytes); insertion order == LRU order
        self._entries: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_held(self) -> int:
        return sum(nb for _, nb in self._entries.values())

    def executor(self, model_id: str, version: int,
                 net: CompiledLUTNetwork, *,
                 backend: Optional[str] = None,
                 placement=None) -> PlannedExecutor:
        """Fetch-or-build the executor for one artifact version."""
        backend = backend or net.backend
        key = (model_id, version, backend,
               None if placement is None else placement.cache_key())
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return hit[0]
        self.stats.misses += 1
        ex = self._build(net, backend, placement)
        self._entries[key] = (ex, executor_cost_bytes(net))
        self._evict()
        return ex

    def _build(self, net: CompiledLUTNetwork, backend: str,
               placement) -> PlannedExecutor:
        # mirror CompiledLUTNetwork.compile_backend's plan reuse/staleness
        # logic, but keep the executor OUT of net._executors so this cache
        # owns the only registry-side reference (eviction must free it)
        be = backends.resolve(backend)
        plan = net._plans.get(be.name)
        if plan is None or plan.meta.get("plan_format") != be.plan_format:
            plan = net._plans[be.name] = backends.make_plan(net.folded(), be)
        return PlannedExecutor(net, be, plan, placement=placement)

    def _evict(self) -> None:
        while ((self.max_entries is not None
                and len(self._entries) > self.max_entries)
               or (self.max_bytes is not None and len(self._entries) > 1
                   and self.bytes_held > self.max_bytes)):
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def drop_model(self, model_id: str) -> int:
        """Drop every cached executor of one model (all versions)."""
        stale = [k for k in self._entries if k[0] == model_id]
        for k in stale:
            del self._entries[k]
        return len(stale)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantEntry:
    """Current serving state of one model id."""

    model_id: str
    net: CompiledLUTNetwork
    version: int
    reference: Reference
    slo: Optional[object] = None          # admission.TenantSLO
    history: List[SwapEvent] = dataclasses.field(default_factory=list)


ArtifactSource = Union[str, CompiledLUTNetwork]


def _load(source: ArtifactSource, device=None) -> CompiledLUTNetwork:
    if isinstance(source, CompiledLUTNetwork):
        return source
    return CompiledLUTNetwork.load(source, device=device)


class TenantRegistry:
    """model-id -> versioned artifact, with smoke-checked hot swaps."""

    def __init__(self, cache: Optional[ExecutorCache] = None, *,
                 faults=None, device=None):
        # explicit None test: an EMPTY ExecutorCache is falsy (__len__ == 0)
        # and `cache or ...` would silently discard the caller's budgets
        self.cache = cache if cache is not None else ExecutorCache()
        self._entries: Dict[str, TenantEntry] = {}
        # fault seam (serve/faults.py): deploy candidates loaded from disk
        # cross the injector's registry_load seam, which may corrupt the
        # freshly parsed tables — the corruption the smoke check must catch
        self._faults = faults
        # where artifacts given as paths are registered (resolved at load:
        # CUDA by default, raising without a card)
        self.device = device

    # -- lookup --------------------------------------------------------------
    def __contains__(self, model_id: str) -> bool:
        return model_id in self._entries

    def model_ids(self) -> List[str]:
        return list(self._entries)

    def get(self, model_id: str) -> TenantEntry:
        try:
            return self._entries[model_id]
        except KeyError:
            raise KeyError(
                f"unknown model {model_id!r}; registered: "
                f"{sorted(self._entries)}") from None

    def history(self, model_id: str) -> List[SwapEvent]:
        return list(self.get(model_id).history)

    def executor(self, model_id: str, *, backend: Optional[str] = None,
                 placement=None) -> PlannedExecutor:
        e = self.get(model_id)
        return self.cache.executor(e.model_id, e.version, e.net,
                                   backend=backend, placement=placement)

    # -- lifecycle -----------------------------------------------------------
    def register(self, model_id: str, source: ArtifactSource, *,
                 reference: Optional[Reference] = None,
                 slo=None) -> TenantEntry:
        """Install version 1 of a model.  Computes a self-reference when
        none is shipped, so later deploys always have a rollback anchor."""
        if model_id in self._entries:
            raise ValueError(f"model {model_id!r} already registered; "
                             "use deploy() to ship a new version")
        net = _load(source, self.device)
        entry = TenantEntry(model_id=model_id, net=net, version=1,
                            reference=reference or make_reference(net),
                            slo=slo)
        self._entries[model_id] = entry
        return entry

    def unregister(self, model_id: str) -> None:
        self.get(model_id)
        del self._entries[model_id]
        self.cache.drop_model(model_id)

    def deploy(self, model_id: str, source: ArtifactSource, *,
               reference: Optional[Reference] = None,
               strict: bool = False) -> SwapEvent:
        """Zero-downtime hot swap: load the candidate, smoke-check it,
        swap atomically on success — instant rollback on mismatch.

        The incumbent serves throughout: the candidate is loaded and
        checked off to the side, and only a PASSING candidate is installed
        (one entry mutation; the fleet picks the new version up at its
        next tick boundary, in-flight blocks on the old version retire
        normally).  A failing candidate changes nothing except the swap
        history.  ``strict=True`` additionally raises on rejection —
        serving paths keep the default and read the returned event."""
        entry = self.get(model_id)
        t = time.time()
        try:
            net = _load(source, entry.net.device)
            if self._faults is not None and not isinstance(
                    source, CompiledLUTNetwork):
                # registry_load seam: only path-loaded candidates — the
                # injector may corrupt the freshly parsed copy in place,
                # never a caller-owned in-memory artifact
                net = self._faults.registry_load(model_id, net)
            ok, reason, rows = smoke_check(net, reference)
        except Exception as exc:  # unreadable/incompatible artifact
            ok, reason, rows, net = False, f"load failed: {exc}", 0, None
        if ok:
            event = SwapEvent(model_id=model_id,
                              from_version=entry.version,
                              to_version=entry.version + 1,
                              ok=True, reason=reason,
                              rows_checked=rows, t=t)
            entry.net = net
            entry.version += 1
            entry.reference = reference or make_reference(net)
        else:
            event = SwapEvent(model_id=model_id,
                              from_version=entry.version,
                              to_version=entry.version,
                              ok=False, reason=reason,
                              rows_checked=rows, t=t)
        entry.history.append(event)
        if strict and not ok:
            raise ValueError(f"deploy({model_id!r}) rejected: {reason}")
        return event
