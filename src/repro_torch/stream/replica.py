"""Stream-state replication for engine failover (the port of
``repro.stream.replica``; host numpy only, so checkpoints and logs are
byte-compatible with the reference's).

A stream's entire cross-step footprint is ``n_state`` integer codes, so
replicating live streams is cheap enough to do synchronously: the
primary ships every *acknowledged* step's input row to a standby's
:class:`ReplicationLog` before the step is accepted, and periodically
ships a :class:`StreamCheckpoint` — the code-space ``StreamStore``
snapshot plus per-stream applied-step counts.  Both cross the "wire" as
plain bytes / ndarrays (``StreamCheckpoint.to_bytes`` is a ``.npz``
payload), never as shared Python objects, so the standby could live in
another process or host.

Failover contract: when the primary dies, :meth:`StandbyReplica.activate`
builds a **fresh** fleet lane from the replicated artifact, re-opens
every live stream with its checkpointed state codes, and replays the
acked tail (steps after the checkpoint's applied count) in feed order.
Because the step transition is deterministic, bit-identical across
backends×placements, and the checkpoint is taken at a retire boundary
(state codes and applied counts update together in the fleet's
writeback), the recovered streams produce *exactly* the codes an
uninterrupted run would — verified per backend by
``tests/test_torch_faults.py`` and ``benchmarks/torch_chaos_soak.py``.  Acked-step durability is the
synchronous replicate-before-accept order: a step the caller saw
accepted is either in the standby's log or covered by a later
checkpoint, so zero acknowledged requests are lost.

Consistency note: a checkpoint may be taken while steps are in flight —
the store/sessions pair only advances at retire, so the snapshot is
always "state after exactly ``applied[sid]`` steps"; in-flight and
pending steps are simply part of the replayed tail.
"""
from __future__ import annotations

import collections
import io
import json
from typing import Deque, Dict, List, Optional

import numpy as np

__all__ = ["StreamCheckpoint", "ReplicationLog", "StandbyReplica",
           "ReplicatedStreamTenant", "checkpoint_streams"]


class StreamCheckpoint:
    """A code-space snapshot of every live stream of one tenant lane.

    ``states`` holds the packed state codes ([n_streams, n_state], the
    store's narrow dtype) and ``applied`` the number of steps each state
    has absorbed — the replay cursor into the replication log.
    """

    def __init__(self, model_id: str, seq: int, stream_ids: List,
                 states: np.ndarray, applied: List[int]):
        if len(stream_ids) != len(states) or len(stream_ids) != len(applied):
            raise ValueError("stream_ids/states/applied length mismatch")
        self.model_id = model_id
        self.seq = int(seq)
        self.stream_ids = list(stream_ids)
        self.states = np.asarray(states)
        self.applied = [int(a) for a in applied]

    def __len__(self) -> int:
        return len(self.stream_ids)

    def state_for(self, stream_id) -> Optional[np.ndarray]:
        try:
            return self.states[self.stream_ids.index(stream_id)]
        except ValueError:
            return None

    def applied_for(self, stream_id) -> int:
        try:
            return self.applied[self.stream_ids.index(stream_id)]
        except ValueError:
            return 0

    # -- wire format ---------------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize to a self-contained ``.npz`` payload (the checkpoint
        is what crosses hosts — no live objects)."""
        bio = io.BytesIO()
        meta = json.dumps({"model_id": self.model_id, "seq": self.seq,
                           "stream_ids": self.stream_ids})
        np.savez(bio, meta=np.array(meta), states=self.states,
                 applied=np.asarray(self.applied, np.int64))
        return bio.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "StreamCheckpoint":
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            meta = json.loads(str(z["meta"][()]))
            return cls(meta["model_id"], meta["seq"], meta["stream_ids"],
                       z["states"], z["applied"].tolist())


def checkpoint_streams(fleet, model_id: str, seq: int) -> StreamCheckpoint:
    """Snapshot one tenant lane's live streams off a (primary) fleet.

    ``applied`` is ``len(session.steps)`` — the store's state codes and
    the session's completed-step list advance together at writeback, so
    the pair is consistent at any point between retires."""
    lane = fleet._stream_lane(model_id)
    sids = lane.store.stream_ids()
    n_state = lane.cell.cell.n_state
    states = (np.stack([lane.store.get(sid) for sid in sids])
              if sids else np.zeros((0, n_state), np.int32))
    applied = [len(lane.sessions[sid].steps) if sid in lane.sessions else 0
               for sid in sids]
    return StreamCheckpoint(model_id, seq, sids, states, applied)


class ReplicationLog:
    """Acked step inputs per stream, in feed order, prunable by checkpoint.

    The standby owns one; the primary appends synchronously (replicate
    before accept).  ``tail(sid, applied)`` returns the steps a recovered
    stream still has to replay; ``prune(ckpt)`` drops rows a checkpoint
    already covers so the log stays bounded by the checkpoint interval."""

    def __init__(self) -> None:
        self._rows: Dict[object, Deque[np.ndarray]] = {}
        self._base: Dict[object, int] = {}   # steps pruned from the front
        self.closed: set = set()

    def stream_ids(self) -> List:
        return list(self._rows)

    def open(self, stream_id) -> None:
        if stream_id in self._rows:
            raise ValueError(f"stream {stream_id!r} already replicated")
        self._rows[stream_id] = collections.deque()
        self._base[stream_id] = 0

    def ack(self, stream_id, xs: np.ndarray) -> int:
        """Append acked step rows ([n_in] or [T, n_in]); returns the
        stream's total acked step count."""
        xs = np.asarray(xs, np.float32)
        if xs.ndim == 1:
            xs = xs[None]
        self._rows[stream_id].extend(np.array(row) for row in xs)
        return self._base[stream_id] + len(self._rows[stream_id])

    def close(self, stream_id) -> None:
        self.closed.add(stream_id)

    def acked(self, stream_id) -> int:
        return self._base.get(stream_id, 0) + len(self._rows.get(stream_id, ()))

    def pruned_base(self, stream_id) -> int:
        """Steps pruned from the front (covered by shipped checkpoints)."""
        return self._base.get(stream_id, 0)

    def tail(self, stream_id, applied: int) -> np.ndarray:
        """Steps after the first ``applied`` ones, as [T, n_in] (T may be
        0).  ``applied`` below the pruned base means a checkpoint the
        caller skipped already covered those rows — an ordering bug."""
        rows = self._rows[stream_id]
        base = self._base[stream_id]
        if applied < base:
            raise ValueError(
                f"stream {stream_id!r}: replay from step {applied} but the "
                f"log was pruned to step {base} (stale checkpoint?)")
        skip = applied - base
        kept = list(rows)[skip:]
        if not kept:
            n_in = rows[0].shape[0] if rows else 0
            return np.zeros((0, n_in), np.float32)
        return np.stack(kept)

    def prune(self, ckpt: StreamCheckpoint) -> int:
        """Drop rows already absorbed into ``ckpt``; returns rows dropped."""
        dropped = 0
        for sid, applied in zip(ckpt.stream_ids, ckpt.applied):
            rows = self._rows.get(sid)
            if rows is None:
                continue
            drop = min(max(0, applied - self._base[sid]), len(rows))
            for _ in range(drop):
                rows.popleft()
            self._base[sid] += drop
            dropped += drop
        return dropped


class StandbyReplica:
    """The receiving half: artifact + replication log + last checkpoint.

    Holds no engine until :meth:`activate` — the standby is a cold spare
    whose only running cost is the log and one checkpoint blob.  All
    ``receive_*`` payloads are bytes/ndarrays, never live objects."""

    def __init__(self, model_id: str, source, *, block: int = 256,
                 depth: int = 2, backend: Optional[str] = None,
                 placement=None):
        self.model_id = model_id
        self._source = source          # artifact path / net / compiled cell
        self._block = int(block)
        self._depth = int(depth)
        self._backend = backend
        self._placement = placement
        self.log = ReplicationLog()
        self._ckpt: Optional[StreamCheckpoint] = None
        self.checkpoints_received = 0
        self.fleet = None              # set by activate()

    @property
    def checkpoint(self) -> Optional[StreamCheckpoint]:
        return self._ckpt

    # -- replication inbox ---------------------------------------------------
    def receive_open(self, stream_id) -> None:
        self.log.open(stream_id)

    def receive_steps(self, stream_id, xs: np.ndarray) -> int:
        return self.log.ack(stream_id, xs)

    def receive_close(self, stream_id) -> None:
        self.log.close(stream_id)

    def receive_checkpoint(self, data: bytes) -> StreamCheckpoint:
        ckpt = StreamCheckpoint.from_bytes(data)
        if ckpt.model_id != self.model_id:
            raise ValueError(f"checkpoint for {ckpt.model_id!r} sent to "
                             f"standby of {self.model_id!r}")
        if self._ckpt is not None and ckpt.seq <= self._ckpt.seq:
            return self._ckpt          # stale/duplicate: keep the newer one
        self._ckpt = ckpt
        self.log.prune(ckpt)
        self.checkpoints_received += 1
        return ckpt

    # -- failover ------------------------------------------------------------
    def live_stream_ids(self) -> List:
        return [sid for sid in self.log.stream_ids()
                if sid not in self.log.closed]

    def activate(self, **fleet_kwargs):
        """Take over: build a fresh fleet lane (``fleet_kwargs`` go to
        :class:`~repro_torch.serve.fleet.LUTFleet`, ``device=`` among them
        when the artifact is a path) from the replicated artifact, restore every stream that is still owed answers from
        the last checkpoint, and replay the acked tail in feed order.

        A CLOSED stream is restored too when it may still owe answers
        (closing only marks a stream; already-fed steps complete later, so
        the primary can die between close and the final step) — it is
        re-closed after its tail is queued, so the replay finishes it.  A
        closed stream whose log was pruned by a checkpoint it no longer
        appears in was *finalized* under that checkpoint (every answer
        delivered) and is skipped.  Re-answering steps the primary already
        delivered is possible and safe — at-least-once delivery of
        bit-identical answers.

        Returns ``(fleet, replayed)`` — the standby's own fleet (now
        primary; keep feeding/pumping it) and per-stream replayed-step
        counts.  The caller pumps; after the pump each recovered session's
        ``steps`` continue exactly where the checkpoint left off."""
        from repro_torch.serve.fleet import LUTFleet
        fleet = LUTFleet(block=self._block, depth=self._depth,
                         **fleet_kwargs)
        fleet.register(self.model_id, self._source, block=self._block,
                       backend=self._backend, placement=self._placement)
        ckpt = self._ckpt
        replayed: Dict[object, int] = {}
        for sid in self.log.stream_ids():
            in_ckpt = ckpt is not None and sid in ckpt.stream_ids
            closed = sid in self.log.closed
            if closed and not in_ckpt:
                if self.log.pruned_base(sid) > 0:
                    continue    # finalized under an older checkpoint
                if self.log.acked(sid) == 0:
                    continue    # opened and closed without a single step
            applied = ckpt.applied_for(sid) if in_ckpt else 0
            state = ckpt.state_for(sid) if in_ckpt else None
            tail = self.log.tail(sid, applied)
            fleet.open_stream(self.model_id, sid, state=state)
            if len(tail):
                fleet.submit_stream(self.model_id, sid, tail)
            if closed:
                fleet.close_stream(self.model_id, sid)
            replayed[sid] = len(tail)
        self.fleet = fleet
        return fleet, replayed


class ReplicatedStreamTenant:
    """Primary-side driver: one stream tenant with synchronous ack
    replication and periodic checkpoint shipping.

    Wraps the stream API of a primary fleet; every mutation reaches the
    standby BEFORE the primary accepts it (that ordering is the zero-
    lost-acks guarantee).  ``checkpoint_every`` completed steps, the
    current :class:`StreamCheckpoint` is serialized and shipped, which
    also prunes the standby's log."""

    def __init__(self, fleet, model_id: str, standby: StandbyReplica, *,
                 checkpoint_every: int = 256):
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self.fleet = fleet
        self.model_id = model_id
        self.standby = standby
        self.checkpoint_every = int(checkpoint_every)
        self.seq = 0
        self._completed_at_last_ckpt = 0

    def open_stream(self, stream_id):
        self.standby.receive_open(stream_id)
        return self.fleet.open_stream(self.model_id, stream_id)

    def submit(self, stream_id, xs: np.ndarray):
        lane = self.fleet._stream_lane(self.model_id)
        if stream_id in lane.closing or stream_id not in lane.pending:
            # let the fleet raise its own error BEFORE anything is
            # replicated — a rejected step must not linger in the log,
            # where failover would replay it as if it had been accepted
            return self.fleet.submit_stream(self.model_id, stream_id, xs)
        self.standby.receive_steps(stream_id, xs)     # replicate, THEN accept
        return self.fleet.submit_stream(self.model_id, stream_id, xs)

    def close_stream(self, stream_id):
        self.standby.receive_close(stream_id)
        return self.fleet.close_stream(self.model_id, stream_id)

    def _completed_steps(self) -> int:
        lane = self.fleet._stream_lane(self.model_id)
        return sum(len(s.steps) for s in lane.sessions.values())

    def checkpoint(self) -> StreamCheckpoint:
        """Snapshot + ship now; returns the shipped checkpoint."""
        self.seq += 1
        ckpt = checkpoint_streams(self.fleet, self.model_id, self.seq)
        self.standby.receive_checkpoint(ckpt.to_bytes())
        self._completed_at_last_ckpt = self._completed_steps()
        return ckpt

    def maybe_checkpoint(self) -> Optional[StreamCheckpoint]:
        """Ship a checkpoint if ``checkpoint_every`` steps completed since
        the last one (call from the serving loop between pumps)."""
        if (self._completed_steps() - self._completed_at_last_ckpt
                >= self.checkpoint_every):
            return self.checkpoint()
        return None
