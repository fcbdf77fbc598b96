"""Stateful streaming inference over assembled-LUT recurrent cells (the
port of ``repro.stream``).

  * :mod:`repro_torch.stream.cell`: the cell ABI, its training forward and
    the :class:`CompiledStreamCell` artifact, whose folded per-step
    transition closes the recurrent loop in integer-code space.
  * :mod:`repro_torch.stream.session`: per-stream state (packed codes by
    stream id) and the continuous-batching stream router over a cell-mode
    :class:`~repro_torch.serve.lut_engine.LUTEngine`.
  * :mod:`repro_torch.stream.replica`: code-space checkpoint replication
    to a standby and bit-identical stream failover.
"""
from repro_torch.stream.cell import (  # noqa: F401
    CompiledStreamCell,
    StreamCellConfig,
    apply_sequence,
    apply_sequence_codes,
    apply_step,
    compile_cell,
    migrate_state_codes,
    state_migration_mode,
)
from repro_torch.stream.replica import (  # noqa: F401
    ReplicatedStreamTenant,
    ReplicationLog,
    StandbyReplica,
    StreamCheckpoint,
    checkpoint_streams,
)
from repro_torch.stream.session import (  # noqa: F401
    StreamRouter,
    StreamSession,
    StreamStore,
)
