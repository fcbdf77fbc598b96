"""Stateful streaming inference over assembled-LUT recurrent cells (the
port of ``repro.stream``).

  * :mod:`repro_torch.stream.cell`: the cell ABI, its training forward and
    the :class:`CompiledStreamCell` artifact, whose folded per-step
    transition closes the recurrent loop in integer-code space.
  * :mod:`repro_torch.stream.session`: per-stream state (packed codes by
    stream id) and the continuous-batching stream router over a cell-mode
    :class:`~repro_torch.serve.lut_engine.LUTEngine`.

Replication and failover (``repro.stream.replica``) are not ported yet
(ROADMAP A.12).
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
from repro_torch.stream.session import (  # noqa: F401
    StreamRouter,
    StreamSession,
    StreamStore,
)
