"""Assembled-LUT recurrent cells (the port of ``repro.stream.cell``).

A *cell* is an ordinary :class:`~repro_torch.core.assemble.AssembleConfig`
with a recurrent wiring convention on top:

  * the network input is ``[x_t | s_t]``: ``n_in`` fresh features plus
    ``n_state`` state positions, all quantized through the one shared input
    boundary (``in_q``);
  * the final layer emits ``[y_t | s_{t+1}]``: ``n_out`` logit units plus
    ``n_state`` next-state units, all through the final-layer boundary
    (``out_q``).

The recurrent edge is a *re-quantization*: the state leaves the cell as
out-boundary codes and re-enters as in-boundary codes through
:func:`repro_torch.core.quant.recode`.  During training the state is carried
as the out-boundary fake-quant *values*, which the next step's input
fake-quant maps to the same codes, so the folded cell streams bit-identically
to the quantized training forward, step for step, on every backend.

:class:`CompiledStreamCell` is the deployment artifact: a
:class:`~repro_torch.pipeline.CompiledLUTNetwork` plus the ``(n_in,
n_state)`` split.  Its transition runs in code space, and
:meth:`CompiledStreamCell.predict_sequence` loops over the same step
function that :meth:`CompiledStreamCell.step` calls, so streamed and offline
codes agree by construction.  A step may run under a
:class:`~repro_torch.backends.Placement` (split over a mesh of device
slots), with the same codes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import backends
from repro_torch.core import assemble, quant
from repro_torch.core.assemble import AssembleConfig, LUTNet
from repro_torch.core.quant import QuantSpec
from repro_torch.pipeline import CompiledLUTNetwork, compile_network


@dataclasses.dataclass(frozen=True)
class StreamCellConfig:
    """The cell ABI: an assembled network plus the recurrent split."""

    net: AssembleConfig
    n_in: int       # fresh features per step
    n_state: int    # state positions (input tail and output tail)

    def __post_init__(self):
        """Check the split against the network's widths."""
        if self.n_state < 1:
            raise ValueError("a cell needs n_state >= 1")
        if self.net.in_features != self.n_in + self.n_state:
            raise ValueError(
                f"cell input split {self.n_in}+{self.n_state} != "
                f"net.in_features {self.net.in_features}")
        last = self.net.layers[-1].units
        if last <= self.n_state:
            raise ValueError(
                f"final layer has {last} units; needs > n_state "
                f"({self.n_state}) to leave room for outputs")

    @property
    def n_out(self) -> int:
        """Output (logit) units per step."""
        return self.net.layers[-1].units - self.n_state

    def in_spec(self) -> QuantSpec:
        """The input boundary, which the state re-enters through."""
        return self.net.input_quant_spec()

    def out_spec(self) -> QuantSpec:
        """The final-layer boundary, which the state leaves through."""
        return self.net.quant_spec(len(self.net.layers) - 1)

    def zero_state_code(self) -> int:
        """The in-boundary code of state value 0 (the initial state)."""
        s = self.in_spec()
        return int(np.clip(0, s.qmin, s.qmax) - s.qmin)


# ---------------------------------------------------------------------------
# training-side forward (float state, fake-quant boundaries)
# ---------------------------------------------------------------------------

def init(seed: int, cell: StreamCellConfig, **kw) -> LUTNet:
    """Cell parameters are plain assemble parameters of ``cell.net``."""
    return assemble.init(seed, cell.net, **kw)


def apply_step(net: LUTNet, cell: StreamCellConfig, x_t: torch.Tensor,
               s: torch.Tensor, *, training: bool = False,
               dense: bool = False, bn_batch_stats: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One training-graph step: ``(x_t [B, n_in], s [B, n_state] float)``
    -> ``(y [B, n_out], s_next [B, n_state])``.

    ``s`` carries the out-boundary fake-quant values; the input fake-quant
    inside :func:`assemble.apply` is the training-time image of the folded
    state recode.  When ``training`` the BN statistics in ``net`` are
    refreshed; ``bn_batch_stats=False`` normalizes with the running
    statistics (frozen-stats BN), which is what the folded cell bakes in.
    """
    out = assemble.apply(net, cell.net, torch.cat([x_t, s], dim=-1),
                         training=training, dense=dense,
                         bn_batch_stats=bn_batch_stats)
    return out[:, :cell.n_out], out[:, cell.n_out:]


def apply_sequence(net: LUTNet, cell: StreamCellConfig, xs: torch.Tensor,
                   s0: Optional[torch.Tensor] = None, *,
                   training: bool = False, dense: bool = False,
                   bn_batch_stats: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_step` over ``xs [B, T, n_in]``, in order.

    Returns ``(ys [B, T, n_out], s_final)``; with ``training=True`` the BN
    statistics are refreshed at every step (the last step's stand)."""
    xs = torch.as_tensor(xs, dtype=torch.float32).to(net.device)
    s = s0 if s0 is not None else torch.zeros(
        (xs.shape[0], cell.n_state), dtype=torch.float32, device=net.device)
    ys = []
    for t in range(xs.shape[1]):
        y, s = apply_step(net, cell, xs[:, t], s, training=training,
                          dense=dense, bn_batch_stats=bn_batch_stats)
        ys.append(y)
    return torch.stack(ys, dim=1), s


@torch.no_grad()
def apply_sequence_codes(net: LUTNet, cell: StreamCellConfig, xs,
                         s0_codes=None) -> torch.Tensor:
    """Integer-code reference over the *training* graph: the hard-quantized
    eval forward over ``xs [B, T, n_in]`` with the state edge in code space.
    The folded streamed path must match it bit for bit."""
    in_q, in_spec = net.in_q, cell.in_spec()
    out_q, out_spec = net.layers[-1].out_q, cell.out_spec()
    xs = torch.as_tensor(xs, dtype=torch.float32).to(net.device)
    if s0_codes is None:
        s = torch.full((xs.shape[0], cell.n_state), cell.zero_state_code(),
                       dtype=torch.int32, device=net.device)
    else:
        s = torch.as_tensor(s0_codes).to(net.device, torch.int32)
    ys = []
    for t in range(xs.shape[1]):
        s_deq = quant.dequantize_codes(in_q, in_spec, s)
        out = assemble.apply_codes(net, cell.net,
                                   torch.cat([xs[:, t], s_deq], dim=-1))
        s = quant.recode(out_q, out_spec, in_q, in_spec, out[:, cell.n_out:])
        ys.append(out[:, :cell.n_out])
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# the deployment artifact
# ---------------------------------------------------------------------------

StepFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class CompiledStreamCell:
    """A folded cell: :class:`CompiledLUTNetwork` plus the recurrent split.

    The folded transition runs in code space: ``quantize(x) ++ s_codes ->
    cascade -> split -> recode state``, with no float round trip on the
    recurrent edge, on the network's device.  :meth:`step` is the per-tick
    function the serving layer drives; :meth:`predict_sequence` loops over
    the same function."""

    def __init__(self, net: CompiledLUTNetwork, n_in: int, n_state: int):
        """Wrap ``net`` with the split and record it in its metadata."""
        self.net = net
        self.cell = StreamCellConfig(net=net.cfg, n_in=n_in, n_state=n_state)
        net.extra_meta["stream_cell"] = {"n_in": n_in, "n_state": n_state}
        # (backend name, placement cache key) -> step function
        self._raw: Dict[tuple, StepFn] = {}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_network(cls, net: CompiledLUTNetwork,
                     like: Optional["CompiledStreamCell"] = None
                     ) -> "CompiledStreamCell":
        """Wrap a loaded network: the split from its ``extra_meta`` (written
        by :meth:`save`), else ``like``'s split."""
        sc = net.extra_meta.get("stream_cell")
        if sc is None and like is not None:
            sc = {"n_in": like.cell.n_in, "n_state": like.cell.n_state}
        if sc is None:
            raise ValueError("artifact carries no stream_cell metadata and "
                             "no reference cell was given")
        return cls(net, int(sc["n_in"]), int(sc["n_state"]))

    def save(self, path: str) -> str:
        """Write the artifact (the reference's ``.npz`` format)."""
        return self.net.save(path)

    @classmethod
    def load(cls, path: str, *, device=None) -> "CompiledStreamCell":
        """Read a cell artifact written by either package onto ``device``
        (CUDA by default)."""
        return cls.from_network(CompiledLUTNetwork.load(path, device=device))

    # -- state ---------------------------------------------------------------
    def init_state_codes(self, batch: int) -> torch.Tensor:
        """The initial state of ``batch`` streams, ``[batch, n_state]``."""
        return torch.full((batch, self.cell.n_state),
                          self.cell.zero_state_code(), dtype=torch.int32,
                          device=self.net.device)

    # -- the folded transition ----------------------------------------------
    def _key(self, backend, placement):
        be = backends.resolve(backend or self.net.backend)
        return ((be.name,
                 None if placement is None else placement.cache_key()), be)

    def raw_step(self, backend: Optional[str] = None,
                 placement=None) -> StepFn:
        """The step function ``(x [B, n_in] f32, s_codes [B, n_state]) ->
        (y_codes, y_logits, s_next_codes)`` of ``backend`` (default: the
        network's) under ``placement``, on the network's device."""
        key, be = self._key(backend, placement)
        if key in self._raw:
            return self._raw[key]
        # compile_backend owns planning and plan staleness; reuse its plan
        plan = self.net.compile_backend(be.name, placement=placement).plan
        if placement is None:
            cascade = lambda codes: be.run(plan, codes)  # noqa: E731
        else:
            cascade = backends.place(be, plan, placement)
        dev = self.net.device
        in_q = {"log_scale": self.net.in_log_scale}
        out_q = {"log_scale": self.net.out_log_scale}
        in_spec, out_spec = self.cell.in_spec(), self.cell.out_spec()
        n_out = self.cell.n_out

        def step(x, s_codes):
            x = torch.as_tensor(x, dtype=torch.float32).to(dev)
            s_codes = torch.as_tensor(s_codes).to(dev, torch.int32)
            x_codes = quant.quantize_codes(in_q, in_spec, x)
            out = cascade(torch.cat([x_codes, s_codes], dim=-1))
            s_next = quant.recode(out_q, out_spec, in_q, in_spec,
                                  out[:, n_out:])
            y = quant.dequantize_codes(out_q, out_spec, out[:, :n_out])
            return out[:, :n_out], y, s_next

        self._raw[key] = step
        return step

    def step(self, x, s_codes, *, backend: Optional[str] = None,
             placement=None):
        """One folded streamed tick: ``(y_codes, y, s_next_codes)``."""
        return self.raw_step(backend, placement)(x, s_codes)

    def predict_sequence(self, xs, s0_codes=None, *,
                         backend: Optional[str] = None, placement=None):
        """Offline full-sequence evaluation: the step function of
        :meth:`step` over ``xs [B, T, n_in]`` in order.  Returns
        ``(y_codes [B, T, n_out], y [B, T, n_out], s_final_codes
        [B, n_state])``."""
        raw = self.raw_step(backend, placement)
        xs = torch.as_tensor(xs, dtype=torch.float32).to(self.net.device)
        s = (self.init_state_codes(xs.shape[0]) if s0_codes is None
             else s0_codes)
        codes, logits = [], []
        for t in range(xs.shape[1]):
            yc, y, s = raw(xs[:, t], s)
            codes.append(yc)
            logits.append(y)
        return torch.stack(codes, dim=1), torch.stack(logits, dim=1), s


def compile_cell(params: LUTNet, cell: StreamCellConfig, *,
                 backend: Optional[str] = None) -> CompiledStreamCell:
    """Fold trained cell parameters (on their own device) into the
    deployable stream artifact."""
    net = compile_network(params, cell.net, backend=backend)
    return CompiledStreamCell(net, cell.n_in, cell.n_state)


# ---------------------------------------------------------------------------
# hot-swap state migration
# ---------------------------------------------------------------------------

def state_migration_mode(old: CompiledStreamCell,
                         new: CompiledStreamCell) -> Optional[str]:
    """How live per-stream state moves across a version swap:
    ``"carried"`` (identical in-boundary: codes transfer verbatim),
    ``"requantized"`` (same ``n_state``, another boundary: codes are
    re-quantized through :func:`quant.recode`), or ``None`` (another state
    width: streams must drain)."""
    if old.cell.n_state != new.cell.n_state:
        return None
    same = (old.cell.in_spec() == new.cell.in_spec()
            and old.net.in_log_scale == new.net.in_log_scale)
    return "carried" if same else "requantized"


def migrate_state_codes(old: CompiledStreamCell, new: CompiledStreamCell,
                        s_codes) -> torch.Tensor:
    """Map in-boundary state codes of ``old`` onto ``new``'s in-boundary,
    on ``new``'s device."""
    mode = state_migration_mode(old, new)
    if mode is None:
        raise ValueError("state widths differ; drain instead of migrating")
    s_codes = torch.as_tensor(s_codes).to(new.net.device, torch.int32)
    if mode == "carried":
        return s_codes
    return quant.recode({"log_scale": old.net.in_log_scale},
                        old.cell.in_spec(),
                        {"log_scale": new.net.in_log_scale},
                        new.cell.in_spec(), s_codes)
