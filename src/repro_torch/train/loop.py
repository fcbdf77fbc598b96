"""Production training loop (``repro.train.loop``): checkpoint/restart,
straggler flags, retries.

* resumes from the newest complete checkpoint (atomic, in the reference's
  format);
* data deterministic in the step => exact replay after a failure;
* each step's wall time (device work included: the loop waits for the
  card before the clock stops) feeds the straggler detector;
* a failed step (device loss, preemption) restores the newest checkpoint
  and replays, up to ``max_retries`` times;
* asynchronous checkpoints copy to host memory and write on a thread;
  on a mesh every rank gathers the state and rank 0 alone writes it
  (``LoopConfig.ckpt_write``).

The port's step functions update the parameters in place (the reference's
return new ones), so a failure inside the optimizer's update leaves the
parameters part-updated: replay from a checkpoint is what makes that safe,
as it is in the reference for device loss.  ``LoopState.codec`` turns the
state into the tree that is checkpointed (``launch.steps.StateCodec`` for
an LM: the reference's parameter and AdamW trees) and back; without one
``(params, opt_state)`` is saved as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, Tuple

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.dist.straggler import StepTimer, StragglerDetector


class TreeCodec(Protocol):
    """Turns the loop's (params, opt_state) into a checkpoint tree and back."""

    def to_tree(self, params: Any, opt_state: Any) -> Any:
        """The tree to checkpoint."""

    def from_tree(self, tree: Any, params: Any, opt_state: Any
                  ) -> Tuple[Any, Any]:
        """(params, opt_state) holding a restored ``tree``."""


@dataclasses.dataclass
class LoopConfig:
    """Length, checkpointing, logging and retries of a run."""

    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    ckpt_async: bool = True
    log_every: int = 20
    max_retries: int = 2
    keep_ckpts: int = 3
    ckpt_write: bool = True     # False on every rank of a mesh but rank 0


@dataclasses.dataclass
class LoopState:
    """What the loop carries from step to step."""

    params: Any
    opt_state: Any
    step: int = 0
    metrics_history: list = dataclasses.field(default_factory=list)
    straggler: StragglerDetector = dataclasses.field(
        default_factory=StragglerDetector)
    failures: int = 0
    codec: Optional[TreeCodec] = None


def _tree(state: LoopState) -> Any:
    if state.codec is None:
        return (state.params, state.opt_state)
    return state.codec.to_tree(state.params, state.opt_state)


def _restore(cfg: LoopConfig, state: LoopState,
             step: Optional[int] = None) -> int:
    tree, rstep = checkpoint.restore(cfg.ckpt_dir, _tree(state), step=step)
    if state.codec is None:
        state.params, state.opt_state = tree
    else:
        state.params, state.opt_state = state.codec.from_tree(
            tree, state.params, state.opt_state)
    return rstep


def _block_until_ready(metrics: Dict[str, Any]) -> None:
    """Wait for the devices of the metrics' tensors (the step's work)."""
    for dev in {v.device for v in metrics.values()
                if isinstance(v, torch.Tensor) and v.is_cuda}:
        torch.cuda.synchronize(dev)


def run(cfg: LoopConfig, state: LoopState, step_fn: Callable,
        batch_fn: Callable[[int], Dict[str, Any]],
        log_fn: Callable[[int, dict], None] = None) -> LoopState:
    """``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``;
    ``batch_fn(step) -> batch`` (it MUST be deterministic in ``step`` for
    replay).  Runs to ``cfg.total_steps``; ``metrics_history`` gets each
    step's metrics as floats with ``step_time_s`` and ``straggler``."""
    if cfg.ckpt_dir:
        latest = checkpoint.latest_step(cfg.ckpt_dir)
        if latest is not None:
            state.step = _restore(cfg, state, latest)

    while state.step < cfg.total_steps:
        step = state.step
        batch = batch_fn(step)
        attempts = 0
        while True:
            try:
                with StepTimer() as t:
                    params, opt_state, metrics = step_fn(
                        state.params, state.opt_state, batch)
                    _block_until_ready(metrics)
                break
            except Exception:  # noqa: BLE001 -- device loss / preemption
                attempts += 1
                state.failures += 1
                if attempts > cfg.max_retries:
                    raise
                if cfg.ckpt_dir and checkpoint.latest_step(cfg.ckpt_dir) \
                        is not None:
                    step = state.step = _restore(cfg, state)
                    batch = batch_fn(step)
        state.params, state.opt_state = params, opt_state
        state.step = step + 1
        flagged = state.straggler.observe(step, t.dt)
        m = {k: float(v) for k, v in metrics.items()}
        m["step_time_s"] = t.dt
        m["straggler"] = flagged
        state.metrics_history.append(m)
        if log_fn and (step % cfg.log_every == 0 or flagged):
            log_fn(step, m)
        if cfg.ckpt_dir and (state.step % cfg.ckpt_every == 0
                             or state.step == cfg.total_steps):
            tree = _tree(state)     # a collective for sharded state
            save = checkpoint.save_async if cfg.ckpt_async \
                else checkpoint.save
            if cfg.ckpt_write:
                save(cfg.ckpt_dir, state.step, tree, keep=cfg.keep_ckpts)
    checkpoint.wait_pending()
    return state
