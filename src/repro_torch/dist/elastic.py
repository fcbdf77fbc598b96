"""Elastic remesh planning (the port of ``repro.dist.elastic``): can a
checkpoint trained on mesh A resume on mesh B?

Checks are structural, not empirical: the new tensor axis must divide the
sharded dimensions (d_model, padded vocab), and the fp32 master + AdamW
state must fit the per-device HBM budget on the shrunken device count.
``ckpt/checkpoint.py`` does the actual respacing (save unsharded, restore
with explicit shardings); this module only answers go / no-go with a
reason.  Pure Python, copied from the reference so that both packages
give the same verdicts.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# fp32 params + AdamW m/v: 12 bytes per parameter of optimizer+master state.
STATE_BYTES_PER_PARAM = 12
# usable HBM per device for persistent state (half of a 64 GiB part; the
# rest is activations/temp — the dry-run proves those separately).
HBM_STATE_BUDGET = 32 * 2 ** 30


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    ok: bool
    reason: str = ""
    old_devices: int = 0
    new_devices: int = 0
    per_device_state_bytes: int = 0


def _devices(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def plan_search_remesh(old_devices: int, new_devices: int, *,
                       population: int) -> RemeshPlan:
    """Go/no-go for re-assigning assembly-search population slices after a
    device vanishes mid-rung (the assembly search).

    Slice programs carry no cross-device collective state — each is an
    independent vmapped program over explicitly-passed init keys — so the
    only structural requirement is a surviving device: any alive device
    replays a lost slice bit-identically.  ``population`` is recorded for
    the event log (the rebalanced load is population / new_devices)."""
    if new_devices < 1:
        return RemeshPlan(ok=False, old_devices=old_devices,
                          new_devices=new_devices,
                          reason=(f"no devices left to host the "
                                  f"{population}-candidate population"))
    return RemeshPlan(ok=True, old_devices=old_devices,
                      new_devices=new_devices)


def plan_serving_remesh(old_devices: int, new_devices: int, *,
                        tenants: int = 1) -> RemeshPlan:
    """Go/no-go for re-planning a serving lane's placement after a device
    of its mesh is lost (``serve/fleet.py`` graceful degradation).

    Serving placements split a block's rows over the mesh's slots and
    every slot holds the full artifact (``backends/placement.py``), so
    there is no cross-device state to respace.  The structural requirement is one surviving
    device; the verdict records the shrink so the fleet's DegradeEvent
    can log it.  ``tenants`` is the number of lanes sharing the mesh
    (event-log context, like ``population`` above)."""
    if new_devices < 1:
        return RemeshPlan(ok=False, old_devices=old_devices,
                          new_devices=new_devices,
                          reason=(f"no surviving devices to host "
                                  f"{tenants} serving lane(s)"))
    return RemeshPlan(
        ok=True, old_devices=old_devices, new_devices=new_devices,
        reason=(f"resharding batch axis over {new_devices} of "
                f"{old_devices} devices"))


def plan_remesh(cfg, old_shape: Tuple[int, ...], new_shape: Tuple[int, ...],
                *, hbm_budget: int = HBM_STATE_BUDGET) -> RemeshPlan:
    """Validate resuming ``cfg`` from mesh ``old_shape`` on ``new_shape``.

    Mesh shapes follow the (pod,) data, model axis convention — the last
    axis is the tensor-parallel one.
    """
    old_n, new_n = _devices(old_shape), _devices(new_shape)
    model = new_shape[-1]
    for dim_name, dim in (("d_model", cfg.d_model),
                          ("padded vocab", cfg.padded_vocab)):
        if dim % model:
            return RemeshPlan(
                ok=False, old_devices=old_n, new_devices=new_n,
                reason=(f"{dim_name}={dim} not divisible by model axis "
                        f"{model} of new mesh {new_shape}"))
    state = cfg.n_params() * STATE_BYTES_PER_PARAM
    per_device = state // new_n
    if per_device > hbm_budget:
        return RemeshPlan(
            ok=False, old_devices=old_n, new_devices=new_n,
            per_device_state_bytes=per_device,
            reason=(f"per-device optimizer state {per_device / 2**30:.1f} "
                    f"GiB exceeds HBM budget {hbm_budget / 2**30:.0f} GiB "
                    f"on {new_n} devices"))
    return RemeshPlan(ok=True, old_devices=old_n, new_devices=new_n,
                      per_device_state_bytes=per_device)
