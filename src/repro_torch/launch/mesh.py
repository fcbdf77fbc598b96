"""The serving mesh (the port of ``repro.launch.mesh.make_serving_mesh``).

The reference places LUT serving on a ``jax.sharding.Mesh`` of devices.
``torch.distributed.DeviceMesh`` needs process groups, and the fleet is one
process, so the port has its own mesh: an array of **device slots**, each
an integer id plus the ``torch.device`` it runs on, and the axis names.

Slots decouple the mesh from the physical device count: a CPU test holds
4 slots on ``cpu`` (as the reference does on 4 forced host devices), a
one-card run 2 slots on ``cuda:0``, and a multi-GPU host maps slots to
``cuda:0..n-1``.  Fault injection and elastic remeshing name slots by id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device


@dataclasses.dataclass(frozen=True)
class DeviceSlot:
    """One place a shard runs: an id and the device behind it."""

    id: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Slots along one named axis (the serving mesh is one data-parallel
    axis; meshes of several axes wait for ``dist.sharding``)."""

    slots: Tuple[DeviceSlot, ...]
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        """Check the layout and that slot ids are unique."""
        object.__setattr__(self, "slots", tuple(self.slots))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if not self.slots:
            raise ValueError("a mesh needs at least one slot")
        if len(self.axis_names) != 1:
            raise ValueError(f"a serving mesh has one axis, got "
                             f"{self.axis_names}")
        if len({s.id for s in self.slots}) != len(self.slots):
            raise ValueError("mesh slot ids must be unique")

    @property
    def devices(self) -> np.ndarray:
        """The slots as an object array (the reference's ``Mesh.devices``)."""
        arr = np.empty(len(self.slots), dtype=object)
        arr[:] = self.slots
        return arr

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size."""
        return {self.axis_names[0]: len(self.slots)}

    @property
    def size(self) -> int:
        """Number of slots."""
        return len(self.slots)


def make_serving_mesh(devices: int = 0, *, device=None,
                      slots: Optional[int] = None) -> DeviceMesh:
    """1-D ``("data",)`` serving mesh.

    The physical devices are ``device`` when given (one device, e.g.
    ``"cpu"`` or ``"cuda:0"``), else every CUDA device (raises without
    one).  Without ``slots`` the mesh holds the first ``devices`` of them
    (all when 0), one slot each, as the reference does.  ``slots=n`` holds
    ``n`` slots dealt round-robin over the physical devices, so several
    slots may share one device."""
    if device is not None:
        dev = _device.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        physical = [dev]
    else:
        _device.resolve(None)
        physical = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    if slots is None:
        n = devices or len(physical)
        if n > len(physical):
            raise ValueError(f"asked for {n} devices, have {len(physical)}")
    else:
        n = int(slots)
        if n < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
    return DeviceMesh(tuple(DeviceSlot(i, physical[i % len(physical)])
                            for i in range(n)))


def mesh_devices(mesh: DeviceMesh) -> int:
    """Number of slots in ``mesh``."""
    return mesh.size
