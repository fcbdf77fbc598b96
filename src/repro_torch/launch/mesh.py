"""Meshes (``repro.launch.mesh``).

Training and the dry run use torch's ``DeviceMesh``
(:func:`make_production_mesh`, :func:`make_mesh`, :func:`make_host_mesh`)
with the reference's axis convention (DESIGN.md §7): ``pod`` is the
data-centre boundary (pure data parallelism), ``data`` the data-parallel
axis inside a pod, ``model`` the tensor axis.  A ``DeviceMesh`` needs the
default process group, of exactly the mesh's size: ``torchrun`` ranks
for training, torch's fake group for the dry run; :func:`make_host_mesh`
starts a one-rank group itself when none exists.  The functions build
nothing at import.

LUT serving places work on a mesh of its own (:func:`make_serving_mesh`).
The reference places it on a ``jax.sharding.Mesh`` of devices.
``torch.distributed.DeviceMesh`` needs process groups, and the fleet is one
process, so the serving mesh is an array of **device slots**, each
an integer id plus the ``torch.device`` it runs on, and the axis names.

Slots decouple the mesh from the physical device count: a CPU test holds
4 slots on ``cpu`` (as the reference does on 4 forced host devices), a
one-card run 2 slots on ``cuda:0``, and a multi-GPU host maps slots to
``cuda:0..n-1``.  Fault injection and elastic remeshing name slots by id.
"""
from __future__ import annotations

import dataclasses
import os
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
    axis; training meshes of several axes are torch ``DeviceMesh``es)."""

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


def _device_type(device) -> str:
    """The mesh's device type: ``device``'s, else CUDA (raises without a
    card, as every entry point of the port does)."""
    return _device.resolve(device).type


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    """A torch ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of
    the default process group, on CUDA unless ``device`` says else
    (``"cpu"``; ``"meta"`` gives a CPU mesh).  A group larger than the mesh
    lends it its first ranks (the dry run's placeholder ranks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    dev = "cpu" if str(device) == "meta" else _device_type(device)
    n = int(np.prod(shape))
    if dist.is_initialized() and dist.get_world_size() > n:
        return DeviceMesh(dev, torch.arange(n).reshape(shape),
                          mesh_dim_names=axes)
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def production_shape(*, multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh: (16, 16) ``(data, model)`` or
    (2, 16, 16) ``(pod, data, model)``; ``REPRO_MESH_SHAPE="2,4"`` /
    ``REPRO_MESH_SHAPE_MULTI="2,2,2"`` override the shape (the same path
    at a size a test can hold)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    override = os.environ.get(
        "REPRO_MESH_SHAPE_MULTI" if multi_pod else "REPRO_MESH_SHAPE")
    if override:
        shape = tuple(int(x) for x in override.split(","))
        if len(shape) != len(axes):
            raise ValueError(f"mesh override {shape} for axes {axes}")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production ``DeviceMesh`` (:func:`production_shape`)."""
    return make_mesh(*production_shape(multi_pod=multi_pod), device=device)


def make_host_mesh(device=None):
    """A (1, 1) ``(data, model)`` mesh on this process's device, so that one
    device runs the meshed code paths; starts a one-rank process group (an
    in-process store) when none exists."""
    import torch.distributed as dist
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), device=dev)
