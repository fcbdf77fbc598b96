"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says else.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device exists, so a missing card never degrades silently to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def kind(device: Optional[torch.device]) -> str:
    """``"gpu"`` for a CUDA device, else the device type (``"cpu"``)."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    t = torch.device(device).type
    return "gpu" if t == "cuda" else t


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
