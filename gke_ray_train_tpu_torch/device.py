"""Device resolution shared by every entry point.

An entry point runs on ``cuda`` unless its caller names another device.
With no device given and no CUDA present it raises: the port never
carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    must then exist: ``cuda:LOCAL_RANK`` under a process group (one
    rank per card), else bare ``cuda``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        from gke_ray_train_tpu_torch.parallel.mesh import (
            is_distributed, local_rank)
        if is_distributed():
            return torch.device("cuda", local_rank())
        return torch.device("cuda")
    return torch.device(device)


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``t`` lies on ``device`` (a bare ``cuda`` matches any
    CUDA index)."""
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what} lies on {t.device}, not on {device}")


def host_to_device(x, device: torch.device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on ``device`` without making the
    host wait: on CUDA through pinned memory and a ``non_blocking`` copy
    (a copy from pageable memory waits for the card); elsewhere a plain
    copy."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def world_size() -> int:
    """Ranks of the initialized ``torch.distributed`` group (1 without
    one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
