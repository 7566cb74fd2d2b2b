"""Where the port runs, and at what float32 precision.

Entry points (``FLRunConfig``, ``UnifiedEngine``, ``PlaneAccumulator``)
run on CUDA unless the caller passes ``device="cpu"``; without a card
they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none (or
    when a CUDA device is named and none is present)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for CUDA, and no CUDA "
                           "device is available")
    return dev


def strict_f32(device: Optional[torch.device] = None) -> None:
    """The reference is full float32: turn TF32 off for cuDNN
    convolutions (on by default) and cuBLAS matmuls. The one place the
    port sets these; ``UnifiedEngine`` calls it for CUDA devices."""
    if device is None or device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
