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
    convolutions (on by default) and cuBLAS matmuls, and take cuDNN's
    deterministic algorithms — a full-width VGG's f32 gradients carry
    rounding of up to ~1% of a leaf's largest entry, so atomics that
    add in a different order each run would make two runs of one round
    part. The one place the port sets these; ``UnifiedEngine``,
    ``LoopBackend`` and the serving entry call it for CUDA devices."""
    if device is None or device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True


def kernel_for(use_kernel: Optional[bool], device: torch.device) -> bool:
    """Resolve an op's ``use_kernel`` for tensors on ``device``: None is
    the kernel on CUDA and the plain version on the CPU; True on CPU
    tensors raises (the kernels are CUDA C++)."""
    if use_kernel is None:
        return device.type == "cuda"
    if use_kernel and device.type != "cuda":
        raise ValueError(f"use_kernel=True needs CUDA tensors (the kernels "
                         f"are CUDA C++); these are on {device}")
    return bool(use_kernel)
