"""The hand-written CUDA To-Wider kernel, bound with ctypes.

``kernels/csrc/netchange.cu`` replaces the JAX package's Pallas TPU
kernel ``repro/kernels/netchange/widen.py`` ``widen_2d``: ``out[r, j] =
x[r, map[j]] * scale[j]``, a gather (the TPU kernel's one-hot matmul
would do ``old`` multiply-adds per output). It is built at first use
like every kernel of the port (``kernels/build.py``); nothing is compiled
or loaded when this module is imported.

``widen_2d`` takes the JAX kernel's ``(R, old)`` matrix, or an ``(outer,
old, inner)`` tensor widened along its middle axis (a leading-axis
widening, as NetChange's outgoing weights need, without a transpose).
The wrapper takes CUDA tensors only: it checks device, dtype (f32 x and
scale, int32 map), shape and contiguity and raises on anything the kernel
does not take, allocates the output with ``torch.empty``, launches on the
current stream without synchronising, raises if the launch was refused,
and adds one to its launch count (``launch_counts``). That every
``map[j]`` lies in ``[0, old)`` is the caller's to hold (``ops.py`` checks
it on the host); the plain version lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild

KERNELS = ("widen_2d",)
_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def build() -> Path:
    """Compile ``netchange.cu`` for sm_90a unless this source's library is
    already built; returns the library path."""
    return kbuild.build("netchange")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.widen_error_string.argtypes = [i]
    lib.widen_error_string.restype = ctypes.c_char_p
    # x map scale out outer old new inner stream
    lib.widen.argtypes = [p, p, p, p, i64, i, i, i64, p]
    lib.widen.restype = i


def _library() -> ctypes.CDLL:
    return kbuild.load("netchange", _declare)


def _check(name: str, t: torch.Tensor, shape, device, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def widen_2d(x: torch.Tensor, mapping: torch.Tensor,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (R, old) -> (R, new), or (outer, old, inner) -> (outer, new,
    inner): ``out[..., j, ...] = x[..., map[j], ...] * scale[j]`` (scale
    None = 1). f32 in and out; mapping int32 ``(new,)``."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (R, old) or (outer, old, inner); got "
                         f"{tuple(x.shape)}")
    outer, old = x.shape[0], x.shape[1]
    inner = x.shape[2] if x.dim() == 3 else 1
    new = mapping.shape[0] if mapping.dim() == 1 else 0
    if min(outer, old, inner, new) < 1:
        raise ValueError(f"empty widen operand: x {tuple(x.shape)}, mapping "
                         f"{tuple(mapping.shape)}")
    dev = x.device
    _check("x", x, x.shape, dev, torch.float32)
    _check("mapping", mapping, (new,), dev, torch.int32)
    if scale is not None:
        _check("scale", scale, (new,), dev, torch.float32)
    shape = (outer, new) if x.dim() == 2 else (outer, new, inner)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    rc = _library().widen(x.data_ptr(), mapping.data_ptr(),
                          None if scale is None else scale.data_ptr(),
                          out.data_ptr(), outer, old, new, inner,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = _library().widen_error_string(rc).decode()
        raise RuntimeError(f"widen_2d kernel launch failed: {msg} ({rc})")
    _launches["widen_2d"] += 1
    return out
