"""Plain PyTorch version of the To-Wider kernel — the CPU path and the
oracle the CUDA kernel is held against (the JAX package's
``kernels/netchange/ref.py``)."""
from __future__ import annotations

import torch


def widen_ref(x, mapping, scale, *, axis: int = 1):
    """``out = take(x, mapping, axis) * scale`` along ``axis`` (the JAX
    oracle's columns of an ``(R, old)`` matrix by default); ``scale``
    ``(new,)``, None = 1. f32 out."""
    out = torch.index_select(x.float(), axis, mapping.long())
    if scale is None:
        return out
    shape = [1] * out.dim()
    shape[axis] = -1
    return out * scale.float().reshape(shape)
