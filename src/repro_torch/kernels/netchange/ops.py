"""Entry point of the To-Wider kernel: NetChange's duplicate (incoming)
and duplicate-and-split (outgoing) widening, with the JAX package's
signature (``repro/kernels/netchange/ops.py`` ``widen_cols``) and its
generalisation to any axis (``widen``), which ``core/netchange.py``
calls.

The device rule is the port's: on CUDA tensors the CUDA kernel
(``widen.py``) or an error, on CPU tensors the plain version
(``ref.py``); ``use_kernel=False`` forces the plain version (the only
way to it on the card), ``use_kernel=True`` on CPU tensors raises.
Nothing falls back. Any shape is taken as it is (the JAX op pads to 256
for the TPU's tiles).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import kernel_for
from repro_torch.kernels.netchange import ref
from repro_torch.kernels.netchange.widen import widen_2d


def split_scale(mapping: np.ndarray, old: int) -> np.ndarray:
    """``1 / |group|`` for each new index: each duplicate group of the
    outgoing weights shares its source's weight (Alg. 2 l.11-14)."""
    counts = np.bincount(mapping, minlength=old)
    return (1.0 / counts[mapping]).astype(np.float32)


def widen(x: torch.Tensor, mapping, *, axis: int, split: bool = False,
          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """``x`` widened along ``axis`` by ``mapping`` (``new`` source
    indices in ``[0, x.shape[axis])``, array-like or tensor):
    ``out[..., j, ...] = x[..., mapping[j], ...]``, divided by the size
    of j's duplicate group when ``split``. f32 out."""
    mapping = np.asarray(mapping.cpu() if torch.is_tensor(mapping)
                         else mapping, dtype=np.int64).reshape(-1)
    axis = axis % x.dim()
    old = x.shape[axis]
    if mapping.size == 0 or mapping.min() < 0 or mapping.max() >= old:
        raise ValueError(f"widen: mapping must be non-empty indices in "
                         f"[0, {old})")
    scale = split_scale(mapping, old) if split else None
    dev = x.device
    if not kernel_for(use_kernel, dev):
        return ref.widen_ref(
            x, torch.as_tensor(mapping, device=dev),
            None if scale is None else torch.as_tensor(scale, device=dev),
            axis=axis)
    if x.dtype != torch.float32:
        raise ValueError(f"widen: the kernel takes f32, got {x.dtype}")
    outer = int(np.prod(x.shape[:axis], dtype=np.int64))
    inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    m = torch.as_tensor(mapping.astype(np.int32), device=dev)
    s = None if scale is None else torch.as_tensor(scale, device=dev)
    out = widen_2d(x.contiguous().reshape(outer, old, inner), m, s)
    return out.reshape(*x.shape[:axis], mapping.size, *x.shape[axis + 1:])


def widen_cols(x: torch.Tensor, mapping, *, split: bool = False,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (R, old) -> (R, new). ``split=False`` duplicates columns (To-Wider
    incoming); ``split=True`` divides each duplicate group by its size
    (outgoing)."""
    return widen(x, mapping, axis=1, split=split, use_kernel=use_kernel)
