"""Hand-written CUDA flash-attention kernels, bound with ctypes.

The three kernels of ``kernels/csrc/flash_attention.cu`` replace the JAX
package's Pallas TPU kernels (``repro/kernels/flash_attention/``):
``flash_fwd`` (``fwd.py`` ``_kernel``), and the backward pair
``flash_bwd_dq`` (``bwd.py`` ``_dq_kernel``) and ``flash_bwd_dkv``
(``bwd.py`` ``_dkv_kernel``). They are built at first use like every
kernel of the port (``kernels/build.py``); nothing is compiled or loaded
when this module is imported.

Layouts are the JAX kernels': q, out, dout, dq ``(B, KV, G, Sq, hd)``;
k, v, dk, dv ``(B, Sk, KV, hd)``; lse, delta ``(B, KV, G, Sq)``; q_pos
``(Sq,)``, kv_pos ``(Sk,)`` int32 absolute positions (-1 masks a key).
Any Sq and Sk are taken as they are; hd must be one of ``HEAD_DIMS``
(8 to 256, powers of two, and 192: MLA's qk head dim, deepseek-v2's).

All three run every product on the tensor cores at f32 accuracy (each
product split into three TF32 products, see the source's header), over
tiles copied 16 bytes at a time, for every head dim above.

Each wrapper takes CUDA tensors only: it checks device, dtype (f32
operands, int32 positions), shape, contiguity and the 16-byte alignment
of the operands and raises on anything the kernel does not take, allocates
its outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and adds one to its
launch count (``launch_counts``). The plain versions live in ``ref.py``;
the autograd binding and the dispatch between the two are ``ops.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build as kbuild

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
HEAD_DIMS = (8, 16, 32, 64, 128, 192, 256)
_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def build() -> Path:
    """Compile ``flash_attention.cu`` for sm_90a unless this source's
    library is already built; returns the library path."""
    return kbuild.build("flash_attention")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_error_string.argtypes = [i]
    lib.flash_error_string.restype = ctypes.c_char_p
    tail = [i, i, i, i, i, i, f, i, i, p]     # B KV G Sq Sk hd scale causal
    lib.flash_fwd.argtypes = [p] * 7 + tail   # window stream
    lib.flash_bwd_dq.argtypes = [p] * 9 + tail
    lib.flash_bwd_dkv.argtypes = [p] * 10 + tail
    lib.flash_smem_bytes.argtypes = [i, i]    # kernel hd
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv,
               lib.flash_smem_bytes):
        fn.restype = i


def _library() -> ctypes.CDLL:
    return kbuild.load("flash_attention", _declare)


def smem_bytes(hd: int) -> dict:
    """The dynamic shared memory each kernel's launch requests at head
    dim ``hd``, in bytes, as the built library computes it."""
    if hd not in HEAD_DIMS:
        raise head_dim_error(hd)
    lib = _library()
    return {name: lib.flash_smem_bytes(i, hd)
            for i, name in enumerate(KERNELS)}


def _check(name: str, t: torch.Tensor, shape, device,
           dtype=torch.float32) -> None:
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


def head_dim_error(hd: int, head_dims=HEAD_DIMS) -> ValueError:
    """The error for a head dim the attention kernels are not built for."""
    return ValueError(f"head dim {hd}: the kernels are built for "
                      f"{head_dims}")


def _check_inputs(q, k, v, q_pos, kv_pos):
    """Shapes of the common operands; returns (B, KV, G, Sq, Sk, hd)."""
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, Sq, hd) and k, v "
                         f"(B, Sk, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, KV, G, Sq, hd = q.shape
    Sk = k.shape[1]
    if hd not in HEAD_DIMS:
        raise head_dim_error(hd)
    if min(B, KV, G, Sq, Sk) < 1:
        raise ValueError(f"empty attention operand: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    dev = q.device
    _check("q", q, (B, KV, G, Sq, hd), dev)
    _check("k", k, (B, Sk, KV, hd), dev)
    _check("v", v, (B, Sk, KV, hd), dev)
    _check("q_pos", q_pos, (Sq,), dev, torch.int32)
    _check("kv_pos", kv_pos, (Sk,), dev, torch.int32)
    return B, KV, G, Sq, Sk, hd


def _check_aligned(**operands) -> None:
    for name, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels copy 16 bytes at a time, "
                             "so its data must start on a 16-byte boundary")


def _launch(kernel: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _library().flash_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")
    _launches[kernel] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, q_pos, kv_pos, *, causal: bool = True,
              window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(out (B,KV,G,Sq,hd), lse (B,KV,G,Sq))`` f32, with
    ``lse = rowmax + log(rowsum)`` of the masked scaled scores."""
    B, KV, G, Sq, Sk, hd = _check_inputs(q, k, v, q_pos, kv_pos)
    _check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    lib = _library()
    _launch("flash_fwd", lib.flash_fwd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, KV, G, Sq, Sk, hd,
            hd ** -0.5, int(causal), int(window), _stream(q))
    return out, lse


def _check_bwd(q, k, v, q_pos, kv_pos, lse, delta, dout):
    B, KV, G, Sq, Sk, hd = _check_inputs(q, k, v, q_pos, kv_pos)
    _check("lse", lse, (B, KV, G, Sq), q.device)
    _check("delta", delta, (B, KV, G, Sq), q.device)
    _check("dout", dout, (B, KV, G, Sq, hd), q.device)
    _check_aligned(q=q, k=k, v=v, dout=dout)
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dout.data_ptr()),
            (B, KV, G, Sq, Sk, hd))


def flash_bwd_dq(q, k, v, q_pos, kv_pos, lse, delta, dout, *,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """dq ``(B,KV,G,Sq,hd)`` f32 from the forward's ``lse`` and ``delta =
    rowsum(dout * out)``."""
    ins, dims = _check_bwd(q, k, v, q_pos, kv_pos, lse, delta, dout)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _library().flash_bwd_dq, *ins, dq.data_ptr(),
            *dims, dims[-1] ** -0.5, int(causal), int(window), _stream(q))
    return dq


def flash_bwd_dkv(q, k, v, q_pos, kv_pos, lse, delta, dout, *,
                  causal: bool = True, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) ``(B,Sk,KV,hd)`` f32, each summed over the G query heads
    of its group."""
    ins, dims = _check_bwd(q, k, v, q_pos, kv_pos, lse, delta, dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", _library().flash_bwd_dkv, *ins, dk.data_ptr(),
            dv.data_ptr(), *dims, dims[-1] ** -0.5, int(causal), int(window),
            _stream(q))
    return dk, dv


def flash_bwd(q, k, v, q_pos, kv_pos, lse, delta, dout, *,
              causal: bool = True, window: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward: ``(dq, dk, dv)`` f32 in the primal layouts — one
    ``flash_bwd_dq`` and one ``flash_bwd_dkv`` launch."""
    kw = dict(causal=causal, window=window)
    dq = flash_bwd_dq(q, k, v, q_pos, kv_pos, lse, delta, dout, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, q_pos, kv_pos, lse, delta, dout,
                               **kw))
