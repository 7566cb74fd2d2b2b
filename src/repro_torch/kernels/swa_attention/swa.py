"""Hand-written CUDA sliding-window serving kernels, bound with ctypes.

The kernels of ``kernels/csrc/swa_attention.cu`` replace the JAX
package's Pallas TPU kernels (``repro/kernels/swa_attention/``):
``swa_decode`` (``decode.py`` ``_kernel``: one token against a ring KV
cache) and ``swa_prefill`` (``prefill.py`` ``_kernel``: banded attention
over a prompt). They are built at first use like every kernel of the
port (``kernels/build.py``); nothing is compiled or loaded when this
module is imported.

Layouts are the JAX kernels': decode q and out ``(B, KV, G, hd)``,
prefill q and out ``(B, KV, G, S, hd)``; k, v ``(B, S, KV, hd)`` (the
model's cache layout, read as it is); key_pos ``(S,)`` int32 absolute
slot positions (-1 = unwritten). Operands are f32 or bf16 (prefill: q,
k and v of one type; decode: k and v of one type, q its own); outputs
are f32. Any S is taken; hd must be 16, 32, 64 or 128.

``swa_decode`` is flash-decoding: a split pass (the cache cut into
chunks along S, one block per chunk, (b, kv head) and group of query
heads) and a combine pass over the chunks' partial softmax states. The
wrapper allocates the partials with ``torch.empty`` and counts one
launch of ``swa_decode`` per call (both passes).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and 16-byte alignment and raises on anything the kernel does
not take, allocates its outputs with ``torch.empty``, launches on the
current stream without synchronising, raises if the launch was refused,
and adds one to its launch count (``launch_counts``). The plain versions
live in ``ref.py``; the dispatch between the two is ``ops.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build as kbuild

KERNELS = ("swa_decode", "swa_prefill")
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# swa_decode's split: enough blocks for four per SM of a 132-SM card, each
# chunk a multiple of the 16 keys a block takes per step
DECODE_TARGET_BLOCKS = 4 * 132
DECODE_KEYS_PER_STEP = 16
DECODE_MIN_CHUNK = 64
_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def build() -> Path:
    """Compile ``swa_attention.cu`` for sm_90a unless this source's
    library is already built; returns the library path."""
    return kbuild.build("swa_attention")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.swa_error_string.argtypes = [i]
    lib.swa_error_string.restype = ctypes.c_char_p
    # q q_bf16 k v kv_bf16 kpos pm pl pacc out
    # B KV G S hd chunk n_split qpos window scale stream
    lib.swa_decode.argtypes = ([p, i, p, p, i, p, p, p, p, p]
                               + [i] * 9 + [f, p])
    # q k v bf16 out B KV G S hd causal window scale stream
    lib.swa_prefill.argtypes = [p, p, p, i, p] + [i] * 7 + [f, p]
    for fn in (lib.swa_decode, lib.swa_prefill):
        fn.restype = i


def _library() -> ctypes.CDLL:
    return kbuild.load("swa_attention", _declare)


def _check(name: str, t: torch.Tensor, shape, device, dtypes) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must start on a 16-byte boundary")


def _check_kv(q, k, v, S, KV, hd):
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernels are built for "
                         f"{HEAD_DIMS}")
    if k.dim() != 4:
        raise ValueError(f"k, v must be (B, S, KV, hd); got "
                         f"{tuple(k.shape)}")
    dev = q.device
    _check("q", q, q.shape, dev, DTYPES)
    _check("k", k, (q.shape[0], S, KV, hd), dev, DTYPES)
    _check("v", v, (q.shape[0], S, KV, hd), dev, (k.dtype,))


def _launch(kernel: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _library().swa_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")
    _launches[kernel] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def decode_split(B: int, KV: int, G: int, S: int) -> Tuple[int, int]:
    """(chunk, n_split): how ``swa_decode`` cuts S — enough chunks for
    ``DECODE_TARGET_BLOCKS`` blocks, none shorter than
    ``DECODE_MIN_CHUNK`` keys, each a multiple of the 16 keys a block
    takes per step."""
    blocks = B * KV * -(-G // group_chunk(G))
    n = max(1, min(-(-DECODE_TARGET_BLOCKS // blocks),
                   S // DECODE_MIN_CHUNK))
    per = -(-S // n)
    chunk = -(-per // DECODE_KEYS_PER_STEP) * DECODE_KEYS_PER_STEP
    return chunk, -(-S // chunk)


def group_chunk(G: int) -> int:
    """Query heads one decode block serves (1, 2, 4 or 8); larger groups
    take several blocks per (b, kv head), each reading the cache."""
    for gc in (1, 2, 4):
        if G <= gc:
            return gc
    return 8


def swa_decode(q, k, v, key_pos, q_pos: int, *, window: int = 0
               ) -> torch.Tensor:
    """q (B,KV,G,hd); k, v (B,S,KV,hd); key_pos (S,) int32; q_pos an int.
    Returns (B,KV,G,hd) f32."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, hd); got {tuple(q.shape)}")
    B, KV, G, hd = q.shape
    S = k.shape[1] if k.dim() == 4 else 0
    if min(B, KV, G, S) < 1:
        raise ValueError(f"empty decode operand: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    _check_kv(q, k, v, S, KV, hd)
    _check("key_pos", key_pos, (S,), q.device, (torch.int32,))
    rows = B * KV * -(-G // group_chunk(G))     # the grid's y extent
    if rows > 65535:
        raise ValueError(f"swa_decode: B * KV * head groups = {rows} > "
                         f"65535 blocks")
    chunk, n_split = decode_split(B, KV, G, S)
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((B * KV, n_split, G), **f32)
    pl = torch.empty((B * KV, n_split, G), **f32)
    pacc = torch.empty((B * KV, n_split, G, hd), **f32)
    out = torch.empty((B, KV, G, hd), **f32)
    _launch("swa_decode", _library().swa_decode, q.data_ptr(), _is_bf16(q),
            k.data_ptr(), v.data_ptr(), _is_bf16(k), key_pos.data_ptr(),
            pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
            B, KV, G, S, hd, chunk, n_split, int(q_pos), int(window),
            hd ** -0.5, _stream(q))
    return out


def swa_prefill(q, k, v, *, window: int, causal: bool = True
                ) -> torch.Tensor:
    """q (B,KV,G,S,hd); k, v (B,S,KV,hd), positions ``arange(S)``.
    Returns (B,KV,G,S,hd) f32. ``causal=False`` takes only
    ``window=0`` (``ops.swa_prefill`` says why)."""
    if q.dim() != 5:
        raise ValueError(f"q must be (B, KV, G, S, hd); got "
                         f"{tuple(q.shape)}")
    B, KV, G, S, hd = q.shape
    if min(B, KV, G, S) < 1:
        raise ValueError(f"empty prefill operand: q {tuple(q.shape)}")
    if not causal and window > 0:
        raise ValueError("swa_prefill: causal=False takes only window=0")
    _check_kv(q, k, v, S, KV, hd)
    if k.dtype != q.dtype:
        raise ValueError(f"swa_prefill: q is {q.dtype} and k, v "
                         f"{k.dtype}; the kernel takes one type")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("swa_prefill", _library().swa_prefill, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), _is_bf16(q), out.data_ptr(), B, KV,
            G, S, hd, int(causal), int(window), hd ** -0.5, _stream(q))
    return out
