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
are f32. Any S is taken; hd must be one of ``HEAD_DIMS`` (8 to 256,
powers of two). Head dim 192 (MLA's, which the flash kernels take) has
no caller here: deepseek-v2 has no local layers, and MLA's decode is
plain einsums over its latent cache (``models/attention.py``).

``swa_decode`` is flash-decoding in one launch: one thread-block
cluster per (b, kv head, group of query heads), whose ``n_split``
blocks walk interleaved 16-slot groups of the cache and merge their
softmax states through distributed shared memory (``decode_split``
plans it, ``decode_slots`` says which slots each block takes). The
wrapper allocates only ``out`` (and, with ``return_lse``, the heads'
log-sum-exp the same launch writes: what the sequence-split decode
cache combines its parts by, ``sharding.collectives.combine_seq``).

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
from typing import List

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention.flash import head_dim_error

KERNELS = ("swa_decode", "swa_prefill")
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# swa_decode's split: a cluster of blocks per (b, kv head, head group),
# enough of them for four blocks per SM of the card, each block taking
# interleaved groups of the 16 slots it walks per step (4 warps, 4 slots
# each: swa_attention.cu kKeysPerStep). Clusters hold at most 8 blocks
# (the portable size), or 16 where 8 would leave SMs idle.
DECODE_BLOCKS_PER_SM = 4
DECODE_KEYS_PER_STEP = 16
DECODE_CLUSTER = 8
DECODE_CLUSTER_MAX = 16
_launches = dict.fromkeys(KERNELS, 0)
# the swa_decode launches that wrote the log-sum-exp too (``return_lse``;
# counted in ``_launches["swa_decode"]`` as well)
_lse_launches = {"swa_decode": 0}
_decode_plans: dict = {}


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(_launches)


def lse_launches() -> int:
    """``swa_decode`` launches with ``return_lse`` since the last
    ``reset_launch_counts`` (a part of ``launch_counts()``'s)."""
    return _lse_launches["swa_decode"]


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
    _lse_launches["swa_decode"] = 0


def build() -> Path:
    """Compile ``swa_attention.cu`` for sm_90a unless this source's
    library is already built; returns the library path."""
    return kbuild.build("swa_attention")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.swa_error_string.argtypes = [i]
    lib.swa_error_string.restype = ctypes.c_char_p
    # q q_bf16 k v kv_bf16 kpos out lse B KV G S hd n_split qpos window
    # scale stream
    lib.swa_decode.argtypes = [p, i, p, p, i, p, p, p] + [i] * 8 + [f, p]
    # q k v bf16 out B KV G S hd causal window scale stream
    lib.swa_prefill.argtypes = [p, p, p, i, p] + [i] * 7 + [f, p]
    lib.swa_prefill_smem_bytes.argtypes = [i, i]     # hd bf16
    for fn in (lib.swa_decode, lib.swa_prefill, lib.swa_prefill_smem_bytes):
        fn.restype = i


def _library() -> ctypes.CDLL:
    return kbuild.load("swa_attention", _declare)


def prefill_smem_bytes(hd: int) -> dict:
    """The dynamic shared memory a ``swa_prefill`` launch requests at
    head dim ``hd`` for f32 and bf16 operands, in bytes, as the built
    library computes it."""
    if hd not in HEAD_DIMS:
        raise head_dim_error(hd, HEAD_DIMS)
    lib = _library()
    return {str(dt).removeprefix("torch."): lib.swa_prefill_smem_bytes(
        hd, int(dt == torch.bfloat16)) for dt in DTYPES}


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
        raise head_dim_error(hd, HEAD_DIMS)
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


def decode_split(B: int, KV: int, G: int, S: int, sms: int,
                 hd: int) -> int:
    """``n_split``: how many blocks ``swa_decode``'s cluster per (b, kv
    head, head group) has on a card of ``sms`` SMs at head dim ``hd``. Block r walks the
    ``DECODE_KEYS_PER_STEP``-slot groups r, r + n_split, r + 2 n_split,
    ... of the cache, so a window's visible slots spread over every
    block. Enough blocks for ``DECODE_BLOCKS_PER_SM`` an SM, at most
    ``DECODE_CLUSTER`` a cluster (``DECODE_CLUSTER_MAX`` when that many
    would leave SMs idle), and no block without a group."""
    rows = B * KV * -(-G // group_chunk(G, hd))     # clusters: the grid's y
    if rows > 65535:
        raise ValueError(f"swa_decode: B * KV * head groups = {rows} > "
                         f"65535 clusters")
    cap = (DECODE_CLUSTER_MAX if rows * DECODE_CLUSTER < sms
           else DECODE_CLUSTER)
    n = min(cap, -(-DECODE_BLOCKS_PER_SM * sms // rows),
            -(-S // DECODE_KEYS_PER_STEP))
    return max(1, n)


def decode_slots(S: int, n_split: int) -> List[List[int]]:
    """The cache slots each block of a decode cluster walks, in order."""
    g = DECODE_KEYS_PER_STEP
    return [[s for g0 in range(r * g, S, n_split * g)
             for s in range(g0, min(S, g0 + g))]
            for r in range(n_split)]


def group_chunk(G: int, hd: int) -> int:
    """Query heads one decode cluster serves (1, 2, 4 or 8; at most 4 at
    hd 256, where a lane holds 8 columns: swa_attention.cu kMaxGroup);
    larger groups take several clusters per (b, kv head), each reading
    the cache."""
    for gc in (1, 2, 4):
        if G <= gc:
            return gc
    return 8 if hd <= 128 else 4


def _decode_plan(q, k, v, key_pos) -> tuple:
    """Everything about a decode call that its operands' shapes, dtypes
    and devices decide, checked once per such key (raising on what the
    kernel does not take, every time) and cached: the bound C function,
    the launch's integer arguments, the scale and the output's shape."""
    key = (q.shape, k.shape, v.shape, key_pos.shape, q.dtype, k.dtype,
           v.dtype, key_pos.dtype, q.device, k.device, v.device,
           key_pos.device)
    plan = _decode_plans.get(key)
    if plan is None:
        if q.dim() != 4:
            raise ValueError(f"q must be (B, KV, G, hd); got "
                             f"{tuple(q.shape)}")
        B, KV, G, hd = q.shape
        S = k.shape[1] if k.dim() == 4 else 0
        if min(B, KV, G, S) < 1:
            raise ValueError(f"empty decode operand: q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}")
        _check_decode(q, k, v, key_pos)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split = decode_split(B, KV, G, S, sms, hd)
        plan = (_library().swa_decode, _is_bf16(q), _is_bf16(k),
                (B, KV, G, S, hd, n_split), hd ** -0.5, (B, KV, G, hd))
        _decode_plans[key] = plan
    return plan


def _check_decode(q, k, v, key_pos) -> None:
    S, KV, hd = k.shape[1], q.shape[1], q.shape[3]
    _check_kv(q, k, v, S, KV, hd)
    _check("key_pos", key_pos, (S,), q.device, (torch.int32,))


def swa_decode(q, k, v, key_pos, q_pos: int, *, window: int = 0,
               return_lse: bool = False):
    """q (B,KV,G,hd); k, v (B,S,KV,hd); key_pos (S,) int32; q_pos an int.
    Returns (B,KV,G,hd) f32, and with ``return_lse`` also (B,KV,G) f32:
    each head's log-sum-exp of its visible slots' scaled scores, -inf
    where no slot is visible (the same launch writes both). One launch;
    the only allocations are the outputs."""
    fn, q_bf16, kv_bf16, dims, scale, out_shape = _decode_plan(q, k, v,
                                                              key_pos)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_pos.data_ptr())
    if (any(p % 16 for p in ptrs) or not q.is_contiguous()
            or not k.is_contiguous() or not v.is_contiguous()
            or not key_pos.is_contiguous()):
        _check_decode(q, k, v, key_pos)           # raises, saying why
    out = torch.empty(out_shape, dtype=torch.float32, device=q.device)
    lse = (torch.empty(out_shape[:-1], dtype=torch.float32, device=q.device)
           if return_lse else None)
    _launch("swa_decode", fn, ptrs[0], q_bf16, ptrs[1], ptrs[2], kv_bf16,
            ptrs[3], out.data_ptr(), 0 if lse is None else lse.data_ptr(),
            *dims, int(q_pos), int(window), scale, _stream(q))
    if lse is None:
        return out
    _lse_launches["swa_decode"] += 1
    return out, lse


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
