"""Hand-written CUDA kernels for FedAvg aggregation, bound with ctypes.

The kernels of ``kernels/csrc/fedavg.cu`` replace the JAX package's
Pallas TPU kernels of the same names (``repro/kernels/fedavg/fedavg.py``):
``weighted_sum_2d`` (paper Eq. 1), ``plane_agg_2d`` (coverage /
multiplicity / fallback pass), ``weighted_sum_masked_2d`` and
``weighted_sum_masked_mult_2d`` (the per-leaf coverage average), the
streaming pair ``plane_accum_2d`` (in-place fold of a row chunk into
running buffers; f32 or bf16 chunks) + ``plane_finish_2d`` (the closing
divide/fallback pass), and ``plane_accum_q_2d`` (the int8 wire's fused
dequantize + fold).

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``build/`` at the repository root and
loaded with ``ctypes`` (``kernels/build.py``). Nothing is compiled or
loaded when this module is imported.

Each wrapper takes CUDA tensors only: it checks device, dtype (f32; a
streamed chunk may be bf16 or int8 where said), shape and contiguity and raises on anything the kernel does not take
(any column count N is taken as it is: no padding), allocates its output
with ``torch.empty``, launches
on the current stream without synchronising, raises if the launch was
refused, and adds one to its launch count (``launch_counts``).
The plain PyTorch versions live in ``ref.py``; the dispatch between the
two is ``ops.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild

MAX_K = 48 * 1024 // 4            # client weights staged in shared memory

KERNELS = ("weighted_sum", "plane_agg", "plane_accum", "plane_finish",
           "plane_accum_q", "weighted_sum_masked", "weighted_sum_masked_mult")
_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


# ------------------------------------------------------------------- build
def build() -> Path:
    """Compile ``fedavg.cu`` for sm_90a unless this source's library is
    already built (``kernels/build.py``); returns the library path."""
    return kbuild.build("fedavg")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fedavg_error_string.argtypes = [i]
    lib.fedavg_error_string.restype = ctypes.c_char_p
    lib.fedavg_weighted_sum.argtypes = [p, p, p, i, ll, p]
    lib.fedavg_plane_agg.argtypes = [p, p, p, p, p, p, i, ll, i, p]
    lib.fedavg_plane_accum.argtypes = [p, p, p, p, p, p, p, i, ll, p]
    lib.fedavg_plane_finish.argtypes = [p, p, p, p, p, ll, i, p]
    lib.fedavg_plane_accum_bf16.argtypes = [p, p, p, p, p, p, p, i, ll, p]
    lib.fedavg_plane_accum_q.argtypes = [p, p, p, p, p, p, p, p, p, i, ll,
                                         ll, i, p]
    lib.fedavg_weighted_sum_masked.argtypes = [p, p, p, p, i, ll, i, p]
    lib.fedavg_weighted_sum_masked_mult.argtypes = [p, p, p, p, p, i, ll, i,
                                                    p]
    for fn in (lib.fedavg_weighted_sum, lib.fedavg_plane_agg,
               lib.fedavg_plane_accum, lib.fedavg_plane_finish,
               lib.fedavg_plane_accum_bf16, lib.fedavg_plane_accum_q,
               lib.fedavg_weighted_sum_masked,
               lib.fedavg_weighted_sum_masked_mult):
        fn.restype = i


def _library() -> ctypes.CDLL:
    return kbuild.load("fedavg", _declare)


# ---------------------------------------------------------------- wrappers
def _check(name: str, t: torch.Tensor, shape, device,
           dtypes=(torch.float32,)) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected "
                         f"{' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_cols(n: int, k: int) -> None:
    if n < 1:
        raise ValueError(f"N={n} must be positive")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} must be in [1, {MAX_K}]")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(kernel: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _library().fedavg_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")
    _launches[kernel] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def weighted_sum_2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (K, N); w: (K,) -> (N,) f32:
    ``out[n] = Σ_k w[k] x[k, n]``."""
    K, N = x.shape
    _check_cols(N, K)
    _check("x", x, (K, N), x.device)
    _check("w", w, (K,), x.device)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _library()
    _launch("weighted_sum", lib.fedavg_weighted_sum, x.data_ptr(),
            w.data_ptr(), out.data_ptr(), K, N, _stream(x))
    return out


def plane_agg_2d(x, w, m, mu=None, fb=None, *,
                 renorm: bool = True) -> torch.Tensor:
    """x, m [, mu]: (K, N); w: (K,); [fb: (N,)] -> (N,) f32. Per
    coordinate ``Σ_k (w_k m_k / mu_k) x_k`` (mu ≤ 0 read as 1),
    divided by ``Σ_k w_k m_k / mu_k`` where that is > 0 when
    ``renorm``, and ``fb`` where no client covers (``Σ_k m_k == 0``)."""
    K, N = x.shape
    _check_cols(N, K)
    _check("x", x, (K, N), x.device)
    _check("w", w, (K,), x.device)
    _check("m", m, (K, N), x.device)
    if mu is not None:
        _check("mu", mu, (K, N), x.device)
    if fb is not None:
        _check("fb", fb, (N,), x.device)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _library()
    _launch("plane_agg", lib.fedavg_plane_agg, x.data_ptr(), w.data_ptr(),
            m.data_ptr(), _ptr(mu), _ptr(fb), out.data_ptr(), K, N,
            int(renorm), _stream(x))
    return out


def weighted_sum_masked_2d(x, w, m, *, renorm: bool = True) -> torch.Tensor:
    """x, m: (K, N); w: (K,) -> (N,) f32: ``Σ_k w_k m_k x_k``, divided
    by ``Σ_k w_k m_k`` where that is > 0 (0 elsewhere) when ``renorm`` —
    the per-leaf coverage average; no fallback."""
    K, N = x.shape
    _check_cols(N, K)
    _check("x", x, (K, N), x.device)
    _check("w", w, (K,), x.device)
    _check("m", m, (K, N), x.device)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _library()
    _launch("weighted_sum_masked", lib.fedavg_weighted_sum_masked,
            x.data_ptr(), w.data_ptr(), m.data_ptr(), out.data_ptr(), K, N,
            int(renorm), _stream(x))
    return out


def weighted_sum_masked_mult_2d(x, w, m, mu, *,
                                renorm: bool = True) -> torch.Tensor:
    """x, m, mu: (K, N); w: (K,) -> (N,) f32: as
    ``weighted_sum_masked_2d`` with client weight ``w_k m_k / mu_k``
    (mu ≤ 0 read as 1)."""
    K, N = x.shape
    _check_cols(N, K)
    _check("x", x, (K, N), x.device)
    _check("w", w, (K,), x.device)
    _check("m", m, (K, N), x.device)
    _check("mu", mu, (K, N), x.device)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _library()
    _launch("weighted_sum_masked_mult", lib.fedavg_weighted_sum_masked_mult,
            x.data_ptr(), w.data_ptr(), m.data_ptr(), mu.data_ptr(),
            out.data_ptr(), K, N, int(renorm), _stream(x))
    return out


def _check_accum(num, den, cov, K, N, device, w, m, mu) -> None:
    _check_cols(N, K)
    for name, t in (("num", num), ("den", den), ("cov", cov)):
        _check(name, t, (1, N), device)
    _check("w", w, (K,), device)
    if m is not None:
        _check("m", m, (K, N), device)
    if mu is not None:
        _check("mu", mu, (K, N), device)


def plane_accum_2d(num, den, cov, x, w, m=None, mu=None):
    """One streaming accumulate step, IN PLACE on the ``(1, N)`` f32
    buffers num/den/cov: ``num += Σ w m/mu x``, ``den += Σ w m/mu``,
    ``cov += Σ m`` over the ``(K_chunk, N)`` chunk x [, m, mu] (m = 1
    when absent; mu needs m). x may be f32 or bf16 (read as it is, each
    element widened to f32 in the kernel); the rest is f32. Returns the
    same three tensors."""
    K, N = x.shape
    if mu is not None and m is None:
        raise ValueError("mult needs masks")
    _check("x", x, (K, N), x.device, (torch.float32, torch.bfloat16))
    _check_accum(num, den, cov, K, N, x.device, w, m, mu)
    lib = _library()
    fn = (lib.fedavg_plane_accum_bf16 if x.dtype == torch.bfloat16
          else lib.fedavg_plane_accum)
    _launch("plane_accum", fn, num.data_ptr(), den.data_ptr(),
            cov.data_ptr(), x.data_ptr(), w.data_ptr(), _ptr(m), _ptr(mu),
            K, N, _stream(x))
    return num, den, cov


def check_tile(tile) -> int:
    """``plane_accum_q_2d``'s scale tile: a positive multiple of 128."""
    if isinstance(tile, bool) or not isinstance(tile, int) \
            or tile < 128 or tile % 128:
        raise ValueError(f"tile={tile!r} must be a positive multiple of 128")
    return tile


def plane_accum_q_2d(num, den, cov, xq, s, w, m=None, mu=None, base=None,
                     *, tile: int = 256):
    """One fused dequantize-accumulate step, IN PLACE on the ``(1, N)``
    f32 buffers: the int8 ``(K_chunk, N)`` chunk xq times its per-tile
    scales s ``(K_chunk, ceil(N/tile))`` f32 (column c reads
    ``s[k, c // tile]``) is folded as ``plane_accum_2d`` folds an f32
    chunk, with optional m / mu ``(K_chunk, N)``, or with ``base``
    ``(1, N)`` the fold ``x·m + base·(1−m)`` followed by an unmasked
    accumulate (needs m, excludes mu). ``tile`` is a multiple of 128.
    Returns the same three tensors."""
    K, N = xq.shape
    if mu is not None and m is None:
        raise ValueError("mult needs masks")
    if base is not None and (m is None or mu is not None):
        raise ValueError("fold needs masks and is exclusive with mult")
    n_tiles = -(-N // check_tile(tile))
    _check("xq", xq, (K, N), xq.device, (torch.int8,))
    _check("s", s, (K, n_tiles), xq.device)
    _check_accum(num, den, cov, K, N, xq.device, w, m, mu)
    if base is not None:
        _check("base", base, (1, N), xq.device)
    lib = _library()
    _launch("plane_accum_q", lib.fedavg_plane_accum_q, num.data_ptr(),
            den.data_ptr(), cov.data_ptr(), xq.data_ptr(), s.data_ptr(),
            w.data_ptr(), _ptr(m), _ptr(mu), _ptr(base), K, N, n_tiles,
            tile, _stream(xq))
    return num, den, cov


def plane_finish_2d(num, den, cov, fb=None, *,
                    renorm: bool = True) -> torch.Tensor:
    """The divide pass closing a streamed accumulation: num/den/cov
    [, fb]: ``(1, N)`` -> ``(1, N)`` f32 — ``num / den`` where den > 0
    (0 elsewhere) when ``renorm``, ``fb`` where cov == 0."""
    _, N = num.shape
    _check_cols(N, 1)
    for name, t in (("num", num), ("den", den), ("cov", cov)):
        _check(name, t, (1, N), num.device)
    if fb is not None:
        _check("fb", fb, (1, N), num.device)
    out = torch.empty((1, N), dtype=torch.float32, device=num.device)
    lib = _library()
    _launch("plane_finish", lib.fedavg_plane_finish, num.data_ptr(),
            den.data_ptr(), cov.data_ptr(), _ptr(fb), out.data_ptr(), N,
            int(renorm), _stream(num))
    return out
