"""Hand-written CUDA kernels for FedAvg aggregation, bound with ctypes.

The four kernels of ``kernels/csrc/fedavg.cu`` replace the JAX package's
Pallas TPU kernels of the same names (``repro/kernels/fedavg/fedavg.py``):
``weighted_sum_2d`` (paper Eq. 1), ``plane_agg_2d`` (coverage /
multiplicity / fallback pass), and the streaming pair ``plane_accum_2d``
(in-place fold of a row chunk into running buffers) +
``plane_finish_2d`` (the closing divide/fallback pass).

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``build/`` at the repository root (keyed
by a hash of the source and flags, so an edit rebuilds) and loaded with
``ctypes``. Nothing is compiled or loaded when this module is imported.

Each wrapper takes CUDA tensors only: it checks device, dtype (f32),
shape and contiguity and raises on anything the kernel does not take
(any column count N is taken as it is: no padding), allocates its output
with ``torch.empty``, launches
on the current stream without synchronising, raises if the launch was
refused, and adds one to its launch count (``launch_counts``).
The plain PyTorch versions live in ``ref.py``; the dispatch between the
two is ``ops.py``'s.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fedavg.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_K = 48 * 1024 // 4            # client weights staged in shared memory

KERNELS = ("weighted_sum", "plane_agg", "plane_accum", "plane_finish")
_launches = dict.fromkeys(KERNELS, 0)
_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


# ------------------------------------------------------------------- build
def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfedavg_{digest[:16]}.so"


def build() -> Path:
    """Compile ``fedavg.cu`` for sm_90a unless this source's library is
    already built; returns the library path."""
    path = library_path()
    with _build_lock:
        if path.exists():
            return path
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError("building the fedavg kernels needs the CUDA "
                               "toolkit (nvcc); none was found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
               "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fedavg_error_string.argtypes = [i]
        lib.fedavg_error_string.restype = ctypes.c_char_p
        lib.fedavg_weighted_sum.argtypes = [p, p, p, i, ll, p]
        lib.fedavg_plane_agg.argtypes = [p, p, p, p, p, p, i, ll, i, p]
        lib.fedavg_plane_accum.argtypes = [p, p, p, p, p, p, p, i, ll, p]
        lib.fedavg_plane_finish.argtypes = [p, p, p, p, p, ll, i, p]
        for fn in (lib.fedavg_weighted_sum, lib.fedavg_plane_agg,
                   lib.fedavg_plane_accum, lib.fedavg_plane_finish):
            fn.restype = i
        _lib = lib
    return _lib


# ---------------------------------------------------------------- wrappers
def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
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


def plane_accum_2d(num, den, cov, x, w, m=None, mu=None):
    """One streaming accumulate step, IN PLACE on the ``(1, N)`` f32
    buffers num/den/cov: ``num += Σ w m/mu x``, ``den += Σ w m/mu``,
    ``cov += Σ m`` over the ``(K_chunk, N)`` chunk x [, m, mu] (m = 1
    when absent; mu needs m). Returns the same three tensors."""
    K, N = x.shape
    if mu is not None and m is None:
        raise ValueError("mult needs masks")
    _check_cols(N, K)
    for name, t in (("num", num), ("den", den), ("cov", cov)):
        _check(name, t, (1, N), x.device)
    _check("x", x, (K, N), x.device)
    _check("w", w, (K,), x.device)
    if m is not None:
        _check("m", m, (K, N), x.device)
    if mu is not None:
        _check("mu", mu, (K, N), x.device)
    lib = _library()
    _launch("plane_accum", lib.fedavg_plane_accum, num.data_ptr(),
            den.data_ptr(), cov.data_ptr(), x.data_ptr(), w.data_ptr(),
            _ptr(m), _ptr(mu), K, N, _stream(x))
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
