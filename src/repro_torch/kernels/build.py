"""Build and load the port's CUDA sources: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled at first use for sm_90a into
``build/`` at the repository root. The library's file name carries a
hash of the source, of every header in ``csrc/`` (``*.cuh``, which the
sources include) and of the flags, so an edit to any of them rebuilds;
the compile writes a temporary file that is renamed into place, so two
processes never load a half-written library. An nvcc failure raises with the
compiler's output; ptxas's report of each kernel (registers, shared
memory, spills) is kept beside the library (``ptxas_report``). Two
sources can build at once (one lock each), so a caller may start every
build together. Nothing is compiled or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def headers() -> list:
    """The shared headers of the sources, ``csrc/*.cuh``, in name order."""
    return sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the
    headers and the flags."""
    h = hashlib.sha256(source(name).read_bytes())
    for header in headers():
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's library is already
    built; returns the library path."""
    path = library_path(name)
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:                  # one build per source; sources in parallel
        if path.exists():
            return path
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError(f"building the {name} kernels needs the CUDA "
                               "toolkit (nvcc); none was found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
               "-o", str(tmp), str(source(name))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        report_path(name).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    return path


def report_path(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def ptxas_report(name: str) -> str:
    """ptxas's ``-v`` output for the built ``csrc/<name>.cu``: per kernel,
    its registers, shared memory, stack and spill bytes."""
    return report_path(name).read_text()


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed);
    ``declare`` sets its functions' ``argtypes``/``restype`` once."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        declare(lib)
        _libs[name] = lib
    return lib
