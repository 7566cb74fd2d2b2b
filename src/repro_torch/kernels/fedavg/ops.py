"""Dispatch layer over the fedavg kernels: aggregate packed planes.

Every op takes its device from its tensors. On CUDA tensors it launches
the hand-written kernel (``fedavg.py``) on the planes as they are (the
kernels take any parameter count, so nothing is padded or copied), or
raises; on CPU tensors it runs the plain version (``ref.py``).
``use_kernel=None`` is that rule; ``use_kernel=False`` forces the plain
version (the only way to it on the card); ``use_kernel=True`` on CPU
tensors raises. Nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fedavg import ref
from repro_torch.kernels.fedavg.fedavg import (plane_accum_2d, plane_agg_2d,
                                               plane_finish_2d,
                                               weighted_sum_2d)


def _f32(a):
    return None if a is None else a.float().contiguous()


def kernel_for(use_kernel: Optional[bool], device: torch.device) -> bool:
    """Resolve ``use_kernel`` for tensors on ``device``."""
    if use_kernel is None:
        return device.type == "cuda"
    if use_kernel and device.type != "cuda":
        raise ValueError(f"use_kernel=True needs CUDA tensors (the kernels "
                         f"are CUDA C++); these are on {device}")
    return bool(use_kernel)


def plane_agg(plane, w, *, masks=None, mult=None, fallback=None,
              renorm: bool = True, use_kernel: Optional[bool] = None):
    """Aggregate a packed ``(K, P)`` plane in ONE pass -> ``(P,)`` f32.

    Plain Eq. 1 without ``masks`` (``weighted_sum_2d``); coverage-weighted
    with them (``plane_agg_2d``: renormalized over the covering subset
    when ``renorm``, multiplicity-aware with ``mult``, ``fallback`` on
    uncovered coordinates)."""
    if mult is not None:
        assert masks is not None, "mult needs masks (coverage aggregation)"
    if fallback is not None:
        assert masks is not None, "fallback needs masks (uncovered coords)"
    if not kernel_for(use_kernel, plane.device):
        return ref.plane_agg_ref(plane, w, masks=masks, mult=mult,
                                 fallback=fallback, renorm=renorm)
    x, w = _f32(plane), _f32(w)
    if masks is None:
        return weighted_sum_2d(x, w)
    return plane_agg_2d(x, w, _f32(masks), _f32(mult), _f32(fallback),
                        renorm=renorm)


def plane_accum(num, den, cov, chunk, w, *, masks=None, mult=None,
                use_kernel: Optional[bool] = None):
    """Functional streaming accumulate on ``(n,)`` buffers:
    ``(num, den, cov) + (K_chunk, n) chunk -> updated (num, den, cov)``
    (new tensors). The stateless face of :class:`PlaneAccumulator`,
    which updates its buffers in place."""
    if mult is not None:
        assert masks is not None, "mult needs masks (coverage aggregation)"
    K, n = chunk.shape
    assert num.shape == den.shape == cov.shape == (n,), \
        (num.shape, den.shape, cov.shape, chunk.shape)
    if not kernel_for(use_kernel, chunk.device):
        return ref.plane_accum_ref(num, den, cov, chunk, w, masks, mult)
    # fresh copies: the kernel updates them in place, the caller's
    # buffers stay untouched
    trip = [t.float().reshape(1, n).clone() for t in (num, den, cov)]
    plane_accum_2d(*trip, _f32(chunk), _f32(w), _f32(masks), _f32(mult))
    return tuple(t[0] for t in trip)


def plane_finish(num, den, cov, *, fallback=None, renorm: bool = True,
                 use_kernel: Optional[bool] = None):
    """Close a streamed accumulation on ``(n,)`` buffers -> ``(n,)`` f32:
    renorm divide where den > 0, ``fallback`` where no client ever
    covered (cov == 0). Without either the numerator is the result and
    no pass runs."""
    n = num.shape[0]
    assert num.shape == den.shape == cov.shape == (n,)
    if not kernel_for(use_kernel, num.device):
        return ref.plane_finish_ref(num, den, cov, fallback, renorm=renorm)
    if not renorm and fallback is None:
        return num.float()
    trip = [_f32(t).reshape(1, n) for t in (num, den, cov)]
    fb = None if fallback is None else _f32(fallback).reshape(1, n)
    return plane_finish_2d(*trip, fb, renorm=renorm)[0]


class PlaneAccumulator:
    """Streaming O(P)-memory plane aggregation state.

    Holds three running ``(1, P)`` f32 buffers — numerator, renorm
    denominator and coverage count — and consumes a cohort in
    ``(K_chunk, P)`` row chunks: on CUDA each ``update`` is one launch of
    the ``plane_accum`` kernel that folds the chunk into the buffers IN
    PLACE (the Pallas kernel's ``input_output_aliases``), so aggregation
    memory is the three buffers plus one chunk, independent of K.
    ``finish`` closes with the ``plane_finish`` pass and reproduces
    ``plane_agg`` on the whole plane. ``merge`` sums another
    accumulator's partial triple (exact: the masked weighted sum is
    associative); ``stats`` reports the memory accounting.

    ``device=None`` means CUDA (raises without a card); ``use_kernel``
    follows the ``ops`` rule for that device.
    """

    def __init__(self, n: int, *, use_kernel: Optional[bool] = None,
                 device: DeviceLike = None):
        self.n = int(n)
        self.device = resolve_device(device)
        self.use_kernel = kernel_for(use_kernel, self.device)
        shape = (1, self.n)
        self._num = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._den = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._cov = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.rows = 0
        self.chunks = 0
        self.peak_rows = 0
        self._chunk_bytes = 0

    def _note(self, kc: int, nbytes: int):
        self.rows += int(kc)
        self.chunks += 1
        self.peak_rows = max(self.peak_rows, int(kc))
        self._chunk_bytes = max(self._chunk_bytes, int(nbytes))

    def update(self, chunk, w, *, masks=None, mult=None):
        """Accumulate one ``(K_chunk, n)`` row chunk with weights ``w``
        (``(K_chunk,)``, already normalized over the FULL cohort by the
        caller — chunking must not change the weights)."""
        if mult is not None:
            assert masks is not None, "mult needs masks"
        kc, n = chunk.shape
        assert n == self.n, (n, self.n)
        x, m, mu = _f32(chunk), _f32(masks), _f32(mult)
        w = torch.as_tensor(w, dtype=torch.float32,
                            device=self.device).contiguous()
        if self.use_kernel:
            plane_accum_2d(self._num, self._den, self._cov, x, w, m, mu)
        else:
            self._num, self._den, self._cov = ref.plane_accum_ref(
                self._num, self._den, self._cov, x, w, m, mu)
        self._note(kc, kc * n * (4 + 4 * (m is not None)
                                 + 4 * (mu is not None)))
        return self

    def update_q(self, chunk, scales, w, *, masks=None, mult=None,
                 base=None):
        raise NotImplementedError(
            "the int8 wire's fused dequantize-accumulate (plane_accum_q) "
            "is not ported yet — ROADMAP.md queue 1, compressed wire")

    def merge(self, other: "PlaneAccumulator"):
        """Sum another accumulator's partial triple into this one (exact
        by associativity). Both must cover the same n."""
        assert other.n == self.n, \
            "merge needs accumulators over the same plane layout"
        self._num = self._num + other._num
        self._den = self._den + other._den
        self._cov = self._cov + other._cov
        self.rows += other.rows
        self.chunks += other.chunks
        self.peak_rows = max(self.peak_rows, other.peak_rows)
        self._chunk_bytes = max(self._chunk_bytes, other._chunk_bytes)
        return self

    def partials(self):
        """The raw (num, den, cov) triple, ``(n,)`` each."""
        return self._num[0], self._den[0], self._cov[0]

    def finish(self, *, renorm: bool = True, fallback=None):
        """The one divide pass -> ``(n,)`` f32: ``renorm`` divides by the
        accumulated covering mass where positive; ``fallback``
        substitutes on coordinates no streamed client covered. Without
        either the numerator is the result (a view of it; no pass)."""
        if not renorm and fallback is None:
            return self._num[0]
        fb = None if fallback is None else _f32(fallback).reshape(1, self.n)
        if self.use_kernel:
            out = plane_finish_2d(self._num, self._den, self._cov, fb,
                                  renorm=renorm)
        else:
            out = ref.plane_finish_ref(self._num, self._den, self._cov, fb,
                                       renorm=renorm)
        return out[0]

    def stats(self) -> dict:
        """Memory accounting: ``buffer_bytes`` (3 f32 buffers) + the
        largest chunk's streamed operands = ``peak_bytes`` —
        O(P·K_chunk), independent of total rows."""
        buffers = 3 * self.n * 4
        return {"n": self.n, "rows": self.rows, "chunks": self.chunks,
                "peak_chunk_rows": self.peak_rows,
                "buffer_bytes": buffers, "chunk_bytes": self._chunk_bytes,
                "peak_bytes": buffers + self._chunk_bytes}
