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

from repro_torch.device import DeviceLike, kernel_for, resolve_device
from repro_torch.kernels.fedavg import ref
from repro_torch.kernels.fedavg.fedavg import (
    check_tile, plane_accum_2d, plane_accum_q_2d, plane_agg_2d,
    plane_finish_2d, weighted_sum_2d, weighted_sum_masked_2d,
    weighted_sum_masked_mult_2d)


def _f32(a):
    return None if a is None else a.float().contiguous()


def _chunk(x):
    """A streamed chunk as the accumulate kernel reads it: bf16 stays
    bf16 (the kernel widens each element; the f32 chunk never exists),
    anything else is f32."""
    if x.dtype == torch.bfloat16:
        return x.contiguous()
    return _f32(x)


def _check_q(chunk, scales, n, tile, masks, mult, base):
    """What ``plane_accum_q`` and ``update_q`` both require of an int8
    chunk, its scale grid and the variant's operands."""
    if mult is not None:
        assert masks is not None, "mult needs masks (coverage aggregation)"
    if base is not None:
        assert masks is not None and mult is None, \
            "fold needs masks and is exclusive with mult"
    if chunk.dtype != torch.int8:
        raise ValueError(f"int8 chunks only, got {chunk.dtype}")
    kc, nc = chunk.shape
    assert nc == n, (nc, n)
    grid = (kc, -(-n // tile))
    assert tuple(scales.shape) == grid, (tuple(scales.shape), grid)


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


def weighted_sum(stacked, w, *, use_kernel: Optional[bool] = None):
    """stacked: (K, *shape); w: (K,) -> (*shape,) f32: Eq. 1 on one
    leaf (``weighted_sum_2d`` over its flattened coordinates)."""
    K, shape = stacked.shape[0], stacked.shape[1:]
    flat = stacked.reshape(K, -1)
    if not kernel_for(use_kernel, stacked.device):
        return ref.weighted_sum_ref(flat, w).reshape(shape)
    return weighted_sum_2d(_f32(flat), _f32(w)).reshape(shape)


def weighted_sum_masked(stacked, w, masks, *, mult=None, renorm: bool = True,
                        use_kernel: Optional[bool] = None):
    """stacked, masks [, mult]: (K, *shape); w: (K,) -> (*shape,) f32 —
    the per-leaf coverage average: ``Σ_k w_k m_k x_k``, divided by
    ``Σ_k w_k m_k`` where that is > 0 when ``renorm`` (coordinates no
    client covers come back 0 — callers substitute their own fallback);
    with ``mult`` the client weight is ``w_k m_k / mult_k``
    (``weighted_sum_masked_2d`` / ``weighted_sum_masked_mult_2d``)."""
    K, shape = stacked.shape[0], stacked.shape[1:]
    x, m = stacked.reshape(K, -1), masks.reshape(K, -1)
    mu = None if mult is None else mult.reshape(K, -1)
    if not kernel_for(use_kernel, stacked.device):
        return ref.weighted_sum_masked_ref(x, w, m, mult=mu,
                                           renorm=renorm).reshape(shape)
    if mu is None:
        out = weighted_sum_masked_2d(_f32(x), _f32(w), _f32(m),
                                     renorm=renorm)
    else:
        out = weighted_sum_masked_mult_2d(_f32(x), _f32(w), _f32(m),
                                          _f32(mu), renorm=renorm)
    return out.reshape(shape)


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
    plane_accum_2d(*trip, _chunk(chunk), _f32(w), _f32(masks), _f32(mult))
    return tuple(t[0] for t in trip)


def plane_accum_q(num, den, cov, chunk, scales, w, *, masks=None, mult=None,
                  base=None, tile: int = 256,
                  use_kernel: Optional[bool] = None):
    """Functional fused dequantize-accumulate on ``(n,)`` buffers:
    ``(num, den, cov) + int8 (K_chunk, n) chunk with per-tile scales
    (K_chunk, ceil(n/tile)) -> updated (num, den, cov)`` (new tensors).
    ``masks``/``mult`` are the coverage variants, ``base`` ``(n,)`` the
    filler_mode="global" fold (x·m + base·(1−m), then an unmasked
    accumulate)."""
    n = chunk.shape[1]
    assert num.shape == den.shape == cov.shape == (n,), \
        (num.shape, den.shape, cov.shape, chunk.shape)
    _check_q(chunk, scales, n, check_tile(tile), masks, mult, base)
    if not kernel_for(use_kernel, chunk.device):
        return ref.plane_accum_q_ref(num, den, cov, chunk, scales, w, masks,
                                     mult, base, tile=tile)
    trip = [t.float().reshape(1, n).clone() for t in (num, den, cov)]
    plane_accum_q_2d(*trip, chunk.contiguous(), _f32(scales), _f32(w),
                     _f32(masks), _f32(mult),
                     None if base is None else _f32(base).reshape(1, n),
                     tile=tile)
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

    ``update_q`` takes the int8 wire's chunks (``core.quant``) with
    their per-tile scales through the fused dequantize-accumulate kernel
    (``plane_accum_q``); it needs ``q_tile``, the scale tile (a multiple
    of 128), set at construction.

    ``device=None`` means CUDA (raises without a card); ``use_kernel``
    follows the ``ops`` rule for that device.
    """

    def __init__(self, n: int, *, use_kernel: Optional[bool] = None,
                 device: DeviceLike = None, q_tile: Optional[int] = None):
        self.n = int(n)
        self.device = resolve_device(device)
        self.use_kernel = kernel_for(use_kernel, self.device)
        self.q_tile = None if q_tile is None else check_tile(q_tile)
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
        caller — chunking must not change the weights). A bf16 chunk
        (the bf16 wire) is read as it is; everything else is taken as
        f32."""
        if mult is not None:
            assert masks is not None, "mult needs masks"
        kc, n = chunk.shape
        assert n == self.n, (n, self.n)
        x, m, mu = _chunk(chunk), _f32(masks), _f32(mult)
        w = torch.as_tensor(w, dtype=torch.float32,
                            device=self.device).contiguous()
        if self.use_kernel:
            plane_accum_2d(self._num, self._den, self._cov, x, w, m, mu)
        else:
            self._num, self._den, self._cov = ref.plane_accum_ref(
                self._num, self._den, self._cov, x, w, m, mu)
        self._note(kc, kc * n * (x.element_size() + 4 * (m is not None)
                                 + 4 * (mu is not None)))
        return self

    def update_q(self, chunk, scales, w, *, masks=None, mult=None,
                 base=None):
        """Accumulate one int8 ``(K_chunk, n)`` chunk with per-tile
        ``scales`` (``(K_chunk, ceil(n/q_tile))``) through the fused
        dequantize-accumulate kernel — on CUDA the f32 chunk never
        exists; aggregation traffic is 1 byte/coordinate plus the scale
        grid. ``base`` ``(n,)`` is the filler_mode="global" fold."""
        assert self.q_tile is not None, \
            "update_q needs q_tile set at construction"
        tile, (kc, n) = self.q_tile, chunk.shape
        _check_q(chunk, scales, self.n, tile, masks, mult, base)
        nt = -(-n // tile)
        s, m, mu = _f32(scales), _f32(masks), _f32(mult)
        b = None if base is None else _f32(base).reshape(1, n)
        w = torch.as_tensor(w, dtype=torch.float32,
                            device=self.device).contiguous()
        if self.use_kernel:
            plane_accum_q_2d(self._num, self._den, self._cov,
                             chunk.contiguous(), s, w, m, mu, b, tile=tile)
        else:
            self._num, self._den, self._cov = ref.plane_accum_q_ref(
                self._num, self._den, self._cov, chunk, s, w, m, mu, b,
                tile=tile)
        self._note(kc, kc * (n + 4 * nt + 4 * n * (m is not None)
                             + 4 * n * (mu is not None))
                   + 4 * n * (b is not None))
        return self

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
        largest chunk's streamed operands at their actual itemsizes (an
        int8 chunk counts 1 byte/coordinate plus its scale grid) =
        ``peak_bytes`` — O(P·K_chunk), independent of total rows."""
        buffers = 3 * self.n * 4
        return {"n": self.n, "rows": self.rows, "chunks": self.chunks,
                "peak_chunk_rows": self.peak_rows,
                "buffer_bytes": buffers, "chunk_bytes": self._chunk_bytes,
                "peak_bytes": buffers + self._chunk_bytes}
