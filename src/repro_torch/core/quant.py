"""Quantized wire formats for plane aggregation.

What a client ships each round is a packed ``(P,)`` plane row (or a
``(K_chunk, P)`` chunk of rows — ``core.plane``); this module defines
how those rows encode on the wire:

  * ``"f32"``   — the uncompressed baseline: full f32 rows, no encoding.
  * ``"bf16"``  — a plain dtype cast, 2 bytes/coordinate, no side data.
                  The streaming accumulate (``kernels/fedavg``) reads a
                  bf16 chunk as it is and casts each element to f32 in
                  registers, so the f32 chunk never exists.
  * ``"int8"``  — symmetric per-tile quantization, 1 byte/coordinate
                  plus one f32 scale per ``tile`` coordinates: the row
                  splits into dense tiles of ``tile`` columns (a multiple
                  of 128, default 256), each tile carries
                  ``scale = max|x| / 127`` and ``q = round(x / scale)``
                  clipped to [-127, 127]. Dequantization is ``q·scale``,
                  fused into the streaming accumulate by
                  ``kernels/fedavg.plane_accum_q``.

A 0/1 ``mask`` (the sparse wire) zeroes the off-mask coordinates before
quantizing; ``payload_nbytes`` then counts only the covered coordinates.

Error feedback keeps the quantization unbiased across rounds: each
client holds a residual ``e`` (f32, client-side only) and encodes
``q = Q(x + e)``, ``e' = (x + e) - deq(q)``, so the noise a round drops
is re-injected the next round. ``deq(q) + e' == x + e`` holds exactly.

Every function here gives the JAX package's bits for the same input:
the scale is a true f32 division by 127, ``q`` a true division by the
scale (not a product with its reciprocal), rounded half to even. The
(…, n) inputs are taken as they are: the last tile may straddle the row
end and its scale is taken over the real coordinates only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

WIRE_FORMATS = ("f32", "bf16", "int8")
INT8_MAX = 127.0
DEFAULT_TILE = 256   # scale granularity: one f32 scale per `tile` coords
_LANE = 128          # tiles are multiples of 128 coordinates

_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


def wire_itemsize(fmt: str) -> int:
    """Bytes per coordinate of the VALUES payload."""
    if fmt not in WIRE_FORMATS:
        raise ValueError(f"wire={fmt!r}, expected one of {WIRE_FORMATS}")
    return _ITEMSIZE[fmt]


def validate_tile(tile: int) -> int:
    if (isinstance(tile, bool) or not isinstance(tile, int)
            or tile < _LANE or tile % _LANE):
        raise ValueError(f"wire tile={tile!r} must be a positive multiple "
                         f"of {_LANE} (lane-aligned scale tiles)")
    return tile


def n_tiles(n: int, tile: int = DEFAULT_TILE) -> int:
    """Number of scale tiles covering an ``n``-coordinate row (the last
    tile may straddle the row end)."""
    return -(-int(n) // int(tile))


def _split(x: torch.Tensor, tile: int):
    """(..., n) -> (the whole tiles as a (..., n // tile, tile) view, the
    ragged tail (..., n % tile) view)."""
    n = x.shape[-1]
    full = (n // tile) * tile
    body = x[..., :full].reshape(x.shape[:-1] + (n // tile, tile))
    return body, x[..., full:]


def _tile_scales(x: torch.Tensor, tile: int) -> torch.Tensor:
    """max|x| / 127 per tile, (..., n_tiles). ``max|x|`` is taken as
    ``max(amax, -amin)`` (exact: negation and |.| round nothing), so no
    ``|x|`` temporary of the chunk's size is made."""
    body, tail = _split(x, tile)
    parts = []
    if body.shape[-2]:
        parts.append(torch.maximum(body.amax(-1), body.amin(-1).neg()))
    if tail.shape[-1]:
        parts.append(tail.abs().amax(-1, keepdim=True))
    return torch.cat(parts, -1) / INT8_MAX


def _scale_(qf: torch.Tensor, scales: torch.Tensor, tile: int
            ) -> torch.Tensor:
    """``qf *= scale`` per tile, in place on ``qf`` (..., n), through
    views (no per-coordinate scale tensor is made)."""
    body, tail = _split(qf, tile)
    full = body.shape[-2]
    if full:
        body.mul_(scales[..., :full, None])
    if tail.shape[-1]:
        tail.mul_(scales[..., full:])
    return qf


def _quantize_int8(x: torch.Tensor, tile: int, *, keep_float: bool = False):
    """(values int8, scales f32[, the clipped rounded quotients as f32])
    for an f32 ``x`` already masked."""
    scales = _tile_scales(x, tile)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    qf = torch.empty_like(x)
    body, tail = _split(x, tile)
    qb, qt = _split(qf, tile)
    full = body.shape[-2]
    if full:
        torch.div(body, safe[..., :full, None], out=qb)
    if tail.shape[-1]:
        torch.div(tail, safe[..., full:], out=qt)
    qf.round_().clamp_(-INT8_MAX, INT8_MAX)
    q = qf.to(torch.int8)
    return (q, scales, qf) if keep_float else (q, scales)


def quantize(x, fmt: str, *, tile: int = DEFAULT_TILE, mask=None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode ``x`` (..., n) f32 for the wire -> ``(values, scales)``.

    ``fmt="f32"``/``"bf16"``: a cast, ``scales`` is None. ``"int8"``:
    symmetric per-tile quantization — ``scales`` has shape
    ``(..., n_tiles(n, tile))``, all-zero tiles get scale 0 (payload 0;
    dequantization multiplies by the raw scale). A 0/1 ``mask`` zeroes
    off-mask coordinates BEFORE the scale is computed."""
    x = torch.as_tensor(x).float()
    if mask is not None:
        x = x * mask.float()
    if fmt == "f32":
        return x, None
    if fmt == "bf16":
        return x.to(torch.bfloat16), None
    if fmt != "int8":
        raise ValueError(f"wire={fmt!r}, expected one of {WIRE_FORMATS}")
    return _quantize_int8(x, validate_tile(tile))


def dequantize(values, scales=None, *, tile: int = DEFAULT_TILE
               ) -> torch.Tensor:
    """Decode a wire payload back to f32. int8 payloads need their
    ``scales``; bf16/f32 are casts (``scales`` ignored/None)."""
    values = torch.as_tensor(values)
    if values.dtype != torch.int8:
        return values.float()
    assert scales is not None, "int8 payloads need their per-tile scales"
    tile = validate_tile(tile)
    return _scale_(values.float(), scales.float(), tile)


def encode(x, residual, fmt: str, *, tile: int = DEFAULT_TILE, mask=None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Error-feedback encode: ``q = Q(x + e)`` ->
    ``(values, scales, new_residual)``.

    ``deq(values, scales) + new_residual == x + e`` on every shipped
    (on-``mask``) coordinate; off-mask coordinates carry no payload and
    no residual. ``residual=None`` starts from zero (round 0).

    Memory: besides the payload, at most two temporaries of ``x``'s
    size exist at once (``x + e``, which becomes the new residual in
    place, and the int8 path's quotients, which become ``deq(q)`` in
    place)."""
    x = torch.as_tensor(x).float()
    xe = x.clone() if residual is None else x + residual.float()
    if mask is not None:
        m = mask.float()
        xe.mul_(m)                  # quantize's own masking, in place
    if fmt == "f32":
        values, scales = xe.clone(), None
        xe.zero_()
    elif fmt == "bf16":
        values, scales = xe.to(torch.bfloat16), None
        xe.sub_(values.float())
    elif fmt == "int8":
        tile = validate_tile(tile)
        values, scales, deq = _quantize_int8(xe, tile, keep_float=True)
        xe.sub_(_scale_(deq, scales, tile))
        del deq
    else:
        raise ValueError(f"wire={fmt!r}, expected one of {WIRE_FORMATS}")
    if mask is not None:
        xe.mul_(m)
    return values, scales, xe


def values_nbytes(fmt: str, count: int) -> int:
    """Bytes of the VALUES payload for ``count`` shipped coordinates."""
    return int(count) * wire_itemsize(fmt)


def scales_nbytes(fmt: str, n: int, *, tile: int = DEFAULT_TILE) -> int:
    """Bytes of the scale side-channel (int8 only: one f32 per tile,
    dense over the row — sparsity does not thin the scale grid)."""
    return 4 * n_tiles(n, tile) if fmt == "int8" else 0


def payload_nbytes(fmt: str, n: int, *, tile: int = DEFAULT_TILE,
                   covered: Optional[int] = None) -> int:
    """Total wire bytes for one ``n``-coordinate row: values (all ``n``
    coordinates dense, or only ``covered`` of them under the sparse
    wire) + the dense per-tile scales for int8."""
    count = n if covered is None else covered
    return values_nbytes(fmt, count) + scales_nbytes(fmt, n, tile=tile)
