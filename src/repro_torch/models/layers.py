"""Primitive layers of the transformer path (the JAX package's
``models/layers.py``). Parameters are plain tensors in the JAX layout
(``(Din, Dout)`` matmul weights), so a JAX-initialised tree crosses over
leaf for leaf."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.collectives import (copy_to_model, sp_active,
                                              tp_active, tp_enter, tp_held,
                                              tp_leave)


def _draw(shape, std: float, generator, device, dtype):
    """Normal(0, std²) from ``generator``, drawn where the generator lives
    (a CUDA generator draws on its card; a CPU one, or None, on the CPU)
    and then moved; ``device="meta"`` gives the shape only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    where = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator, device=where).mul_(
        std).to(device=device, dtype=dtype)


def dense_init(shape, generator, *, device=None, dtype=torch.float32,
               fan_in: Optional[int] = None):
    fan_in = fan_in or shape[-2] if len(shape) >= 2 else shape[-1]
    return _draw(shape, 1.0 / math.sqrt(max(fan_in, 1)), generator, device,
                 dtype)


def embed_init(shape, generator, *, device=None, dtype=torch.float32):
    return _draw(shape, 0.02, generator, device, dtype)


def zeros(shape, *, device=None, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return theta ** exps


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The
    half-split layout: rotate (x[:hd/2], x[hd/2:]) as pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)        # (hd/2,)
    angles = positions[..., None].float() * freqs         # (..., S, hd/2)
    angles = angles[..., None, :]                         # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


# ------------------------------------------- the batch-free product
# The remat "dots" policy (``models/transformer.py``'s ``_Remat``) keeps
# the outputs of the products that are ``dot_general``s without batch
# dimensions in the reference: the weight projections, which every such
# product goes through (``dot``). A remat unit's forward under "dots"
# records them on a tape and returns them from the Function; its
# backward replays them in the same order, so the recompute reads each
# product back (``_SavedDot``) instead of computing it again. Under
# "full" the recompute computes them all again. The tapes are a plain
# stack, not thread-local: on the card the autograd engine runs the
# backward on its device thread.
_TAPES: list = []
_DOT_COUNTS = {"forward": 0, "recomputed": 0, "replayed": 0}


class _Tape:
    """The batch-free products of one remat unit: ``mode`` "save" (the
    forward under "dots": record), "replay" (its backward: read back in
    order), "forward" / "recompute" (the "full" policy: count only)."""

    def __init__(self, mode: str, saved=()):
        self.mode = mode
        self.saved = list(saved)
        self.next = 0


def dot_tape(mode: str, saved=()):
    """Push a tape for one remat unit's forward or recompute; pop it with
    ``end_tape``."""
    tape = _Tape(mode, saved)
    _TAPES.append(tape)
    return tape


def end_tape(tape: _Tape) -> list:
    """Pop ``tape``; returns the products it recorded. A replay must have
    read back every product it was given."""
    assert _TAPES and _TAPES[-1] is tape
    _TAPES.pop()
    if tape.mode == "replay":
        assert tape.next == len(tape.saved), (tape.next, len(tape.saved))
    return tape.saved


def dot_counts(reset: bool = False) -> dict:
    """Batch-free products inside remat units since the last reset:
    ``forward`` computed in a unit's forward, ``recomputed`` computed
    again in its backward ("full"), ``replayed`` read back there
    ("dots")."""
    out = dict(_DOT_COUNTS)
    if reset:
        for k in _DOT_COUNTS:
            _DOT_COUNTS[k] = 0
    return out


class _SavedDot(torch.autograd.Function):
    """``x @ w`` whose value is the saved product ``y``: the forward
    returns ``y``, the backward is the product's (``g wᵀ`` and ``xᵀ g``,
    as ``matmul`` folds the leading axes)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, y):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n = w.shape[-1]
        g2 = g.reshape(-1, n)
        gx = (g2 @ w.transpose(0, 1)).reshape(x.shape)
        gw = x.reshape(-1, x.shape[-1]).transpose(0, 1) @ g2
        return gx, gw, None


def dot(x, w):
    """``x @ w`` for a weight ``w`` (Din, Dout): the batch-free product
    the remat "dots" policy saves (see above); a plain matmul outside a
    remat unit."""
    if not _TAPES:
        return x @ w
    tape = _TAPES[-1]
    if tape.mode == "replay":
        _DOT_COUNTS["replayed"] += 1
        y = tape.saved[tape.next]
        tape.next += 1
        return _SavedDot.apply(x, w, y)
    y = x @ w
    if tape.mode == "save":
        tape.saved.append(y)
    _DOT_COUNTS["recomputed" if tape.mode == "recompute" else "forward"] += 1
    return y


def mlp_init(generator, cfg, d_model: int, d_ff: int, *, device=None,
             dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    if cfg.mlp_kind == "gelu":
        p = {"wi": dense_init((d_model, d_ff), generator, **kw),
             "wd": dense_init((d_ff, d_model), generator, **kw)}
        if cfg.mlp_bias:
            p["bi"] = zeros((d_ff,), **kw)
            p["bd"] = zeros((d_model,), **kw)
        return p
    return {"wg": dense_init((d_model, d_ff), generator, **kw),
            "wu": dense_init((d_model, d_ff), generator, **kw),
            "wd": dense_init((d_ff, d_model), generator, **kw)}


def mlp_apply(p, x, mlp_kind: str, ctx=None, d_ff: int = 0):
    """The dense FFN. Under a ``ctx`` with a model axis the leaves are
    whole (the FFN runs whole on every rank) or this rank's part of the
    layer's ``d_ff`` (its whole width; ``sharding.rules.tp_slice``):
    ``wg``/``wu``/``wi``/``bi`` column-split, ``wd`` row-split, the
    partials summed by one ``all_reduce`` (``tp_row_matmul``) and ``bd``
    added once, after it."""
    held = p["wd"].shape[-2]
    split = tp_active(ctx) and tp_held(ctx, d_ff or held, held)
    x = tp_enter(x, ctx, split)
    if mlp_kind == "gelu":
        h = dot(x, p["wi"])
        if "bi" in p:
            h = h + p["bi"]
        out = tp_row_matmul(gelu(h), p["wd"], ctx, split)
        if "bd" in p:
            # under sequence parallelism ``out`` is the rank's rows: the
            # bias's gradient is the sum of the ranks'
            bd = p["bd"]
            out = out + (copy_to_model(bd, ctx) if sp_active(ctx) else bd)
        return out
    act = gelu if mlp_kind == "geglu" else F.silu
    return tp_row_matmul(act(dot(x, p["wg"])) * dot(x, p["wu"]), p["wd"],
                         ctx, split)


def tp_row_matmul(h, w, ctx=None, split: bool = False):
    """Row-parallel projection ``y = h @ w`` (attention ``wo``, MLP
    ``wd``). Under a model axis with ``split`` — ``h`` this rank's
    columns of the contraction, ``w`` its rows — the rank's partial
    product is summed over the model group: in f32 (a low-precision
    partial is computed in f32, as XLA's default all-reduce is), or,
    under ``ctx.tp_bf16_reduce``, cast to the activation dtype before the
    reduce (half the bytes; the reference's ``shard_map`` + ``psum``).
    Under sequence parallelism the output is then cut to the rank's rows
    (``tp_leave``). Without a model axis a plain matmul. The product
    goes through ``dot`` before the reduce: the remat "dots" policy keeps
    the rank's partial, as the reference's shard-mapped dot is kept."""
    if not tp_active(ctx):
        return dot(h, w)
    if split and not ctx.tp_bf16_reduce and h.dtype != torch.float32:
        return tp_leave(dot(h.float(), w.float()), ctx, True).to(h.dtype)
    return tp_leave(dot(h, w), ctx, split)


def causal_conv1d(x, kernel, state=None):
    """Depthwise causal conv along time. x: (B, S, C), kernel: (W, C).

    Returns (out, new_state) where state is the last W-1 inputs (B, W-1, C).
    """
    W = kernel.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([state, x], dim=1)                     # (B, S+W-1, C)
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i: i + x.shape[1], :] * kernel[i]
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return out, new_state
