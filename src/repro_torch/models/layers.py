"""Primitive layers of the transformer path (the JAX package's
``models/layers.py``). Parameters are plain tensors in the JAX layout
(``(Din, Dout)`` matmul weights), so a JAX-initialised tree crosses over
leaf for leaf."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.collectives import (tp_active, tp_enter, tp_held,
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
        h = x @ p["wi"]
        if "bi" in p:
            h = h + p["bi"]
        out = tp_row_matmul(gelu(h), p["wd"], ctx, split)
        if "bd" in p:
            out = out + p["bd"]
        return out
    act = gelu if mlp_kind == "geglu" else F.silu
    return tp_row_matmul(act(x @ p["wg"]) * (x @ p["wu"]), p["wd"], ctx,
                         split)


def tp_row_matmul(h, w, ctx=None, split: bool = False):
    """Row-parallel projection ``y = h @ w`` (attention ``wo``, MLP
    ``wd``). Under a model axis with ``split`` — ``h`` this rank's
    columns of the contraction, ``w`` its rows — the rank's partial
    product is summed over the model group: in f32 (a low-precision
    partial is computed in f32, as XLA's default all-reduce is), or,
    under ``ctx.tp_bf16_reduce``, cast to the activation dtype before the
    reduce (half the bytes; the reference's ``shard_map`` + ``psum``).
    Under sequence parallelism the output is then cut to the rank's rows
    (``tp_leave``). Without a model axis a plain matmul."""
    if not tp_active(ctx):
        return h @ w
    if split and not ctx.tp_bf16_reduce and h.dtype != torch.float32:
        return tp_leave(h.float() @ w.float(), ctx, True).to(h.dtype)
    return tp_leave(h @ w, ctx, split)


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
