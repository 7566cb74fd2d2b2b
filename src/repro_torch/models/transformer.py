"""Config-driven transformer stack, dense path (the JAX package's
``models/transformer.py``).

Layers are organized as *pattern units* (the repeating layer group):
parameters of each unit position are stacked over a leading ``n_units``
axis (``params["units"]["b{i}"]``), as in the JAX package, so NetChange
depth transforms are slices/concats of that axis and a JAX-initialised
tree crosses over leaf for leaf. The stack is traversed with a Python
loop over the unit axis where JAX uses ``lax.scan``. Layers that don't
fill a whole unit live unstacked under ``params["rem"]``.

Ported: attention blocks ("global", "local") with a dense MLP, for
training and for serving (prefill builds the decode cache in the JAX
tree layout; decode writes each new token into it in place). MoE, MLA,
the recurrent blocks, the whisper encoder and the vision front end raise
``NotImplementedError`` (ROADMAP.md queue 1, item 9).

  init_params(generator, cfg, device=)     -> params
  forward(params, cfg, tokens, ctx=)       -> logits (B,S,V) f32
  forward_hidden(params, cfg, tokens, ctx=) -> final-norm hidden (B,S,D)
  prefill(params, cfg, tokens, ctx=, cache_len=) -> (last logits (B,V), cache)
  decode_step(params, cfg, token, cache, pos, ctx=) -> (logits (B,V), cache)
  init_cache(cfg, B, S_max, dtype=, device=) -> cache
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import (embed_init, dense_init, mlp_apply,
                                       mlp_init, rms_norm, zeros)
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx

Params = Dict[str, Any]

_QUEUE = "the transformer stack (item 9)"


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense_only(cfg: ModelConfig) -> None:
    """Raise on the parts of a config the port does not run yet."""
    for what, present in (("MoE", cfg.moe is not None),
                          ("MLA", cfg.mla is not None),
                          ("the whisper encoder", cfg.encoder is not None),
                          ("the front end", cfg.frontend is not None)):
        if present:
            raise not_ported(f"{what} ({cfg.name})", _QUEUE)
    for kind in cfg.layer_pattern:
        if kind not in ("global", "local"):
            raise not_ported(f"layer kind {kind!r} ({cfg.name})", _QUEUE)


# ------------------------------------------------------------- block init
def block_init(generator, cfg: ModelConfig, kind: str, *, device=None,
               dtype=torch.float32) -> Params:
    """One attention block's parameters; ``device="meta"`` gives shapes
    only."""
    if kind not in ("global", "local"):
        raise not_ported(f"layer kind {kind!r}", _QUEUE)
    D = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    return {"ln1": zeros((D,), **kw), "ln2": zeros((D,), **kw),
            "attn": A.attn_init(generator, cfg, **kw),
            "mlp": mlp_init(generator, cfg, D, cfg.d_ff, **kw)}


def block_apply_seq(p, cfg, kind, x, positions, *, ctx, return_cache=False,
                    cache_len=None):
    """Full-sequence pre-norm block: x + attn(norm x), then + mlp.
    Returns (x, cache|None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, cache = A.attn_apply_seq(p["attn"], cfg, h, positions, kind=kind,
                                ctx=ctx, return_cache=return_cache,
                                cache_len=cache_len)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_kind, ctx), cache


def block_apply_decode(p, cfg, kind, x, pos, cache, *, ctx):
    """One-token attention block step ("global" / "local"); the block's
    cache is written in place. Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, cache = A.attn_apply_decode(p["attn"], cfg, h, pos, cache, kind=kind,
                                   ctx=ctx)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_kind, ctx), cache


def _block_cache_init(cfg, kind, B, S_max, dtype, device=None):
    return A.init_attn_cache(cfg, B, S_max, dtype, kind=kind, device=device)


def _stack(trees):
    if not isinstance(trees[0], dict):
        return torch.stack(trees)
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}


# ----------------------------------------------------------------- init
def init_params(generator: Optional[torch.Generator], cfg: ModelConfig, *,
                device=None) -> Params:
    """Random parameters (drawn from ``generator`` where it lives — a CUDA
    generator draws on its card — then moved to ``device``) in the JAX
    package's tree layout; ``device="meta"`` gives the shapes only.
    Matches the JAX init in distribution."""
    cfg.validate()
    _dense_only(cfg)
    kw = dict(device=device, dtype=_param_dtype(cfg))
    D, V = cfg.d_model, cfg.vocab_size
    params: Params = {"embed": embed_init((V, D), generator, **kw),
                      "final_ln": zeros((D,), **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((D, V), generator, **kw)
    if cfg.n_units:
        params["units"] = {
            f"b{i}": _stack([block_init(generator, cfg, kind, **kw)
                             for _ in range(cfg.n_units)])
            for i, kind in enumerate(cfg.layer_pattern)}
    rem = {f"b{i}": block_init(generator, cfg, kind, **kw)
           for i, kind in enumerate(cfg.rem_kinds)}
    if rem:
        params["rem"] = rem
    return params


# ------------------------------------------------------------- embeddings
def _embed(params, cfg, tokens):
    h = params["embed"][tokens.long()].to(_param_dtype(cfg))
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _logits(params, cfg, h, fp32=True):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = h @ w
    return out.float() if fp32 else out


# ------------------------------------------------------------ seq traversal
def _traverse_seq(params, cfg, h, positions, *, ctx, return_cache=False,
                  cache_len=None):
    """The stacked units in order (a loop over the unit axis), then the
    unstacked remainder. Returns (h, caches|None), the caches in the JAX
    tree layout: ``{"units": {"b{i}": {"k", "v"} stacked over n_units},
    "rem": {"b{i}": ...}}``."""
    if ctx.remat:
        raise not_ported("layer rematerialisation (ctx.remat)", _QUEUE)
    kw = dict(ctx=ctx, return_cache=return_cache, cache_len=cache_len)
    cache = {}
    if cfg.n_units:
        units = [_unbind(params["units"][f"b{i}"])
                 for i in range(cfg.pattern_len)]
        per_unit = [[] for _ in range(cfg.pattern_len)]
        for u in range(cfg.n_units):
            for i, kind in enumerate(cfg.layer_pattern):
                h, c = block_apply_seq(units[i][u], cfg, kind, h, positions,
                                       **kw)
                per_unit[i].append(c)
        if return_cache:
            cache["units"] = {f"b{i}": _stack(cs)
                              for i, cs in enumerate(per_unit)}
    rem = {}
    for i, kind in enumerate(cfg.rem_kinds):
        h, rem[f"b{i}"] = block_apply_seq(params["rem"][f"b{i}"], cfg, kind,
                                          h, positions, **kw)
    if not return_cache:
        return h, None
    if rem:
        cache["rem"] = rem
    return h, cache


def _unbind(tree):
    """A stacked block tree -> one tree per unit. ``unbind`` once (its
    backward stacks the units' gradients into one buffer per leaf, as
    ``lax.scan`` does), where indexing each unit would give every unit's
    gradient a zero-filled buffer of the whole stack."""
    if not isinstance(tree, dict):
        return torch.unbind(tree, 0)
    per_key = {k: _unbind(v) for k, v in tree.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[u] for k, v in per_key.items()} for u in range(n)]


def forward_hidden(params, cfg: ModelConfig, tokens, *,
                   ctx: ShardCtx = CPU_CTX):
    """Final-norm hidden states (B, S, D)."""
    _dense_only(cfg)
    h = _embed(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = _traverse_seq(params, cfg, h, positions, ctx=ctx)
    return rms_norm(h, params["final_ln"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, ctx: ShardCtx = CPU_CTX,
            fp32_logits=True):
    """Training forward: logits for every position. tokens: (B, S)."""
    h = forward_hidden(params, cfg, tokens, ctx=ctx)
    return _logits(params, cfg, h, fp32_logits)


def prefill(params, cfg: ModelConfig, tokens, *, ctx: ShardCtx = CPU_CTX,
            cache_len: Optional[int] = None):
    """Prefill: returns (last-position logits (B,V) f32, cache); global
    layers' caches hold ``cache_len`` (default S) slots, local layers' the
    last ``window`` positions as a ring."""
    _dense_only(cfg)
    h = _embed(params, cfg, tokens)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    h, cache = _traverse_seq(params, cfg, h, positions, ctx=ctx,
                             return_cache=True, cache_len=cache_len or S)
    h = rms_norm(h[:, -1:], params["final_ln"], cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], cache


def decode_step(params, cfg: ModelConfig, token, cache, pos: int, *,
                ctx: ShardCtx = CPU_CTX):
    """One decode step. token: (B,1) int; pos: the new token's position
    (an int). Writes the token's k/v into ``cache`` in place; returns
    (logits (B,V) f32, cache)."""
    _dense_only(cfg)
    pos = int(pos)
    h = _embed(params, cfg, token)
    if cfg.n_units:
        units = [_unbind(params["units"][f"b{i}"])
                 for i in range(cfg.pattern_len)]
        for u in range(cfg.n_units):
            for i, kind in enumerate(cfg.layer_pattern):
                c = cache["units"][f"b{i}"]
                h, _ = block_apply_decode(
                    units[i][u], cfg, kind, h, pos,
                    {"k": c["k"][u], "v": c["v"][u]}, ctx=ctx)
    for i, kind in enumerate(cfg.rem_kinds):
        h, _ = block_apply_decode(params["rem"][f"b{i}"], cfg, kind, h, pos,
                                  cache["rem"][f"b{i}"], ctx=ctx)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], cache


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=None, *,
               device=None) -> Params:
    """Zero decode caches in the JAX tree layout (``prefill``'s)."""
    _dense_only(cfg)
    dtype = dtype or _param_dtype(cfg)
    cache: Dict[str, Any] = {}
    if cfg.n_units:
        cache["units"] = {
            f"b{i}": _stack([_block_cache_init(cfg, kind, B, S_max, dtype,
                                               device)
                             for _ in range(cfg.n_units)])
            for i, kind in enumerate(cfg.layer_pattern)}
    if cfg.rem_kinds:
        cache["rem"] = {f"b{i}": _block_cache_init(cfg, kind, B, S_max, dtype,
                                                   device)
                        for i, kind in enumerate(cfg.rem_kinds)}
    return cache
