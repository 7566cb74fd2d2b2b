"""Config-driven transformer stack (the JAX package's
``models/transformer.py``).

Layers are organized as *pattern units* (the repeating layer group):
parameters of each unit position are stacked over a leading ``n_units``
axis (``params["units"]["b{i}"]``), as in the JAX package, so NetChange
depth transforms are slices/concats of that axis and a JAX-initialised
tree crosses over leaf for leaf. The stack is traversed with a Python
loop over the unit axis where JAX uses ``lax.scan``. Layers that don't
fill a whole unit live unstacked under ``params["rem"]``.

Ported: attention blocks ("global", "local") — GQA or MLA attention,
with a dense MLP or a MoE FFN (``models/moe.py``) — and the recurrent
blocks ("rglru" with its MLP, "mlstm", "slstm"; ``models/ssm.py``), for
training and for serving (prefill builds the decode cache in the JAX
tree layout: ``{"k", "v"}`` a layer, MLA's latent ``{"ckv", "krope"}``,
a recurrent block's state; decode writes each new token, or the new
state, into it in place). The whisper encoder and the vision front end
raise ``NotImplementedError`` (ROADMAP.md queue 1, items 2-3).

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
from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (embed_init, dense_init, mlp_apply,
                                       mlp_init, rms_norm, zeros)
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx

Params = Dict[str, Any]

_QUEUE = "the transformer stack (items 2-3)"
_KINDS = ("global", "local", "rglru", "mlstm", "slstm")


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _ported_only(cfg: ModelConfig) -> None:
    """Raise on the parts of a config the port does not run yet."""
    for what, present in (("the whisper encoder", cfg.encoder is not None),
                          ("the front end", cfg.frontend is not None)):
        if present:
            raise not_ported(f"{what} ({cfg.name})", _QUEUE)
    for kind in cfg.layer_pattern:
        if kind not in _KINDS:
            raise not_ported(f"layer kind {kind!r} ({cfg.name})", _QUEUE)


# ------------------------------------------------------------- block init
def block_init(generator, cfg: ModelConfig, kind: str, *, device=None,
               dtype=torch.float32) -> Params:
    """One block's parameters; ``device="meta"`` gives shapes only."""
    if kind not in _KINDS:
        raise not_ported(f"layer kind {kind!r}", _QUEUE)
    D = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    if kind == "rglru":
        return {"ln1": zeros((D,), **kw),
                "rg": SSM.rglru_init(generator, cfg, **kw),
                "ln2": zeros((D,), **kw),
                "mlp": mlp_init(generator, cfg, D, cfg.d_ff, **kw)}
    if kind == "mlstm":
        return {"ln1": zeros((D,), **kw),
                "mx": SSM.mlstm_init(generator, cfg, **kw)}
    if kind == "slstm":
        return {"ln1": zeros((D,), **kw),
                "sx": SSM.slstm_init(generator, cfg, **kw)}
    p = {"ln1": zeros((D,), **kw), "ln2": zeros((D,), **kw),
         "attn": (A.mla_init(generator, cfg, **kw) if cfg.mla is not None
                  else A.attn_init(generator, cfg, **kw))}
    if cfg.moe is not None:
        p["moe"] = M.moe_init(generator, cfg, **kw)
    else:
        p["mlp"] = mlp_init(generator, cfg, D, cfg.d_ff, **kw)
    return p


def _ffn(p, cfg, x, ctx):
    if cfg.moe is not None:
        return M.moe_apply(p["moe"], cfg, x, ctx)
    return mlp_apply(p["mlp"], x, cfg.mlp_kind, ctx)


def block_apply_seq(p, cfg, kind, x, positions, *, ctx, return_cache=False,
                    cache_len=None):
    """Full-sequence pre-norm block: x + attn(norm x) (or the recurrent
    mixer), then + mlp. Returns (x, cache|None); a recurrent block's
    cache is its state after the last position."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rglru":
        y, st = SSM.rglru_seq(p["rg"], h, None, return_state=return_cache)
        x = x + y
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h2, cfg.mlp_kind, ctx), st
    if kind == "mlstm":
        y, st = SSM.mlstm_seq(p["mx"], cfg, h, None,
                              return_state=return_cache)
        return x + y, st
    if kind == "slstm":
        y, st = SSM.slstm_seq(p["sx"], cfg, h, None,
                              return_state=return_cache)
        return x + y, st
    if cfg.mla is not None:
        y, cache = A.mla_apply_seq(p["attn"], cfg, h, positions, ctx=ctx,
                                   return_cache=return_cache,
                                   cache_len=cache_len)
    else:
        y, cache = A.attn_apply_seq(p["attn"], cfg, h, positions, kind=kind,
                                    ctx=ctx, return_cache=return_cache,
                                    cache_len=cache_len)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(p, cfg, h2, ctx), cache


def block_apply_decode(p, cfg, kind, x, pos, cache, *, ctx):
    """One-token block step; the block's cache (an attention block's
    k/v, a recurrent block's state) is written in place. Returns (x,
    cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("rglru", "mlstm", "slstm"):
        if kind == "rglru":
            y, st = SSM.rglru_decode(p["rg"], h, cache)
        elif kind == "mlstm":
            y, st = SSM.mlstm_decode(p["mx"], cfg, h, cache)
        else:
            y, st = SSM.slstm_decode(p["sx"], cfg, h, cache)
        for n, t in st.items():
            cache[n].copy_(t)
        x = x + y
        if kind != "rglru":
            return x, cache
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h2, cfg.mlp_kind, ctx), cache
    if cfg.mla is not None:
        y, cache = A.mla_apply_decode(p["attn"], cfg, h, pos, cache, ctx=ctx)
    else:
        y, cache = A.attn_apply_decode(p["attn"], cfg, h, pos, cache,
                                       kind=kind, ctx=ctx)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(p, cfg, h2, ctx), cache


def _block_cache_init(cfg, kind, B, S_max, dtype, device=None):
    if kind == "rglru":
        return SSM.init_rglru_state(cfg, B, dtype, device=device)
    if kind == "mlstm":
        return SSM.init_mlstm_state(cfg, B, dtype, device=device)
    if kind == "slstm":
        return SSM.init_slstm_state(cfg, B, dtype, device=device)
    if cfg.mla is not None:
        return A.init_mla_cache(cfg, B, S_max, dtype, device=device)
    return A.init_attn_cache(cfg, B, S_max, dtype, kind=kind, device=device)


def _stack(trees):
    if not isinstance(trees[0], dict):
        return torch.stack(trees)
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}


# ----------------------------------------------------------------- init
def _stacked_blocks(generator, cfg, kind, n, kw):
    """``n`` blocks stacked on a new leading axis, drawn one after another
    as ``block_init`` draws them and each copied into its slot as it is
    drawn: a large config holds one block beside the stack, not the
    stack twice."""
    block = block_init(generator, cfg, kind, **kw)
    out = tu.tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), block)
    for u in range(n):
        if u:
            block = block_init(generator, cfg, kind, **kw)
        tu.tree_map(lambda o, b: o[u].copy_(b), out, block)
        del block
    return out


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig, *,
                device=None) -> Params:
    """Random parameters (drawn from ``generator`` where it lives — a CUDA
    generator draws on its card — then moved to ``device``) in the JAX
    package's tree layout; ``device="meta"`` gives the shapes only.
    Matches the JAX init in distribution."""
    cfg.validate()
    _ported_only(cfg)
    kw = dict(device=device, dtype=_param_dtype(cfg))
    D, V = cfg.d_model, cfg.vocab_size
    params: Params = {"embed": embed_init((V, D), generator, **kw),
                      "final_ln": zeros((D,), **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((D, V), generator, **kw)
    if cfg.n_units:
        params["units"] = {
            f"b{i}": _stacked_blocks(generator, cfg, kind, cfg.n_units, kw)
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
    tree layout: ``{"units": {"b{i}": {"k", "v"} (MLA: {"ckv", "krope"};
    a recurrent block: its state) stacked over n_units}, "rem": {"b{i}":
    ...}}``."""
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
    _ported_only(cfg)
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
    _ported_only(cfg)
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
    (an int). Writes the token's k/v (a recurrent block's new state) into
    ``cache`` in place; returns (logits (B,V) f32, cache)."""
    _ported_only(cfg)
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
                    {n: t[u] for n, t in c.items()}, ctx=ctx)
    for i, kind in enumerate(cfg.rem_kinds):
        h, _ = block_apply_decode(params["rem"][f"b{i}"], cfg, kind, h, pos,
                                  cache["rem"][f"b{i}"], ctx=ctx)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], cache


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=None, *,
               device=None) -> Params:
    """Zero decode caches in the JAX tree layout (``prefill``'s)."""
    _ported_only(cfg)
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
