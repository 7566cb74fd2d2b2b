"""Config-driven transformer stack (the JAX package's
``models/transformer.py``).

Layers are organized as *pattern units* (the repeating layer group):
parameters of each unit position are stacked over a leading ``n_units``
axis (``params["units"]["b{i}"]``), as in the JAX package, so NetChange
depth transforms are slices/concats of that axis and a JAX-initialised
tree crosses over leaf for leaf. The stack is traversed with a Python
loop over the unit axis where JAX uses ``lax.scan``. Layers that don't
fill a whole unit live unstacked under ``params["rem"]``.

Block kinds: attention blocks ("global", "local") — GQA or MLA
attention, with a dense MLP or a MoE FFN (``models/moe.py``) — whisper's
decoder block ("crossdec": causal self-attention, then cross-attention
onto the encoder's output, then the MLP), and the recurrent blocks
("rglru" with its MLP, "mlstm", "slstm"; ``models/ssm.py``), for
training and for serving (prefill builds the decode cache in the JAX
tree layout: ``{"k", "v"}`` a layer, a "crossdec" layer's cross kv
``{"xk", "xv"}`` beside them, MLA's latent ``{"ckv", "krope"}``, a
recurrent block's state; decode writes each new token, or the new
state, into it in place and only reads the cross kv).

Front ends (``aux``, precomputed embeddings, as in the reference): the
vision front end's patch embeddings (B, n_prefix, D) go ahead of the
token embeddings; the whisper encoder (``encode``: bidirectional
self-attention with RoPE and RMSNorm, the reference's backbone
deviation) runs over frame embeddings (B, n_ctx, D), and its output
feeds every "crossdec" layer.

Under a ``ShardCtx`` with a model axis of m > 1 ranks (tensor
parallelism; the tree cut by ``sharding.rules.tp_slice``) every block
kind runs the rank's part: the embedding vocab-parallel (a vision
prefix's ``aux`` rows go ahead of the summed token rows), the logits the
rank's vocabulary columns, attention, MLA, cross-attention and the
encoder the rank's heads, the recurrent blocks its channels or heads,
the caches its part (``sharding.rules.tp_cache_slice``), and
``seq_parallel`` splits the residual stream's rows between blocks
(``_sp_boundary``, the encoder's too).

Under data axes of d > 1 ranks (FSDP) the batch is the rank's rows and
each leaf its data part of its model part (``tp_slice``): a unit's
leaves are gathered whole over the data axes where the unit is taken
(``_dp``: a stacked unit of the decoder or the encoder, a remainder
block, the embedding, the output projection, the final norms), so the
blocks run the rank's model part as above. Under ``ctx.remat`` the
gather is inside the checkpointed unit: the backward gathers the unit
again instead of keeping it. A decode batch the data axes do not split
(``ctx.batch_whole``, ``sharding.rules.batch_ctx``) is whole on every
data rank, its attention caches the rank's block of slots
(``models/attention.py``): ``init_cache`` sizes them, and
``decode_step`` is given the whole cache's length (``cache_len``) to
find each layer's block.

  init_params(generator, cfg, device=)     -> params
  forward(params, cfg, tokens, ctx=, aux=) -> logits (B,S,V) f32
  forward_hidden(params, cfg, tokens, ctx=, aux=) -> final-norm hidden
  prefill(params, cfg, tokens, ctx=, aux=, cache_len=) -> (last logits (B,V), cache)
  decode_step(params, cfg, token, cache, pos, ctx=, cache_len=) -> (logits (B,V), cache)
  init_cache(cfg, B, S_max, dtype=, device=, ctx=) -> cache
  encode(enc_params, cfg, frames, ctx=)    -> encoder output (B,n_ctx,D)
  vision_prefix(cfg), aux_shape(cfg, B)    -> the front end's rows, aux shape
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import layers as L
from repro_torch.models.layers import (embed_init, dense_init,
                                       mlp_apply, mlp_init, rms_norm, zeros)
from repro_torch.sharding.collectives import (copy_to_model, dp_active,
                                              dp_enter, gather_seq,
                                              reduce_from_model, sp_active,
                                              split_seq, tp_active, tp_held)
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx
from repro_torch.sharding.rules import (batch_ctx, cache_rows, fsdp_dims,
                                        head_plan)

Params = Dict[str, Any]

_KINDS = ("global", "local", "crossdec", "rglru", "mlstm", "slstm")


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------- block init
def block_init(generator, cfg: ModelConfig, kind: str, *, device=None,
               dtype=torch.float32) -> Params:
    """One block's parameters; ``device="meta"`` gives shapes only."""
    if kind not in _KINDS:
        raise ValueError(kind)
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
    if kind == "crossdec":
        p["lnx"] = zeros((D,), **kw)
        p["xattn"] = A.cross_attn_init(generator, cfg, **kw)
    if cfg.moe is not None:
        p["moe"] = M.moe_init(generator, cfg, **kw)
    else:
        p["mlp"] = mlp_init(generator, cfg, D, cfg.d_ff, **kw)
    return p


def _dp(tree, prefix, cfg, ctx):
    """FSDP: ``tree``, the leaves at path ``prefix`` of the parameter tree
    (a unit, a block, a leaf), gathered whole over the data axes
    (``sharding.collectives.dp_enter``); unchanged without data axes of
    more than one rank."""
    if not dp_active(ctx):
        return tree
    return dp_enter(tree, fsdp_dims(cfg, ctx), ctx, prefix)


def _ffn(p, cfg, x, ctx):
    if cfg.moe is not None:
        return M.moe_apply(p["moe"], cfg, x, ctx)
    return mlp_apply(p["mlp"], x, cfg.mlp_kind, ctx, d_ff=cfg.d_ff)


def _seq_ctx(ctx, S: int):
    """``ctx`` with ``seq_parallel`` kept only where it applies: a model
    axis of m > 1 ranks that divides the sequence length (the reference's
    ``_sp_boundary`` leaves other lengths whole, decode steps among
    them)."""
    if ctx.seq_parallel and not (tp_active(ctx)
                                 and S % ctx.model_size == 0):
        return dataclasses.replace(ctx, seq_parallel=False)
    return ctx


def _sp_boundary(x, positions, ctx):
    """Sequence-parallel residual boundary (the reference's): under
    ``seq_parallel`` a whole residual stream is cut to the rank's S/m
    rows (``_SplitSeq``), and stays so between blocks. A block's mixer
    and FFN gather it whole (``tp_enter``) and hand back the rank's rows
    of their summed output (``tp_leave``): Megatron's reduce-scatter /
    all-gather in place of the row-parallel ``all_reduce``.
    ``_traverse_seq`` gathers the rows back after the last block."""
    if sp_active(ctx) and x.shape[1] == positions.shape[0]:
        return split_seq(x, ctx)
    return x


def _norm_scale(scale, ctx):
    """A block norm's scale under sequence parallelism reads the rank's
    rows only: its gradient is the sum of the ranks'."""
    return copy_to_model(scale, ctx) if sp_active(ctx) else scale


def block_apply_seq(p, cfg, kind, x, positions, *, ctx, return_cache=False,
                    cache_len=None, enc_out=None):
    """Full-sequence pre-norm block: x + attn(norm x) (or the recurrent
    mixer), a "crossdec" block then + cross-attn(norm x) onto
    ``enc_out``, then + mlp. Returns (x, cache|None); a recurrent block's
    cache is its state after the last position, a "crossdec" block's
    holds the cross kv as ``xk``, ``xv``. Under sequence parallelism
    (``_sp_boundary``) x comes back as the rank's rows."""
    x = _sp_boundary(x, positions, ctx)
    h = rms_norm(x, _norm_scale(p["ln1"], ctx), cfg.norm_eps)
    if kind == "rglru":
        y, st = SSM.rglru_seq(p["rg"], h, None, return_state=return_cache,
                              ctx=ctx)
        x = x + y
        h2 = rms_norm(x, _norm_scale(p["ln2"], ctx), cfg.norm_eps)
        return x + _ffn(p, cfg, h2, ctx), st
    if kind == "mlstm":
        y, st = SSM.mlstm_seq(p["mx"], cfg, h, None,
                              return_state=return_cache, ctx=ctx)
        return x + y, st
    if kind == "slstm":
        y, st = SSM.slstm_seq(p["sx"], cfg, h, None,
                              return_state=return_cache, ctx=ctx)
        return x + y, st
    if cfg.mla is not None:
        y, cache = A.mla_apply_seq(p["attn"], cfg, h, positions, ctx=ctx,
                                   return_cache=return_cache,
                                   cache_len=cache_len)
    else:
        y, cache = A.attn_apply_seq(p["attn"], cfg, h, positions,
                                    kind=_self_kind(kind), ctx=ctx,
                                    return_cache=return_cache,
                                    cache_len=cache_len)
    x = x + y
    if kind == "crossdec":
        hx = rms_norm(x, _norm_scale(p["lnx"], ctx), cfg.norm_eps)
        ckv = A.cross_kv(p["xattn"], cfg, enc_out, ctx)
        x = x + A.cross_attn_apply(p["xattn"], cfg, hx, ckv, ctx=ctx)
        if return_cache:
            cache = dict(cache, xk=ckv["k"], xv=ckv["v"])
    h2 = rms_norm(x, _norm_scale(p["ln2"], ctx), cfg.norm_eps)
    return x + _ffn(p, cfg, h2, ctx), cache


def _self_kind(kind: str) -> str:
    """A "crossdec" block's self-attention is a global layer's."""
    return "global" if kind == "crossdec" else kind


def block_apply_decode(p, cfg, kind, x, pos, cache, *, ctx,
                       cache_len=None):
    """One-token block step; the block's cache (an attention block's
    k/v, a recurrent block's state) is written in place; a "crossdec"
    block reads its cross kv (``xk``, ``xv``) as it is. ``cache_len``:
    the whole cache's length, which a sequence-split cache needs
    (``decode_step``). Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("rglru", "mlstm", "slstm"):
        if kind == "rglru":
            y, st = SSM.rglru_decode(p["rg"], h, cache, ctx)
        elif kind == "mlstm":
            y, st = SSM.mlstm_decode(p["mx"], cfg, h, cache, ctx)
        else:
            y, st = SSM.slstm_decode(p["sx"], cfg, h, cache, ctx)
        for n, t in st.items():
            cache[n].copy_(t)
        x = x + y
        if kind != "rglru":
            return x, cache
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + _ffn(p, cfg, h2, ctx), cache
    if cfg.mla is not None:
        y, cache = A.mla_apply_decode(p["attn"], cfg, h, pos, cache, ctx=ctx,
                                      cache_len=cache_len)
    else:
        # the self k/v are written in place; the cross kv stay as they are
        y, _ = A.attn_apply_decode(p["attn"], cfg, h, pos, cache,
                                   kind=_self_kind(kind), ctx=ctx,
                                   cache_len=cache_len)
    x = x + y
    if kind == "crossdec":
        hx = rms_norm(x, p["lnx"], cfg.norm_eps)
        ckv = {"k": cache["xk"], "v": cache["xv"]}
        x = x + A.cross_attn_apply(p["xattn"], cfg, hx, ckv, ctx=ctx)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(p, cfg, h2, ctx), cache


def _block_cache_init(cfg, kind, B, S_max, dtype, device=None,
                      ctx: ShardCtx = CPU_CTX):
    """One block's zero cache for ``ctx``'s rank: its part on a model
    axis (its kv heads, recurrent channels or heads; ``sharding.rules``),
    its block of the attention caches' slots under ``ctx.batch_whole``."""
    m, rank = ctx.model_size, ctx.model_rank
    if kind == "rglru":
        return SSM.init_rglru_state(cfg, B, dtype, device=device,
                                    model_size=m)
    if kind == "mlstm":
        return SSM.init_mlstm_state(cfg, B, dtype, device=device,
                                    model_size=m)
    if kind == "slstm":
        return SSM.init_slstm_state(cfg, B, dtype, device=device,
                                    model_size=m)
    if cfg.mla is not None:
        return A.init_mla_cache(cfg, B, S_max, dtype, device=device, ctx=ctx)
    c = A.init_attn_cache(cfg, B, S_max, dtype, kind=_self_kind(kind),
                          device=device,
                          heads=head_plan(cfg.n_heads, cfg.n_kv_heads, m,
                                          rank), ctx=ctx)
    if kind == "crossdec":
        nx = head_plan(cfg.n_heads, cfg.n_heads, m, rank).nq
        shape = (B, cfg.encoder.n_ctx, nx, cfg.resolved_head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def _stack(trees):
    if not isinstance(trees[0], dict):
        return torch.stack(trees)
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}


# ----------------------------------------------------------- whisper encoder
def _enc_block_init(generator, cfg, *, device=None, dtype=torch.float32):
    D = cfg.encoder.d_model
    kw = dict(device=device, dtype=dtype)
    return {"ln1": zeros((D,), **kw),
            "attn": A.attn_init(generator, cfg, **kw),
            "ln2": zeros((D,), **kw),
            "mlp": mlp_init(generator, cfg, D, cfg.d_ff, **kw)}


def _enc_block_apply(p, cfg, x, positions, *, ctx):
    """One encoder block: bidirectional self-attention, then the MLP, as
    a decoder block's (under a model axis the rank's heads and d_ff;
    under sequence parallelism ``x`` the rank's rows)."""
    x = _sp_boundary(x, positions, ctx)
    h = rms_norm(x, _norm_scale(p["ln1"], ctx), cfg.norm_eps)
    y, _ = A.attn_apply_seq(p["attn"], cfg, h, positions, ctx=ctx,
                            causal=False)
    x = x + y
    h2 = rms_norm(x, _norm_scale(p["ln2"], ctx), cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_kind, ctx, d_ff=cfg.d_ff)


def encode(params, cfg: ModelConfig, frames, *, ctx: ShardCtx = CPU_CTX):
    """The whisper encoder over frame embeddings (B, n_ctx, D): the
    stacked encoder units in order (a loop where the reference scans),
    then the final norm. ``params`` is ``params["encoder"]``. Under
    sequence parallelism the frames' rows are split between blocks and
    gathered whole after the last."""
    x = frames
    positions = torch.arange(frames.shape[1], device=frames.device)
    ctx = _seq_ctx(ctx, frames.shape[1])
    for unit in _unbind(params["units"]):
        unit = _dp(unit, ("encoder", "units"), cfg, ctx)
        x = _enc_block_apply(unit, cfg, x, positions, ctx=ctx)
    if sp_active(ctx) and x.shape[1] != positions.shape[0]:
        x = gather_seq(x, ctx)
    scale = _dp(params["final_ln"], ("encoder", "final_ln"), cfg, ctx)
    return rms_norm(x, scale, cfg.norm_eps)


def _encoder_out(params, cfg, aux, ctx):
    """The encoder's output for a config with an encoder, else None. The
    frames come as ``aux``; the federated batches carry tokens and labels
    only, so a cohort of an encoder config has none to give."""
    if cfg.encoder is None:
        return None
    if aux is None:
        raise ValueError(
            f"{cfg.name}: the whisper encoder needs its frames: pass aux "
            f"(batch['aux']), frame embeddings of shape (B, "
            f"{cfg.encoder.n_ctx}, {cfg.encoder.d_model}); token batches "
            f"(tokens, labels) carry none")
    return encode(params["encoder"], cfg, aux, ctx=ctx)


# ----------------------------------------------------------------- init
def _stacked_blocks(init, n):
    """``n`` blocks stacked on a new leading axis, drawn one after another
    by ``init()`` and each copied into its slot as it is drawn: a large
    config holds one block beside the stack, not the stack twice."""
    block = init()
    out = tu.tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), block)
    for u in range(n):
        if u:
            block = init()
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
    kw = dict(device=device, dtype=_param_dtype(cfg))
    D, V = cfg.d_model, cfg.vocab_size
    params: Params = {"embed": embed_init((V, D), generator, **kw),
                      "final_ln": zeros((D,), **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((D, V), generator, **kw)
    if cfg.n_units:
        params["units"] = {
            f"b{i}": _stacked_blocks(
                lambda: block_init(generator, cfg, kind, **kw), cfg.n_units)
            for i, kind in enumerate(cfg.layer_pattern)}
    rem = {f"b{i}": block_init(generator, cfg, kind, **kw)
           for i, kind in enumerate(cfg.rem_kinds)}
    if rem:
        params["rem"] = rem
    if cfg.encoder is not None:
        units = _stacked_blocks(lambda: _enc_block_init(generator, cfg, **kw),
                                cfg.encoder.n_layers)
        params["encoder"] = {"units": units, "final_ln": zeros((D,), **kw)}
    return params


# ------------------------------------------------------------- embeddings
def vision_prefix(cfg: ModelConfig) -> int:
    """Rows the vision front end puts ahead of the text (0 without one)."""
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        return cfg.frontend.n_prefix
    return 0


def aux_shape(cfg: ModelConfig, batch: int):
    """The shape of the ``aux`` a config takes: patch embeddings (B,
    n_prefix, D), or the encoder's frames (B, n_ctx, D); None without a
    front end that takes one."""
    if cfg.encoder is not None:
        return (batch, cfg.encoder.n_ctx, cfg.encoder.d_model)
    if vision_prefix(cfg):
        return (batch, vision_prefix(cfg), cfg.d_model)
    return None


def _embed(params, cfg, tokens, aux=None, ctx: ShardCtx = CPU_CTX):
    """Token embeddings; with the vision front end and ``aux`` given, the
    patch embeddings (B, n_prefix, D) go ahead of them. Vocab-parallel
    when the embedding holds this rank's rows of the vocabulary: ids
    outside them read zero and the ranks' rows are summed
    (``_ReduceFromModel``); ``embed_scale`` applies after the sum."""
    E = _dp(params["embed"], ("embed",), cfg, ctx)
    dt = _param_dtype(cfg)
    if tp_active(ctx) and tp_held(ctx, cfg.vocab_size, E.shape[0]):
        Vl = E.shape[0]
        local = tokens.long() - ctx.model_rank * Vl
        mine = (local >= 0) & (local < Vl)
        h = E[local.clamp(0, Vl - 1)].to(dt)
        h = torch.where(mine[..., None], h, torch.zeros_like(h))
        h = reduce_from_model(h, ctx)
    else:
        h = E[tokens.long()].to(dt)
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    if vision_prefix(cfg) and aux is not None:
        h = torch.cat([aux.to(h.dtype), h], dim=1)
    return h


def logits_weight(params, cfg, ctx: ShardCtx = CPU_CTX):
    """The (D, V) output projection: ``embed``ᵀ when tied, ``lm_head``
    (under FSDP gathered whole over the data axes)."""
    if cfg.tie_embeddings:
        return _dp(params["embed"], ("embed",), cfg, ctx).T
    return _dp(params["lm_head"], ("lm_head",), cfg, ctx)


def vocab_lo(params, cfg, ctx) -> Optional[int]:
    """The first vocabulary id of this rank's logits columns when they are
    vocab-parallel (the output projection holds the rank's 1/m of the
    vocabulary), else None (whole logits)."""
    held = (params["embed"].shape[0] if cfg.tie_embeddings
            else params["lm_head"].shape[-1])
    if tp_active(ctx) and tp_held(ctx, cfg.vocab_size, held):
        return ctx.model_rank * held
    return None


def _logits(params, cfg, h, fp32=True, ctx: ShardCtx = CPU_CTX):
    """Logits of ``h``: column-parallel (the rank's vocabulary columns,
    from ``vocab_lo``; ``h``'s gradient summed over the ranks) when the
    output projection is vocab-split, tied or not."""
    w = logits_weight(params, cfg, ctx)
    if vocab_lo(params, cfg, ctx) is not None:
        h = copy_to_model(h, ctx)
    out = h @ w
    return out.float() if fp32 else out


# ------------------------------------------------------------ seq traversal
class _Remat(torch.autograd.Function):
    """One checkpointed unit: ``body(positions, *tensors) -> h``. The
    forward runs the body without recording a graph and saves its inputs
    (the positions, the unit's parameter leaves, ``h`` and the encoder
    output); the backward runs the body again under ``torch.func.vjp``
    and pulls the cotangent through it. Every tensor the body reads is an
    input (a tensor captured by the closure breaks the generated vmap
    rule). ``setup_context`` and the generated vmap rule make it compose
    with ``torch.func.grad`` and ``vmap(grad)``, which
    ``torch.utils.checkpoint`` does not.

    ``policy`` "full" recomputes everything. "dots" (the reference's
    ``dots_with_no_batch_dims_saveable``) also keeps the outputs of the
    unit's batch-free products (``layers.dot``): the forward records them
    on a tape and returns them as non-differentiable outputs, which
    functorch saves as it saves inputs, and the recompute reads them back
    in order. The products with a batch dimension (attention's q·kᵀ and
    p·v, so the attention kernels run again; the MoE expert products)
    are recomputed under both."""
    generate_vmap_rule = True

    @staticmethod
    def forward(body, policy, positions, *tensors):
        tape = L.dot_tape("save" if policy == "dots" else "forward")
        try:
            h = body(positions, *tensors)
        finally:
            saved = L.end_tape(tape)
        return (h, *saved) if policy == "dots" else (h,)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body, ctx.policy = inputs[0], inputs[1]
        ctx.n_in = len(inputs) - 2
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(*inputs[2:], *output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        saved = ctx.saved_tensors
        positions, *tensors = saved[:ctx.n_in]
        tape = L.dot_tape("replay" if ctx.policy == "dots" else "recompute",
                          saved[ctx.n_in:])
        try:
            with torch.enable_grad():
                _, pull = torch.func.vjp(
                    lambda *t: ctx.body(positions, *t), *tensors)
        finally:
            L.end_tape(tape)
        # first order only: the pull records no graph of its own and frees
        # the recompute's as it goes. ``torch.func.grad`` differentiates
        # with ``create_graph=True``; a recorded pull would keep every
        # unit's recomputed activations to the end of the backward, as
        # the plain traversal keeps its own, and save nothing
        with torch.no_grad():
            grads = pull(g, retain_graph=False)
        return (None, None, None) + tuple(grads)


def _unit_remat(unit_ps, cfg, h, positions, *, ctx, enc_out):
    """One pattern unit (its blocks in order) as one ``_Remat`` call over
    the unit's flattened parameter leaves, ``h`` and ``enc_out``, under
    ``ctx.remat_policy``."""
    flat = tu.flatten(unit_ps)
    paths, n = [p for p, _ in flat], len(flat)

    def body(pos, *tensors):
        # the unit's data parts gathered inside the checkpoint (FSDP): the
        # backward gathers them again rather than keeping them
        ps = _dp(tu.unflatten(paths, tensors[:n]), ("units",), cfg, ctx)
        hh, enc = tensors[n], (tensors[n + 1] if len(tensors) > n + 1
                               else None)
        for i, kind in enumerate(cfg.layer_pattern):
            hh, _ = block_apply_seq(ps[f"b{i}"], cfg, kind, hh, pos,
                                    ctx=ctx, enc_out=enc)
        return hh
    extra = () if enc_out is None else (enc_out,)
    return _Remat.apply(body, ctx.remat_policy, positions,
                        *[v for _, v in flat], h, *extra)[0]


def _traverse_seq(params, cfg, h, positions, *, ctx, return_cache=False,
                  cache_len=None, enc_out=None):
    """The stacked units in order (a loop over the unit axis), then the
    unstacked remainder. Returns (h, caches|None), the caches in the JAX
    tree layout: ``{"units": {"b{i}": {"k", "v"} ("crossdec": also {"xk",
    "xv"}; MLA: {"ckv", "krope"}; a recurrent block: its state) stacked
    over n_units}, "rem": {"b{i}": ...}}``. ``ctx.remat`` checkpoints
    each unit (``_unit_remat``) where the reference's ``jax.checkpoint``
    wraps its scan body; a cache-building pass (prefill) computes what
    the plain traversal computes. Under sequence parallelism the first
    block cuts ``h`` to the rank's rows (``_sp_boundary``) and they are
    gathered whole after the last."""
    ctx = _seq_ctx(ctx, h.shape[1])
    kw = dict(ctx=ctx, return_cache=return_cache, cache_len=cache_len,
              enc_out=enc_out)
    cache = {}
    if cfg.n_units:
        units = [_unbind(params["units"][f"b{i}"])
                 for i in range(cfg.pattern_len)]
        per_unit = [[] for _ in range(cfg.pattern_len)]
        for u in range(cfg.n_units):
            if ctx.remat and not return_cache:
                h = _unit_remat({f"b{i}": units[i][u]
                                 for i in range(cfg.pattern_len)}, cfg, h,
                                positions, ctx=ctx, enc_out=enc_out)
                continue
            unit = _dp({f"b{i}": units[i][u]
                        for i in range(cfg.pattern_len)}, ("units",), cfg,
                       ctx)
            for i, kind in enumerate(cfg.layer_pattern):
                h, c = block_apply_seq(unit[f"b{i}"], cfg, kind, h,
                                       positions, **kw)
                per_unit[i].append(c)
        if return_cache:
            cache["units"] = {f"b{i}": _stack(cs)
                              for i, cs in enumerate(per_unit)}
    rem = {}
    for i, kind in enumerate(cfg.rem_kinds):
        block = _dp(params["rem"][f"b{i}"], ("rem", f"b{i}"), cfg, ctx)
        h, rem[f"b{i}"] = block_apply_seq(block, cfg, kind, h, positions,
                                          **kw)
    if sp_active(ctx) and h.shape[1] != positions.shape[0]:
        h = gather_seq(h, ctx)
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
                   ctx: ShardCtx = CPU_CTX, aux=None):
    """Final-norm hidden states (B, S_total, D): S_total counts a vision
    prefix's rows ahead of the text's."""
    h = _embed(params, cfg, tokens, aux, ctx)
    positions = torch.arange(h.shape[1], device=h.device)
    enc_out = _encoder_out(params, cfg, aux, ctx)
    h, _ = _traverse_seq(params, cfg, h, positions, ctx=ctx,
                         enc_out=enc_out)
    return rms_norm(h, _dp(params["final_ln"], ("final_ln",), cfg, ctx),
                    cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, ctx: ShardCtx = CPU_CTX,
            aux=None, fp32_logits=True):
    """Training forward: logits for every position. tokens: (B, S_text).
    Under a vocab-split model axis the rank's vocabulary columns
    (``vocab_lo``)."""
    h = forward_hidden(params, cfg, tokens, ctx=ctx, aux=aux)
    return _logits(params, cfg, h, fp32_logits, ctx)


def prefill(params, cfg: ModelConfig, tokens, *, ctx: ShardCtx = CPU_CTX,
            aux=None, cache_len: Optional[int] = None):
    """Prefill: returns (last-position logits (B,V) f32, cache); global
    layers' caches hold ``cache_len`` (default S_total) slots, local
    layers' the last ``window`` positions as a ring, "crossdec" layers
    the cross kv of the encoder's output beside them. Under a model axis
    the logits are the rank's vocabulary columns when the vocabulary is
    split (``vocab_lo``) and the caches hold the rank's kv heads."""
    h = _embed(params, cfg, tokens, aux, ctx)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    enc_out = _encoder_out(params, cfg, aux, ctx)
    h, cache = _traverse_seq(params, cfg, h, positions, ctx=ctx,
                             return_cache=True, cache_len=cache_len or S,
                             enc_out=enc_out)
    h = rms_norm(h[:, -1:], _dp(params["final_ln"], ("final_ln",), cfg, ctx),
                 cfg.norm_eps)
    return _logits(params, cfg, h, ctx=ctx)[:, 0], cache


def decode_step(params, cfg: ModelConfig, token, cache, pos: int, *,
                ctx: ShardCtx = CPU_CTX, cache_len: Optional[int] = None):
    """One decode step. token: (B,1) int; pos: the new token's position
    (an int; after a vision prefix it counts the prefix). Writes the
    token's k/v (a recurrent block's new state) into ``cache`` in place;
    returns (logits (B,V) f32, cache); under a model axis as
    ``prefill``'s. Under ``ctx.batch_whole`` ``cache_len`` is the whole
    cache's length (``prefill``'s, ``init_cache``'s ``S_max``): each
    attention layer's block of it is the rank's (``models/attention.py``
    ``cache_slots``); otherwise it is not read."""
    ctx = _seq_ctx(ctx, 1)
    pos = int(pos)
    h = _embed(params, cfg, token, ctx=ctx)
    if cfg.n_units:
        units = [_unbind(params["units"][f"b{i}"])
                 for i in range(cfg.pattern_len)]
        for u in range(cfg.n_units):
            unit = _dp({f"b{i}": units[i][u]
                        for i in range(cfg.pattern_len)}, ("units",), cfg,
                       ctx)
            for i, kind in enumerate(cfg.layer_pattern):
                c = cache["units"][f"b{i}"]
                h, _ = block_apply_decode(
                    unit[f"b{i}"], cfg, kind, h, pos,
                    {n: t[u] for n, t in c.items()}, ctx=ctx,
                    cache_len=cache_len)
    for i, kind in enumerate(cfg.rem_kinds):
        block = _dp(params["rem"][f"b{i}"], ("rem", f"b{i}"), cfg, ctx)
        h, _ = block_apply_decode(block, cfg, kind, h, pos,
                                  cache["rem"][f"b{i}"], ctx=ctx,
                                  cache_len=cache_len)
    h = rms_norm(h, _dp(params["final_ln"], ("final_ln",), cfg, ctx),
                 cfg.norm_eps)
    return _logits(params, cfg, h, ctx=ctx)[:, 0], cache


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=None, *,
               device=None, ctx: ShardCtx = CPU_CTX) -> Params:
    """Zero decode caches in the JAX tree layout (``prefill``'s); under a
    model axis the rank's part (``_block_cache_init``), under data axes
    the rank's rows of the ``B`` (``sharding.rules.cache_rows``) or,
    where they do not split ``B``, every row and the rank's block of
    each attention cache's slots (``sharding.rules.batch_ctx``,
    ``cache_slot_cut``)."""
    dtype = dtype or _param_dtype(cfg)
    ctx = batch_ctx(B, ctx)
    rows = cache_rows(B, ctx)
    B = rows.stop - rows.start
    kw = dict(device=device, ctx=ctx)
    cache: Dict[str, Any] = {}
    if cfg.n_units:
        cache["units"] = {
            f"b{i}": _stack([_block_cache_init(cfg, kind, B, S_max, dtype,
                                               **kw)
                             for _ in range(cfg.n_units)])
            for i, kind in enumerate(cfg.layer_pattern)}
    if cfg.rem_kinds:
        cache["rem"] = {f"b{i}": _block_cache_init(cfg, kind, B, S_max, dtype,
                                                   **kw)
                        for i, kind in enumerate(cfg.rem_kinds)}
    return cache
