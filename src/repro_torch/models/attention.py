"""Attention of the transformer path (the JAX package's
``models/attention.py``): the blockwise pure-PyTorch path, the backend
dispatch ``attend``, decode against a (ring) KV cache, and the GQA layer
for training, prefill (``return_cache``) and decode.

Backends (``ShardCtx.attn_backend``): "auto" runs the hand-written CUDA
kernels on CUDA tensors — flash attention for full sequences, the banded
``swa_prefill`` for sliding-window layers when no gradient is taken
(prefill), ``swa_decode`` for decode — and the plain versions on CPU
tensors (blockwise attention, the einsum ``decode_attention``); "flash"
forces the flash/decode kernels' path (their plain versions on the CPU),
"blockwise" the plain einsums. Caches keep the JAX layout ``(B, S, KV,
hd)``; a local layer's cache is a ring of ``window`` slots (slot = pos %
W), its slots' absolute positions given by ``ring_positions``. Decode
writes the new token's k/v into the cache in place and returns it.

MLA (DeepSeek-V2's multi-head latent attention) runs its full-sequence
attention through ``attend`` at qk head dim ``qk_nope_dim + qk_rope_dim``
(192 at the published widths), v zero-padded to it; its cache is the
latent ``{"ckv", "krope"}`` and its decode plain einsums, the reference's
plain form or, under ``ShardCtx.mla_absorb``, the absorbed one.

Under a ``ShardCtx`` with a model axis (tensor parallelism) a layer
runs the heads its leaves hold (``rank_heads``): its part of
``sharding.rules.head_plan`` under the reference's head layouts, q/k/v
column-parallel, the kernels at the rank's shapes, ``wo`` row-parallel
(``tp_row_matmul``), the caches the rank's kv heads; leaves held whole
run every head on every rank. Cross-attention (H = KV) splits its heads
the same way, the cross kv the rank's heads of the replicated encoder
output; MLA computes its latents whole on every rank (the latent cache
stays whole) and the rank's heads from them.

Cross-attention (whisper's decoder onto the encoder's output) is
non-causal with every position 0, as the reference's: a full sequence
goes through ``attend`` (KV = H, G = 1: the flash kernels on CUDA
tensors), one token through ``attend_decode`` (``swa_decode`` with
window 0 on CUDA tensors) against the read-only cross kv.

Under ``ShardCtx.batch_whole`` (a decode batch the data axes do not
split, ``sharding.rules.batch_ctx``) every data rank runs every row and
each attention cache (``k`` / ``v``, MLA's ``ckv`` / ``krope``) holds
the rank's block of slots (``sharding.rules.seq_block``; a slot count
the data extent does not divide stays whole): the prefill runs whole
and keeps its block, a decode step writes the token's slot on the rank
that holds it, attends over the rank's slots with their log-sum-exp
(``swa_decode``'s on CUDA tensors) and combines the ranks' parts over
the data axes (``sharding.collectives.combine_seq``). The cross kv
stays whole.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import pad_to
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models.layers import (apply_rope, dense_init, dot,
                                       rms_norm, tp_row_matmul, zeros)
from repro_torch.sharding.collectives import (combine_seq, sum_shared,
                                              tp_active, tp_enter, tp_held,
                                              tp_local)
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx
from repro_torch.sharding.rules import (Heads, head_layout,  # noqa: F401
                                        head_plan, seq_block)

NEG_INF = -1e30


def on_card(t: torch.Tensor) -> bool:
    """Where the "auto" backend runs the CUDA kernels: CUDA tensors."""
    return t.device.type == "cuda"


def rank_heads(ctx, H: int, KV: int, nq: int, nk: int) -> Heads:
    """The heads this rank computes of a layer of ``H`` query heads on
    ``KV`` kv heads whose leaves hold ``nq`` query and ``nk`` kv heads:
    every head (one rank, or the leaves held whole: they run whole on
    every rank, no collective) or its part of ``head_plan`` (the leaves
    cut by ``sharding.rules.tp_slice``)."""
    if not tp_active(ctx):
        return Heads("single", H, KV, 0, H, 0, KV)
    if not tp_held(ctx, H, nq):
        return Heads("replicate", H, KV, 0, H, 0, KV)
    heads = head_plan(H, KV, ctx.model_size, ctx.model_rank)
    if (nq, nk) != (heads.nq, heads.nk):
        raise ValueError(f"rank {ctx.model_rank} of {ctx.model_size} "
                         f"({heads.layout}) holds {heads.nq} query and "
                         f"{heads.nk} kv heads; the leaves hold {(nq, nk)}: "
                         f"pass the rank's part (sharding.rules.tp_slice)")
    return heads


def attn_heads(p, cfg, ctx, kv_heads=None) -> Heads:
    """``rank_heads`` of a GQA layer (``kv_heads``: cross-attention's,
    which are its query heads), as its ``wq`` / ``wk`` show."""
    hd = cfg.resolved_head_dim
    return rank_heads(ctx, cfg.n_heads, kv_heads or cfg.n_kv_heads,
                      p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd)


def apply_head_layout_seq(q, k, v, heads: Heads = None):
    """q (B,S,nq,hd) the rank's query heads, k/v (B,S,nk,hd) its kv heads
    -> (q5 (B,S,KV',G',hd), k, v) for ``attend``, by the reference's
    head layouts (``sharding.rules.head_layout``): "kv" (and one rank,
    and "replicate", every head on every rank) group the query heads by
    their kv head (KV' = nk, G' = nq / nk); "expand" repeats each query
    head's kv head to it (KV' = nq, G' = 1), the reference's repeat."""
    B, S, nq, hd = q.shape
    if heads is not None and heads.layout == "expand":
        idx = heads.kv_index()
        return q[:, :, :, None], k[:, :, idx], v[:, :, idx]
    nk = k.shape[2]
    return q.reshape(B, S, nk, nq // nk, hd), k, v


def blockwise_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                        block_q=512, block_kv=512, banded=True,
                        causal_skip=False):
    """Memory-O(block^2) attention. q: (B,Sq,KV,G,hd) (G = query heads per
    kv head); k,v: (B,Sk,KV,hd); q_pos: (Sq,), kv_pos: (Sk,) absolute
    positions (-1 => masked key). Returns (B,Sq,KV*G,hd).

    ``banded`` (window > 0 only) restricts each query block to the
    ~(window+block_q)/block_kv kv blocks it can actually see — assumes
    q_pos/kv_pos are contiguous ascending (true for train/prefill).
    ``causal_skip`` restricts the kv scan of query block i to blocks
    <= i (assumes q and kv are position-aligned, Sq == Sk).
    """
    B, Sq, KV, G, hd = q.shape
    H = KV * G
    Sk = k.shape[1]
    bq, bk = min(block_q, Sq), min(block_kv, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    scale = hd ** -0.5

    qp = pad_to(q, nq * bq, 1) * scale
    qpos_p = pad_to(q_pos, nq * bq, 0, value=-1)
    kp = pad_to(k, nk * bk, 1)
    vp = pad_to(v, nk * bk, 1)
    kpos_p = pad_to(kv_pos, nk * bk, 0, value=-1)
    use_banded = banded and window > 0 and causal

    def inner_step(carry, j0, extra_valid, qi, qpi):
        # one kv block at offset j0 (a block past the ends when not
        # extra_valid); qi (B,bq,KV,G,hd) -> scores (B,KV,G,bq,bk) fp32
        m, l, acc = carry
        kb, vb = kp[:, j0:j0 + bk], vp[:, j0:j0 + bk]
        kpi = kpos_p[j0:j0 + bk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qi, kb).float()
        valid = (kpi >= 0) & extra_valid                  # (bk,)
        mask = valid[None, :].expand(bq, bk)
        if causal:
            mask = mask & (qpi[:, None] >= kpi[None, :])
        if window > 0:
            mask = mask & (qpi[:, None] - kpi[None, :] < window)
        s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype), vb).float()
        acc = acc * corr[..., None] + pv
        return m_new, l, acc

    outs = []
    for i in range(nq):
        qi = qp[:, i * bq:(i + 1) * bq]
        qpi = qpos_p[i * bq:(i + 1) * bq]
        carry = (torch.full((B, KV, G, bq), NEG_INF, dtype=torch.float32,
                            device=q.device),
                 torch.zeros((B, KV, G, bq), dtype=torch.float32,
                             device=q.device),
                 torch.zeros((B, KV, G, bq, hd), dtype=torch.float32,
                             device=q.device))
        if use_banded:
            q_start = i * bq
            span = window + bq - 1
            nrel = -(-span // bk) + 1
            base = ((q_start - window + 1) // bk) * bk
            for j in range(nrel):
                nominal = base + j * bk
                start = min(max(nominal, 0), nk * bk - bk)
                ok = 0 <= nominal < nk * bk
                carry = inner_step(carry, start, ok, qi, qpi)
        else:
            n_blocks = (i + 1 if causal_skip and causal and Sq == Sk
                        and bq == bk else nk)
            for j in range(n_blocks):
                carry = inner_step(carry, j * bk, True, qi, qpi)
        _, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs)                               # (nq,B,KV,G,bq,hd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * bq, H, hd)
    return out[:, :Sq].to(q.dtype)


def attend(q5, k, v, q_pos, kv_pos, *, causal, window, ctx,
           banded=False, causal_skip=False):
    """Backend-selected full-sequence attention: the one entry every
    train call site goes through. ``ctx.attn_backend`` picks the
    implementation — "auto" trains through the flash CUDA kernels on CUDA
    tensors and keeps ``blockwise_attention`` on the CPU; "flash" /
    "blockwise" force a backend (a forced "flash" on CPU tensors runs the
    plain versions through the same autograd Functions).
    ``banded``/``causal_skip`` are blockwise-only scan shortcuts; the
    flash kernels mask natively."""
    backend = getattr(ctx, "attn_backend", "auto")
    if backend == "auto":
        backend = "flash" if on_card(q5) else "blockwise"
    if backend == "flash":
        return flash_attention(q5, k, v, q_pos, kv_pos, causal=causal,
                               window=window, block_q=ctx.block_q,
                               block_kv=ctx.block_kv)
    if backend != "blockwise":
        raise ValueError(f"unknown attn_backend {backend!r}")
    return blockwise_attention(q5, k, v, q_pos, kv_pos, causal=causal,
                               window=window, block_q=ctx.block_q,
                               block_kv=ctx.block_kv, banded=banded,
                               causal_skip=causal_skip)


def decode_attention(q, k_cache, v_cache, key_pos, q_pos, *, window=0,
                     return_lse=False):
    """One-token attention vs a cache, plain einsums. q: (B,H,hd); caches
    (B,Sc,KV,hd); key_pos: (Sc,) absolute positions of cache slots (-1 =
    unwritten); q_pos an int or a 0-d tensor. Returns (B,H,hd) in
    q.dtype; with ``return_lse`` also (B,H) f32, the log-sum-exp of the
    visible slots' scaled scores (-inf where none is visible)."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).float()
    valid = (key_pos >= 0) & (key_pos <= q_pos)
    if window > 0:
        valid = valid & (q_pos - key_pos < window)
    vis = valid[None, None, None, :]
    p = torch.softmax(torch.where(vis, s, torch.full_like(s, NEG_INF)),
                      dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype),
                       v_cache).float()
    out = out.reshape(B, H, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(vis, s, torch.full_like(
        s, float("-inf"))), dim=-1)
    return out, lse.reshape(B, H)


def attend_decode(q, k_cache, v_cache, key_pos, q_pos, *, window, ctx,
                  return_lse=False):
    """Backend-selected decode attention (module docstring): the
    ``swa_decode`` kernel on CUDA tensors under "auto"/"flash", the plain
    ``decode_attention`` otherwise; ``return_lse`` as theirs."""
    backend = getattr(ctx, "attn_backend", "auto")
    if backend == "auto":
        backend = "flash" if on_card(q) else "blockwise"
    if backend == "flash":
        res = swa_ops.decode_attention(q, k_cache, v_cache, key_pos, q_pos,
                                       window=window, return_lse=return_lse)
        if return_lse:
            return res[0].to(q.dtype), res[1]
        return res.to(q.dtype)
    if backend != "blockwise":
        raise ValueError(f"unknown attn_backend {backend!r}")
    return decode_attention(q, k_cache, v_cache, key_pos, q_pos,
                            window=window, return_lse=return_lse)


def ring_positions(pos, size, device=None):
    """Absolute positions held by a ring buffer of ``size`` after writing
    position ``pos`` at slot pos % size. Unwritten slots come out < 0."""
    slots = torch.arange(size, device=device)
    return pos - torch.remainder(pos - slots, size)


# ---------------------------------------------------------------- GQA layer
def attn_init(generator, cfg, *, device=None, dtype=torch.float32):
    D, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": dense_init((D, H * hd), generator, **kw),
        "wk": dense_init((D, KV * hd), generator, **kw),
        "wv": dense_init((D, KV * hd), generator, **kw),
        "wo": dense_init((H * hd, D), generator, fan_in=H * hd, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H * hd,), **kw)
        p["bk"] = zeros((KV * hd,), **kw)
        p["bv"] = zeros((KV * hd,), **kw)
    return p


def _qkv(p, cfg, x, heads: Heads = None, ctx: ShardCtx = CPU_CTX):
    """The projections of the rank's heads (every head without
    ``heads``). Where other ranks hold the rank's kv heads too ("expand"),
    the kv leaves' gradients are summed over them."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nk = ((cfg.n_heads, cfg.n_kv_heads) if heads is None
              else (heads.nq, heads.nk))
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    if heads is not None and heads.shared:
        kv = {n: sum_shared(t, ctx, heads.k0 * hd, heads.KV * hd)
              for n, t in kv.items()}
    q = dot(x, p["wq"])
    k = dot(x, kv["wk"])
    v = dot(x, kv["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + kv["bk"], v + kv["bv"]
    return (q.reshape(B, S, nq, hd), k.reshape(B, S, nk, hd),
            v.reshape(B, S, nk, hd))


def _banded_prefill(q5, k, v, window):
    """Local-layer attention through the ``swa_prefill`` kernel: q5
    (B,S,KV,G,hd) at positions ``arange(S)`` (what train and prefill
    pass) -> (B,S,H,hd) in q5.dtype."""
    B, S, KV, G, hd = q5.shape
    out = swa_ops.swa_prefill(q5.permute(0, 2, 3, 1, 4), k, v, window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, KV * G, hd).to(q5.dtype)


def attn_apply_seq(p, cfg, x, positions, *, kind="global",
                   ctx: ShardCtx = CPU_CTX, return_cache=False,
                   cache_len=None, causal=True):
    """Full-sequence self-attention (train / prefill), causal (global or
    local: sliding ``cfg.window``) or, ``causal=False``, bidirectional
    (the whisper encoder's). positions: (S,), contiguous ascending.
    Returns (y, cache|None); cache k/v are post-RoPE, the rank's kv heads.
    For local layers the prefill cache keeps only the last ``window``
    slots. Under a model axis the rank runs its heads (``attn_heads``):
    column-parallel q/k/v, the kernels at the rank's shapes, ``wo``
    row-parallel (``tp_row_matmul``); under sequence parallelism ``x``
    is the rank's rows and so is ``y``."""
    heads = attn_heads(p, cfg, ctx)
    x = tp_enter(x, ctx, heads.split)
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, heads, ctx)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else 0
    q5a, ka, va = apply_head_layout_seq(q, k, v, heads)
    if (window > 0 and getattr(ctx, "attn_backend", "auto") == "auto"
            and on_card(q) and not torch.is_grad_enabled()):
        out = _banded_prefill(q5a, ka, va, window)
    else:
        out = attend(q5a, ka, va, positions, positions, causal=causal,
                     window=window, ctx=ctx, banded=ctx.banded_local,
                     causal_skip=ctx.causal_skip)
    y = tp_row_matmul(out.reshape(B, S, -1), p["wo"], ctx, heads.split)
    cache = None
    if return_cache:
        cache = _build_cache(k, v, positions, window, cache_len, S, ctx)
    return y, cache


def _build_cache(k, v, positions, window, cache_len, S, ctx):
    """Arrange prefill k/v into the decode cache layout: the rank's block
    of slots (``seq_block``; every slot unless ``ctx.batch_whole``)."""
    if window > 0:
        W = min(window, cache_len or window)
        lo, hi = seq_block(W, ctx)
        # ring layout: slot = pos % W for the last W positions (distinct
        # slots: take <= W), written into the whole ring; the rank keeps
        # its block of slots (no boolean mask: it works on meta tensors)
        take = min(W, k.shape[1])
        slots = torch.remainder(positions[-take:], W).long()
        ring = (k.shape[0], W) + tuple(k.shape[2:])
        ck = k.new_zeros(ring).index_copy_(1, slots, k[:, -take:])
        cv = k.new_zeros(ring).index_copy_(1, slots,
                                           v[:, -take:].to(k.dtype))
        if (lo, hi) != (0, W):
            ck, cv = ck[:, lo:hi].clone(), cv[:, lo:hi].clone()
        return {"k": ck, "v": cv}
    lo, hi = seq_block(cache_len or S, ctx)
    n = max(0, min(S, hi) - lo)
    ck = k.new_zeros((k.shape[0], hi - lo) + tuple(k.shape[2:]))
    cv = torch.zeros_like(ck)
    ck[:, :n] = k[:, lo:lo + n]
    cv[:, :n] = v[:, lo:lo + n]
    return {"k": ck, "v": cv}


def cache_slots(held: int, window: int, cache_len, ctx) -> int:
    """The whole slot count of a decode cache whose leaves hold ``held``
    slots on this rank: ``held`` itself unless ``ctx.batch_whole``, where
    the cache may hold a block of them and ``cache_len`` (the whole
    cache's length, ``prefill``'s) says how many: ``min(window,
    cache_len)`` on a ring, ``cache_len`` else."""
    if not ctx.batch_whole:
        return held
    if cache_len is None:
        raise ValueError("a decode step whose batch is whole on every data "
                         "rank (ShardCtx.batch_whole) needs cache_len: its "
                         "caches may hold a block of their slots")
    L = min(window, cache_len) if window > 0 else cache_len
    lo, hi = seq_block(L, ctx)
    if hi - lo != held:
        raise ValueError(f"the cache holds {held} slots; a rank's block of "
                         f"{L} is {hi - lo}")
    return L


def attn_apply_decode(p, cfg, x, pos: int, cache, *, kind="global",
                      ctx: ShardCtx = CPU_CTX, cache_len=None):
    """One-token decode. x: (B,1,D); pos: the new token's position (an
    int); cache {'k','v'} (the rank's kv heads), written in place at the
    token's slot and returned. Under "expand" with query heads whose kv
    heads are not equal groups, the cache is read repeated to them.
    Under ``ctx.batch_whole`` the cache may hold the rank's block of its
    ``cache_slots`` slots: the rank that holds the token's slot writes
    it, and the rank's attention over its slots is combined over the
    data axes (``combine_seq``)."""
    B = x.shape[0]
    heads = attn_heads(p, cfg, ctx)
    x = tp_enter(x, ctx, heads.split)
    q, k, v = _qkv(p, cfg, x, heads, ctx)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)[:, 0]          # (B,nq,hd)
    k = apply_rope(k, pos_arr, cfg.rope_theta)[:, 0]          # (B,nk,hd)
    v = v[:, 0]
    window = cfg.window if kind == "local" else 0
    ck, cv = cache["k"], cache["v"]
    L = cache_slots(ck.shape[1], window, cache_len, ctx)
    lo, hi = seq_block(L, ctx)
    slot = pos % L if window > 0 else min(pos, L - 1)
    if lo <= slot < hi:
        ck[:, slot - lo] = k
        cv[:, slot - lo] = v
    key_pos = (ring_positions(pos, L, device=x.device) if window > 0
               else torch.arange(L, device=x.device))[lo:hi]
    rk, rv = ck, cv
    if not heads.uniform:
        idx = heads.kv_index()
        rk, rv = ck[:, :, idx], cv[:, :, idx]
    split = hi - lo < L
    out = attend_decode(q, rk, rv, key_pos, pos, window=window, ctx=ctx,
                        return_lse=split)
    if split:
        out = combine_seq(*out, ctx)
    y = tp_row_matmul(out.reshape(B, 1, -1), p["wo"], ctx, heads.split)
    return y, {"k": ck, "v": cv}


def init_attn_cache(cfg, B, S_max, dtype=torch.float32, *, kind="global",
                    device=None, heads: Heads = None,
                    ctx: ShardCtx = CPU_CTX):
    """Zero k and v caches (two tensors: decode writes them in place):
    ``window`` ring slots on local layers, ``S_max`` on global ones (the
    rank's block of them under ``ctx.batch_whole``, ``seq_block``); the
    kv heads of ``heads`` (a rank's part), every kv head without."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if heads is not None:
        KV = heads.nk
    lo, hi = seq_block(min(cfg.window, S_max) if kind == "local" else S_max,
                       ctx)
    return {"k": torch.zeros((B, hi - lo, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((B, hi - lo, KV, hd), dtype=dtype,
                             device=device)}


# --------------------------------------------------------- cross attention
def cross_attn_init(generator, cfg, *, device=None, dtype=torch.float32):
    D, H = cfg.d_model, cfg.n_heads
    hd = cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": dense_init((D, H * hd), generator, **kw),
        "wk": dense_init((D, H * hd), generator, **kw),
        "wv": dense_init((D, H * hd), generator, **kw),
        "wo": dense_init((H * hd, D), generator, fan_in=H * hd, **kw),
    }


def cross_kv(p, cfg, enc_out, ctx: ShardCtx = CPU_CTX):
    """The cross k, v of the encoder's output (B,T,D): (B,T,H,hd) each, the
    rank's heads under a model axis (H = KV: the "kv" layout). The
    encoder's output is replicated: its gradient is the ranks' sum."""
    B, T, _ = enc_out.shape
    heads = attn_heads(p, cfg, ctx, cfg.n_heads)
    enc_out = tp_local(enc_out, ctx, heads.split)
    hd = cfg.resolved_head_dim
    return {"k": dot(enc_out, p["wk"]).reshape(B, T, heads.nk, hd),
            "v": dot(enc_out, p["wv"]).reshape(B, T, heads.nk, hd)}


def cross_attn_apply(p, cfg, x, kv, *, ctx: ShardCtx = CPU_CTX):
    """x (B,S,D) attends to the cross kv (B,T,H,hd) (the rank's heads),
    non-causal, every position 0: S > 1 through ``attend``, S == 1
    through ``attend_decode``; ``wq`` column- and ``wo`` row-parallel
    under a model axis, as self-attention's."""
    heads = attn_heads(p, cfg, ctx, cfg.n_heads)
    x = tp_enter(x, ctx, heads.split)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dot(x, p["wq"]).reshape(B, S, heads.nq, hd)
    T = kv["k"].shape[1]
    kpos = torch.zeros((T,), dtype=torch.int32, device=x.device)
    if S == 1:
        out = attend_decode(q[:, 0], kv["k"], kv["v"], kpos, 0, window=0,
                            ctx=ctx)[:, None]
    else:
        qpos = torch.zeros((S,), dtype=torch.int32, device=x.device)
        q5, k5, v5 = apply_head_layout_seq(q, kv["k"], kv["v"])
        out = attend(q5, k5, v5, qpos, kpos, causal=False, window=0, ctx=ctx)
    return tp_row_matmul(out.reshape(B, S, -1), p["wo"], ctx, heads.split)


# ------------------------------------------------------------------- MLA
def mla_init(generator, cfg, *, device=None, dtype=torch.float32):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "wq_a": dense_init((D, m.q_lora_rank), generator, **kw),
        "qln": zeros((m.q_lora_rank,), **kw),
        "wq_b": dense_init((m.q_lora_rank, H * qk), generator, **kw),
        "wkv_a": dense_init((D, m.kv_lora_rank + m.qk_rope_dim), generator,
                            **kw),
        "kvln": zeros((m.kv_lora_rank,), **kw),
        "wkv_b": dense_init((m.kv_lora_rank,
                             H * (m.qk_nope_dim + m.v_head_dim)), generator,
                            **kw),
        "wo": dense_init((H * m.v_head_dim, D), generator,
                         fan_in=H * m.v_head_dim, **kw),
    }


def mla_heads(p, cfg, ctx) -> Heads:
    """``rank_heads`` of an MLA layer (H = KV), as its ``wq_b`` shows."""
    m = cfg.mla
    n = p["wq_b"].shape[-1] // (m.qk_nope_dim + m.qk_rope_dim)
    return rank_heads(ctx, cfg.n_heads, cfg.n_heads, n, n)



def _mla_q(p, cfg, x, positions, heads: Heads, ctx):
    """The rank's heads' queries: the latent ``cq`` whole on every rank
    (``wq_a`` and the norm over it are whole), then its heads' columns of
    ``wq_b``."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rms_norm(dot(x, p["wq_a"]), p["qln"], cfg.norm_eps)
    q = dot(tp_local(cq, ctx, heads.split), p["wq_b"]).reshape(
        B, S, heads.nq, m.qk_nope_dim + m.qk_rope_dim)
    qn, qr = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _mla_ckv(p, cfg, x, positions):
    m = cfg.mla
    kv = dot(x, p["wkv_a"])
    ckv = rms_norm(kv[..., :m.kv_lora_rank], p["kvln"], cfg.norm_eps)
    krope = kv[..., m.kv_lora_rank:][:, :, None, :]           # 1 shared head
    krope = apply_rope(krope, positions, cfg.rope_theta)[:, :, 0]
    return ckv, krope


def mla_apply_seq(p, cfg, x, positions, *, ctx: ShardCtx = CPU_CTX,
                  return_cache=False, cache_len=None):
    """Full-sequence causal MLA (train / prefill): q and k at qk dim
    ``qk_nope_dim + qk_rope_dim`` (the rope half of k one head broadcast
    to all), v zero-padded to it, through ``attend`` (KV = H, G = 1).
    Returns (y, cache|None); the cache is the latent ``{"ckv", "krope"}``
    of ``cache_len`` (default S) slots. Under a model axis the latents
    are computed whole on every rank (the cache holds them whole, as the
    plan's), the rank's heads from them (``mla_heads``), ``wo``
    row-parallel; under sequence parallelism ``x`` and ``y`` are the
    rank's rows."""
    m = cfg.mla
    heads = mla_heads(p, cfg, ctx)
    x = tp_enter(x, ctx, False)
    B, S, _ = x.shape
    H = heads.nq
    qn, qr = _mla_q(p, cfg, x, positions, heads, ctx)
    ckv, krope = _mla_ckv(p, cfg, x, positions)
    kv = dot(tp_local(ckv, ctx, heads.split), p["wkv_b"]).reshape(
        B, S, H, m.qk_nope_dim + m.v_head_dim)
    kn, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    kr = tp_local(krope, ctx, heads.split)
    q = torch.cat([qn, qr], -1)
    k = torch.cat([kn, kr[:, :, None].expand(B, S, H, m.qk_rope_dim)], -1)
    vp = pad_to(v, q.shape[-1], -1)                 # pad v to the qk dim
    q5, k, vp = apply_head_layout_seq(q, k, vp)     # (B,S,H,1,qk)
    out = attend(q5, k, vp, positions, positions, causal=True, window=0,
                 ctx=ctx, causal_skip=ctx.causal_skip)
    out = out[..., :m.v_head_dim]
    y = tp_row_matmul(out.reshape(B, S, -1), p["wo"], ctx, heads.split)
    cache = None
    if return_cache:
        lo, hi = seq_block(cache_len or S, ctx)
        n = max(0, min(S, hi) - lo)
        c1 = ckv.new_zeros((B, hi - lo, m.kv_lora_rank))
        c2 = krope.new_zeros((B, hi - lo, m.qk_rope_dim))
        c1[:, :n] = ckv[:, lo:lo + n]
        c2[:, :n] = krope[:, lo:lo + n]
        cache = {"ckv": c1, "krope": c2}
    return y, cache


def mla_apply_decode(p, cfg, x, pos: int, cache, *,
                     ctx: ShardCtx = CPU_CTX, cache_len=None):
    """One-token MLA decode against the latent cache, written in place at
    ``pos`` and returned. Plain einsums: the reference's default form
    builds k and v over the whole cache; ``ctx.mla_absorb`` folds
    ``wkv_b`` into q and the output instead (scores in the latent
    space). Under a model axis both run the rank's heads on the whole
    latent cache; ``wo`` row-parallel. Under ``ctx.batch_whole`` the
    cache may hold the rank's block of slots (``attn_apply_decode``):
    both forms then attend over it and combine over the data axes by
    ``torch.logsumexp`` of the masked scores (``combine_seq``)."""
    m = cfg.mla
    B = x.shape[0]
    heads = mla_heads(p, cfg, ctx)
    H = heads.nq
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    qn, qr = _mla_q(p, cfg, x, pos_arr, heads, ctx)           # (B,1,H,*)
    qn, qr = qn[:, 0], qr[:, 0]
    ckv1, krope1 = _mla_ckv(p, cfg, x, pos_arr)
    ckv, krope = cache["ckv"], cache["krope"]
    L = cache_slots(ckv.shape[1], 0, cache_len, ctx)
    lo, hi = seq_block(L, ctx)
    slot = min(pos, L - 1)
    if lo <= slot < hi:
        ckv[:, slot - lo] = ckv1[:, 0]
        krope[:, slot - lo] = krope1[:, 0]
    valid = torch.arange(lo, hi, device=x.device) <= pos
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H,
                               m.qk_nope_dim + m.v_head_dim)
    wk, wv = wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    if ctx.mla_absorb:
        q_abs = torch.einsum("bhn,rhn->bhr", qn, wk)           # (B,H,r)
        s = (torch.einsum("bhr,bsr->bhs", q_abs, ckv).float()
             + torch.einsum("bhe,bse->bhs", qr, krope).float()) * scale
        s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=-1)
        lat = torch.einsum("bhs,bsr->bhr", pr.to(ckv.dtype), ckv)
        out = torch.einsum("bhr,rhv->bhv", lat, wv)
    else:
        kv = torch.einsum("bsr,rhx->bshx", ckv, wkv_b)
        kn, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
        s = (torch.einsum("bhn,bshn->bhs", qn, kn).float()
             + torch.einsum("bhe,bse->bhs", qr, krope).float()) * scale
        s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=-1)
        out = torch.einsum("bhs,bshv->bhv", pr.to(v.dtype), v)
    if hi - lo < L:
        out = combine_seq(out, torch.logsumexp(s, dim=-1), ctx)
    y = tp_row_matmul(out.reshape(B, 1, -1), p["wo"], ctx, heads.split)
    return y, {"ckv": ckv, "krope": krope}


def init_mla_cache(cfg, B, S_max, dtype=torch.float32, *, device=None,
                   ctx: ShardCtx = CPU_CTX):
    """Zero latent caches (decode writes them in place): the rank's block
    of the ``S_max`` slots under ``ctx.batch_whole`` (``seq_block``)."""
    m = cfg.mla
    lo, hi = seq_block(S_max, ctx)
    return {"ckv": torch.zeros((B, hi - lo, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((B, hi - lo, m.qk_rope_dim), dtype=dtype,
                                 device=device)}
