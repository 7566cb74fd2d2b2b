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

MLA and cross-attention come with their slices (ROADMAP.md queue 1,
item 9).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import pad_to
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models.layers import (apply_rope, dense_init, tp_row_matmul,
                                       zeros)
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx

NEG_INF = -1e30


def on_card(t: torch.Tensor) -> bool:
    """Where the "auto" backend runs the CUDA kernels: CUDA tensors."""
    return t.device.type == "cuda"


def apply_head_layout_seq(q5, k, v, ctx):
    """The JAX package maps heads onto a model-parallel mesh axis here;
    on one card (``ctx.model_size == 1``) the layout is the identity."""
    assert ctx.model_size == 1, "head layouts need a mesh (not ported)"
    return q5, k, v


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


def decode_attention(q, k_cache, v_cache, key_pos, q_pos, *, window=0):
    """One-token attention vs a cache, plain einsums. q: (B,H,hd); caches
    (B,Sc,KV,hd); key_pos: (Sc,) absolute positions of cache slots (-1 =
    unwritten); q_pos an int or a 0-d tensor. Returns (B,H,hd) in
    q.dtype."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).float()
    valid = (key_pos >= 0) & (key_pos <= q_pos)
    if window > 0:
        valid = valid & (q_pos - key_pos < window)
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype),
                       v_cache).float()
    return out.reshape(B, H, hd).to(q.dtype)


def attend_decode(q, k_cache, v_cache, key_pos, q_pos, *, window, ctx):
    """Backend-selected decode attention (module docstring): the
    ``swa_decode`` kernel on CUDA tensors under "auto"/"flash", the plain
    ``decode_attention`` otherwise."""
    backend = getattr(ctx, "attn_backend", "auto")
    if backend == "auto":
        backend = "flash" if on_card(q) else "blockwise"
    if backend == "flash":
        return swa_ops.decode_attention(q, k_cache, v_cache, key_pos, q_pos,
                                        window=window).to(q.dtype)
    if backend != "blockwise":
        raise ValueError(f"unknown attn_backend {backend!r}")
    return decode_attention(q, k_cache, v_cache, key_pos, q_pos,
                            window=window)


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


def _qkv(p, cfg, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _banded_prefill(q5, k, v, window):
    """Local-layer attention through the ``swa_prefill`` kernel: q5
    (B,S,KV,G,hd) at positions ``arange(S)`` (what train and prefill
    pass) -> (B,S,H,hd) in q5.dtype."""
    B, S, KV, G, hd = q5.shape
    out = swa_ops.swa_prefill(q5.permute(0, 2, 3, 1, 4), k, v, window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, KV * G, hd).to(q5.dtype)


def attn_apply_seq(p, cfg, x, positions, *, kind="global",
                   ctx: ShardCtx = CPU_CTX, return_cache=False,
                   cache_len=None):
    """Full-sequence causal self-attention (train / prefill), global or
    local (sliding ``cfg.window``). positions: (S,), contiguous ascending.
    Returns (y, cache|None); cache k/v are post-RoPE. For local layers the
    prefill cache keeps only the last ``window`` slots."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else 0
    q5 = q.reshape(B, S, KV, H // KV, hd)
    q5a, ka, va = apply_head_layout_seq(q5, k, v, ctx)
    if (window > 0 and getattr(ctx, "attn_backend", "auto") == "auto"
            and on_card(q) and not torch.is_grad_enabled()):
        out = _banded_prefill(q5a, ka, va, window)
    else:
        out = attend(q5a, ka, va, positions, positions, causal=True,
                     window=window, ctx=ctx, banded=ctx.banded_local,
                     causal_skip=ctx.causal_skip)
    y = tp_row_matmul(out.reshape(B, S, -1), p["wo"], ctx)
    cache = None
    if return_cache:
        cache = _build_cache(k, v, positions, window, cache_len, S)
    return y, cache


def _build_cache(k, v, positions, window, cache_len, S):
    """Arrange prefill k/v into the decode cache layout."""
    if window > 0:
        W = min(window, cache_len or window)
        # ring layout: slot = pos % W for the last W positions
        take = min(W, k.shape[1])
        slots = torch.remainder(positions[-take:], W).long()
        ck = k.new_zeros((k.shape[0], W) + tuple(k.shape[2:]))
        cv = torch.zeros_like(ck)
        ck[:, slots] = k[:, -take:]
        cv[:, slots] = v[:, -take:]
        return {"k": ck, "v": cv}
    L = cache_len or S
    ck = k.new_zeros((k.shape[0], L) + tuple(k.shape[2:]))
    cv = torch.zeros_like(ck)
    ck[:, :S] = k
    cv[:, :S] = v
    return {"k": ck, "v": cv}


def attn_apply_decode(p, cfg, x, pos: int, cache, *, kind="global",
                      ctx: ShardCtx = CPU_CTX):
    """One-token decode. x: (B,1,D); pos: the new token's position (an
    int); cache {'k','v'}, written in place at the token's slot and
    returned."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)[:, 0]          # (B,H,hd)
    k = apply_rope(k, pos_arr, cfg.rope_theta)[:, 0]          # (B,KV,hd)
    v = v[:, 0]
    window = cfg.window if kind == "local" else 0
    ck, cv = cache["k"], cache["v"]
    Sc = ck.shape[1]
    slot = pos % Sc if window > 0 else min(pos, Sc - 1)
    ck[:, slot] = k
    cv[:, slot] = v
    key_pos = (ring_positions(pos, Sc, device=x.device) if window > 0
               else torch.arange(Sc, device=x.device))
    out = attend_decode(q, ck, cv, key_pos, pos, window=window, ctx=ctx)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, {"k": ck, "v": cv}


def init_attn_cache(cfg, B, S_max, dtype=torch.float32, *, kind="global",
                    device=None):
    """Zero k and v caches (two tensors: decode writes them in place):
    ``window`` ring slots on local layers, ``S_max`` on global ones."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L = min(cfg.window, S_max) if kind == "local" else S_max
    return {"k": torch.zeros((B, L, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((B, L, KV, hd), dtype=dtype, device=device)}
