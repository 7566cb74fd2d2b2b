"""Plain PyTorch versions of the sliding-window serving kernels — the CPU
path and the oracle the CUDA kernels are held against.

The JAX package's ``kernels/swa_attention/ref.py``, op for op: inputs in
f32 or bf16, math in f32, q scaled by ``hd ** -0.5``, masks from
positions, ``softmax`` over the masked scores. The masked score is the
FINITE ``NEG_INF = -1e30``, as there: a query that sees no key gives
every key the same weight, so its output is the mean of v over every
key (not NaN, not 0).

Layouts are the kernels': decode q ``(B, KV, G, hd)``, prefill q
``(B, KV, G, S, hd)``; k, v ``(B, S, KV, hd)``; outputs f32 in q's
layout.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def prefill_ref(q, k, v, *, window: int, causal: bool = True):
    """Sliding-window attention over a prompt at positions ``arange(S)``:
    key j is visible to query i when (causal) j <= i and (window > 0)
    i - j < window. q (B,KV,G,S,hd); k, v (B,S,KV,hd) -> (B,KV,G,S,hd)
    f32."""
    hd, S = q.shape[-1], q.shape[3]
    s = torch.einsum("bkgqd,bskd->bkgqs", q.float() * hd ** -0.5, k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bkgqd", p, v.float())


def decode_ref(q, k, v, key_pos, q_pos, *, window: int = 0):
    """One query token against a (ring) cache whose slot s holds absolute
    position ``key_pos[s]`` (< 0 = unwritten): slot s is visible when
    0 <= key_pos[s] <= q_pos and (window > 0) q_pos - key_pos[s] <
    window. q (B,KV,G,hd); k, v (B,S,KV,hd) -> (B,KV,G,hd) f32."""
    hd = q.shape[-1]
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * hd ** -0.5, k.float())
    valid = (key_pos >= 0) & (key_pos <= q_pos)
    if window > 0:
        valid = valid & (q_pos - key_pos < window)
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v.float())
