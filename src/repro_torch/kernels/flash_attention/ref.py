"""Plain PyTorch versions of the flash-attention kernels — the CPU path
and the oracle the CUDA kernels are held against.

The JAX package's ``kernels/flash_attention/ref.py``, op for op: scale on
q, position masks (-1 = masked key), f32 accumulation, online softmax
over kv blocks of ``block_kv``, ``acc / max(l, 1e-30)``. The masked score
is the FINITE ``NEG_INF = -1e30``, as there: a query row that sees no key
averages v over every key and gets ``lse ≈ -1e30``, and the backward
recomputes ``p = exp(NEG_INF - lse) = 1`` on it (the CUDA kernels keep
the same convention).

Layout is the kernel layout: q ``(B, KV, G, Sq, hd)``; k, v
``(B, Sk, KV, hd)``; q_pos ``(Sq,)`` / kv_pos ``(Sk,)`` absolute
positions.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_mask(q_pos, kv_pos, causal: bool, window: int):
    """(Sq, Sk) bool mask from absolute positions (-1 = masked key)."""
    valid = (kv_pos >= 0)[None, :].expand(q_pos.shape[0], kv_pos.shape[0])
    if causal:
        valid = valid & (q_pos[:, None] >= kv_pos[None, :])
    if window > 0:
        valid = valid & (q_pos[:, None] - kv_pos[None, :] < window)
    return valid


def _scores(qf, kb, qpos, kpos, causal, window):
    s = torch.einsum("bkgqd,bskd->bkgqs", qf, kb.float())
    mask = _block_mask(qpos, kpos, causal, window)
    return torch.where(mask[None, None, None], s,
                       torch.full_like(s, NEG_INF))


def _attend_block(qf, kb, vb, qpos, kpos, causal, window, m, l, acc):
    """One online-softmax step. qf (B,KV,G,Sq,hd) pre-scaled f32;
    kb/vb (B,bk,KV,hd); carry m/l (B,KV,G,Sq), acc (B,KV,G,Sq,hd)."""
    s = _scores(qf, kb, qpos, kpos, causal, window)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, vb.float())
    acc = acc * corr[..., None] + pv
    return m_new, l, acc


def _kv_blocks(Sk: int, block_kv: int):
    if Sk <= block_kv:
        return [(0, Sk)]
    assert Sk % block_kv == 0, (Sk, block_kv)
    return [(lo, lo + block_kv) for lo in range(0, Sk, block_kv)]


def flash_fwd_ref(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                  block_kv=128):
    """Returns (out, lse): out (B,KV,G,Sq,hd) f32, lse (B,KV,G,Sq) f32
    with lse = rowmax + log(rowsum) of the masked scores."""
    B, KV, G, Sq, hd = q.shape
    scale = hd ** -0.5
    qf = q.float() * scale
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for lo, hi in _kv_blocks(k.shape[1], block_kv):
        m, l, acc = _attend_block(qf, k[:, lo:hi], v[:, lo:hi], q_pos,
                                  kv_pos[lo:hi], causal, window, m, l, acc)
    lmax = torch.clamp(l, min=1e-30)
    return acc / lmax[..., None], m + torch.log(lmax)


def flash_bwd_ref(q, k, v, q_pos, kv_pos, out, lse, dout, *, causal=True,
                  window=0, block_kv=128):
    """Recompute-from-residuals backward. Returns (dq, dk, dv) f32 in the
    primal layouts. ``delta = rowsum(dout * out)`` is the FlashAttention-2
    normalizer correction; dk absorbs the q scale because s = (q*scale)k^T."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    qf = q.float() * scale
    do = dout.float()
    delta = (do * out).sum(dim=-1)             # (B,KV,G,Sq)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for lo, hi in _kv_blocks(k.shape[1], block_kv):
        kb, vb = k[:, lo:hi].float(), v[:, lo:hi].float()
        s = _scores(qf, kb, q_pos, kv_pos[lo:hi], causal, window)
        p = torch.exp(s - lse[..., None])      # normalized probs, 0 off-mask
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p, do))
        dp = torch.einsum("bkgqd,bskd->bkgqs", do, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bkgqs,bskd->bkgqd", ds, kb)
        dks.append(torch.einsum("bkgqs,bkgqd->bskd", ds, qf))
    return dq * scale, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
