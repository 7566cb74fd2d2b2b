"""Entry points of the sliding-window serving kernels, with the JAX
package's signatures and layouts (``repro/kernels/swa_attention/ops.py``
and ``prefill.py``).

The device rule is the port's: on CUDA tensors the CUDA kernels
(``swa.py``) or an error, on CPU tensors the plain versions
(``ref.py``); ``use_kernel=False`` forces the plain version (the only
way to it on the card), ``use_kernel=True`` on CPU tensors raises.
Nothing falls back. Both kernels take any S as it is: the JAX kernels'
block sizes (``block_s``, ``block_q``, ``block_kv``) are TPU tiles, kept
in the signatures and not read.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import kernel_for
from repro_torch.kernels.swa_attention import ref, swa

# What the JAX package computes for causal=False. Its Pallas kernel
# stops each q block's band at the block's last row (prefill.py
# ``_kernel``: ``nominal <= (qi*bq + bq - 1) // bk``), so later keys are
# never visited; its oracle (``ref.prefill_ref``) admits every key j with
# i - j < window, later ones included. The two differ (max |diff| 0.81
# at S=128, hd=16, window 32 or 0, blocks of 32; 6.1e-7 with
# causal=True) and no caller uses the case. With window=0 the oracle's
# answer is full bidirectional attention, which the port computes; with
# a window the port has no single definition to be held to, and raises.
NONCAUSAL_WINDOW_ERROR = (
    "swa_prefill(causal=False, window>0) is not defined: the JAX package's "
    "Pallas kernel (repro/kernels/swa_attention/prefill.py) stops each "
    "query block's band at the block's end, while its oracle "
    "(repro/kernels/swa_attention/ref.py prefill_ref) admits every later "
    "key inside the window, and the two disagree; use causal=True, or "
    "window=0 for full bidirectional attention")


def decode_attention(q, k_cache, v_cache, key_pos, q_pos, *, window: int = 0,
                     block_s: int = 512, use_kernel: Optional[bool] = None,
                     return_lse: bool = False):
    """One query token per sequence against a (ring) cache. q (B,H,hd);
    caches (B,S,KV,hd); key_pos (S,) absolute slot positions (-1 =
    unwritten); q_pos the query's position (an int or a 0-d tensor).
    Returns (B,H,hd) f32; with ``return_lse`` also (B,H) f32, each
    head's log-sum-exp of its visible slots' scaled scores (-inf where
    none is visible): on the card the kernel's, never a fallback."""
    del block_s
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    qr = q.reshape(B, KV, H // KV, hd)
    if kernel_for(use_kernel, q.device):
        res = swa.swa_decode(qr.contiguous(), k_cache.contiguous(),
                             v_cache.contiguous(),
                             key_pos.to(torch.int32).contiguous(),
                             int(q_pos), window=window,
                             return_lse=return_lse)
    else:
        res = ref.decode_ref(qr, k_cache, v_cache, key_pos, q_pos,
                             window=window, return_lse=return_lse)
    if return_lse:
        return res[0].reshape(B, H, hd), res[1].reshape(B, H)
    return res.reshape(B, H, hd)


def swa_prefill(q, k, v, *, window: int, block_q: int = 256,
                block_kv: int = 256, causal: bool = True,
                use_kernel: Optional[bool] = None):
    """Banded sliding-window attention over a prompt at positions
    ``arange(S)``: each query sees the keys j with (causal) j <= i and
    (window > 0) i - j < window; ``window=0`` is full causal, or full
    bidirectional with ``causal=False`` (the JAX oracle's definition).
    q (B,KV,G,S,hd); k, v (B,S,KV,hd). Returns (B,KV,G,S,hd) f32. ``causal=False`` with a
    window raises ``ValueError`` (``NONCAUSAL_WINDOW_ERROR``)."""
    del block_q, block_kv
    if not causal and window > 0:
        raise ValueError(NONCAUSAL_WINDOW_ERROR)
    if kernel_for(use_kernel, q.device):
        return swa.swa_prefill(q.contiguous(), k.contiguous(),
                               v.contiguous(), window=window, causal=causal)
    return ref.prefill_ref(q, k, v, window=window, causal=causal)
