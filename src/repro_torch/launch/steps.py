"""Step functions of the JAX package's ``launch/steps.py``: the
language-model loss of the training step (next-token cross-entropy,
optionally computed in sequence chunks so the (B, S, V) logits never
exist at once) and the serving steps (``make_prefill_step``,
``make_decode_step``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx


def chunked_softmax_xent(h, w, labels, *, chunk: int = 0):
    """Mean next-token CE. h: (B,S,D); w: (D,V); labels: (B,S) int.
    chunk = sequence-chunk size (0 => one chunk: returns the argmax
    predictions as aux, else the hit rate, as the JAX version does)."""
    B, S, D = h.shape
    labels = labels.long()
    if chunk <= 0 or chunk >= S:
        logits = (h @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (lse - ll).mean(), logits.argmax(-1)
    n = -(-S // chunk)
    pad = n * chunk - S
    hp = F.pad(h, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad))
    mask = F.pad(torch.ones((B, S), dtype=torch.float32, device=h.device),
                 (0, pad))
    total = hits = 0.0
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = (hp[:, sl] @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        li, mi = lp[:, sl], mask[:, sl]
        ll = torch.gather(logits, -1, li[..., None])[..., 0]
        total = total + ((lse - ll) * mi).sum()
        hits = hits + ((logits.argmax(-1) == li).float() * mi).sum()
    return total / (B * S), hits / (B * S)


def lm_loss(params, cfg: ModelConfig, batch, *, ctx: ShardCtx = CPU_CTX,
            loss_chunk: int = 0):
    """batch: {'tokens': (B,S), 'labels': (B,S)}. Returns (loss, aux)."""
    h = T.forward_hidden(params, cfg, batch["tokens"], ctx=ctx)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    loss, aux = chunked_softmax_xent(h, w, batch["labels"], chunk=loss_chunk)
    return loss, {"acc_or_preds": aux}


def make_prefill_step(cfg: ModelConfig, *, ctx: ShardCtx = CPU_CTX,
                      cache_len: Optional[int] = None):
    """``prefill_step(params, batch) -> (last logits (B,V), cache)``;
    batch ``{'tokens': (B,S)}``."""
    def prefill_step(params, batch):
        if batch.get("aux") is not None:
            raise not_ported("modality inputs (batch['aux'])",
                             "the transformer stack (item 9)")
        return T.prefill(params, cfg, batch["tokens"], ctx=ctx,
                         cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, ctx: ShardCtx = CPU_CTX):
    """``decode_step(params, token (B,1), cache, pos) -> (logits (B,V),
    cache)``; the cache is written in place."""
    def decode_step(params, token, cache, pos):
        return T.decode_step(params, cfg, token, cache, pos, ctx=ctx)
    return decode_step
