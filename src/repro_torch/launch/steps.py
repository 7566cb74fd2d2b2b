"""Step functions of the JAX package's ``launch/steps.py``: the
language-model loss of the training step (next-token cross-entropy,
optionally computed in sequence chunks so the (B, S, V) logits never
exist at once), the training step (``make_train_step``) and the serving
steps (``make_prefill_step``, ``make_decode_step``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.func import grad_and_value

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx


def _text_hidden(cfg, h, aux):
    """Drop the vision prefix's rows, so the hidden rows align with the
    labels. A batch without ``aux`` has no prefix rows (``_embed`` adds
    them only with ``aux``), so nothing is dropped: the reference drops
    ``n_prefix`` rows all the same and its text-only loss fails on
    mismatched shapes (ROADMAP.md, the JAX package's known faults)."""
    npx = T.vision_prefix(cfg)
    return h[:, npx:] if npx and aux is not None else h


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
    """batch: {'tokens': (B,S), 'labels': (B,S), ['aux': modality
    embeddings]}. Returns (loss, aux)."""
    aux = batch.get("aux")
    h = T.forward_hidden(params, cfg, batch["tokens"], ctx=ctx, aux=aux)
    h = _text_hidden(cfg, h, aux)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    loss, aux = chunked_softmax_xent(h, w, batch["labels"], chunk=loss_chunk)
    return loss, {"acc_or_preds": aux}


def make_train_step(cfg: ModelConfig, optimizer, *, ctx: ShardCtx = CPU_CTX,
                    loss_chunk: int = 0):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    {'loss'})``: the ``lm_loss`` gradient (``torch.func``; ``aux`` is an
    input, not differentiated), then the optimizer's in-place update.
    batch ``{'tokens', 'labels', ['aux']}``."""
    def loss(params, batch):
        return lm_loss(params, cfg, batch, ctx=ctx, loss_chunk=loss_chunk)

    gv = grad_and_value(loss, has_aux=True)

    def train_step(params, opt_state, step, batch):
        grads, (value, _) = gv(params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, {"loss": value.detach()}
    return train_step


def make_prefill_step(cfg: ModelConfig, *, ctx: ShardCtx = CPU_CTX,
                      cache_len: Optional[int] = None):
    """``prefill_step(params, batch) -> (last logits (B,V), cache)``;
    batch ``{'tokens': (B,S), ['aux': modality embeddings]}``."""
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch["tokens"], ctx=ctx,
                         aux=batch.get("aux"), cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, ctx: ShardCtx = CPU_CTX):
    """``decode_step(params, token (B,1), cache, pos) -> (logits (B,V),
    cache)``; the cache is written in place."""
    def decode_step(params, token, cache, pos):
        return T.decode_step(params, cfg, token, cache, pos, ctx=ctx)
    return decode_step
