"""Step functions of the JAX package's ``launch/steps.py``: the
language-model loss of the training step (next-token cross-entropy,
optionally computed in sequence chunks so the (B, S, V) logits never
exist at once), the training step (``make_train_step``) and the serving
steps (``make_prefill_step``, ``make_decode_step``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import grad_and_value

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding.collectives import (all_reduce_nograd,
                                              copy_to_model, dp_active,
                                              reduce_from_data,
                                              reduce_from_model,
                                              vocab_argmax)
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx


def _text_hidden(cfg, h, aux):
    """Drop the vision prefix's rows, so the hidden rows align with the
    labels. A batch without ``aux`` has no prefix rows (``_embed`` adds
    them only with ``aux``), so nothing is dropped: the reference drops
    ``n_prefix`` rows all the same and its text-only loss fails on
    mismatched shapes (ROADMAP.md, the JAX package's known faults)."""
    npx = T.vision_prefix(cfg)
    return h[:, npx:] if npx and aux is not None else h


def _xent(h, w, labels, ctx, lo):
    """Per-row cross-entropy and argmax of ``h @ w``. ``lo`` None: whole
    logits. Else vocab-parallel: ``w`` holds the rank's columns, global
    ids from ``lo``: the max over the ranks (``ReduceOp.MAX``, no
    gradient: the log-sum-exp does not depend on the shift), the sum of
    exp and the target logit (masked to the rank's range) summed over
    them, the argmax across ranks the lower id on a tie."""
    if lo is None:
        logits = (h @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return lse - ll, logits.argmax(-1)
    logits = (copy_to_model(h, ctx) @ w).float()
    Vl = logits.shape[-1]
    shift = all_reduce_nograd(logits.amax(-1), ctx, dist.ReduceOp.MAX)
    se = reduce_from_model(torch.exp(logits - shift[..., None]).sum(-1),
                           ctx)
    local = labels - lo
    mine = (local >= 0) & (local < Vl)
    ll = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    ll = reduce_from_model(torch.where(mine, ll, torch.zeros_like(ll)), ctx)
    return shift + torch.log(se) - ll, vocab_argmax(logits, ctx, lo)


def chunked_softmax_xent(h, w, labels, *, chunk: int = 0,
                         ctx: ShardCtx = CPU_CTX, lo: Optional[int] = None):
    """Mean next-token CE. h: (B,S,D); w: (D,V); labels: (B,S) int.
    chunk = sequence-chunk size (0 => one chunk: returns the argmax
    predictions as aux, else the hit rate, as the JAX version does).
    ``lo``: ``w`` holds the vocabulary columns from id ``lo`` of a
    vocab-split model axis (``transformer.vocab_lo``); the loss, the
    predictions and the hit rate are then the whole vocabulary's, on
    every rank.

    Under data axes of more than one rank (FSDP) ``h`` and ``labels`` are
    the rank's rows: the loss and the hit rate are the whole batch's, on
    every rank (the rows' sums and counts summed over the data axes,
    ``_ReduceFromData``), so each rank's gradient is its rows' share of
    the whole batch's; the predictions stay the rank's rows."""
    B, S, D = h.shape
    labels = labels.long()
    if chunk <= 0 or chunk >= S:
        rows, preds = _xent(h, w, labels, ctx, lo)
        if dp_active(ctx):
            tot = reduce_from_data(torch.stack(
                [rows.sum(), rows.new_full((), float(rows.numel()))]), ctx)
            return tot[0] / tot[1], preds
        return rows.mean(), preds
    n = -(-S // chunk)
    pad = n * chunk - S
    hp = F.pad(h, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad))
    mask = F.pad(torch.ones((B, S), dtype=torch.float32, device=h.device),
                 (0, pad))
    total = hits = 0.0
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        li, mi = lp[:, sl], mask[:, sl]
        rows, preds = _xent(hp[:, sl], w, li, ctx, lo)
        total = total + (rows * mi).sum()
        hits = hits + ((preds == li).float() * mi).sum()
    if dp_active(ctx):
        tot = reduce_from_data(torch.stack(
            [total, hits, total.new_full((), float(B * S))]), ctx)
        return tot[0] / tot[2], tot[1] / tot[2]
    return total / (B * S), hits / (B * S)


def lm_loss(params, cfg: ModelConfig, batch, *, ctx: ShardCtx = CPU_CTX,
            loss_chunk: int = 0):
    """batch: {'tokens': (B,S), 'labels': (B,S), ['aux': modality
    embeddings]}. Returns (loss, aux). Under a model axis every rank
    returns the whole loss (vocab-parallel when the output projection is
    split); under data axes the batch (``aux`` too) is the rank's rows
    and every rank returns the whole batch's loss
    (``chunked_softmax_xent``)."""
    aux = batch.get("aux")
    h = T.forward_hidden(params, cfg, batch["tokens"], ctx=ctx, aux=aux)
    h = _text_hidden(cfg, h, aux)
    loss, aux = chunked_softmax_xent(h, T.logits_weight(params, cfg, ctx),
                                     batch["labels"], chunk=loss_chunk,
                                     ctx=ctx, lo=T.vocab_lo(params, cfg, ctx))
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


def make_decode_step(cfg: ModelConfig, *, ctx: ShardCtx = CPU_CTX,
                     cache_len: Optional[int] = None):
    """``decode_step(params, token (B,1), cache, pos) -> (logits (B,V),
    cache)``; the cache is written in place. ``cache_len``: the whole
    cache's length, which a sequence-split cache needs
    (``ctx.batch_whole``; ``transformer.decode_step``)."""
    def decode_step(params, token, cache, pos):
        return T.decode_step(params, cfg, token, cache, pos, ctx=ctx,
                             cache_len=cache_len)
    return decode_step
