"""Mixture-of-Experts FFN with sort-based dispatch (the JAX package's
``models/moe.py``), on one card: every expert stays whole, so the JAX
package's expert-parallel ``shard_map`` branch (and its all-to-all
variant) is not ported and raises.

The reference leaves the dispatch to XLA; here it is plain PyTorch, with
``torch.bmm`` for the expert products. Two choices keep it equal to the
reference and reproducible on the card:

  * top-k is a stable descending sort, so of equal probabilities the
    lower expert id wins, as ``jax.lax.top_k`` does (``torch.topk`` does
    not). Expert duplication (``core/tfamily.py``) makes exact ties.
  * no scatter adds: every gather's index is injective (rows past the end
    read a zero row), so neither a gather nor its backward adds two
    values into one place, and the combine sums a token's ``top_k``
    contributions over an axis of its own. Two runs are bit-equal.

Expert counts come from a compare-and-sum rather than ``bincount``,
which has no ``vmap`` batching rule (the unified engine vmaps the loss
over clients).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import not_ported
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, zeros
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx


def moe_init(generator, cfg, *, device=None, dtype=torch.float32):
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    kw = dict(device=device, dtype=dtype)
    p = {
        "router": dense_init((D, E), generator, **kw),
        # router bias: zero at init; NetChange expert duplication shifts
        # the duplicates by -log(group size) here
        "router_b": zeros((E,), **kw),
        "wg": dense_init((E, D, Fe), generator, fan_in=D, **kw),
        "wu": dense_init((E, D, Fe), generator, fan_in=D, **kw),
        "wd": dense_init((E, Fe, D), generator, fan_in=Fe, **kw),
    }
    if m.n_shared:
        # shared experts: one fused SwiGLU MLP of width n_shared * d_ff_shared
        shared_cfg = dataclasses.replace(cfg, mlp_kind="swiglu")
        p["shared"] = mlp_init(generator, shared_cfg, D,
                               m.n_shared * m.d_ff_shared, **kw)
    return p


def top_k(probs, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, ties to the
    lower index (a stable descending sort)."""
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return wts[..., :k], ids[..., :k]


def _route(router, x2d, k: int, router_b=None):
    logits = (x2d @ router).float()                           # (N,E)
    if router_b is not None:
        logits = logits + router_b.float()
    probs = torch.softmax(logits, dim=-1)
    wts, ids = top_k(probs, k)                                # (N,k)
    wts = wts / torch.clamp(wts.sum(-1, keepdim=True), min=1e-9)
    return wts, ids, probs


def _capacity(n_tokens: int, k: int, n_experts_total: int, cf: float) -> int:
    return max(1, int(n_tokens * k / n_experts_total * cf) + 1)


def _dispatch_ffn_combine(x2d, ids, wts, wg, wu, wd, *, capacity: int):
    """Sort-based dispatch -> per-expert matmuls -> weighted combine.

    x2d (N,D); ids/wts (N,k); wg/wu/wd the expert stacks (E, ...). Each
    expert takes its first ``capacity`` assignments in (token, slot)
    order; the rest are dropped (contribute 0), as in the reference.
    """
    N, D = x2d.shape
    k = ids.shape[1]
    E = wg.shape[0]
    C = capacity
    dev = x2d.device

    flat = ids.reshape(-1)                                    # (N*k,)
    order = torch.argsort(flat, stable=True)                  # by expert
    counts = (flat[:, None] == torch.arange(E, device=dev)).sum(0)
    starts = torch.cumsum(counts, 0) - counts                 # exclusive
    slot = torch.arange(C, device=dev)
    filled = slot[None, :] < counts[:, None]                  # (E,C)
    # dispatch: slot (e, c) takes sorted assignment starts[e] + c, i.e.
    # flat assignment order[.]; empty slots read the zero row N*k
    src = torch.clamp(starts[:, None] + slot[None, :], max=N * k - 1)
    slot_src = torch.where(filled, order[src], N * k)         # (E,C)
    x_rep = x2d[:, None, :].expand(N, k, D).reshape(N * k, D)
    x_pad = torch.cat([x_rep, x_rep.new_zeros(1, D)])
    buf = x_pad[slot_src]                                     # (E,C,D)

    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    y_buf = torch.bmm(h, wd)                                  # (E,C,D)

    # combine: assignment j is the rank-th of its expert (its sorted
    # position less the expert's start); kept when rank < C, else it
    # reads the zero row E*C
    rank = torch.argsort(order) - starts[flat]
    at = torch.where(rank < C, flat * C + rank, E * C)        # (N*k,)
    y_pad = torch.cat([y_buf.reshape(E * C, D), y_buf.new_zeros(1, D)])
    gath = y_pad[at].reshape(N, k, D)
    return (gath * wts.to(gath.dtype)[..., None]).sum(1)


def _moe_routed(x, p, cfg):
    """Routed-experts part. x: (B,S,D)."""
    m = cfg.moe
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    wts, ids, _ = _route(p["router"], x2d, m.top_k, p.get("router_b"))
    C = _capacity(x2d.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    out = _dispatch_ffn_combine(x2d, ids, wts, p["wg"], p["wu"], p["wd"],
                                capacity=C)
    return out.reshape(B, S, D)


def moe_apply(p, cfg, x, ctx: ShardCtx = CPU_CTX):
    """x: (B,S,D). Dispatch + expert FFN + combine (+ shared experts)."""
    if ctx.moe_all_to_all:
        raise not_ported("expert-parallel MoE dispatch (moe_all_to_all)",
                         "client-axis distribution (item 3)")
    out = _moe_routed(x, p, cfg)
    if cfg.moe.n_shared:
        out = out + mlp_apply(p["shared"], x, "swiglu")
    return out
