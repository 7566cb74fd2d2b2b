"""Mixture-of-Experts FFN with sort-based dispatch (the JAX package's
``models/moe.py``).

Expert parallelism: under a ``ShardCtx`` with a mesh and a
``model_axis`` whose extent m divides the expert count E, each rank of
the model axis holds E/m experts (``sharding.rules.expert_slice``),
routes its replicated input with the whole router, runs the dispatch on
its experts only (``e_offset`` = rank·E/m) and the partial outputs are
summed over the model group: the reference's ``shard_map`` + ``psum``.
Gradients come from two ``torch.autograd.Function``s, the transposes of
that pair: identity forward / ``all_reduce`` backward on the replicated
inputs (x, router, router_b), ``all_reduce`` forward / identity
backward on the combined output. Otherwise the experts stay whole.
``ShardCtx.moe_all_to_all`` selects nothing: as in the reference, it is
accepted and the computation is the same.

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
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, zeros
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx
from repro_torch.sharding.rules import moe_spec


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


def _dispatch_ffn_combine(x2d, ids, wts, wg, wu, wd, *, capacity: int,
                          e_offset: int = 0, n_experts: int = 0):
    """Sort-based dispatch -> per-expert matmuls -> weighted combine.

    x2d (N,D); ids/wts (N,k) over all ``n_experts`` experts (0: the
    stacks' count); wg/wu/wd the stacks of experts ``[e_offset,
    e_offset + E_loc)``. Each expert takes its first ``capacity``
    assignments in (token, slot) order; the rest are dropped (contribute
    0), as in the reference. Assignments to experts outside the stacks
    contribute 0 here (another rank's part).
    """
    N, D = x2d.shape
    k = ids.shape[1]
    E_loc = wg.shape[0]
    E = n_experts or E_loc
    C = capacity
    dev = x2d.device

    flat = ids.reshape(-1)                                    # (N*k,)
    order = torch.argsort(flat, stable=True)                  # by expert
    counts = (flat[:, None] == torch.arange(E, device=dev)).sum(0)
    starts = torch.cumsum(counts, 0) - counts                 # exclusive
    local = torch.arange(e_offset, e_offset + E_loc, device=dev)
    slot = torch.arange(C, device=dev)
    filled = slot[None, :] < counts[local][:, None]           # (E_loc,C)
    # dispatch: slot (e, c) takes sorted assignment starts[e] + c, i.e.
    # flat assignment order[.]; empty slots read the zero row N*k
    src = torch.clamp(starts[local][:, None] + slot[None, :],
                      max=N * k - 1)
    slot_src = torch.where(filled, order[src], N * k)         # (E_loc,C)
    x_rep = x2d[:, None, :].expand(N, k, D).reshape(N * k, D)
    x_pad = torch.cat([x_rep, x_rep.new_zeros(1, D)])
    buf = x_pad[slot_src]                                     # (E,C,D)

    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    y_buf = torch.bmm(h, wd)                                  # (E,C,D)

    # combine: assignment j is the rank-th of its expert (its sorted
    # position less the expert's start); kept when rank < C and its
    # expert is held here, else it reads the zero row E_loc*C
    rank = torch.argsort(order) - starts[flat]
    kept = (rank < C) & (flat >= e_offset) & (flat < e_offset + E_loc)
    at = torch.where(kept, (flat - e_offset) * C + rank, E_loc * C)
    y_pad = torch.cat([y_buf.reshape(E_loc * C, D),
                       y_buf.new_zeros(1, D)])
    gath = y_pad[at].reshape(N, k, D)
    return (gath * wts.to(gath.dtype)[..., None]).sum(1)


def _moe_routed(x, p, cfg, *, e_offset: int = 0):
    """Routed-experts part. x: (B,S,D); the expert stacks hold experts
    ``[e_offset, e_offset + E_loc)``."""
    m = cfg.moe
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    wts, ids, _ = _route(p["router"], x2d, m.top_k, p.get("router_b"))
    C = _capacity(x2d.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    out = _dispatch_ffn_combine(x2d, ids, wts, p["wg"], p["wu"], p["wd"],
                                capacity=C, e_offset=e_offset,
                                n_experts=m.n_experts)
    return out.reshape(B, S, D)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, ``all_reduce`` (sum) backward over the model
    group: a replicated input of rank-local work (the transpose of
    ``psum``'s identity cotangent)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """``all_reduce`` (sum) forward, identity backward over the model
    group: partial outputs summed into a replicated one, whose cotangent
    every rank already holds whole."""

    @staticmethod
    def forward(x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_expert_parallel(x, p, cfg, ctx: ShardCtx):
    """This rank's experts on the replicated ``x``, summed over the model
    group. ``p``'s expert stacks must be the rank's E/m slice."""
    E, m = cfg.moe.n_experts, ctx.model_size
    per = E // m
    if p["wg"].shape[0] != per:
        raise ValueError(
            f"expert-parallel MoE over {m} ranks holds {per} of {E} experts "
            f"a rank; the expert stacks hold {p['wg'].shape[0]}: pass the "
            f"rank's slice (sharding.rules.expert_slice)")
    group = ctx.model_group()
    q = {"router": _CopyToModel.apply(p["router"], group),
         "wg": p["wg"], "wu": p["wu"], "wd": p["wd"]}
    if "router_b" in p:
        q["router_b"] = _CopyToModel.apply(p["router_b"], group)
    out = _moe_routed(_CopyToModel.apply(x, group), q, cfg,
                      e_offset=ctx.model_rank * per)
    return _ReduceFromModel.apply(out, group)


def moe_apply(p, cfg, x, ctx: ShardCtx = CPU_CTX):
    """x: (B,S,D). Dispatch + expert FFN + combine (+ shared experts).
    Expert-parallel when ``ctx`` is distributed and E divides its model
    extent (module docstring); the experts stay whole otherwise."""
    if ctx.distributed and moe_spec(cfg.moe.n_experts,
                                    ctx.model_size) == "experts":
        out = _moe_expert_parallel(x, p, cfg, ctx)
    else:
        out = _moe_routed(x, p, cfg)
    if cfg.moe.n_shared:
        out = out + mlp_apply(p["shared"], x, "swiglu")
    return out
