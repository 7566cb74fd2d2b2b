"""Mixture-of-Experts FFN with sort-based dispatch (the JAX package's
``models/moe.py``).

Under a ``ShardCtx`` with a model axis of m ranks the expert stacks are
placed by ``sharding.rules.moe_spec``: expert-parallel when m divides
the expert count E (each rank holds E/m experts and runs the dispatch on
them only, ``e_offset`` = rank·E/m), else each expert's F axis split
(``wg``/``wu`` column-, ``wd`` row-split: every rank runs every expert
at F/m) when m divides F, else whole. Either split routes the
replicated input with the whole, replicated router — the capacity comes
from the global token count — and the ranks' partial outputs are summed
over the model group: the reference's ``shard_map`` + ``psum`` (or
GSPMD's F-split). Gradients come from the collectives' Functions
(``sharding/collectives.py``): the input and the router through
``_CopyToModel``, the output through ``_ReduceFromModel``.
``ShardCtx.moe_all_to_all`` selects nothing: as in the reference, it is
accepted and the computation is the same.

Under data axes of d > 1 ranks (FSDP) a rank routes its own rows, and
the dispatch is the whole batch's all the same: the capacity comes from
the whole batch's token count, and an expert's first ``capacity``
assignments in the whole batch's (token, slot) order are kept, so a
rank's assignment is kept when the assignments to its expert on the
lower data ranks (``prior``: the ranks' expert counts gathered, no
gradient) and its own before it are fewer than the capacity.

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

from repro_torch.models.layers import (dense_init, dot, mlp_apply, mlp_init,
                                      zeros)
from repro_torch.sharding.collectives import (copy_to_model, dp_active,
                                              gather_data_nograd, tp_active,
                                              tp_enter, tp_held, tp_leave)
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
    logits = dot(x2d, router).float()                           # (N,E)
    if router_b is not None:
        logits = logits + router_b.float()
    probs = torch.softmax(logits, dim=-1)
    wts, ids = top_k(probs, k)                                # (N,k)
    wts = wts / torch.clamp(wts.sum(-1, keepdim=True), min=1e-9)
    return wts, ids, probs


def _capacity(n_tokens: int, k: int, n_experts_total: int, cf: float) -> int:
    return max(1, int(n_tokens * k / n_experts_total * cf) + 1)


def _dispatch_ffn_combine(x2d, ids, wts, wg, wu, wd, *, capacity: int,
                          e_offset: int = 0, n_experts: int = 0,
                          prior=None):
    """Sort-based dispatch -> per-expert matmuls -> weighted combine.

    x2d (N,D); ids/wts (N,k) over all ``n_experts`` experts (0: the
    stacks' count); wg/wu/wd the stacks of experts ``[e_offset,
    e_offset + E_loc)``. Each expert takes its first ``capacity``
    assignments in (token, slot) order; the rest are dropped (contribute
    0), as in the reference. Assignments to experts outside the stacks
    contribute 0 here (another rank's part). ``prior`` (E,): each
    expert's assignments ahead of these (the lower data ranks' rows),
    which take that many of its ``capacity`` slots.
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
    if prior is None:
        filled = slot[None, :] < counts[local][:, None]       # (E_loc,C)
    else:
        room = torch.clamp(C - prior[local], min=0)
        filled = slot[None, :] < torch.minimum(counts[local], room)[:, None]
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
    ahead = rank if prior is None else rank + prior[flat]
    kept = (ahead < C) & (flat >= e_offset) & (flat < e_offset + E_loc)
    at = torch.where(kept, (flat - e_offset) * C + rank, E_loc * C)
    y_pad = torch.cat([y_buf.reshape(E_loc * C, D),
                       y_buf.new_zeros(1, D)])
    gath = y_pad[at].reshape(N, k, D)
    return (gath * wts.to(gath.dtype)[..., None]).sum(1)


def _data_prior(ids, n_experts: int, ctx):
    """Under FSDP: (each expert's assignments on the lower data ranks
    (E,), the whole batch's token count factor d); (None, 1) else, and
    where every data rank holds the whole batch (``ctx.batch_whole``:
    its tokens are the whole batch's already)."""
    if not dp_active(ctx) or ctx.batch_whole:
        return None, 1
    counts = (ids.reshape(-1)[:, None]
              == torch.arange(n_experts, device=ids.device)).sum(0)
    every = gather_data_nograd(counts, ctx)                   # (d,E)
    return every[:ctx.data_rank].sum(0), ctx.data_size


def _moe_routed(x, p, cfg, *, e_offset: int = 0, ctx: ShardCtx = CPU_CTX):
    """Routed-experts part. x: (B,S,D); the expert stacks hold experts
    ``[e_offset, e_offset + E_loc)``; under FSDP the rank's rows of the
    whole batch's dispatch (module docstring)."""
    m = cfg.moe
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    wts, ids, _ = _route(p["router"], x2d, m.top_k, p.get("router_b"))
    prior, d = _data_prior(ids, m.n_experts, ctx)
    C = _capacity(x2d.shape[0] * d, m.top_k, m.n_experts,
                  m.capacity_factor)
    out = _dispatch_ffn_combine(x2d, ids, wts, p["wg"], p["wu"], p["wd"],
                                capacity=C, e_offset=e_offset,
                                n_experts=m.n_experts, prior=prior)
    return out.reshape(B, S, D)


def _moe_split(x, p, cfg, ctx: ShardCtx, e_offset: int):
    """The rank's part of the routed experts on the replicated ``x``
    (its experts, or every expert's F slice), summed over the model
    group. The router is replicated: its gradient, like ``x``'s, is the
    sum of the ranks' (``tp_enter`` / ``_CopyToModel``)."""
    q = {"router": copy_to_model(p["router"], ctx),
         "wg": p["wg"], "wu": p["wu"], "wd": p["wd"]}
    if "router_b" in p:
        q["router_b"] = copy_to_model(p["router_b"], ctx)
    out = _moe_routed(tp_enter(x, ctx, True), q, cfg, e_offset=e_offset,
                      ctx=ctx)
    return tp_leave(out, ctx, True)


def _moe_expert_parallel(x, p, cfg, ctx: ShardCtx):
    """This rank's experts on the replicated ``x``, summed over the model
    group. ``p``'s expert stacks must be the rank's E/m slice."""
    E, m = cfg.moe.n_experts, ctx.model_size
    per = E // m
    if p["wg"].shape[0] != per:
        raise ValueError(
            f"expert-parallel MoE over {m} ranks holds {per} of {E} experts "
            f"a rank; the expert stacks hold {p['wg'].shape[0]}: pass the "
            f"rank's slice (sharding.rules.expert_slice or tp_slice)")
    return _moe_split(x, p, cfg, ctx, ctx.model_rank * per)


def moe_apply(p, cfg, x, ctx: ShardCtx = CPU_CTX):
    """x: (B,S,D). Dispatch + expert FFN + combine (+ shared experts).
    Under a model axis (module docstring): expert-parallel when E divides
    its extent; else each expert's F split when the stacks hold the
    rank's F slice; else the experts whole on every rank. The shared
    experts are an MLP of the model axis (``mlp_apply``)."""
    mc = cfg.moe
    spec = moe_spec(mc.n_experts, ctx.model_size if tp_active(ctx) else 1,
                    mc.d_ff_expert)
    if spec == "experts":
        out = _moe_expert_parallel(x, p, cfg, ctx)
    elif spec == "ffn" and tp_held(ctx, mc.d_ff_expert, p["wg"].shape[-1]):
        out = _moe_split(x, p, cfg, ctx, 0)
    else:
        out = tp_leave(_moe_routed(tp_enter(x, ctx, False), p, cfg, ctx=ctx),
                       ctx, False)
    if mc.n_shared:
        out = out + mlp_apply(p["shared"], x, "swiglu", ctx,
                              d_ff=mc.n_shared * mc.d_ff_shared)
    return out
