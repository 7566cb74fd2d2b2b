"""The collectives of tensor and expert parallelism over a ``ShardCtx``'s
``model`` axis, as ``torch.autograd.Function``s.

The reference is GSPMD: it places the parameters and XLA inserts the
collectives. The port inserts them itself, Megatron-style. Each is a
Function with ``setup_context``, so it composes with ``torch.func.grad``
(a bare ``dist.all_reduce`` inside a loss would leave its cotangent
wrong without an error). The pairs are transposes of each other:

  * ``_CopyToModel``: identity forward, sum backward — the input of
    rank-local work on a replicated tensor (a column-parallel
    projection's input, the MoE router);
  * ``_ReduceFromModel``: sum forward, identity backward — rank partials
    summed into a replicated tensor (a row-parallel projection's output,
    the vocab-parallel embedding, the loss's sums);
  * ``_GatherSeq``: the rank's rows of the sequence axis gathered whole
    forward, the rank's rows of the cotangent taken backward;
  * ``_SplitSeq``: its transpose (the sequence-parallel boundary).

Over the data axes (FSDP):

  * ``_GatherUnit``: a unit's leaves, each the rank's data part, gathered
    whole forward in one zero-padded sum of the unit's parts; backward
    one sum of the unit's cotangents, each cut leaf's cut back to the
    rank's part (the all-gather / reduce-scatter pair of FSDP, a unit at
    a time) and the leaves the plan keeps whole over the data axes
    (norms, biases, the router) summed whole: every data rank's
    gradient is its rows' share;
  * ``_ReduceFromData``: sum forward, identity backward — the loss's
    sums and counts over the batch's row blocks;
  * ``combine_seq`` (no gradient: serving): a decode batch the data
    axes do not split is whole on every data rank and each attention
    cache holds the rank's block of slots; each rank's attention output
    over its slots and its log-sum-exp move in one zero-padded sum, and
    every rank merges the parts in rank order (``merge_parts``) into
    the whole cache's answer, bit-identical on every data rank.

Each data rank's gradient is its rows' share of the mean over the whole
batch (the loss divides by the global count), so the sum that the
gather's backward takes is the whole-batch gradient: it is scaled once.

gloo has no reduce-scatter, and no all-gather for CUDA tensors: a
gather here is a sum ``all_reduce`` of a zero-padded buffer, and a
reduce-scatter an ``all_reduce`` then the rank's slice (``_GatherSeq``,
``_SumShared``, ``gather_vocab``; ``tp_leave`` under ``seq_parallel``).
Sequence parallelism therefore saves no bytes on the wire here; it
keeps the residual stream's rows split between blocks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree as tu


def tp_active(ctx) -> bool:
    """Whether ``ctx`` has a model axis of more than one rank."""
    return ctx is not None and ctx.distributed and ctx.model_size > 1


def tp_held(ctx, whole: int, held: int) -> bool:
    """Whether a layer of ``whole`` units (heads, columns, vocabulary
    rows) is split over ``ctx``'s model axis, as the ``held`` units of
    its leaf show: all of them (replicated: computed whole on every
    rank) or 1/m of them (this rank's part, ``sharding.rules.tp_slice``).
    Anything else is a tree cut for another mesh."""
    if held == whole:
        return False
    m = ctx.model_size if tp_active(ctx) else 1
    if m > 1 and held * m == whole:
        return True
    raise ValueError(f"a leaf holds {held} of {whole} units under a model "
                     f"axis of {m}: pass the whole tree, or this rank's "
                     f"part (sharding.rules.tp_slice)")


def gather_padded(x, dim, rank, world, sum_):
    """All-gather along ``dim`` as a sum of a zero-padded buffer (gloo has
    no all-gather for CUDA tensors): slot ``rank`` of ``world`` holds
    ``x``, and ``sum_`` sums the buffer in place over the group."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * world
    buf = x.new_zeros(shape)
    buf.narrow(dim, rank * n, n).copy_(x)
    sum_(buf)
    return buf


def _all_gather_rows(x, dim, group, rank, world):
    """``gather_padded`` over one process group."""
    return gather_padded(x, dim, rank, world, lambda b: dist.all_reduce(
        b, op=dist.ReduceOp.SUM, group=group))


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


class _GatherSeq(torch.autograd.Function):
    """x (B, S/m, ...) the rank's rows -> (B, S, ...) every rank's, in
    rank order; backward the rank's rows of a cotangent every rank holds
    whole."""

    @staticmethod
    def forward(x, group, rank, world):
        return _all_gather_rows(x.contiguous(), 1, group, rank, world)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.rank, ctx.world = inputs

    @staticmethod
    def backward(ctx, g):
        n = g.shape[1] // ctx.world
        return g.narrow(1, ctx.rank * n, n), None, None, None


class _SplitSeq(torch.autograd.Function):
    """x (B, S, ...) replicated -> the rank's rows (B, S/m, ...);
    backward gathers the ranks' cotangents."""

    @staticmethod
    def forward(x, group, rank, world):
        n = x.shape[1] // world
        return x.narrow(1, rank * n, n).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.rank, ctx.world = inputs

    @staticmethod
    def backward(ctx, g):
        return (_all_gather_rows(g.contiguous(), 1, ctx.group, ctx.rank,
                                 ctx.world), None, None, None)


class _SumShared(torch.autograd.Function):
    """Identity forward on a leaf slice ``[lo, lo + n)`` of a last axis of
    ``whole`` columns that other ranks hold too; backward sums the
    ranks' cotangents of each column (a zero-padded ``all_reduce``), so
    every holder gets the whole gradient. The "expand" head layout's kv
    projections: a kv head's query heads sit on several ranks."""

    @staticmethod
    def forward(w, group, lo, whole):
        return w.view_as(w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.lo, ctx.whole = inputs

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1]
        buf = g.new_zeros(tuple(g.shape[:-1]) + (ctx.whole,))
        buf.narrow(-1, ctx.lo, n).copy_(g)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ctx.group)
        return buf.narrow(-1, ctx.lo, n).contiguous(), None, None, None


class _AllReduceNoGrad(torch.autograd.Function):
    """``all_reduce`` with ``op`` of a value no gradient flows through
    (the loss's max shift, the argmax across ranks)."""

    @staticmethod
    def forward(x, op, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=op, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None


class _GatherUnit(torch.autograd.Function):
    """``parts``, a unit's leaves — leaf i the rank's contiguous part of
    its dimension ``dims[i]``, or whole where ``dims[i]`` is None — ->
    the whole leaves: every cut leaf's part flattened into row
    ``data_rank`` of one zero (data_size, n) buffer, summed over the data
    axes, and each leaf put back together from the rows in data-rank
    order. Backward: one buffer of every cut leaf's cotangent, its data
    parts in rows, and every whole leaf's cotangent behind them, summed
    over the data axes; a cut leaf's gradient is row ``data_rank`` of
    it, a whole leaf's the sum."""

    @staticmethod
    def forward(sctx, dims, *parts):
        outs = [p.view_as(p) for p in parts]
        cut = [i for i, dim in enumerate(dims) if dim is not None]
        if not cut:
            return tuple(outs)
        d, r = sctx.data_size, sctx.data_rank
        sizes = [parts[i].numel() for i in cut]
        buf = parts[cut[0]].new_zeros(d, sum(sizes))
        buf[r].copy_(torch.cat([parts[i].reshape(-1) for i in cut]))
        sctx.data_sum(buf)
        off = 0
        for i, n in zip(cut, sizes):
            shape = parts[i].shape
            outs[i] = torch.cat([buf[j, off:off + n].view(shape)
                                 for j in range(d)], dim=dims[i])
            off += n
        return tuple(outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sctx, ctx.dims = inputs[0], inputs[1]
        ctx.shapes = [p.shape for p in inputs[2:]]
        ctx.like = inputs[2]

    @staticmethod
    def backward(ctx, *gs):
        d, r = ctx.sctx.data_size, ctx.sctx.data_rank
        cut = [i for i, dim in enumerate(ctx.dims) if dim is not None]
        whole = [i for i, dim in enumerate(ctx.dims) if dim is None]
        n = [int(torch.Size(s).numel()) for s in ctx.shapes]
        n_cut = sum(n[i] for i in cut)
        # the cut leaves' (d, n) column blocks of the rows, then the whole
        # leaves behind the rows: each leaf's offset
        at, off = {}, 0
        for i in cut:
            at[i], off = off, off + n[i]
        off = d * n_cut
        for i in whole:
            at[i], off = off, off + n[i]
        buf = ctx.like.new_zeros(off)
        for i, g in enumerate(gs):
            if g is None:
                continue
            if ctx.dims[i] is None:
                buf[at[i]:at[i] + n[i]].copy_(g.reshape(-1))
                continue
            rows = buf[:d * n_cut].view(d, n_cut)
            for j, c in enumerate(g.chunk(d, dim=ctx.dims[i])):
                rows[j, at[i]:at[i] + n[i]].copy_(c.reshape(-1))
        ctx.sctx.data_sum(buf)
        rows = buf[:d * n_cut].view(d, n_cut)
        return (None, None, *[
            (buf[at[i]:at[i] + n[i]] if ctx.dims[i] is None
             else rows[r, at[i]:at[i] + n[i]]).view(shape)
            for i, shape in enumerate(ctx.shapes)])


class _ReduceFromData(torch.autograd.Function):
    """Sum forward over the data axes, identity backward: the row blocks'
    partial sums summed into the whole batch's."""

    @staticmethod
    def forward(x, sctx):
        out = x.contiguous().clone()
        sctx.data_sum(out)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDataNoGrad(torch.autograd.Function):
    """``x`` (n, ...) of every data rank -> (data_size, n, ...) in
    data-rank order, with no gradient (the MoE's expert counts)."""

    @staticmethod
    def forward(x, sctx):
        return gather_padded(x[None].contiguous(), 0, sctx.data_rank,
                             sctx.data_size, sctx.data_sum)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None


def merge_parts(o, lse):
    """The attention over a whole cache from its parts', in part order:
    ``o`` (d, ..., D) each part's output over its block of slots,
    ``lse`` (d, ...) its log-sum-exp (-inf: no visible slot) -> (...,
    D) f32, ``sum_r w_r o_r / sum_r w_r`` with ``w_r = exp(lse_r - max_r
    lse_r)``. Where no part sees a slot the whole cache's answer is the
    mean of v over every slot (the reference's masked softmax weighs
    every slot alike): the parts' means weighted by their slot counts,
    which are equal (a cut leaves each part 1/d of the slots), so their
    plain mean."""
    o, lse = o.float(), lse.float()
    top = lse.amax(0)
    seen = top > float("-inf")
    w = torch.where(seen, torch.exp(lse - torch.where(
        seen, top, torch.zeros_like(top))), torch.ones_like(lse))
    num, den = w[0][..., None] * o[0], w[0]
    for r in range(1, o.shape[0]):
        num = num + w[r][..., None] * o[r]
        den = den + w[r]
    return num / den[..., None]


def combine_seq(o, lse, ctx):
    """A decode attention whose cache's slots are cut over ``ctx``'s data
    axes (``ctx.batch_whole``): ``o`` (B, H, D) this rank's output over
    its block of slots, ``lse`` (B, H) its log-sum-exp -> the whole
    cache's output in ``o``'s dtype, bit-identical on every data rank.
    One zero-padded sum ``all_reduce`` over the data axes of a (d, B, H,
    D + 1) f32 buffer whose row ``data_rank`` holds ``[o, lse]`` (exact:
    each entry meets only zeros), then ``merge_parts`` in rank order. No
    gradient: serving runs under ``inference_mode``."""
    d, r = ctx.data_size, ctx.data_rank
    D = o.shape[-1]
    buf = o.new_zeros((d,) + tuple(o.shape[:-1]) + (D + 1,),
                      dtype=torch.float32)
    buf[r, ..., :D] = o
    buf[r, ..., D] = lse
    ctx.data_sum(buf)
    return merge_parts(buf[..., :D], buf[..., D]).to(o.dtype)


def dp_active(ctx) -> bool:
    """Whether ``ctx`` has data axes of more than one rank (FSDP)."""
    return ctx is not None and ctx.mesh is not None and ctx.data_size > 1


def reduce_from_data(x, ctx):
    return _ReduceFromData.apply(x, ctx)


def gather_data_nograd(x, ctx):
    return _GatherDataNoGrad.apply(x, ctx)


def dp_enter(tree, dims, ctx, prefix=()):
    """A parameter (sub)tree of data parts (a unit, a block or a leaf) ->
    the rank's ``model`` part, where the unit starts: the leaves cut over
    the data axes (``dims["/".join(path)]``, a negative dimension:
    ``sharding.rules.fsdp_dims``) gathered whole, in one collective for
    the tree (``_GatherUnit``). ``prefix`` is the tree's path in the
    whole tree. The tree unchanged without data axes of more than one
    rank."""
    if not dp_active(ctx):
        return tree
    flat = tu.flatten(tree, tuple(prefix))
    whole = _GatherUnit.apply(ctx, tuple(dims["/".join(p)] for p, _ in flat),
                              *[t for _, t in flat])
    if not isinstance(tree, dict):
        return whole[0]
    return tu.unflatten([p[len(prefix):] for p, _ in flat], whole)


def copy_to_model(x, ctx):
    return _CopyToModel.apply(x, ctx.model_group())


def tp_local(x, ctx, split: bool):
    """A replicated tensor where the rank's own work on it starts (its
    heads' or channels' projections): its gradient is the sum of the
    ranks' (``_CopyToModel``) when ``split``."""
    return copy_to_model(x, ctx) if split else x


def reduce_from_model(x, ctx):
    return _ReduceFromModel.apply(x, ctx.model_group())


def sum_shared(w, ctx, lo: int, whole: int):
    return _SumShared.apply(w, ctx.model_group(), lo, whole)


def gather_seq(x, ctx):
    return _GatherSeq.apply(x, ctx.model_group(), ctx.model_rank,
                            ctx.model_size)


def split_seq(x, ctx):
    return _SplitSeq.apply(x, ctx.model_group(), ctx.model_rank,
                           ctx.model_size)


def all_reduce_nograd(x, ctx, op=dist.ReduceOp.SUM):
    return _AllReduceNoGrad.apply(x, op, ctx.model_group())


def sp_active(ctx) -> bool:
    """Whether ``ctx`` runs sequence parallelism (the caller resolves
    ``seq_parallel`` per sequence length: ``models/transformer.py``)."""
    return tp_active(ctx) and ctx.seq_parallel


def tp_enter(x, ctx, split: bool):
    """The input of a block's mixer or FFN. ``split``: its weights are
    this rank's part, so its work is rank-local (``_CopyToModel``).
    Under sequence parallelism ``x`` holds the rank's rows and is first
    gathered whole (the pair is the all-gather / reduce-scatter of
    Megatron's sequence parallelism)."""
    if not tp_active(ctx):
        return x
    if ctx.seq_parallel:
        x = gather_seq(x, ctx)
    return copy_to_model(x, ctx) if split else x


def tp_leave(y, ctx, split: bool):
    """The output of a block's mixer or FFN: the ranks' partials summed
    when ``split`` (``_ReduceFromModel``), then under sequence
    parallelism cut to the rank's rows."""
    if not tp_active(ctx):
        return y
    if split:
        y = reduce_from_model(y, ctx)
    return split_seq(y, ctx) if ctx.seq_parallel else y


def vocab_argmax(logits, ctx, lo: int):
    """The argmax over the last axis of vocab-sharded ``logits`` (the
    rank's columns start at global id ``lo``) across the model group:
    of equal maxima the lower id wins, as ``argmax`` does in one
    process. Two small ``all_reduce``s (max, then min)."""
    val, idx = logits.max(dim=-1)
    best = all_reduce_nograd(val, ctx, dist.ReduceOp.MAX)
    big = torch.iinfo(torch.int64).max
    cand = torch.where(val == best, idx.long() + lo,
                       torch.full_like(idx, big, dtype=torch.long))
    return all_reduce_nograd(cand, ctx, dist.ReduceOp.MIN)


def gather_vocab(logits, ctx):
    """Vocab-sharded logits (..., V/m) -> the whole (..., V) on every
    rank (a zero-padded sum ``all_reduce``): sampling at a temperature
    reads every token's probability."""
    return _all_gather_rows(logits.contiguous(), logits.dim() - 1,
                            ctx.model_group(), ctx.model_rank,
                            ctx.model_size)
