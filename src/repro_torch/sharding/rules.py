"""Sharding rules (the JAX package's ``sharding/rules.py``): the
client-axis divisibility rule and cohort mesh, the reference's placement
plan (``param_specs`` / ``cache_specs``), the head layouts, and the cut
of a whole parameter tree to one rank's part under tensor and expert
parallelism over ``model`` (``tp_slice``, ``expert_slice``) and its
inverse (``tp_gather``, what a checkpoint writes).

A stacked client spec is the tuple of mesh dimension names a leading
axis is split over; ``()`` means replicated (the reference's ``P()``).
The placement plan is the reference's, entry for entry: for each leaf a
tuple with one entry per dimension, a mesh axis name, a tuple of names
or ``None`` (the reference's ``PartitionSpec`` entries). It is computed
from axis sizes alone (a ``DeviceMesh`` or a mapping of names to sizes),
so it needs no process group. The port executes its ``model`` entries
(``tp_slice``; where the executed slice differs, its docstring says
so); its data entries (FSDP) are computed, not executed.
"""
from __future__ import annotations

import re
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import not_ported
from repro_torch import tree as tu
from repro_torch.sharding.ctx import ShardCtx, axis_size

EXPERT_LEAF = re.compile(r"(^|/)moe/(wg|wu|wd)$")


def stacked_client_spec(mesh, client_axes: Tuple[str, ...],
                        n_clients: int) -> Tuple[str, ...]:
    """The split of a unified cohort's leading K (client) axis: over
    ``client_axes`` when K divides their extent, else replicated (``()``)
    — the divisibility rule the reference applies to every dimension."""
    if mesh is None or not client_axes:
        return ()
    extent = 1
    for a in client_axes:
        extent *= axis_size(mesh, a)
    if extent <= 1 or n_clients % extent != 0:
        return ()
    return tuple(client_axes)


def cohort_mesh(n_clients: int, *, axis: str = "clients",
                device_type: Optional[str] = None):
    """1-D ``DeviceMesh`` for splitting a K-client unified cohort over the
    ranks of the initialised process group: the largest rank count n
    that divides K (ranks 0..n-1), with dimension ``axis``. Returns None
    when only one rank would take part (no process group, world size 1,
    or no n > 1 divides K).

    Building the mesh makes its process group, which every rank of the
    default group must join: call this on every rank. A rank at or past
    n is outside the mesh and gets None; given None, the engine runs the
    whole cohort there on its own (the same round, computed once more),
    so every rank ends with the same globals. ``device_type`` defaults
    to "cuda" when a card is present, else "cpu"."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    n = world
    while n > 1 and n_clients % n != 0:
        n -= 1
    if n <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis,))
    return mesh if dist.get_rank() < n else None


def moe_spec(n_experts: int, model_size: int, d_ff_expert: int = 0) -> str:
    """Placement of a MoE block's expert stacks (``wg``/``wu``/``wd``), the
    reference's ``_moe_spec``: "experts" (expert-parallel: E over
    ``model``) when E divides the model extent; else "ffn" (each
    expert's F axis over ``model``) when F does; else "whole" (every rank
    holds every expert whole)."""
    if model_size <= 1:
        return "whole"
    if n_experts % model_size == 0:
        return "experts"
    if d_ff_expert and d_ff_expert % model_size == 0:
        return "ffn"
    return "whole"


def expert_slice(params, ctx: ShardCtx, n_experts: int):
    """A whole parameter tree -> this rank's part under ``ctx``: every
    expert stack (a ``moe/wg|wu|wd`` leaf, experts on axis -3, stacked
    units or not) cut to the rank's ``E/m`` experts
    ``[rank·E/m, (rank+1)·E/m)`` (copies, so the whole tree can be freed);
    every other leaf as it is. Under an expert-parallel-free ctx the tree
    comes back unchanged."""
    m = ctx.model_size
    if moe_spec(n_experts, m) != "experts":
        return params
    per = n_experts // m
    lo = ctx.model_rank * per

    def one(path, leaf):
        if EXPERT_LEAF.search("/".join(path)):
            assert leaf.shape[-3] == n_experts, (path, leaf.shape)
            return leaf.narrow(leaf.dim() - 3, lo, per).clone()
        return leaf
    return tu.map_with_path(one, params)


# ------------------------------------------------ the reference's plan
DP = "__data__"          # placeholder replaced by the mesh's data axes
MP = "model"

# (path regex, spec template over the LAST len(template) dims; leading
# dims -- the stacked-units axis, the expert axis handled explicitly --
# are replicated)
_PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embed$", (MP, DP)),
    (r"lm_head$", (DP, MP)),
    (r"attn/(wq|wk|wv)$", (DP, MP)),
    (r"attn/(bq|bk|bv)$", (MP,)),
    (r"attn/wo$", (MP, DP)),
    (r"xattn/(wq|wk|wv)$", (DP, MP)),
    (r"xattn/wo$", (MP, DP)),
    (r"attn/(wq_a|wkv_a)$", (DP, MP)),          # MLA down-projections
    (r"attn/(wq_b|wkv_b)$", (None, MP)),        # lora rank small: replicate
    (r"attn/(qln|kvln)$", (None,)),
    (r"(mlp|shared)/(wg|wu|wi)$", (DP, MP)),
    (r"(mlp|shared)/bi$", (MP,)),
    (r"(mlp|shared)/wd$", (MP, DP)),
    (r"(mlp|shared)/bd$", (None,)),
    (r"moe/router$", (None, None)),
    (r"moe/router_b$", (None,)),
    # E -> model when E divides the model axis, else F -> model: resolved
    # in ``_moe_spec``; these templates are the expert-parallel default
    (r"moe/(wg|wu)$", (MP, DP, None)),
    (r"moe/wd$", (MP, None, DP)),
    (r"rg/(win|wgate)$", (DP, MP)),
    (r"rg/conv$", (None, MP)),
    (r"rg/(ba|bx|lam)$", (MP,)),
    (r"rg/(wa|wx)$", (DP, MP)),
    (r"rg/wout$", (MP, DP)),
    (r"mx/(wup|wz|wq|wk|wv)$", (DP, MP)),
    (r"mx/conv$", (None, MP)),
    (r"mx/(wi|wf)$", (DP, None)),
    (r"mx/(bi|bf)$", (None,)),
    (r"mx/gn$", (MP,)),
    (r"mx/wdown$", (MP, DP)),
    (r"sx/(w[zifo])$", (DP, MP)),
    (r"sx/(b[zifo]|bf_init|gn)$", (MP,)),
    (r"sx/(r[zifo])$", (None, None, None)),     # (H, dh, dh): H tiny
    (r"sx/wout$", (DP, MP)),
    (r"(ln1|ln2|lnx|final_ln)$", (None,)),
)

# cache / state leaves (base shapes, before the stacked-units axis):
#   attention k/v (B, S, KV, hd); MLA ckv (B, S, r), krope (B, S, rope);
#   cross xk/xv (B, T, H, hd); rg h (B, R), conv (B, cw-1, R); mlstm C
#   (B, H, dh, dh), n (B, H, dh), m (B, H), conv; slstm c/n/m/h (B, D)
_CACHE_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"/(k|v)$", (DP, "__seq__", MP, None)),
    (r"/(xk|xv)$", (DP, None, MP, None)),
    (r"/ckv$", (DP, "__seq__", None)),
    (r"/krope$", (DP, "__seq__", None)),
    (r"conv$", (DP, None, MP)),
    (r"/C$", (DP, None, None, None)),
    (r"/(n|m)$", (DP, None, None)),
    (r"/(c|h)$", (DP, MP)),
)


def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` or of a mapping of names to
    sizes."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}


def _resolve(template: Tuple, shape: Tuple[int, ...], sizes: dict,
             data_axes: Tuple[str, ...], *, shard_seq: bool,
             align: str = "right", stack_offset: int = 0) -> Tuple:
    """Apply a spec template to ``shape``. Params align right (templates
    describe trailing dims under a stacked-units axis); caches align left
    starting after ``stack_offset`` leading axes. A dimension its axes'
    extent does not divide stays whole (``None``)."""
    ndim = len(shape)
    entries: list = [None] * ndim
    if align == "right":
        off = ndim - len(template)
        if off < 0:
            raise ValueError(f"template {template} longer than {shape}")
        pairs = [(off + i, t) for i, t in enumerate(template)]
    else:
        pairs = [(stack_offset + i, t) for i, t in enumerate(template)
                 if stack_offset + i < ndim]
    for dim, t in pairs:
        if t is None:
            continue
        if t == "__seq__":
            if shard_seq and data_axes:
                t = DP
            else:
                continue
        axes = tuple(data_axes) if t == DP else (t,)
        if not axes:
            continue
        extent = 1
        for a in axes:
            extent *= sizes[a]
        if shape[dim] % extent == 0 and shape[dim] > 0:
            entries[dim] = axes if len(axes) > 1 else axes[0]
    return tuple(entries)


def _match(path: str, rules) -> Optional[Tuple]:
    for pat, tpl in rules:
        if re.search(pat, path):
            return tpl
    return None


def _moe_spec(path: str, shape: Tuple[int, ...], sizes: dict) -> Optional[Tuple]:
    """Expert stacks: expert-parallel when E divides the model axis, else
    tensor-parallel on the expert F dim."""
    m = re.search(r"moe/(wg|wu|wd)$", path)
    if not m:
        return None
    if shape[-3] % sizes[MP] == 0:
        return (MP, DP, None) if m.group(1) in ("wg", "wu") else (MP, None, DP)
    return (None, DP, MP) if m.group(1) in ("wg", "wu") else (None, MP, DP)


def param_specs(params, mesh, data_axes: Tuple[str, ...], *,
                embed_tp: bool = False):
    """The reference's placement of a parameter tree (tensors, ``meta``
    tensors or anything with a ``shape``) on ``mesh``: for each leaf a
    tuple of entries, one a dimension.

    embed_tp: the embedding's vocabulary over ``model`` and d_model
    whole, instead of (vocab -> model, d_model -> data); ``lm_head``
    likewise."""
    sizes = mesh_sizes(mesh)

    def one(path, leaf):
        s = "/".join(path)
        shape = tuple(leaf.shape)
        if embed_tp and re.search(r"(^|/)(embed|lm_head)$", s):
            tpl = (MP, None) if s.endswith("embed") else (None, MP)
            return _resolve(tpl, shape, sizes, data_axes, shard_seq=False)
        tpl = _moe_spec(s, shape, sizes)
        if tpl is None:
            tpl = _match(s, _PARAM_RULES)
        if tpl is None:
            return ()
        return _resolve(tpl, shape, sizes, data_axes, shard_seq=False)
    return tu.map_with_path(one, params)


def cache_specs(cache, mesh, data_axes: Tuple[str, ...], *,
                batch_shardable: bool):
    """The reference's placement of a decode cache. When the batch is too
    small to split the sequence dim takes the data axes instead
    (``__seq__`` entries)."""
    sizes = mesh_sizes(mesh)

    def one(path, leaf):
        s = "/".join(path)
        shape = tuple(leaf.shape)
        tpl = _match(s, _CACHE_RULES)
        if tpl is None:
            return ()
        return _resolve(tpl, shape, sizes, data_axes,
                        shard_seq=not batch_shardable, align="left",
                        stack_offset=1 if s.startswith("units") else 0)
    return tu.map_with_path(one, cache)


# ------------------------------------------------------- head layouts
def head_layout(H: int, KV: int, model_size: int) -> str:
    """How attention heads map onto the model axis (the reference's):
      'kv'        — KV % m == 0: KV/m kv heads a rank, with their G query
                    heads each; no collective inside the attention;
      'expand'    — else H % m == 0: H/m query heads a rank, k/v repeated
                    to them (G = 1);
      'replicate' — neither divides: every head on every rank;
      'single'    — one rank."""
    if model_size <= 1:
        return "single"
    if KV % model_size == 0:
        return "kv"
    if H % model_size == 0:
        return "expand"
    return "replicate"


class Heads(NamedTuple):
    """The attention heads one rank computes: query heads ``[q0, q0 +
    nq)`` and kv heads ``[k0, k0 + nk)`` of a layer of ``H`` query heads
    on ``KV`` kv heads (``group`` = H / KV query heads a kv head)."""
    layout: str
    H: int
    KV: int
    q0: int
    nq: int
    k0: int
    nk: int

    @property
    def group(self) -> int:
        return self.H // self.KV

    @property
    def split(self) -> bool:
        return self.nq < self.H

    def kv_index(self) -> list:
        """For each of the rank's query heads, its kv head's index among
        the rank's kv heads."""
        return [(self.q0 + i) // self.group - self.k0
                for i in range(self.nq)]

    @property
    def uniform(self) -> bool:
        """Whether the rank's query heads are ``nk`` equal groups of
        ``nq / nk`` consecutive heads, one kv head each (then the
        attention runs at KV = nk, G = nq / nk without repeating k/v)."""
        if self.nq % self.nk:
            return False
        g = self.nq // self.nk
        return self.kv_index() == [i // g for i in range(self.nq)]

    @property
    def shared(self) -> bool:
        """Whether another rank holds one of this rank's kv heads too
        (their gradients are summed over the holders)."""
        return self.split and self.nq < self.nk * self.group


def head_plan(H: int, KV: int, model_size: int, rank: int) -> Heads:
    """Rank ``rank``'s heads under ``head_layout``. The plan is
    head-aligned: under "expand" the rank holds the kv heads its query
    heads read, under "replicate" every head (``tp_slice``)."""
    layout = head_layout(H, KV, model_size)
    G = H // KV
    if layout == "kv":
        nq, nk = H // model_size, KV // model_size
        return Heads(layout, H, KV, rank * nq, nq, rank * nk, nk)
    if layout == "expand":
        nq = H // model_size
        q0 = rank * nq
        k0, k1 = q0 // G, (q0 + nq - 1) // G + 1
        return Heads(layout, H, KV, q0, nq, k0, k1 - k0)
    return Heads(layout, H, KV, 0, H, 0, KV)


# ------------------------------------------------- the executed slice
ATTN_LEAF = re.compile(r"(^|/)attn/(wq|wk|wv|wo|bq|bk|bv)$")
FFN_LEAF = re.compile(r"(^|/)(mlp|shared)/(wg|wu|wi|bi|wd)$")
VOCAB_LEAF = re.compile(r"(^|/)(embed|lm_head)$")


def tp_not_ported(cfg) -> Optional[Tuple[str, str]]:
    """(what, ROADMAP item) of the first block of ``cfg`` that tensor
    parallelism does not cover yet, or None."""
    kinds = set(cfg.layer_pattern) | set(cfg.rem_kinds)
    item = "item 4, tensor parallelism for the rest of the model: {}"
    if cfg.mla is not None:
        return "MLA attention", item.format("MLA")
    if kinds & {"rglru", "mlstm", "slstm"}:
        return "a recurrent block", item.format("the recurrent blocks")
    if "crossdec" in kinds or cfg.encoder is not None:
        return ("cross-attention and the whisper encoder",
                item.format("cross-attention and the encoder"))
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        return "the vision prefix", item.format("the vision prefix")
    return None


def require_tp_ported(cfg, model_size: int) -> None:
    """Raise ``not_ported`` for a config with a block tensor parallelism
    does not cover, under a model axis of more than one rank."""
    if model_size <= 1:
        return
    miss = tp_not_ported(cfg)
    if miss is not None:
        raise not_ported(f"{cfg.name}: {miss[0]} under a model axis of "
                         f"{model_size} ranks", miss[1])


def tp_leaf_slice(path: str, shape: Tuple[int, ...], cfg, model_size: int,
                  rank: int) -> Optional[Tuple[int, int, int]]:
    """The part of a whole leaf that rank ``rank`` of a model axis of
    ``model_size`` holds: ``(dim, start, length)``, or None (the leaf
    whole). Dimensions align right, so a stacked unit's leaf (a leading
    ``n_units`` axis) cuts as an unstacked one."""
    m = model_size
    if m <= 1:
        return None
    nd = len(shape)

    def part(dim, whole):
        per = whole // m
        return (nd + dim, rank * per, per)

    if VOCAB_LEAF.search(path):
        dim = -2 if path.endswith("embed") else -1
        return part(dim, shape[dim]) if shape[dim] % m == 0 else None
    a = ATTN_LEAF.search(path)
    if a:
        heads = head_plan(cfg.n_heads, cfg.n_kv_heads, m, rank)
        if not heads.split:
            return None
        hd = cfg.resolved_head_dim
        name = a.group(2)
        if name == "wo":
            return (nd - 2, heads.q0 * hd, heads.nq * hd)
        if name in ("wq", "bq"):
            return (nd - 1, heads.q0 * hd, heads.nq * hd)
        return (nd - 1, heads.k0 * hd, heads.nk * hd)
    f = FFN_LEAF.search(path)
    if f:
        dim = -2 if f.group(3) == "wd" else -1
        return part(dim, shape[dim]) if shape[dim] % m == 0 else None
    e = EXPERT_LEAF.search(path)
    if e:
        ffn_dim = -2 if e.group(2) == "wd" else -1
        spec = moe_spec(shape[-3], m, shape[ffn_dim])
        if spec == "experts":
            return part(-3, shape[-3])
        if spec == "ffn":
            return part(ffn_dim, shape[ffn_dim])
    return None


def tp_slice_rank(params, cfg, model_size: int, rank: int):
    """``tp_slice`` for rank ``rank`` of a model axis of ``model_size``
    (no process group needed)."""
    if model_size <= 1:
        return params
    require_tp_ported(cfg, model_size)

    def one(path, leaf):
        cut = tp_leaf_slice("/".join(path), tuple(leaf.shape), cfg,
                            model_size, rank)
        if cut is None:
            return leaf
        return leaf.narrow(*cut).clone()
    return tu.map_with_path(one, params)


def tp_slice(params, ctx: ShardCtx, cfg):
    """A whole parameter tree -> this rank's part under ``ctx``'s model
    axis (copies, so the whole tree can be freed); the tree unchanged
    without a model axis of more than one rank. The cut follows the
    plan's ``model`` entries, made head-aligned:

      * ``embed`` / ``lm_head``: the vocabulary (rows / columns) when
        the model extent divides it, else whole;
      * attention (``head_plan``): ``wq``/``bq`` the rank's query heads'
        columns, ``wk``/``wv``/``bk``/``bv`` its kv heads', ``wo`` its
        query heads' rows;
      * ``mlp`` / ``shared``: ``wg``/``wu``/``wi``/``bi`` columns and
        ``wd`` rows of d_ff when the extent divides it, else whole;
      * ``moe`` stacks: experts (``moe_spec`` "experts") or each expert's
        F (``"ffn"``), else whole;
      * every other leaf (norms, ``bd``, the router) whole.

    Where this differs from ``param_specs``' ``model`` entries:
      * "expand" layout: ``wk``/``wv``/``bk``/``bv`` hold the rank's kv
        heads whole (the plan splits their KV·hd columns evenly, which
        cuts a head when KV < m: glm4-9b at model 4 gets 64 of a head's
        128 columns a rank), so a kv head sits on every rank whose query
        heads read it;
      * "replicate" layout: ``wq``/``wk``/``wv``/``wo`` and the biases
        whole (the plan splits any that the extent divides), so the
        attention runs whole on every rank with no collective.
    The plan's data entries (FSDP) are not executed: a data axis of more
    than one rank raises ``not_ported``."""
    for a in ctx.data_axes:
        if ctx.mesh is not None and axis_size(ctx.mesh, a) > 1:
            raise not_ported(f"FSDP over the data axis {a!r}",
                             "item 4, tensor parallelism for the rest of "
                             "the model: FSDP over the data axes")
    return tp_slice_rank(params, cfg, ctx.model_size, ctx.model_rank)


def _owned(cuts, rank: int) -> Optional[Tuple[int, int]]:
    """[lo, hi) of rank ``rank``'s cut (``cuts[r] = (dim, start,
    length)``) that no lower rank holds: a column several ranks hold (the
    "expand" layout's kv heads) is taken from its first holder. None when
    every column is a lower rank's."""
    _, start, length = cuts[rank]
    lo = max([start] + [c[1] + c[2] for c in cuts[:rank] if c is not None])
    return (lo, start + length) if lo < start + length else None


def tp_gather(params, ctx: ShardCtx, cfg, whole):
    """The inverse of ``tp_slice``: this rank's part -> the whole tree on
    every rank of ``ctx``'s model axis; ``whole`` gives the whole leaves'
    shapes (e.g. ``init_params(None, cfg, device="meta")``). A cut leaf
    is gathered by one zero-padded sum ``all_reduce`` over the model
    group (gloo has no all-gather for CUDA tensors), each column written
    by one holder (``_owned``) in f32 (exact for a bf16 leaf, whose sum
    meets only zeros); a leaf held whole is every rank's own.
    ``tp_slice`` of the result gives each rank its part bit for bit."""
    m = ctx.model_size
    if m <= 1:
        return params
    shapes = {"/".join(p): tuple(s.shape) for p, s in tu.flatten(whole)}
    me = ctx.model_rank

    def one(path, leaf):
        key = "/".join(path)
        cuts = [tp_leaf_slice(key, shapes[key], cfg, m, r) for r in range(m)]
        if cuts[me] is None:
            return leaf
        dim, start, _ = cuts[me]
        buf = torch.zeros(shapes[key], dtype=torch.float32,
                          device=leaf.device)
        own = _owned(cuts, me)
        if own is not None:
            lo, hi = own
            buf.narrow(dim, lo, hi - lo).copy_(
                leaf.narrow(dim, lo - start, hi - lo))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ctx.model_group())
        return buf.to(leaf.dtype)
    return tu.map_with_path(one, params)
