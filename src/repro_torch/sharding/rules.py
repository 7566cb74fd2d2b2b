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
so) and its data entries (FSDP: ``data_cut_dim``, ``fsdp_dims``): a
rank holds its data part of its model part of each leaf, and the model
gathers a unit's leaves whole over the data axes where the unit runs
(``sharding.collectives.dp_enter``), on the CPU's gloo ranks and on the
card alike. A decode batch the data extent does not divide
(``batch_splits``, the reference's rule) is whole on every data rank
(``batch_ctx``, ``cache_rows``), and the plan's ``__seq__`` entries cut
the attention caches' slots over the data axes instead
(``cache_slot_cut``, ``seq_block``).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

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


def _leaf_spec(s: str, shape: Tuple[int, ...], sizes: dict,
               data_axes: Tuple[str, ...], embed_tp: bool) -> Tuple:
    """``param_specs``' entries for the leaf at path ``s``."""
    if embed_tp and re.search(r"(^|/)(embed|lm_head)$", s):
        tpl = (MP, None) if s.endswith("embed") else (None, MP)
        return _resolve(tpl, shape, sizes, data_axes, shard_seq=False)
    tpl = _moe_spec(s, shape, sizes)
    if tpl is None:
        tpl = _match(s, _PARAM_RULES)
    if tpl is None:
        return ()
    return _resolve(tpl, shape, sizes, data_axes, shard_seq=False)


def param_specs(params, mesh, data_axes: Tuple[str, ...], *,
                embed_tp: bool = False):
    """The reference's placement of a parameter tree (tensors, ``meta``
    tensors or anything with a ``shape``) on ``mesh``: for each leaf a
    tuple of entries, one a dimension.

    embed_tp: the embedding's vocabulary over ``model`` and d_model
    whole, instead of (vocab -> model, d_model -> data); ``lm_head``
    likewise."""
    sizes = mesh_sizes(mesh)
    return tu.map_with_path(
        lambda path, leaf: _leaf_spec("/".join(path), tuple(leaf.shape),
                                      sizes, data_axes, embed_tp), params)


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
MLA_LEAF = re.compile(r"(^|/)attn/(wq_b|wkv_b|wo)$")
XATTN_LEAF = re.compile(r"(^|/)xattn/(wq|wk|wv|wo)$")
FFN_LEAF = re.compile(r"(^|/)(mlp|shared)/(wg|wu|wi|bi|wd)$")
VOCAB_LEAF = re.compile(r"(^|/)(embed|lm_head)$")
RG_LEAF = re.compile(r"(^|/)rg/(wgate|wa|wx|ba|bx|lam|wout)$")
MX_LEAF = re.compile(r"(^|/)mx/(wz|wq|wk|wv|wi|wf|bi|bf|gn|wdown)$")
SX_LEAF = re.compile(r"(^|/)sx/(w[zifo]|b[zifo]|bf_init|gn|r[zifo]|wout)$")
# the block kinds of ``models/transformer.py`` the cut covers
TP_KINDS = frozenset(("global", "local", "crossdec", "rglru", "mlstm",
                      "slstm"))


def tp_not_ported(cfg) -> Optional[str]:
    """The first block kind of ``cfg`` that ``tp_slice`` has no cut for,
    or None (every kind the model builds)."""
    for kind in tuple(cfg.layer_pattern) + tuple(cfg.rem_kinds):
        if kind not in TP_KINDS:
            return kind
    return None


def tp_width(whole: int, model_size: int) -> int:
    """A rank's part of ``whole`` units (recurrent channels or heads) that
    the cut splits evenly: ``whole / m`` when m > 1 divides it, else
    ``whole`` (held whole on every rank)."""
    m = model_size
    return whole // m if m > 1 and whole % m == 0 else whole


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

    def heads_cut(dim, H, KV, width, kv=False):
        # the rank's query (or kv) heads of ``width`` entries each
        heads = head_plan(H, KV, m, rank)
        if not heads.split:
            return None
        lo, n = (heads.k0, heads.nk) if kv else (heads.q0, heads.nq)
        return (nd + dim, lo * width, n * width)

    if VOCAB_LEAF.search(path):
        dim = -2 if path.endswith("embed") else -1
        return part(dim, shape[dim]) if shape[dim] % m == 0 else None
    mla = cfg.mla
    a = MLA_LEAF.search(path) if mla is not None else None
    if a:
        H, name = cfg.n_heads, a.group(2)
        width = {"wq_b": mla.qk_nope_dim + mla.qk_rope_dim,
                 "wkv_b": mla.qk_nope_dim + mla.v_head_dim,
                 "wo": mla.v_head_dim}[name]
        return heads_cut(-2 if name == "wo" else -1, H, H, width)
    a = ATTN_LEAF.search(path) or XATTN_LEAF.search(path)
    if a:
        name = a.group(2)
        H = cfg.n_heads
        KV = H if path.split("/")[-2] == "xattn" else cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        return heads_cut(-2 if name == "wo" else -1, H, KV, hd,
                         kv=name not in ("wq", "bq", "wo"))
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
    r = RG_LEAF.search(path)
    if r:
        dim = -2 if r.group(2) == "wout" else -1
        return part(dim, shape[dim]) if shape[dim] % m == 0 else None
    x = MX_LEAF.search(path) or SX_LEAF.search(path)
    if x:
        # by head: the rank's heads of ``width`` entries each
        H, name = cfg.ssm.n_heads, x.group(2)
        if H % m:
            return None
        per = H // m
        if name in ("wi", "wf", "bi", "bf") and path.split("/")[-2] == "mx":
            width, dim = 1, -1              # one gate column a head
        elif name.startswith("r"):
            width, dim = 1, -3              # (H, dh, dh)
        else:
            width = shape[-2 if name in ("wdown", "wout") else -1] // H
            dim = -2 if name in ("wdown", "wout") else -1
        return (nd + dim, rank * per * width, per * width)
    return None


def tp_cache_slice(path: str, shape: Tuple[int, ...], cfg, model_size: int,
                   rank: int) -> Optional[Tuple[int, int, int]]:
    """The part of a whole decode-cache leaf (``models/transformer.py``
    ``init_cache``'s layout) that rank ``rank`` holds, as
    ``tp_leaf_slice``: attention k / v its kv heads, a "crossdec" layer's
    cross kv its heads, an RG-LRU's ``h`` its channels, an mLSTM's ``C``
    / ``n`` / ``m`` its heads, an sLSTM's state its heads' channels; the
    latent MLA cache and the convolution states whole (``tp_slice``)."""
    m = model_size
    if m <= 1:
        return None
    parts = path.split("/")
    kinds = cfg.layer_pattern if parts[0] == "units" else cfg.rem_kinds
    kind, name, nd = kinds[int(parts[1][1:])], parts[-1], len(shape)
    if name in ("k", "v", "xk", "xv"):
        cross = name.startswith("x")
        heads = head_plan(cfg.n_heads, cfg.n_heads if cross
                          else cfg.n_kv_heads, m, rank)
        if not heads.split:
            return None
        lo, n = (heads.q0, heads.nq) if cross else (heads.k0, heads.nk)
        return (nd - 2, lo, n)
    if name == "conv" or kind not in ("rglru", "mlstm", "slstm"):
        return None
    whole = cfg.d_rnn if kind == "rglru" else cfg.ssm.n_heads
    per = tp_width(whole, m)
    if per == whole:
        return None
    if kind == "slstm":
        per *= cfg.d_model // cfg.ssm.n_heads
    dim = {"C": -3, "n": -2, "m": -1}[name] if kind == "mlstm" else -1
    return (nd + dim, rank * per, per)


def tp_slice_rank(params, cfg, model_size: int, rank: int):
    """``tp_slice`` for rank ``rank`` of a model axis of ``model_size``
    (no process group needed)."""
    if model_size <= 1:
        return params
    kind = tp_not_ported(cfg)
    if kind is not None:
        raise ValueError(f"{cfg.name}: the block kind {kind!r} has no "
                         f"tensor-parallel cut")

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
      * attention (``head_plan``; the decoder's and the whisper
        encoder's): ``wq``/``bq`` the rank's query heads' columns,
        ``wk``/``wv``/``bk``/``bv`` its kv heads', ``wo`` its query
        heads' rows; cross-attention (``xattn``, H = KV) the same;
      * MLA (H = KV): ``wq_b`` / ``wkv_b`` the rank's heads' columns,
        ``wo`` their rows;
      * ``mlp`` / ``shared``: ``wg``/``wu``/``wi``/``bi`` columns and
        ``wd`` rows of d_ff when the extent divides it, else whole;
      * ``moe`` stacks: experts (``moe_spec`` "experts") or each expert's
        F (``"ffn"``), else whole;
      * the RG-LRU (``rg``): ``wgate``/``wa``/``wx``/``ba``/``bx``/``lam``
        the rank's channels of d_rnn (columns), ``wout`` their rows, when
        the extent divides d_rnn, else whole;
      * the mLSTM (``mx``) and sLSTM (``sx``), by head when the extent
        divides the head count, else whole: the rank's heads' columns of
        ``wz``/``wq``/``wk``/``wv`` and ``w[zifo]``, entries of ``gn``,
        ``b[zifo]``, ``bf_init``, ``wi``/``wf``/``bi``/``bf`` (one gate a
        head), ``r[zifo]`` (its heads' blocks), rows of ``wdown`` and
        ``wout``;
      * every other leaf (norms, ``bd``, the router, MLA's ``wq_a``/
        ``wkv_a``/``qln``/``kvln``, ``rg/win``/``rg/conv``,
        ``mx/wup``/``mx/conv``) whole.

    Where this differs from ``param_specs``' ``model`` entries:
      * "expand" layout: ``wk``/``wv``/``bk``/``bv`` hold the rank's kv
        heads whole (the plan splits their KV·hd columns evenly, which
        cuts a head when KV < m: glm4-9b at model 4 gets 64 of a head's
        128 columns a rank), so a kv head sits on every rank whose query
        heads read it;
      * "replicate" layout: ``wq``/``wk``/``wv``/``wo`` and the biases
        whole (the plan splits any that the extent divides), so the
        attention runs whole on every rank with no collective;
      * MLA: ``wq_a`` / ``wkv_a`` whole (the plan splits their columns):
        ``qln`` / ``kvln`` are RMSNorms over the whole latent, so a rank
        holding latent columns would need an all-gather before the norm;
        every rank computes the latents whole and its heads from them;
      * ``rg/win`` / ``rg/conv`` and ``mx/wup`` / ``mx/conv`` whole (the
        plan splits their channels): the RG-LRU's gates and the mLSTM's
        q / k / i / f contract over every channel of the convolved input,
        so every rank computes it whole;
      * ``mx/wi`` / ``wf`` / ``bi`` / ``bf`` and ``sx/r[zifo]`` by head
        (the plan keeps them whole): a head's gates and recurrence feed
        that head's cell only;
      * ``sx/wout`` by rows of the rank's heads, row-parallel (the plan
        splits its columns);
      * the caches: the recurrent states of the rank's heads or channels
        (``C``/``n``/``m`` too, which the plan keeps whole), the
        convolution states whole (the plan splits their channels), as
        the convolutions run whole.

    Under data axes of d > 1 ranks (FSDP) each leaf is then cut on the
    plan's data dimension into d contiguous parts, and the rank keeps
    part ``ctx.data_rank`` (``data_cut_dim``): the rank holds 1/d of its
    model part of every leaf the plan cuts over data. ``sx/wout``'s rows
    are both axes' dimension: the data cut splits the rank's model rows.
    ``tp_gather`` inverts both cuts."""
    mine = tp_slice_rank(params, cfg, ctx.model_size, ctx.model_rank)
    return data_slice_rank(mine, cfg, ctx.model_size, ctx.data_size,
                           ctx.data_rank, embed_tp=ctx.embed_tp)


# ------------------------------------------------- the data cut (FSDP)
def data_cut_dim(path: str, shape: Tuple[int, ...], cfg, model_size: int,
                 data_size: int, *, embed_tp: bool = False) -> Optional[int]:
    """The dimension of a whole leaf that data axes of ``data_size``
    ranks cut (negative: it aligns right, so a stacked unit's leaf and
    one unit of it cut alike), or None (held whole over the data axes).

    It is the plan's data entry (``param_specs`` at data extent
    ``data_size`` and model extent ``model_size``): a dimension the
    extent does not divide stays whole. The cut splits the rank's
    length of that dimension after its model cut (``tp_leaf_slice``)
    into ``data_size`` contiguous parts; where the model cut takes the
    same dimension (``sx/wout``'s rows) and leaves a length the extent
    does not divide, the leaf stays whole over the data axes."""
    if data_size <= 1:
        return None
    spec = _leaf_spec(path, shape, {"data": data_size, MP: model_size},
                      ("data",), embed_tp)
    dims = [i for i, e in enumerate(spec) if e == "data"]
    if not dims:
        return None
    dim = dims[0]
    cut = tp_leaf_slice(path, shape, cfg, model_size, 0)
    held = cut[2] if cut is not None and cut[0] == dim else shape[dim]
    if held % data_size:
        return None
    return dim - len(shape)


@functools.lru_cache(maxsize=64)
def _fsdp_dims(cfg, model_size: int, data_size: int, embed_tp: bool) -> dict:
    from repro_torch.models import transformer as T     # lazy: a cycle
    shapes = T.init_params(None, cfg, device="meta")
    return {"/".join(p): data_cut_dim("/".join(p), tuple(t.shape), cfg,
                                      model_size, data_size,
                                      embed_tp=embed_tp)
            for p, t in tu.flatten(shapes)}


def fsdp_dims(cfg, ctx: ShardCtx) -> dict:
    """Path -> ``data_cut_dim`` of every leaf of ``cfg``'s parameter tree
    under ``ctx`` (memoized per config and extents)."""
    return _fsdp_dims(cfg, ctx.model_size, ctx.data_size, ctx.embed_tp)


def data_slice_rank(params, cfg, model_size: int, data_size: int,
                    data_rank: int, *, embed_tp: bool = False):
    """A tree of a rank's model parts -> its data parts: each leaf that
    ``data_cut_dim`` cuts narrowed to part ``data_rank`` of ``data_size``
    (copies); the others as they are. No process group needed."""
    if data_size <= 1:
        return params
    dims = _fsdp_dims(cfg, model_size, data_size, embed_tp)

    def one(path, leaf):
        dim = dims["/".join(path)]
        if dim is None:
            return leaf
        n = leaf.shape[dim] // data_size
        return leaf.narrow(dim, data_rank * n, n).clone()
    return tu.map_with_path(one, params)


def data_rows(n: int, ctx: ShardCtx) -> slice:
    """This rank's contiguous block of a batch of ``n`` rows over the data
    axes (``ctx.data_rank``'s of ``ctx.data_size`` equal blocks; every
    row without data axes of more than one rank). A batch the extent
    does not divide raises ``ValueError`` (the reference's
    ``data_shardings`` would keep it whole on every rank, which FSDP's
    loss, a mean over the whole batch, does not do; the reference's
    train shapes all divide). Serving such a batch: ``cache_rows``."""
    d = ctx.data_size
    if d <= 1:
        return slice(0, n)
    if n % d:
        raise ValueError(f"a batch of {n} rows does not split over data "
                         f"axes {tuple(ctx.data_axes)} of {d} ranks")
    per = n // d
    return slice(ctx.data_rank * per, (ctx.data_rank + 1) * per)


def batch_splits(n: int, ctx: ShardCtx) -> bool:
    """Whether a batch of ``n`` rows splits over ``ctx``'s data axes: the
    reference's rule (``launch/specs.py`` ``data_shardings``), their
    extent d divides ``n`` and ``n >= d``; always without data axes of
    more than one rank."""
    d = ctx.data_size
    return d <= 1 or (n % d == 0 and n >= d)


def batch_ctx(n: int, ctx: ShardCtx) -> ShardCtx:
    """``ctx`` for serving a batch of ``n`` rows: ``batch_whole`` where
    the data axes do not split it (``batch_splits``). Every data rank
    then serves every row, and the plan's ``__seq__`` entries cut the
    attention caches' slots over the data axes instead
    (``cache_slot_cut``)."""
    whole = not batch_splits(n, ctx)
    if whole == ctx.batch_whole:
        return ctx
    return dataclasses.replace(ctx, batch_whole=whole)


def cache_rows(n: int, ctx: ShardCtx) -> slice:
    """The rows of a decode batch of ``n`` this rank serves: its
    ``data_rows`` where the data axes split the batch
    (``batch_splits``), else every row (the reference's long-context
    decode at B = 1: its caches' slots are cut instead)."""
    if not batch_splits(n, ctx):
        return slice(0, n)
    return data_rows(n, ctx)


def seq_block(n_slots: int, ctx: ShardCtx) -> Tuple[int, int]:
    """``[lo, hi)`` of a sequence-split cache leaf's ``n_slots`` slots
    that this rank holds: under ``ctx.batch_whole``, block ``data_rank``
    of ``data_size`` contiguous equal blocks where the extent divides
    ``n_slots`` (``_resolve``'s divisibility); every slot otherwise. A
    ring's blocks are blocks of its slots (slot = position % ring)."""
    d = ctx.data_size
    if not ctx.batch_whole or d <= 1 or n_slots <= 0 or n_slots % d:
        return 0, n_slots
    per = n_slots // d
    return ctx.data_rank * per, (ctx.data_rank + 1) * per


def cache_slot_cut(path: str, shape: Tuple[int, ...], ctx: ShardCtx
                   ) -> Optional[Tuple[int, int, int]]:
    """The slot cut of a whole decode-cache leaf (``init_cache``'s layout,
    ``path`` its path in the cache tree) on this rank, ``(dim, lo, hi)``,
    or None where the rank holds every slot: under ``ctx.batch_whole``
    the ``__seq__`` entry of ``_CACHE_RULES`` (attention ``k`` / ``v``,
    MLA ``ckv`` / ``krope``) at the dimension ``cache_specs(...,
    batch_shardable=False)`` gives the data axes, ``seq_block`` of it."""
    if not ctx.batch_whole:
        return None
    tpl = _match(path, _CACHE_RULES)
    if tpl is None or "__seq__" not in tpl:
        return None
    dim = (1 if path.startswith("units") else 0) + tpl.index("__seq__")
    lo, hi = seq_block(shape[dim], ctx)
    return None if hi - lo == shape[dim] else (dim, lo, hi)


def _owned(cuts, rank: int) -> Optional[Tuple[int, int]]:
    """[lo, hi) of rank ``rank``'s cut (``cuts[r] = (dim, start,
    length)``) that no lower rank holds: a column several ranks hold (the
    "expand" layout's kv heads) is taken from its first holder. None when
    every column is a lower rank's."""
    _, start, length = cuts[rank]
    lo = max([start] + [c[1] + c[2] for c in cuts[:rank] if c is not None])
    return (lo, start + length) if lo < start + length else None


def tp_gather_part(leaf, key: str, shape: Tuple[int, ...], cfg,
                   model_size: int, rank: int):
    """Rank ``rank``'s share of ``tp_gather`` for one leaf: a zero f32
    buffer of the whole leaf's ``shape`` holding the columns of its part
    ``leaf`` that no lower rank holds (``_owned``); their sum over the
    ranks is the whole leaf. None for a leaf the rank holds whole."""
    m = model_size
    cuts = [tp_leaf_slice(key, shape, cfg, m, r) for r in range(m)]
    if cuts[rank] is None:
        return None
    dim, start, _ = cuts[rank]
    buf = torch.zeros(shape, dtype=torch.float32, device=leaf.device)
    own = _owned(cuts, rank)
    if own is not None:
        lo, hi = own
        buf.narrow(dim, lo, hi - lo).copy_(leaf.narrow(dim, lo - start,
                                                       hi - lo))
    return buf


def tp_gather(params, ctx: ShardCtx, cfg, whole):
    """The inverse of ``tp_slice``: this rank's part -> the whole tree on
    every rank of ``ctx``'s mesh; ``whole`` gives the whole leaves'
    shapes (e.g. ``init_params(None, cfg, device="meta")``). A leaf cut
    over the data axes is first gathered over them (a zero-padded sum,
    ``collectives.gather_padded``; exact in any dtype, each entry meets
    only zeros), which gives the rank's model part. A leaf cut over
    ``model`` is then gathered by one zero-padded sum ``all_reduce``
    over the model group (gloo has no all-gather for CUDA tensors), each
    column written by one holder (``tp_gather_part``) in f32 (exact for
    a bf16 leaf, whose sum meets only zeros); a leaf held whole is every
    rank's own. ``tp_slice`` of the result gives each rank its part bit
    for bit."""
    if ctx.mesh is not None and ctx.data_size > 1:
        from repro_torch.sharding.collectives import gather_padded
        dims = fsdp_dims(cfg, ctx)
        params = tu.map_with_path(
            lambda path, leaf: leaf if dims["/".join(path)] is None else
            gather_padded(leaf.contiguous(), dims["/".join(path)],
                          ctx.data_rank, ctx.data_size, ctx.data_sum),
            params)
    m = ctx.model_size
    if m <= 1:
        return params
    shapes = {"/".join(p): tuple(s.shape) for p, s in tu.flatten(whole)}

    def one(path, leaf):
        key = "/".join(path)
        buf = tp_gather_part(leaf, key, shapes[key], cfg, m, ctx.model_rank)
        if buf is None:
            return leaf
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ctx.model_group())
        return buf.to(leaf.dtype)
    return tu.map_with_path(one, params)
