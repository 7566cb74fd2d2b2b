"""Cohort-parallel unified FL engine on the packed parameter plane.

NetChange embeds every heterogeneous client into the cohort's union
architecture, so a whole federated round runs as ONE stacked program
instead of a Python loop over clients:

  * client k's model = the global architecture with a constant *filler*
    on the parameters the client doesn't have (identity convs for VGG —
    whatever ``up()`` inserts) and a 0/1 *trainable mask* on the ones it
    does; width heterogeneity adds the *segment operators* of
    ``core.segments`` (``up()`` is linear: ``u = E p + filler``),
  * round state lives on a contiguous ``(K, P)`` f32 plane
    (``core.plane``); masks, filler, coverage and multiplicity are
    row-aligned planes, participant gathers are row slices, and the
    depth-only round start is the fused ``g·m + f·(1−m)``,
  * local training is ``torch.func.vmap(grad(loss))`` over the plane's
    unpacked views, gradients transformed by ``E Eᵀ`` (segment sums,
    1/c² on Net2Net split axes) and mask-projected on the plane, then an
    SGD(+momentum) update written IN PLACE into the plane — union-space
    SGD equals client-shape SGD,
  * aggregation is ONE pass of a hand-written CUDA kernel over the plane
    (``kernels/fedavg``: ``weighted_sum`` for Eq. 1, ``plane_agg`` for
    the coverage average), or — for large cohorts — the streaming pair
    ``plane_accum`` (per ``k_chunk`` rows, in place) + ``plane_finish``.

Compressed wire (``wire="bf16" | "int8"``, ``core.quant``): each trained
chunk is encoded with error feedback — a per-client residual plane
``(K, P)`` f32 carries what quantization dropped into the next round —
and aggregated as it would arrive: an int8 chunk through the fused
dequantize-accumulate kernel ``plane_accum_q``, a bf16 chunk through
``plane_accum`` as it is. A compressed round always streams.
``wire_sparse`` ships only covered coordinates (``agg_mode="coverage"``).

Partial participation runs the round on the ``selected`` rows, weights
renormalized over the subset, per-client rows scattered back.

Client-axis mesh (``mesh``, a ``DeviceMesh`` with ``client_axes``; SPMD
over ``torch.distributed``, every rank running the same round): when the
participants split over the client axes, rank r holds the contiguous
rows ``CohortCtx.edge_groups(ks)[r]``: it uploads only its rows' batches,
runs their round start and local training (no collective), and reduces
them to one partial with the GLOBAL subset weights; one ``all_reduce``
(sum) over the client axes is the global reduce, so every rank ends the
round with the same state. Participants that do not split take the flat
round on every rank. Per method:

  * fedadp: the partial is the ``(num, den, cov)`` triple
    (``plane_accum``: the plane layout in one launch, the stream layout
    chunk by chunk), closed by one ``plane_finish``. A compressed wire
    encodes each rank's rows with their residual rows: a client's
    residual row lives on the rank that last encoded it (``_wire_owner``),
    and a round moves only the rows of participants that changed rank
    (``_place_residuals``, one zero-padded ``all_reduce``);
  * clustered / flexifed: one partial sum per (cluster ∩ participants)
    and, for FlexiFed, the prefix's over all participants
    (``core.aggregation.group_partials``), stacked into one ``all_reduce``;
    every rank writes the averages onto the participants' rows;
  * standalone: the trained rows reach every rank
    (``CohortCtx.gather_rows``).
The per-client state ends every round replicated: the whole ``(K, P)``
plane on every rank, as fedadp's globals are.

Methods: ``fedadp`` (filler "zero" | "global", agg_mode "filler" |
"coverage"), and the per-client-state baselines ``clustered`` (one
``weighted_sum`` pass per architecture cluster ∩ participants, broadcast
back onto its rows), ``flexifed`` (the VGG chain's common prefix is a
COLUMN mask on the plane, ``PlaneSpec.col_mask``: one more
``weighted_sum`` over all participants, substituted on the prefix
columns) and ``standalone``. Per-client state is the stacked tree of the
clients embedded at the fixed ``embed_seed`` (``embed``), so
same-architecture clients share one mapping and cluster and prefix
averages commute with the embedding. Cohorts: depth- and
width-heterogeneous (segment-representable), of any family whose
``loss_and_grad`` is a ``torch.func`` gradient (or a ``loss_fn`` under
the union config): VGG, and dense transformers, whose attention backend
``attn_backend`` selects ("auto": the flash CUDA kernels on CUDA tensors;
"flash" / "blockwise" force one).

Float32 is strict: the engine turns TF32 off for cuDNN and cuBLAS and
takes cuDNN's deterministic algorithms (``device.strict_f32``) when it
runs on CUDA. A family may set ``client_chunk``, the clients a vmapped
training chunk holds: VGG sets 1, so each client's convolutions run in
the shapes and algorithms the per-client loop runs (grouped and
ungrouped cuDNN convolutions round a full-width VGG's f32 gradients
differently, by up to ~2% of a leaf's largest entry).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch import tree as tu
from repro_torch.core import plane, quant
from repro_torch.core import segments as sg
from repro_torch.core.aggregation import (AGG_MODES, COVERAGE_POLICIES,
                                          client_weights,
                                          coverage_and_filler,
                                          default_k_chunk, finish_partials,
                                          global_shapes, group_partials,
                                          loosen,
                                          plane_partials, resolve_agg_layout,
                                          stack_trees, subset_weights)
from repro_torch.core.baselines import _cluster_ids
from repro_torch.core.netchange import (KeyedCache, NARROW_MODES,
                                        round_embed_seed)
from repro_torch.device import DeviceLike, resolve_device, strict_f32
from repro_torch.kernels.fedavg import ops as kops
from repro_torch.optim import sgd
from repro_torch.sharding.ctx import CohortCtx, ShardCtx

ENGINE_LAYOUTS = ("auto", "plane", "stream")
ENGINE_METHODS = ("fedadp", "clustered", "flexifed", "standalone")
WIRE_FORMATS = quant.WIRE_FORMATS
COMPUTE_DTYPES = ("f32", "bf16")
ATTN_BACKENDS = ("auto", "flash", "blockwise")


def client_embedding(family, client_cfgs: Sequence, global_cfg, *,
                     seed: int = 0, device=None):
    """Stacked (strict masks, filler) for embedding a cohort into
    ``global_cfg``: per-client trees from
    ``core.aggregation.coverage_and_filler``, stacked on a leading K
    axis."""
    pairs = [coverage_and_filler(family, cfg, global_cfg, seed=seed,
                                 device=device) for cfg in client_cfgs]
    return (stack_trees([m for m, _ in pairs]),
            stack_trees([f for _, f in pairs]))


def _fused_round_start(gp, m_rows, f_rows):
    """Depth-only round start: ``up(down(g))`` is literally ``g·m +
    f·(1−m)`` there. The mask and filler rows are views of the (U, P)
    planes, read row by row into the (K, P) output, so the round start
    holds one (P,) temporary beside it."""
    out = torch.empty((len(m_rows), gp.numel()), dtype=gp.dtype,
                      device=gp.device)
    for o, m, f in zip(out, m_rows, f_rows):
        torch.mul(f, 1.0 - m, out=o)
        o.addcmul_(gp, m)
    return out


def _fold_rows(sp, cov_p, gp):
    """filler_mode="global" on gathered rows: the server's current values
    on the coordinates a client does not cover."""
    return sp * cov_p + gp[None, :] * (1.0 - cov_p)


def _plane_agg_fused(sp, w, cov_p, mult_p, gp, *, renorm: bool,
                     fold_global: bool):
    """The whole (sub-)plane aggregation: ``fold_global`` substitutes
    filler_mode="global"'s uncovered coordinates first, then ONE
    ``plane_agg`` pass."""
    if fold_global:
        sp = _fold_rows(sp, cov_p, gp)
        cov_p = mult_p = gp = None
    return kops.plane_agg(sp, w, masks=cov_p, mult=mult_p, fallback=gp,
                          renorm=renorm)


@dataclass
class UnifiedEngine:
    """Runs FL rounds in the packed unified space. See module docstring.
    ``device=None`` means CUDA (raises without a card)."""
    family: Any
    client_cfgs: Sequence[Any]
    n_samples: Sequence[int]
    lr: float = 0.01
    momentum: float = 0.0
    method: str = "fedadp"
    filler_mode: str = "zero"            # "zero" | "global"
    agg_mode: str = "filler"             # "filler" (Eq. 1) | "coverage"
    coverage: str = "loose"              # what counts as covered
    narrow_mode: str = "paper"           # fedadp distribute: Alg. 3 | fold
    loss_fn: Optional[Callable] = None   # loss(params, batch) under the
                                         # union config; default: the
                                         # family's loss_and_grad
    mesh: Any = None                     # DeviceMesh: split the client
                                         # axis over client_axes
    client_axes: Tuple[str, ...] = ("clients",)
    embed_seed: int = 0                  # base NetChange seed
    agg_layout: str = "auto"             # "auto" | "plane" | "stream"
    k_chunk: Optional[int] = None        # streaming chunk rows (None=auto)
    wire: str = "f32"                    # client->server payload encoding
                                         # (core.quant): "f32" | "bf16" |
                                         # "int8" — non-f32 streams
    wire_tile: int = quant.DEFAULT_TILE  # int8 scale tile (128 multiple)
    wire_sparse: bool = False            # ship covered coords only —
                                         # needs agg_mode="coverage"
    compute_dtype: str = "f32"           # local-training compute policy
    attn_backend: str = "auto"           # transformer attention backend
    timing: bool = False                 # time the training phase
                                         # (synchronizes the device)
    device: DeviceLike = None

    def __post_init__(self):
        if self.agg_layout not in ENGINE_LAYOUTS:
            raise ValueError(
                f"agg_layout={self.agg_layout!r}, expected one of "
                f"{ENGINE_LAYOUTS}")
        if self.k_chunk is not None and int(self.k_chunk) < 1:
            raise ValueError(f"k_chunk={self.k_chunk!r}, expected a "
                             f"positive int or None")
        if self.agg_mode not in AGG_MODES:
            raise ValueError(f"agg_mode={self.agg_mode!r}, expected one of "
                             f"{AGG_MODES}")
        if self.coverage not in COVERAGE_POLICIES:
            raise ValueError(f"coverage={self.coverage!r}, expected one of "
                             f"{COVERAGE_POLICIES}")
        if self.narrow_mode not in NARROW_MODES:
            raise ValueError(f"narrow_mode={self.narrow_mode!r}, expected "
                             f"one of {NARROW_MODES}")
        if self.wire not in WIRE_FORMATS:
            raise ValueError(f"wire={self.wire!r}, expected one of "
                             f"{WIRE_FORMATS}")
        quant.validate_tile(self.wire_tile)
        if self.wire != "f32":
            if self.method != "fedadp":
                raise ValueError(
                    f"wire={self.wire!r} compresses the fedadp round "
                    f"payloads; method={self.method!r} does not ship "
                    "plane rows through the wire layer")
            if self.agg_layout == "plane":
                raise ValueError(
                    "wire compression aggregates on the streaming path "
                    "(the fused dequantize-accumulate kernel); "
                    "agg_layout='plane' contradicts it — use 'auto' or "
                    "'stream'")
        if self.wire_sparse:
            if self.wire == "f32":
                raise ValueError("wire_sparse needs a compressed wire "
                                 "(wire='bf16' or 'int8')")
            if self.agg_mode != "coverage":
                raise ValueError(
                    "wire_sparse ships only covered coordinates, which "
                    'is exact only under agg_mode="coverage" (uncovered '
                    "coordinates never enter the masked average); "
                    f"agg_mode={self.agg_mode!r} averages them")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={self.compute_dtype!r}, "
                             f"expected one of {COMPUTE_DTYPES}")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend={self.attn_backend!r}, "
                             f"expected one of {ATTN_BACKENDS}")
        if self.method not in ENGINE_METHODS:
            raise ValueError(f"method={self.method!r}, expected one of "
                             f"{ENGINE_METHODS}")
        self._ctx = CohortCtx(mesh=self.mesh,
                              client_axes=tuple(self.client_axes))
        self.device = resolve_device(self.device)
        strict_f32(self.device)
        self._phase_s = {"train": 0.0, "all_reduce": 0.0}
        self._comm = {"all_reduces": 0, "bytes": 0, "moved_rows": 0}
        self._step_sizes: set = set()
        self._agg_stats: Dict = {}
        # per-client error-feedback residual plane (K, P) f32, allocated
        # by the first compressed round; checkpointed by the Federation.
        # Under a client mesh a row is valid on the rank that last
        # encoded its client (``_wire_owner[k]``; -1: on every rank)
        self._wire_res: Optional[torch.Tensor] = None
        self._wire_owner: Optional[np.ndarray] = None
        self._wire_stats: Dict = {}
        self.global_cfg = self.family.union(list(self.client_cfgs))
        self._depth_only = self.family.depth_only(list(self.client_cfgs))
        if not self._depth_only:
            rep = getattr(self.family, "segment_representable", None)
            if rep is None or not rep(list(self.client_cfgs)):
                raise ValueError(
                    "unified engine needs a depth-only or segment-"
                    "representable cohort (family.segment_representable)")
        self._gshapes = global_shapes(self.family, self.global_cfg)
        self.plane_spec = plane.PlaneSpec.from_tree(self._gshapes)
        # the static segment structure (which leaves/axes are widened) is
        # seed-invariant — only the matrix VALUES change per round seed
        if self._depth_only:
            self._axes_map: Dict = {}
        else:
            specs = [self.family.segment_spec(cfg, self.global_cfg,
                                              seed=self.embed_seed)
                     for cfg in self.client_cfgs]
            self._axes_map = sg.union_axes(specs, self._gshapes)
        self._seg_axes = {sg.path_str(p): a
                          for p, a in self._axes_map.items()}
        self._cache = KeyedCache(n_clients=len(self.client_cfgs))
        # seed-invariant artifacts (strict mask, filler at embed_seed)
        # once per UNIQUE client config as (U, P) row planes; client k's
        # row is a gather through the uid index. The filler is read only
        # by the depth-only round start, so other cohorts do not keep it
        # (at glm4-9b width each plane is 3.3 GB); the coverage plane is
        # built from these on first use (_ucov_p)
        uid_of: Dict[Any, int] = {}
        for cfg in self.client_cfgs:
            uid_of.setdefault(cfg, len(uid_of))
        self._uniq_cfgs = list(uid_of)
        self._uid_np = np.asarray([uid_of[c] for c in self.client_cfgs],
                                  np.int64)
        self._uid = torch.as_tensor(self._uid_np, device=self.device)
        U = len(self._uniq_cfgs)
        keep = (True, self._depth_only)
        planes = [torch.empty((U, self.plane_spec.size), device=self.device)
                  if kept else None for kept in keep]
        for u in range(U):      # one config's trees alive at a time
            for dst, t in zip(planes, self._build_uid_mask(u)):
                if dst is not None:
                    dst[u] = plane.pack(t, self.plane_spec)
        self._umask_p, self._ufill_p = planes
        self.weights = client_weights(self.n_samples)
        self.clusters = _cluster_ids(self.client_cfgs)
        # the per-client methods train at the fixed embed_seed: their
        # E Eᵀ matrices are stacked once (fedadp draws per-round ones)
        self._seg_mats0: Dict = (
            {} if self._depth_only or self.method == "fedadp" else
            sg.stack_matrices([self._client_seg(k, self.embed_seed)
                               for k in range(len(self.client_cfgs))],
                              self.device))
        if self.method == "flexifed":
            self._prefix_paths = self._prefix_for(
                tuple(range(len(self.client_cfgs))))
        self._opt = sgd(self.lr, self.momentum)
        self._step = self._build_step()

    # ----------------------------------------------------------- embedding
    def cache_stats(self) -> dict:
        """Hit/miss/size/bound of the embedding-artifact cache."""
        return self._cache.stats()

    def step_stats(self) -> dict:
        """The plane row counts the training step has run at (one step
        function serves them all: nothing is traced per size)."""
        return {"subset_sizes": sorted(self._step_sizes)}

    @functools.cached_property
    def masks(self):
        """The full cohort's strict trainable masks as a stacked tree
        (views of one ``(K, P)`` plane; tree-facing callers only)."""
        return plane.unpack_stacked(self._umask_p[self._uid], self.plane_spec)

    def _build_uid_mask(self, u: int):
        """(strict mask, filler) trees of UNIQUE config ``u`` at the
        fixed ``embed_seed`` — packed once into the ``(U, P)`` planes,
        which are then the only copy kept."""
        return coverage_and_filler(
            self.family, self._uniq_cfgs[u], self.global_cfg,
            seed=self.embed_seed, device=self.device)

    @functools.cached_property
    def _ucov_p(self) -> Optional[torch.Tensor]:
        """The seed-invariant coverage at ``embed_seed`` as a ``(U, P)``
        plane, built on first use (a filler round with
        ``filler_mode="zero"`` never reads it): the strict mask plane
        itself under ``coverage="strict"``; on depth-only cohorts
        ``loosen`` of the mask and filler planes; else None (a width
        cohort's loose coverage moves with the round seed)."""
        if self.coverage == "strict":
            return self._umask_p
        if not self._depth_only:
            return None
        m, f = self._umask_p, self._ufill_p
        return torch.maximum(m, (f.abs() > 0).to(m.dtype))

    def _client_cov_tree(self, k: int):
        """Client k's seed-invariant coverage tree, a view of its row."""
        return plane.unpack(self._ucov_p[int(self._uid_np[k])],
                            self.plane_spec)

    def _uid_rows(self, store: torch.Tensor, ks: Sequence[int]):
        return store[self._uid[torch.as_tensor(list(ks),
                                               device=self.device)]]

    def _mask_views(self, ks):
        """The participants' trainable-mask rows as views (no copy) — what
        the training step multiplies its gradient rows by in place."""
        return [self._umask_p[int(self._uid_np[k])] for k in ks]

    def _filler_views(self, ks):
        return [self._ufill_p[int(self._uid_np[k])] for k in ks]

    def _cov_rows(self, ks) -> torch.Tensor:
        return self._uid_rows(self._ucov_p, ks)

    def _client_spec(self, k: int, seed: int):
        return self.family.segment_spec(self.client_cfgs[k], self.global_cfg,
                                        seed=seed)

    def _client_seg(self, k: int, seed: int):
        """The E Eᵀ matrices (host numpy) for client k at one seed."""
        return self._cache.get(
            ("seg", k, seed),
            lambda: sg.client_matrices(self._client_spec(k, seed),
                                       self._axes_map, self._gshapes,
                                       kind="grad"))

    def _client_cov(self, k: int, seed: int):
        """Aggregation-coverage mask at a round seed (loose needs the
        round's filler: widened identity-conv taps move with the
        mapping)."""
        if self._depth_only or self.coverage == "strict":
            return self._client_cov_tree(k)

        def build():
            mask, filler = coverage_and_filler(
                self.family, self.client_cfgs[k], self.global_cfg, seed=seed,
                device=self.device)
            return loosen(mask, filler)
        return self._cache.get(("cov", k, seed), build)

    def _client_cov_row(self, k: int, seed: int) -> torch.Tensor:
        return self._cache.get(
            ("covrow", k, seed),
            lambda: plane.pack(self._client_cov(k, seed), self.plane_spec,
                               what="cov_row"))

    def _client_mult_row(self, k: int, seed: int) -> torch.Tensor:
        return self._cache.get(
            ("multrow", k, seed),
            lambda: plane.pack(
                sg.multiplicity_tree(self._client_spec(k, seed),
                                     self._gshapes, device=self.device),
                self.plane_spec, what="mult_row"))

    def _round_seed(self, round_idx: int, k: int) -> int:
        return round_embed_seed(self.embed_seed, round_idx, k)

    # ------------------------------------------------------------- step fn
    def _train_cfg(self):
        """Model config of the local training step: the union config, with
        its compute dtype flipped under the bf16 policy (the model casts
        activations to ``cfg.dtype``, so the gradient function is built on
        the bf16 config; the plane itself never leaves f32)."""
        if self.compute_dtype == "bf16":
            return dataclasses.replace(self.global_cfg, dtype="bfloat16")
        return self.global_cfg

    def _train_ctx(self):
        """ShardCtx override for a forced attention backend (None when
        "auto" — the family's default ctx already picks by device)."""
        if self.attn_backend == "auto":
            return None
        return ShardCtx(attn_backend=self.attn_backend)

    def _build_step(self) -> Callable:
        """The packed SGD step: vmap(grad) over the plane's views, E Eᵀ +
        mask projection on the plane, SGD written into the plane."""
        ctx = self._train_ctx()
        # clients per vmapped chunk: the family's choice (VGG: one, so
        # each client's convs run as the loop runs them), else all
        chunk = getattr(self.family, "client_chunk", None)
        if self.loss_fn is not None:
            stacked_grads = vmap(torch.func.grad(self.loss_fn),
                                 chunk_size=chunk)
        else:
            if ctx is None:
                gf = self.family.loss_and_grad(self._train_cfg())
            else:
                try:
                    gf = self.family.loss_and_grad(self._train_cfg(), ctx=ctx)
                except TypeError as e:
                    raise ValueError(
                        f"attn_backend={self.attn_backend!r} needs a family "
                        "whose loss_and_grad accepts a ShardCtx (transformer "
                        "families); this one does not") from e
            stacked_grads = vmap(lambda p, b: gf(p, b)[1], chunk_size=chunk)
        opt = self._opt
        seg_axes = self._seg_axes
        spec = self.plane_spec
        cdt = torch.bfloat16 if self.compute_dtype == "bf16" else None

        def step(sp, opt_state, masks, seg_mats, batch, step_idx):
            params = plane.unpack_stacked(sp, spec)
            if cdt is not None:
                # bf16 compute policy: cast ONCE at unpack; the f32 plane
                # stays the master copy, the forward and backward run in
                # bf16, and the gradients rejoin f32 before the E Eᵀ
                # projection, the masks and the optimizer
                params = tu.tree_map(lambda x: x.to(cdt), params)
            grads = stacked_grads(params, batch)
            if cdt is not None:
                grads = tu.tree_map(lambda g: g.float(), grads)
            grads = sg.project_stacked(grads, seg_axes, seg_mats)
            gp = plane.pack_stacked(grads, spec)
            del grads
            for row, m in zip(gp, masks):
                row.mul_(m)
            new_sp, new_state = opt.update(gp, opt_state, sp, step_idx)
            return plane.requantize(new_sp, spec), new_state

        return step

    # ------------------------------------------------------- round start
    def init_global(self, generator: Optional[torch.Generator] = None):
        return self.family.init(generator, self.global_cfg,
                                device=self.device)

    def _round_start_packed(self, gp, selected=None) -> torch.Tensor:
        """Depth-only round start on planes: ``g·m + f·(1−m)``."""
        ks = (range(len(self.client_cfgs)) if selected is None
              else list(selected))
        return _fused_round_start(gp, self._mask_views(ks),
                                  self._filler_views(ks))

    def round_start(self, global_params, selected=None, round_idx: int = 0):
        """Stacked per-client views of a global model — FedADP's
        distribute (To-Shallower/To-Narrower) in the unified space,
        restricted to ``selected`` when given."""
        if self._depth_only:
            gp = plane.pack(global_params, self.plane_spec)
            return plane.unpack_stacked(
                self._round_start_packed(gp, selected), self.plane_spec)
        return plane.unpack_stacked(
            self._round_start_width(global_params, selected, round_idx),
            self.plane_spec)

    def _round_start_width(self, global_params, selected, round_idx: int
                           ) -> torch.Tensor:
        """The literal per-client ``up(down(g))`` at the round's seeds
        under ``narrow_mode``, packed row by row."""
        ks = (list(range(len(self.client_cfgs))) if selected is None
              else list(selected))
        # the globals as views of one packed plane, as a round returns
        # them: a run resumed from a checkpoint (separately allocated
        # leaves) then meets ``down``'s reductions laid out as the
        # uninterrupted run does, and the two agree bit for bit on CUDA
        # (a reduction's order there can follow its input's alignment)
        global_params = plane.unpack(
            plane.pack(global_params, self.plane_spec,
                       what="round_start/global"), self.plane_spec)
        views = []
        for k in ks:
            s = self._round_seed(round_idx, k)
            down = self.family.down(global_params, self.global_cfg,
                                    self.client_cfgs[k], seed=s,
                                    mode=self.narrow_mode)
            views.append(self.family.up(down, self.client_cfgs[k],
                                        self.global_cfg, seed=s))
        return plane.pack_trees(views, self.plane_spec)

    def embed(self, client_params: Sequence):
        """Per-client (client-space) trees -> the stacked union-space
        state at the FIXED ``embed_seed`` (the per-client-state layout:
        same-architecture clients share one mapping, so cluster and
        prefix averages commute with the embedding). Views of one
        ``(K, P)`` plane, filled one client at a time."""
        sp = torch.empty((len(self.client_cfgs), self.plane_spec.size),
                         device=self.device)
        for k, (p, cfg) in enumerate(zip(client_params, self.client_cfgs)):
            sp[k] = plane.pack(self.family.up(p, cfg, self.global_cfg,
                                              seed=self.embed_seed),
                               self.plane_spec, what="embed")
        return plane.unpack_stacked(sp, self.plane_spec)

    def client_view(self, stacked, k: int):
        return tu.tree_map(lambda x: x[k], stacked)

    # ------------------------------------------------------------ training
    def _train_packed(self, sp: torch.Tensor, stacked_batches: Sequence,
                      masks: Sequence[torch.Tensor], seg_mats
                      ) -> torch.Tensor:
        """One local-training round on the packed plane: fresh optimizer
        state (the per-client loop re-inits SGD momentum every round),
        one step per stacked batch, the plane updated in place. ``masks``
        holds one ``(P,)`` trainable-mask row per plane row."""
        t0 = time.perf_counter() if self.timing else 0.0
        self._step_sizes.add(int(sp.shape[0]))
        opt_state = self._opt.init(sp)
        for i, batch in enumerate(stacked_batches):
            bt = {k: torch.as_tensor(v, device=self.device)
                  for k, v in batch.items()}
            sp, opt_state = self._step(sp, opt_state, masks, seg_mats, bt,
                                       i)
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._phase_s["train"] += time.perf_counter() - t0
        return sp

    def _train_packed_chunked(self, sp: torch.Tensor,
                              stacked_batches: Sequence,
                              masks: Sequence[torch.Tensor], seg_mats,
                              k_chunk: int) -> torch.Tensor:
        """``_train_packed`` in ``k_chunk``-row chunks, each trained in
        place in its rows of ``sp``: the per-client methods keep the
        whole ``(K, P)`` state anyway, but chunking bounds the training
        working set (gradients, momentum) to O(P·k_chunk)."""
        for lo, hi in plane.chunk_bounds(int(sp.shape[0]), k_chunk):
            part = sp[lo:hi]
            out = self._train_packed(
                part, [{k: v[lo:hi] for k, v in b.items()}
                       for b in stacked_batches],
                masks[lo:hi],
                {p: [m[lo:hi] for m in ms] for p, ms in seg_mats.items()})
            if out is not part:
                part.copy_(out)
        return sp

    def train_round(self, stacked, stacked_batches: Sequence, *, masks=None,
                    seg_mats=None):
        """Tree-facing wrapper over ``_train_packed``: packs the stacked
        tree (and mask tree, when given) once, trains on the plane,
        unpacks once. ``masks`` / ``seg_mats`` default to the fixed-seed
        full-cohort embedding."""
        spec = self.plane_spec
        sp = plane.pack_stacked(stacked, spec, what="train_round")
        mask_rows = (self._mask_views(range(len(self.client_cfgs)))
                     if masks is None else
                     list(plane.pack_stacked(masks, spec,
                                             what="train_round/masks")))
        seg_mats = self._full_seg_mats() if seg_mats is None else seg_mats
        return plane.unpack_stacked(
            self._train_packed(sp, stacked_batches, mask_rows, seg_mats),
            spec)

    def _full_seg_mats(self):
        """The full cohort's E Eᵀ matrices at ``embed_seed``."""
        if self._depth_only or self._seg_mats0:
            return self._seg_mats0
        return sg.stack_matrices(
            [self._client_seg(k, self.embed_seed)
             for k in range(len(self.client_cfgs))], self.device)

    def phase_stats(self, reset: bool = False):
        """Cumulative wall-clock seconds per round phase (``timing=True``
        only; ``train`` = the local-training steps of every chunk,
        ``all_reduce`` = the client mesh's collectives)."""
        out = dict(self._phase_s)
        if reset:
            for k in self._phase_s:
                self._phase_s[k] = 0.0
        return out

    def comm_stats(self, reset: bool = False) -> dict:
        """The client mesh's collectives since the last reset: how many
        ``all_reduce`` calls, the bytes this rank contributed to them, and
        the wire residual rows moved between ranks (0 in one process)."""
        out = dict(self._comm)
        if reset:
            for k in self._comm:
                self._comm[k] = 0
        return out

    # --------------------------------------------------------- aggregation
    def agg_stats(self) -> dict:
        """Accounting of the LAST aggregation pass: layout, rows and
        ``peak_bytes`` (the whole ``(K, P)`` sub-plane for "plane"; three
        ``(P,)`` buffers + one chunk for "stream")."""
        return dict(self._agg_stats)

    def wire_stats(self) -> dict:
        """Byte accounting of the LAST compressed round (empty when
        ``wire="f32"``): payload ``bytes_per_round`` (values + int8
        scale grids, covered coordinates only under ``wire_sparse``),
        the dense-f32 baseline, and the reduction factor. Under a client
        mesh the cohort's, not the rank's."""
        return dict(self._wire_stats)

    def wire_residuals(self) -> Optional[torch.Tensor]:
        """The per-client error-feedback residual plane ``(K, P)`` f32 —
        ``None`` until a compressed round has run. What the Federation
        checkpoints. Under a client mesh every rank must call it: the
        rows come together from the ranks that hold them (one
        zero-padded ``all_reduce``; none when every rank already holds
        every row), and every rank keeps the whole plane, so the next
        round moves no row."""
        if (self._wire_res is None or self._wire_owner is None
                or (self._wire_owner < 0).all()):
            return self._wire_res
        me = self._ctx.edge_rank
        mine = [k for k, o in enumerate(self._wire_owner)
                if o == me or (o < 0 and me == 0)]
        whole = torch.zeros_like(self._wire_res)
        if mine:
            idx = torch.as_tensor(mine, device=self.device)
            whole.index_copy_(0, idx, self._wire_res.index_select(0, idx))
        self._wire_res = None
        self._global_reduce(whole)
        self._wire_res = whole
        self._wire_owner[:] = -1
        return whole

    def load_wire_residuals(self, arr):
        """Restore a checkpointed residual plane (the resume path): under
        a client mesh every rank loads the whole plane."""
        arr = torch.as_tensor(arr)
        want = (len(self.client_cfgs), self.plane_spec.size)
        if tuple(arr.shape) != want:
            raise ValueError(f"wire residual plane has shape "
                             f"{tuple(arr.shape)}, engine expects {want}")
        self._wire_res = arr.to(device=self.device, dtype=torch.float32)
        if self._wire_owner is not None:
            self._wire_owner[:] = -1

    def _place_residuals(self, groups) -> None:
        """Put each participant's residual row on the rank that encodes
        it this round (``groups[r]``: rank r's clients): the rows whose
        holder changes move in one zero-padded ``all_reduce`` (the old
        holder writes, the new one reads); every other row stays where
        it is, so under full participation nothing moves after the first
        round."""
        if self._wire_owner is None:
            self._wire_owner = np.full(len(self.client_cfgs), -1, np.int64)
        owner, me = self._wire_owner, self._ctx.edge_rank
        new = {k: r for r, g in enumerate(groups) for k in g}
        moves = sorted(k for k, r in new.items() if 0 <= owner[k] != r)
        if moves:
            buf = torch.zeros((len(moves), self.plane_spec.size),
                              device=self.device)
            for j, k in enumerate(moves):
                if owner[k] == me:
                    buf[j] = self._wire_res[k]
            self._global_reduce(buf)
            for j, k in enumerate(moves):
                if new[k] == me:
                    self._wire_res[k] = buf[j]
            del buf
            self._comm["moved_rows"] += len(moves)
        for k, r in new.items():
            owner[k] = r

    def _wire_cov_count(self, k: int, seed) -> int:
        """Covered-coordinate count of client k's aggregation-coverage
        row (the sparse wire's payload length) — cached per (uid, seed),
        so steady-state rounds do not synchronise the device for it."""
        key = (("covcount", "uid", int(self._uid_np[k]))
               if (self._depth_only or self.coverage == "strict")
               else ("covcount", k, seed))
        return self._cache.get(
            key, lambda: int(self._client_cov_row(
                k, 0 if seed is None else seed).sum().item()))

    def _aggregate_packed(self, sp, w, gp=None, cov_p=None, mult_p=None):
        """FedADP Eq. 1-2 over the (sub-)plane in ONE pass — weights
        already renormalized over the participating subset."""
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        self._agg_stats = {
            "layout": "plane", "k_chunk": None,
            "rows": int(sp.shape[0]), "n": int(sp.shape[1]),
            "peak_bytes": 4 * int(sp.shape[0]) * int(sp.shape[1])}
        if self.agg_mode == "coverage":
            assert gp is not None, \
                'agg_mode="coverage" needs the current global params'
            return _plane_agg_fused(sp, w, cov_p, mult_p, gp, renorm=True,
                                    fold_global=False)
        if self.filler_mode == "global":
            assert gp is not None
            return _plane_agg_fused(sp, w, cov_p, None, gp, renorm=True,
                                    fold_global=True)
        return _plane_agg_fused(sp, w, None, None, None, renorm=True,
                                fold_global=False)

    def aggregate_global(self, stacked, global_params=None, selected=None,
                         *, cov=None, mult=None):
        """FedADP Eq. 1-2 over the (sub-)stacked tree, weights
        renormalized over the participating subset — the tree-facing
        wrapper over ``_aggregate_packed``: packs once, one fused pass,
        unpacks once. Under filler_mode="global" or agg_mode="coverage"
        the coverage (and multiplicity) rows default to the fixed-seed
        embedding's; ``cov`` / ``mult`` (stacked trees) override them for
        per-round-seeded width rounds."""
        spec = self.plane_spec
        w = subset_weights(self.n_samples, selected)
        sp = plane.pack_stacked(stacked, spec, what="aggregate_global")
        need_global = (self.agg_mode == "coverage"
                       or self.filler_mode == "global")
        gp = (plane.pack(global_params, spec, what="aggregate_global/global")
              if global_params is not None and need_global else None)
        cov_p = mult_p = None
        if need_global:
            assert gp is not None, \
                "aggregate_global needs the current global params here"
            ks = (list(range(len(self.client_cfgs))) if selected is None
                  else list(selected))
            cov_p = (plane.pack_stacked(cov, spec,
                                        what="aggregate_global/cov")
                     if cov is not None else
                     self._cov_rows(ks) if self._ucov_p is not None else
                     torch.stack([self._client_cov_row(k, self.embed_seed)
                                  for k in ks]))
            if self.agg_mode == "coverage" and not self._depth_only:
                mult_p = (plane.pack_stacked(mult, spec,
                                             what="aggregate_global/mult")
                          if mult is not None else
                          torch.stack([self._client_mult_row(
                              k, self.embed_seed) for k in ks]))
        return plane.unpack(
            self._aggregate_packed(sp, w, gp, cov_p, mult_p), spec)

    def _flexifed_prefix_paths(self, sel):
        """Chain positions shared by the WHOLE participating subset (same
        layer id) — FlexiFed's common prefix, from the configs alone.
        The tree paths come from the clients' chains; layer ids carry
        widths, so the prefix stops at the first width divergence, and
        on the prefix every participant's embedding is the same operator
        (same widths, fixed seed), so averaging embedded prefixes equals
        embedding the averaged prefix."""
        chains = [self.family.chain_paths(self.client_cfgs[i]) for i in sel]
        paths = set()
        for pos in range(min(len(c) for c in chains)):
            if len({c[pos][0] for c in chains}) == 1:
                paths.add(chains[0][pos][1])
            else:
                break
        return paths

    def _prefix_for(self, sel) -> set:
        key = tuple(sel)
        return self._cache.get(("prefix", key),
                               lambda: self._flexifed_prefix_paths(key))

    def _prefix_cols(self, sel) -> torch.Tensor:
        """The FlexiFed common prefix as a 0/1 COLUMN mask on the plane
        (``PlaneSpec.col_mask``)."""
        key = tuple(sel)

        def build():
            prefix = self._prefix_for(key)
            return torch.as_tensor(self.plane_spec.col_mask(
                lambda path: any(path[:len(pp)] == pp for pp in prefix)),
                device=self.device)
        return self._cache.get(("prefixcols", key), build)

    def _per_client_average(self, sp: torch.Tensor, trained: torch.Tensor,
                            ks, mine) -> torch.Tensor:
        """The per-client methods' aggregation, in place on the state
        plane ``sp``: ``trained`` holds the rows of clients ``mine`` (this
        rank's participants; all of ``ks`` in one process). Clustered:
        each (cluster ∩ participants) averages with its subset weights
        and the average is written onto its rows. FlexiFed: that, then
        the common prefix's columns (``PlaneSpec.col_mask``) take the
        average over all participants. Under a client mesh the averages
        are summed from every rank's partials (``group_partials``, one
        ``all_reduce`` of the stacked ``(C [+1], P)``). Non-participants
        keep their rows."""
        sel = set(ks)
        pos = {k: j for j, k in enumerate(mine)}
        clusters = [ids for ids in ([i for i in c if i in sel]
                                    for c in self.clusters.values()) if ids]
        members = clusters + ([list(ks)] if self.method == "flexifed"
                              else [])
        groups = []
        for ids in members:
            w = subset_weights(self.n_samples, ids)
            at = [(pos[k], w[i]) for i, k in enumerate(ids) if k in pos]
            groups.append(([j for j, _ in at], [x for _, x in at]))
        part = group_partials(trained, groups)
        if len(mine) < len(ks):
            self._global_reduce(part)
        for ids, avg in zip(clusters, part):
            idx = torch.as_tensor(ids, device=self.device)
            sp.index_copy_(0, idx, avg[None, :].expand(len(ids), -1))
        if self.method == "flexifed":
            cm = self._prefix_cols(ks)
            idx = torch.as_tensor(list(ks), device=self.device)
            sub = sp.index_select(0, idx)
            sub.mul_(1.0 - cm).add_(part[-1] * cm)
            sp.index_copy_(0, idx, sub)
        return sp

    def _run_per_client(self, state, stacked_batches: Sequence, sel):
        """A per-client-state round: the stacked state packs to (K, P),
        participants train on their rows (this rank's, under a client
        mesh; in ``k_chunk``-row chunks when pinned), the rows scatter
        back, then the method's aggregation runs on the plane in place
        (standalone: the trained rows are the new ones)."""
        spec = self.plane_spec
        K = len(self.client_cfgs)
        sp = plane.pack_stacked(state, spec, what="run_round/state")
        ks = list(range(K)) if sel is None else sel
        rows = self._ctx.local_rows(len(ks))
        mine = ks if rows is None else ks[rows]
        if rows is not None:
            stacked_batches = [{k: v[rows] for k, v in b.items()}
                               for b in stacked_batches]
        idx = (None if mine == list(range(K))
               else torch.as_tensor(mine, device=self.device))
        trained = sp if idx is None else sp.index_select(0, idx)
        seg_mats = self._seg_mats0
        if idx is not None and seg_mats:
            taken: Dict[int, torch.Tensor] = {}
            seg_mats = {p: [taken.setdefault(id(m), m.index_select(0, idx))
                            for m in ms] for p, ms in seg_mats.items()}
        masks = self._mask_views(mine)
        if self.k_chunk is not None:
            trained = self._train_packed_chunked(
                trained, stacked_batches, masks, seg_mats,
                default_k_chunk(len(mine), self.k_chunk))
        else:
            trained = self._train_packed(trained, stacked_batches, masks,
                                         seg_mats)
        if self.method != "standalone":
            if idx is None:
                sp = trained
            sp = self._per_client_average(sp, trained, ks, mine)
        elif rows is not None:
            idx = torch.as_tensor(ks, device=self.device)
            sp.index_copy_(0, idx, self._gather(trained))
        elif idx is None:
            sp = trained
        else:
            sp.index_copy_(0, idx, trained)
        return plane.unpack_stacked(sp, spec)

    # ---------------------------------------------------------- full round
    def run_round(self, state, stacked_batches: Sequence, selected=None,
                  round_idx: int = 0):
        """One federated round over the participating subset (default:
        full cohort). ``state`` is the global tree for fedadp (returns
        the next one, views of one fresh ``(P,)`` plane) and the stacked
        client tree for the per-client methods (returns the next one,
        views of one ``(K, P)`` plane). ``stacked_batches`` leaves carry
        a leading axis of ``len(selected)``; ``round_idx`` seeds
        fedadp's To-Wider mappings."""
        sel = None if selected is None else list(selected)
        if sel == list(range(len(self.client_cfgs))):
            sel = None
        if self.method != "fedadp":
            return self._run_per_client(state, stacked_batches, sel)
        spec = self.plane_spec
        ks = list(range(len(self.client_cfgs))) if sel is None else sel
        layout = resolve_agg_layout(self.agg_layout,
                                    backend=self.device.type, k=len(ks),
                                    p=spec.size, k_chunk=self.k_chunk)
        # under a client mesh this rank's rows (None: all of them)
        rows = self._ctx.local_rows(len(ks))
        w = subset_weights(self.n_samples, sel)
        groups = None
        if rows is not None:
            groups = self._ctx.edge_groups(ks)
            ks, w = ks[rows], w[rows]
            stacked_batches = [{k: v[rows] for k, v in b.items()}
                               for b in stacked_batches]
        # a compressed wire always streams: the fused dequantize-
        # accumulate kernel is the only consumer of int8 chunks, and bf16
        # chunks ride the same accumulate
        if layout == "stream" or self.wire != "f32":
            return self._run_fedadp_stream(state, stacked_batches, ks, w,
                                           round_idx, groups=groups)
        gp = plane.pack(state, spec, what="run_round/state")
        need_cov = (self.agg_mode == "coverage"
                    or self.filler_mode == "global")
        cov_p = mult_p = None
        if self._depth_only:
            start = self._round_start_packed(gp, ks)
            trained = self._train_packed(start, stacked_batches,
                                         self._mask_views(ks), {})
            cov_p = self._cov_rows(ks) if need_cov else None
        else:
            seeds = [self._round_seed(round_idx, k) for k in ks]
            seg_mats = sg.stack_matrices(
                [self._client_seg(k, s) for k, s in zip(ks, seeds)],
                self.device)
            start = self._round_start_width(state, ks, round_idx)
            trained = self._train_packed(start, stacked_batches,
                                         self._mask_views(ks), seg_mats)
            if need_cov:
                cov_p = torch.stack([self._client_cov_row(k, s)
                                     for k, s in zip(ks, seeds)])
            if self.agg_mode == "coverage":
                mult_p = torch.stack([self._client_mult_row(k, s)
                                      for k, s in zip(ks, seeds)])
        del start
        agg = (self._aggregate_packed if rows is None
               else self._edge_reduce_packed)
        out = agg(trained, w, gp if need_cov else None, cov_p, mult_p)
        return plane.unpack(out, spec)

    @contextlib.contextmanager
    def _collective(self, calls: int, nbytes: int):
        """Account ``calls`` ``all_reduce``s of ``nbytes`` in all: counted
        into ``comm_stats``, timed into ``phase_stats`` under
        ``timing``."""
        t0 = time.perf_counter() if self.timing else 0.0
        yield
        self._comm["all_reduces"] += calls
        self._comm["bytes"] += int(nbytes)
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._phase_s["all_reduce"] += time.perf_counter() - t0

    def _global_reduce(self, *tensors: torch.Tensor) -> None:
        """The mesh's global reduce: sum each tensor in place over the
        client axes."""
        with self._collective(len(tensors), sum(
                t.numel() * t.element_size() for t in tensors)):
            self._ctx.all_reduce(*tensors)

    def _gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a split cohort array, on every rank."""
        with self._collective(1, rows.numel() * rows.element_size()
                              * self._ctx.edge_extent):
            return self._ctx.gather_rows(rows)

    def _edge_reduce_packed(self, sp, w, gp=None, cov_p=None, mult_p=None):
        """Two-level aggregation over the client mesh: this rank's rows
        ``sp`` pre-reduce to a partial (num, den, cov) triple with the
        GLOBAL subset weights ``w`` (``plane_partials``: one
        ``plane_accum``; filler_mode="global" folds the server's values
        into uncovered coordinates first), one ``all_reduce`` sums the
        triples, and ONE finish pass closes (renorm and fallback under
        agg_mode="coverage"). Per-edge renormalization would be wrong
        and never happens."""
        coverage = self.agg_mode == "coverage"
        fold = (not coverage) and self.filler_mode == "global"
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        k_local, n = int(sp.shape[0]), int(sp.shape[1])
        if coverage:
            trip = plane_partials(sp, w, cov_p, mult_p)
        elif fold:
            trip = plane_partials(_fold_rows(sp, cov_p, gp), w)
        else:
            trip = plane_partials(sp, w)
        del sp
        self._global_reduce(*trip)
        e = self._ctx.edge_extent
        self._agg_stats = {
            "layout": "edge", "k_chunk": None, "rows": k_local * e, "n": n,
            "edges": e, "peak_bytes": 4 * n * (3 + k_local)}
        return finish_partials(*trip, renorm=coverage,
                               fallback=gp if coverage else None)

    def _run_fedadp_stream(self, state, stacked_batches: Sequence, ks, w,
                           round_idx: int, *, groups=None):
        """The streaming fedadp round: the participating cohort is
        consumed in ``k_chunk``-row chunks — round start, local training,
        the wire encode (compressed wires) and the in-place accumulate
        per chunk, so one ``(k_chunk, P)`` slab plus the accumulator's
        three ``(P,)`` buffers is all the round state resident (and, on a
        compressed wire, the ``(K, P)`` residual plane); ``finish``
        closes with the one ``plane_finish`` pass (coverage rounds; a
        filler round's numerator is already the result). Same math as
        the whole-plane round (the masked weighted sum splits
        associatively; weights are the GLOBAL subset weights). ``ks`` and
        ``w`` are the rows this rank streams and their weights; ``groups``
        (a client mesh: every rank's rows) sums the accumulators over the
        client axes before the finish, and places the wire's residual
        rows first."""
        spec = self.plane_spec
        kc = default_k_chunk(len(ks), self.k_chunk)
        coverage = self.agg_mode == "coverage"
        fold = (not coverage) and self.filler_mode == "global"
        wire = self.wire
        # the packed global only where it is read; the accumulator's
        # buffers only from the first update on, so neither is resident
        # while the first chunk trains
        gp = (plane.pack(state, spec, what="run_round/state")
              if self._depth_only or coverage or fold else None)
        if wire != "f32" and (self._wire_res is None or round_idx == 0):
            # round 0 = a fresh run: residuals start at zero (a second
            # run on the same engine must not inherit the first one's
            # error feedback); a resume keeps what load_wire_residuals
            # restored
            self._wire_res = None
            self._wire_res = torch.zeros((len(self.client_cfgs), spec.size),
                                         device=self.device)
            self._wire_owner = None
        if wire != "f32" and groups is not None:
            self._place_residuals(groups)
        edge = groups is not None
        acc = None
        payload_bytes = 0
        for lo, hi in plane.chunk_bounds(len(ks), kc):
            cks = ks[lo:hi]
            if self._depth_only:
                seeds = None
                seg_mats: Dict = {}
                start = _fused_round_start(gp, self._mask_views(cks),
                                           self._filler_views(cks))
            else:
                seeds = [self._round_seed(round_idx, k) for k in cks]
                seg_mats = sg.stack_matrices(
                    [self._client_seg(k, s) for k, s in zip(cks, seeds)],
                    self.device)
                start = self._round_start_width(state, cks, round_idx)
            trained = self._train_packed(
                start, [{k: v[lo:hi] for k, v in b.items()}
                        for b in stacked_batches],
                self._mask_views(cks), seg_mats)
            del start
            wk = torch.as_tensor(w[lo:hi], dtype=torch.float32,
                                 device=self.device)
            cov_rows = mult_rows = None
            if coverage or fold:
                cov_rows = (self._cov_rows(cks) if self._depth_only
                            else torch.stack([self._client_cov_row(k, s)
                                              for k, s in zip(cks, seeds)]))
            if coverage:
                mult_rows = (None if self._depth_only
                             else torch.stack([self._client_mult_row(k, s)
                                               for k, s in zip(cks, seeds)]))
            if acc is None:
                acc = kops.PlaneAccumulator(
                    spec.size, device=self.device,
                    q_tile=self.wire_tile if wire == "int8" else None)
            if wire != "f32":
                payload_bytes += self._wire_update(
                    acc, trained, wk, cks, seeds, cov_rows, mult_rows, gp,
                    coverage=coverage, fold=fold)
            elif coverage:
                acc.update(trained, wk, masks=cov_rows, mult=mult_rows)
            elif fold:
                acc.update(_fold_rows(trained, cov_rows, gp), wk)
            else:
                acc.update(trained, wk)
            del trained, cov_rows, mult_rows
        if edge:
            self._global_reduce(*acc.partials())
        out = acc.finish(renorm=coverage, fallback=gp if coverage else None)
        self._agg_stats = {"layout": "stream", "k_chunk": kc,
                           **acc.stats()}
        if edge:
            self._agg_stats["edges"] = self._ctx.edge_extent
        if wire != "f32":
            n_rows = len(ks)
            if edge:
                # the cohort's payload, not the rank's: summed over the
                # client axes (exact in int64)
                tot = torch.tensor([n_rows, payload_bytes], dtype=torch.int64)
                self._global_reduce(tot)
                n_rows, payload_bytes = (int(v) for v in tot)
            f32_bytes = n_rows * spec.size * 4
            self._wire_stats = {
                "wire": wire, "tile": self.wire_tile,
                "sparse": self.wire_sparse, "rows": n_rows,
                "bytes_per_round": int(payload_bytes),
                "f32_bytes": int(f32_bytes),
                "reduction": f32_bytes / max(payload_bytes, 1)}
        return plane.unpack(out, spec)

    def _wire_update(self, acc, trained, wk, cks, seeds, cov_rows, mult_rows,
                     gp, *, coverage: bool, fold: bool) -> int:
        """Error-feedback encode one trained chunk for the wire and fold
        the payload into ``acc`` as it arrives; returns its wire bytes.
        The chunk's residual rows are gathered by client index and
        written back in place (``index_copy_``); an int8 payload goes
        through the fused dequantize-accumulate (``update_q``), a bf16
        one through ``update`` as bf16."""
        wire = self.wire
        idx = torch.as_tensor(cks, device=self.device)
        values, scales, new_res = quant.encode(
            trained, self._wire_res.index_select(0, idx), wire,
            tile=self.wire_tile,
            mask=cov_rows if self.wire_sparse else None)
        self._wire_res.index_copy_(0, idx, new_res)
        del new_res
        counts = ([self._wire_cov_count(k, None if seeds is None else s)
                   for k, s in zip(cks, seeds or cks)]
                  if self.wire_sparse else [None] * len(cks))
        nbytes = sum(quant.payload_nbytes(wire, self.plane_spec.size,
                                          tile=self.wire_tile, covered=c)
                     for c in counts)
        if wire == "int8":
            if coverage:
                acc.update_q(values, scales, wk, masks=cov_rows,
                             mult=mult_rows)
            elif fold:
                acc.update_q(values, scales, wk, masks=cov_rows, base=gp)
            else:
                acc.update_q(values, scales, wk)
        elif coverage:
            acc.update(values, wk, masks=cov_rows, mult=mult_rows)
        elif fold:
            acc.update(_fold_rows(values, cov_rows, gp), wk)
        else:
            acc.update(values, wk)
        return nbytes
