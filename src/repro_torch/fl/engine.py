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

Partial participation runs the round on the ``selected`` rows, weights
renormalized over the subset. Method: ``fedadp`` (filler "zero" |
"global", agg_mode "filler" | "coverage"), on depth- and
width-heterogeneous (segment-representable) cohorts.

Float32 is strict: the engine turns TF32 off for cuDNN and cuBLAS
(``device.strict_f32``) when it runs on CUDA.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch import not_ported
from repro_torch import tree as tu
from repro_torch.core import plane
from repro_torch.core import segments as sg
from repro_torch.core.aggregation import (AGG_MODES, COVERAGE_POLICIES,
                                          coverage_and_filler,
                                          default_k_chunk, global_shapes,
                                          loosen, resolve_agg_layout,
                                          subset_weights)
from repro_torch.core.netchange import (KeyedCache, NARROW_MODES,
                                        round_embed_seed)
from repro_torch.device import DeviceLike, resolve_device, strict_f32
from repro_torch.kernels.fedavg import ops as kops
from repro_torch.optim import sgd

ENGINE_LAYOUTS = ("auto", "plane", "stream")
WIRE_FORMATS = ("f32", "bf16", "int8")
COMPUTE_DTYPES = ("f32", "bf16")
ATTN_BACKENDS = ("auto", "flash", "blockwise")


def _fused_round_start(gp, m, f):
    """Depth-only round start on gathered rows: ``up(down(g))`` is
    literally ``g·m + f·(1−m)`` there."""
    return gp[None, :] * m + f * (1.0 - m)


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
    """Runs FedADP rounds in the packed unified space. See module
    docstring. ``device=None`` means CUDA (raises without a card)."""
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
    mesh: Any = None                     # client-axis sharding (not ported)
    embed_seed: int = 0                  # base NetChange seed
    agg_layout: str = "auto"             # "auto" | "plane" | "stream"
    k_chunk: Optional[int] = None        # streaming chunk rows (None=auto)
    wire: str = "f32"                    # client->server payload encoding
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
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={self.compute_dtype!r}, "
                             f"expected one of {COMPUTE_DTYPES}")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend={self.attn_backend!r}, "
                             f"expected one of {ATTN_BACKENDS}")
        if self.method != "fedadp":
            raise not_ported(f"the engine's method={self.method!r} "
                             "(per-client state)", "the loop path")
        if self.mesh is not None:
            raise not_ported("client-axis sharding (mesh)",
                             "client-axis distribution")
        if self.wire != "f32":
            raise not_ported(f"wire={self.wire!r}", "compressed wire")
        if self.compute_dtype != "f32":
            raise not_ported(f"compute_dtype={self.compute_dtype!r}",
                             "transformer stack")
        if self.attn_backend != "auto":
            raise not_ported(f"attn_backend={self.attn_backend!r}",
                             "transformer stack")
        self.device = resolve_device(self.device)
        strict_f32(self.device)
        self._phase_s = {"train": 0.0}
        self._agg_stats: Dict = {}
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
        # seed-invariant artifacts (strict mask, filler, coverage at
        # embed_seed) once per UNIQUE client config as (U, P) row planes;
        # client k's row is a gather through the uid index
        uid_of: Dict[Any, int] = {}
        for cfg in self.client_cfgs:
            uid_of.setdefault(cfg, len(uid_of))
        self._uniq_cfgs = list(uid_of)
        self._uid_np = np.asarray([uid_of[c] for c in self.client_cfgs],
                                  np.int64)
        self._uid = torch.as_tensor(self._uid_np, device=self.device)
        utrip = [self._uid_mask(u) for u in range(len(self._uniq_cfgs))]
        self._umask_p, self._ufill_p, self._ucov_p = (
            torch.stack([plane.pack(t[i], self.plane_spec) for t in utrip])
            for i in range(3))
        self._opt = sgd(self.lr, self.momentum)
        self._step = self._build_step()

    # ----------------------------------------------------------- embedding
    def cache_stats(self) -> dict:
        """Hit/miss/size/bound of the embedding-artifact cache."""
        return self._cache.stats()

    def _uid_mask(self, u: int):
        """(strict mask, filler, cov) of UNIQUE config ``u`` at the fixed
        ``embed_seed``."""
        def build():
            mask, filler = coverage_and_filler(
                self.family, self._uniq_cfgs[u], self.global_cfg,
                seed=self.embed_seed, device=self.device)
            cov = mask if self.coverage == "strict" else loosen(mask, filler)
            return (mask, filler, cov)
        return self._cache.get(("mask", "uid", u), build)

    def _client_mask(self, k: int):
        return self._uid_mask(int(self._uid_np[k]))

    def _uid_rows(self, store: torch.Tensor, ks: Sequence[int]):
        return store[self._uid[torch.as_tensor(list(ks),
                                               device=self.device)]]

    def _mask_rows(self, ks) -> torch.Tensor:
        return self._uid_rows(self._umask_p, ks)

    def _filler_rows(self, ks) -> torch.Tensor:
        return self._uid_rows(self._ufill_p, ks)

    def _cov_rows(self, ks) -> torch.Tensor:
        return self._uid_rows(self._ucov_p, ks)

    def _client_seg(self, k: int, seed: int):
        """(E Eᵀ matrices, multiplicity tree) for client k at one seed."""
        def build():
            spec = self.family.segment_spec(self.client_cfgs[k],
                                            self.global_cfg, seed=seed)
            return (sg.client_matrices(spec, self._axes_map, self._gshapes,
                                       kind="grad"),
                    sg.multiplicity_tree(spec, self._gshapes,
                                         device=self.device))
        return self._cache.get(("seg", k, seed), build)

    def _client_cov(self, k: int, seed: int):
        """Aggregation-coverage mask at a round seed (loose needs the
        round's filler: widened identity-conv taps move with the
        mapping)."""
        if self._depth_only or self.coverage == "strict":
            return self._client_mask(k)[2]

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
            lambda: plane.pack(self._client_seg(k, seed)[1],
                               self.plane_spec, what="mult_row"))

    def _round_seed(self, round_idx: int, k: int) -> int:
        return round_embed_seed(self.embed_seed, round_idx, k)

    # ------------------------------------------------------------- step fn
    def _build_step(self) -> Callable:
        """The packed SGD step: vmap(grad) over the plane's views, E Eᵀ +
        mask projection on the plane, SGD written into the plane."""
        gf = self.family.loss_and_grad(self.global_cfg)
        stacked_grads = vmap(lambda p, b: gf(p, b)[1])
        opt = self._opt
        seg_axes = self._seg_axes
        spec = self.plane_spec

        def step(sp, opt_state, masks_p, seg_mats, batch, step_idx):
            params = plane.unpack_stacked(sp, spec)
            grads = stacked_grads(params, batch)
            grads = sg.project_stacked(grads, seg_axes, seg_mats)
            gp = plane.pack_stacked(grads, spec) * masks_p
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
        return _fused_round_start(gp, self._mask_rows(ks),
                                  self._filler_rows(ks))

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
        views = []
        for k in ks:
            s = self._round_seed(round_idx, k)
            down = self.family.down(global_params, self.global_cfg,
                                    self.client_cfgs[k], seed=s,
                                    mode=self.narrow_mode)
            views.append(self.family.up(down, self.client_cfgs[k],
                                        self.global_cfg, seed=s))
        return plane.pack_trees(views, self.plane_spec)

    def client_view(self, stacked, k: int):
        return tu.tree_map(lambda x: x[k], stacked)

    # ------------------------------------------------------------ training
    def _train_packed(self, sp: torch.Tensor, stacked_batches: Sequence,
                      masks_p: torch.Tensor, seg_mats) -> torch.Tensor:
        """One local-training round on the packed plane: fresh optimizer
        state (the per-client loop re-inits SGD momentum every round),
        one step per stacked batch, the plane updated in place."""
        t0 = time.perf_counter() if self.timing else 0.0
        opt_state = self._opt.init(sp)
        for i, batch in enumerate(stacked_batches):
            bt = {k: torch.as_tensor(v, device=self.device)
                  for k, v in batch.items()}
            sp, opt_state = self._step(sp, opt_state, masks_p, seg_mats, bt,
                                       i)
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._phase_s["train"] += time.perf_counter() - t0
        return sp

    def phase_stats(self, reset: bool = False):
        """Cumulative wall-clock seconds per round phase (``timing=True``
        only; ``train`` = the local-training steps of every chunk)."""
        out = dict(self._phase_s)
        if reset:
            for k in self._phase_s:
                self._phase_s[k] = 0.0
        return out

    # --------------------------------------------------------- aggregation
    def agg_stats(self) -> dict:
        """Accounting of the LAST aggregation pass: layout, rows and
        ``peak_bytes`` (the whole ``(K, P)`` sub-plane for "plane"; three
        ``(P,)`` buffers + one chunk for "stream")."""
        return dict(self._agg_stats)

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

    # ---------------------------------------------------------- full round
    def run_round(self, state, stacked_batches: Sequence, selected=None,
                  round_idx: int = 0):
        """One federated round over the participating subset (default:
        full cohort). ``state`` is the global tree; returns the next one
        (views of one fresh ``(P,)`` plane). ``stacked_batches`` leaves
        carry a leading axis of ``len(selected)``; ``round_idx`` seeds
        the round's To-Wider mappings."""
        sel = None if selected is None else list(selected)
        if sel == list(range(len(self.client_cfgs))):
            sel = None
        spec = self.plane_spec
        ks = list(range(len(self.client_cfgs))) if sel is None else sel
        layout = resolve_agg_layout(self.agg_layout,
                                    backend=self.device.type, k=len(ks),
                                    p=spec.size, k_chunk=self.k_chunk)
        if layout == "stream":
            return self._run_fedadp_stream(state, stacked_batches, sel,
                                           round_idx)
        w = subset_weights(self.n_samples, sel)
        gp = plane.pack(state, spec, what="run_round/state")
        need_cov = (self.agg_mode == "coverage"
                    or self.filler_mode == "global")
        if self._depth_only:
            start = self._round_start_packed(gp, sel)
            trained = self._train_packed(start, stacked_batches,
                                         self._mask_rows(ks), {})
            cov_p = self._cov_rows(ks) if need_cov else None
            out = self._aggregate_packed(
                trained, w, gp if need_cov else None, cov_p, None)
            return plane.unpack(out, spec)
        seeds = [self._round_seed(round_idx, k) for k in ks]
        segs = [self._client_seg(k, s) for k, s in zip(ks, seeds)]
        seg_mats = sg.stack_matrices([s[0] for s in segs], self.device)
        start = self._round_start_width(state, sel, round_idx)
        trained = self._train_packed(start, stacked_batches,
                                     self._mask_rows(ks), seg_mats)
        cov_p = (torch.stack([self._client_cov_row(k, s)
                              for k, s in zip(ks, seeds)])
                 if need_cov else None)
        mult_p = (torch.stack([self._client_mult_row(k, s)
                               for k, s in zip(ks, seeds)])
                  if self.agg_mode == "coverage" else None)
        out = self._aggregate_packed(
            trained, w, gp if need_cov else None, cov_p, mult_p)
        return plane.unpack(out, spec)

    def _run_fedadp_stream(self, state, stacked_batches: Sequence, sel,
                           round_idx: int):
        """The streaming fedadp round: the participating cohort is
        consumed in ``k_chunk``-row chunks — round start, local training
        and the in-place ``plane_accum`` update per chunk, so one
        ``(k_chunk, P)`` slab plus the accumulator's three ``(P,)``
        buffers is all the round state resident; ``finish`` closes with
        the one ``plane_finish`` pass (coverage rounds; a filler round's
        numerator is already the result). Same math as the whole-plane
        round (the masked weighted sum splits associatively; weights are
        the GLOBAL subset weights)."""
        spec = self.plane_spec
        ks = (list(range(len(self.client_cfgs))) if sel is None
              else list(sel))
        w = subset_weights(self.n_samples, sel)
        gp = plane.pack(state, spec, what="run_round/state")
        kc = default_k_chunk(len(ks), self.k_chunk)
        coverage = self.agg_mode == "coverage"
        fold = (not coverage) and self.filler_mode == "global"
        acc = kops.PlaneAccumulator(spec.size, device=self.device)
        for lo, hi in plane.chunk_bounds(len(ks), kc):
            cks = ks[lo:hi]
            m_rows = self._mask_rows(cks)
            if self._depth_only:
                seeds = None
                seg_mats: Dict = {}
                start = _fused_round_start(gp, m_rows,
                                           self._filler_rows(cks))
            else:
                seeds = [self._round_seed(round_idx, k) for k in cks]
                segs = [self._client_seg(k, s)
                        for k, s in zip(cks, seeds)]
                seg_mats = sg.stack_matrices([s[0] for s in segs],
                                             self.device)
                start = self._round_start_width(state, cks, round_idx)
            trained = self._train_packed(
                start, [{k: v[lo:hi] for k, v in b.items()}
                        for b in stacked_batches],
                m_rows, seg_mats)
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
            if coverage:
                acc.update(trained, wk, masks=cov_rows, mult=mult_rows)
            elif fold:
                acc.update(_fold_rows(trained, cov_rows, gp), wk)
            else:
                acc.update(trained, wk)
        out = acc.finish(renorm=coverage, fallback=gp if coverage else None)
        self._agg_stats = {"layout": "stream", "k_chunk": kc,
                           **acc.stats()}
        return plane.unpack(out, spec)
