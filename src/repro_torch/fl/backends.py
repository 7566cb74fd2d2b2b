"""Execution backends: who actually runs a federated round.

``UnifiedBackend`` is the cohort-parallel path: it wraps
``fl/engine.py``'s ``UnifiedEngine`` so a whole round runs as one
stacked program in the union architecture, aggregated by the fedavg
CUDA kernels. Partial participation draws batches from the
participants' samplers only (the same per-sampler rng stream a per-client
loop would consume). The per-client ``LoopBackend`` comes with the loop
slice (ROADMAP.md queue 1).

Surface to ``Federation``: bind(strategy) / init_state(generator) /
run_round(state, r, selected) / evaluate(state, r, batch) /
client_views(state, r) / samplers.

``unified_ineligible_reason`` is the ``engine="auto"`` rule: unified when
the strategy supports it, the cohort's embedding is segment-representable
and the client batch streams align; it names the first failing condition.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import not_ported
from repro_torch.device import DeviceLike
from repro_torch.fl.engine import UnifiedEngine
from repro_torch.fl.strategy import METHODS


class UnifiedBackend:
    """Cohort-parallel execution through ``UnifiedEngine``."""
    name = "unified"

    def __init__(self, family, client_cfgs: Sequence, samplers: List, *,
                 local_epochs: int = 1, lr: float = 0.01,
                 momentum: float = 0.0, mesh=None, seed: int = 0, agg_layout: str = "auto",
                 k_chunk: Optional[int] = None, device: DeviceLike = None):
        self.family = family
        self.client_cfgs = list(client_cfgs)
        self.samplers = samplers
        self.local_epochs = local_epochs
        self.lr, self.momentum = lr, momentum
        self.mesh, self.seed = mesh, seed
        self.agg_layout, self.k_chunk = agg_layout, k_chunk
        self.device = device
        self.strategy = None
        self.engine: Optional[UnifiedEngine] = None
        self._engine_key = None

    def bind(self, strategy) -> "UnifiedBackend":
        if strategy.name not in METHODS:
            raise ValueError(
                f"unified backend does not support {strategy.name!r}")
        self.strategy = strategy
        # aggregation weights come from the STRATEGY's n_samples
        n_samples = [int(n) for n in strategy.n_samples]
        # the NetChange seed, layout and chunk: an explicit strategy
        # setting wins over the backend's knob; the strategy carries the
        # rest of the engine's knobs
        embed_seed = getattr(strategy, "base_seed", self.seed)
        agg_layout = getattr(strategy, "agg_layout", None)
        if agg_layout in (None, "auto"):
            agg_layout = self.agg_layout
        k_chunk = getattr(strategy, "k_chunk", None)
        if k_chunk is None:
            k_chunk = self.k_chunk
        wire = getattr(strategy, "wire", "f32")
        compute_dtype = getattr(strategy, "compute_dtype", "f32")
        attn_backend = getattr(strategy, "attn_backend", "auto")
        key = (strategy.name, getattr(strategy, "filler", "zero"),
               getattr(strategy, "agg_mode", "filler"),
               getattr(strategy, "coverage", "loose"),
               getattr(strategy, "narrow_mode", "paper"), embed_seed,
               tuple(n_samples), agg_layout, k_chunk, wire, compute_dtype,
               attn_backend)
        if self.engine is None or self._engine_key != key:
            self._engine_key = key
            self.engine = UnifiedEngine(
                self.family, self.client_cfgs, n_samples,
                lr=self.lr, momentum=self.momentum, method=strategy.name,
                filler_mode=getattr(strategy, "filler", "zero"),
                agg_mode=getattr(strategy, "agg_mode", "filler"),
                coverage=getattr(strategy, "coverage", "loose"),
                narrow_mode=getattr(strategy, "narrow_mode", "paper"),
                mesh=self.mesh,
                embed_seed=embed_seed, agg_layout=agg_layout,
                k_chunk=k_chunk, wire=wire, compute_dtype=compute_dtype,
                attn_backend=attn_backend, device=self.device)
        return self

    def _stacked_round_batches(self, selected: Sequence[int]
                               ) -> List[Dict[str, np.ndarray]]:
        """One round of local batches from the PARTICIPATING samplers,
        stacked on a leading axis (``selected`` order)."""
        per = [list(self.samplers[k].round_batches(self.local_epochs))
               for k in selected]
        counts = {len(b) for b in per}
        if len(counts) != 1:
            raise ValueError(
                "unified backend needs aligned client batch streams "
                f"(got per-client step counts {sorted(counts)})")
        out = []
        for t in range(counts.pop()):
            shapes = {tuple((k, v.shape) for k, v in sorted(b[t].items()))
                      for b in per}
            if len(shapes) != 1:
                raise ValueError(
                    "unified backend needs identical batch shapes across "
                    "clients")
            out.append({k: np.stack([b[t][k] for b in per])
                        for k in per[0][t]})
        return out

    def init_state(self, generator=None):
        if self.strategy.kind != "global":
            raise not_ported("per-client-state methods", "the loop path")
        return self.engine.init_global(generator)

    def run_round(self, state, round_idx: int, selected: Sequence[int]):
        sel = list(selected)
        return self.engine.run_round(state, self._stacked_round_batches(sel),
                                     selected=sel, round_idx=round_idx)

    def client_views(self, state, round_idx: int) -> List:
        stacked = self.engine.round_start(state, round_idx=round_idx)
        return [self.engine.client_view(stacked, k)
                for k in range(len(self.client_cfgs))]

    def evaluate(self, state, round_idx: int, eval_batch) -> float:
        gcfg = self.engine.global_cfg
        accs = [self.family.evaluate(p, gcfg, eval_batch)
                for p in self.client_views(state, round_idx)]
        return float(np.mean(accs))


def unified_ineligible_reason(strategy, family, client_cfgs,
                              samplers) -> Optional[str]:
    """Why ``engine="auto"`` could not take the unified engine for this
    run — None when it can: a unified-engine method, a
    segment-representable cohort, and aligned client batch streams."""
    if strategy.name not in METHODS:
        return (f"strategy {strategy.name!r} is not a unified-engine "
                f"method (supported: {', '.join(METHODS)})")
    cfgs = list(client_cfgs)
    rep = getattr(family, "segment_representable", None)
    representable = rep(cfgs) if rep is not None else family.depth_only(cfgs)
    if not representable:
        return ("cohort embedding is not segment-representable (only "
                "depth and supported width dimensions may vary — "
                "family.segment_representable)")
    if len({s.n_samples for s in samplers}) != 1:
        return ("ragged client datasets (unequal n_samples) — stacked "
                "batch streams would not align")
    if len({s.batch_size for s in samplers}) != 1:
        return "unequal client batch sizes — stacked batches must align"
    if len({getattr(s, "round_fraction", None) for s in samplers}) != 1:
        return ("unequal per-round data fractions — stacked batch "
                "streams would not align")
    return None
