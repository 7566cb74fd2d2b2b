"""Execution backends: who actually runs a federated round.

A backend takes a bound strategy (``fl/strategy.py``) and executes
``distribute -> local train -> collect -> aggregate`` for one round:

  * ``LoopBackend``     — the reference path: a Python loop over the
                          participating clients, each trained in its OWN
                          architecture (``family.loss_and_grad(cfg)``,
                          one per config name) with a fresh SGD-momentum
                          state every round, then the strategy's
                          ``aggregate`` on client trees (the fedavg
                          kernels through ``core.aggregation``). Every
                          strategy, any participation subset, any cohort.
  * ``UnifiedBackend``  — the cohort-parallel path: wraps
                          ``fl/engine.py``'s ``UnifiedEngine`` so a whole
                          round runs as one stacked program in the union
                          architecture on the packed ``(K, P)`` plane,
                          aggregated by the fedavg CUDA kernels. FedADP's
                          state is the global tree; the per-client
                          methods' state is the stacked tree of the
                          clients embedded at the fixed seed
                          (``engine.embed``).

Both draw a round's batches from the PARTICIPATING samplers only, in the
same order, so the two consume identical data streams under any
participation schedule, and both start local training from a fresh
optimizer state every round.

Surface to ``Federation``: bind(strategy) / init_state(generator) /
run_round(state, r, selected) / evaluate(state, r, batch) /
client_views(state, r) / samplers, and on the unified backend for
compressed runs wire_stats() / wire_residuals() / load_wire_residuals(arr)
/ plane_spec. Both take a ``device`` (None = CUDA).

``unified_ineligible_reason`` is the ``engine="auto"`` rule: unified when
the strategy supports it, the cohort's embedding is segment-representable
and the client batch streams align; it names the first failing condition.
``unified_eligible`` is its boolean face.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.device import DeviceLike, resolve_device, strict_f32
from repro_torch.fl.engine import UnifiedEngine
from repro_torch.fl.strategy import METHODS
from repro_torch.optim import sgd


class LoopBackend:
    """Per-client reference execution (exactly the paper's protocol)."""
    name = "loop"

    def __init__(self, family, client_cfgs: Sequence, samplers: List, *,
                 local_epochs: int = 1, lr: float = 0.01,
                 momentum: float = 0.0, device: DeviceLike = None):
        self.family = family
        self.client_cfgs = list(client_cfgs)
        self.samplers = samplers
        self.local_epochs = local_epochs
        self.device = resolve_device(device)
        strict_f32(self.device)
        self._opt = sgd(lr, momentum)
        self._grad_fns: Dict[str, Callable] = {}
        self.strategy = None

    def bind(self, strategy) -> "LoopBackend":
        self.strategy = strategy
        return self

    def _grad_fn(self, cfg):
        if cfg.name not in self._grad_fns:
            self._grad_fns[cfg.name] = self.family.loss_and_grad(cfg)
        return self._grad_fns[cfg.name]

    def _local_train(self, k: int, params):
        """Client k's local epochs in its own architecture, on a copy of
        ``params`` (the optimizer writes in place, and ``distribute``
        may hand out the state's own tensors)."""
        gf = self._grad_fn(self.client_cfgs[k])
        params = tu.tree_map(lambda t: t.detach().clone(), params)
        opt_state = self._opt.init(params)   # fresh momentum every round
        for step, batch in enumerate(
                self.samplers[k].round_batches(self.local_epochs)):
            bt = {n: torch.as_tensor(v, device=self.device)
                  for n, v in batch.items()}
            _, grads = gf(params, bt)
            params, opt_state = self._opt.update(grads, opt_state, params,
                                                 step)
        return params

    def init_state(self, generator=None):
        return self.strategy.init_state(generator, device=self.device)

    def run_round(self, state, round_idx: int, selected: Sequence[int]):
        s = self.strategy
        updates = []
        for k in selected:
            trained = self._local_train(k, s.distribute(state, round_idx, k))
            updates.append((k, s.collect(state, round_idx, k, trained)))
        return s.aggregate(state, round_idx, updates)

    def client_views(self, state, round_idx: int) -> List:
        return [self.strategy.client_view(state, k, round_idx)
                for k in range(len(self.client_cfgs))]

    def evaluate(self, state, round_idx: int, eval_batch) -> float:
        accs = [self.family.evaluate(p, c, eval_batch)
                for p, c in zip(self.client_views(state, round_idx),
                                self.client_cfgs)]
        return float(np.mean(accs))


class UnifiedBackend:
    """Cohort-parallel execution through ``UnifiedEngine``."""
    name = "unified"

    def __init__(self, family, client_cfgs: Sequence, samplers: List, *,
                 local_epochs: int = 1, lr: float = 0.01,
                 momentum: float = 0.0, mesh=None, seed: int = 0,
                 agg_layout: str = "auto", k_chunk: Optional[int] = None,
                 wire: str = "f32", wire_tile: int = 256,
                 wire_sparse: bool = False, compute_dtype: str = "f32",
                 attn_backend: str = "auto", device: DeviceLike = None):
        self.family = family
        self.client_cfgs = list(client_cfgs)
        self.samplers = samplers
        self.local_epochs = local_epochs
        self.lr, self.momentum = lr, momentum
        self.mesh, self.seed = mesh, seed
        self.agg_layout, self.k_chunk = agg_layout, k_chunk
        self.wire, self.wire_tile = wire, wire_tile
        self.wire_sparse = wire_sparse
        self.compute_dtype = compute_dtype
        self.attn_backend = attn_backend
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
        # the wire follows the same rule: a strategy carrying a compressed
        # wire wins; "f32" on the strategy defers to the backend's knob
        # (the deployment-wide default)
        wire = getattr(strategy, "wire", None)
        if wire in (None, "f32"):
            wire = self.wire
        wire_tile = getattr(strategy, "wire_tile", None) or self.wire_tile
        wire_sparse = (getattr(strategy, "wire_sparse", False)
                       or self.wire_sparse)
        # the local-training compute policy and the attention backend ride
        # the same precedence: a strategy's non-default setting wins
        compute_dtype = getattr(strategy, "compute_dtype", None)
        if compute_dtype in (None, "f32"):
            compute_dtype = self.compute_dtype
        attn_backend = getattr(strategy, "attn_backend", None)
        if attn_backend in (None, "auto"):
            attn_backend = self.attn_backend
        key = (strategy.name, getattr(strategy, "filler", "zero"),
               getattr(strategy, "agg_mode", "filler"),
               getattr(strategy, "coverage", "loose"),
               getattr(strategy, "narrow_mode", "paper"), embed_seed,
               tuple(n_samples), agg_layout, k_chunk, wire, wire_tile,
               wire_sparse, compute_dtype, attn_backend)
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
                k_chunk=k_chunk, wire=wire, wire_tile=wire_tile,
                wire_sparse=wire_sparse, compute_dtype=compute_dtype,
                attn_backend=attn_backend, device=self.device)
        return self

    @property
    def cohort_ctx(self):
        """The bound engine's client-axis context (``sharding.CohortCtx``)
        when it runs over a client mesh, else None."""
        if self.engine is None or self.engine._ctx.mesh is None:
            return None
        return self.engine._ctx

    @property
    def plane_spec(self):
        """The bound engine's packed layout (``core.plane.PlaneSpec``);
        ``None`` before ``bind``."""
        return self.engine.plane_spec if self.engine is not None else None

    def wire_stats(self) -> Optional[dict]:
        """Byte accounting of the engine's last compressed round (empty
        when ``wire="f32"``, None before ``bind``)."""
        return self.engine.wire_stats() if self.engine is not None else None

    def wire_residuals(self):
        """The engine's per-client error-feedback residual plane
        ``(K, P)`` f32, or None when no compressed round has run — what
        the Federation checkpoints next to the round state."""
        return (self.engine.wire_residuals() if self.engine is not None
                else None)

    def load_wire_residuals(self, arr):
        """Restore a checkpointed residual plane into the bound engine."""
        if self.engine is None:
            raise ValueError("load_wire_residuals needs a bound engine "
                             "(Federation binds before resuming)")
        self.engine.load_wire_residuals(arr)

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
        if self.strategy.kind == "global":
            return self.engine.init_global(generator)
        return self.engine.embed(
            self.strategy.init_state(generator, device=self.engine.device))

    def run_round(self, state, round_idx: int, selected: Sequence[int]):
        sel = list(selected)
        return self.engine.run_round(state, self._stacked_round_batches(sel),
                                     selected=sel, round_idx=round_idx)

    def client_views(self, state, round_idx: int) -> List:
        stacked = (self.engine.round_start(state, round_idx=round_idx)
                   if self.strategy.kind == "global" else state)
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


def unified_eligible(strategy, family, client_cfgs, samplers) -> bool:
    """The ``engine="auto"`` rule — see ``unified_ineligible_reason``."""
    return unified_ineligible_reason(strategy, family, client_cfgs,
                                     samplers) is None
