"""FedADP — Algorithm 1 of the paper, on client trees (the loop path).

Round t:
  1. for each selected client k:   omega_k <- NetChange(omega^t, omega_k)
     (To-Shallower + To-Narrower: server tailors the global model down)
  2. local training on client k's data
  3. omega_k <- NetChange(omega_k, omega^t)
     (To-Deeper + To-Wider: expand back to the global architecture)
  4. omega^{t+1} <- sum_k W_k omega_k   (FedAvg, Eq. 1-2)

``narrow_mode`` selects the paper's Alg. 3 ("paper") or the beyond-paper
function-preserving fold inverse ("fold").

Coverage knobs (single-sourced in ``core.aggregation``):
  * ``coverage``  — "loose" (``|up(ones)| > 0``, counts identity-conv
                    filler taps) or "strict" (parameter landing sites).
  * ``agg_mode``  — "filler": Eq. 1 verbatim; "coverage": the
                    HeteroFL-style renormalized average over covering
                    clients, multiplicity-aware on width-heterogeneous
                    cohorts, uncovered coordinates keeping the server's
                    values.

Step 4 is ``core.aggregation.fedavg`` / ``fedavg_masked``: on CUDA
tensors the fedavg kernels (at the paper's K = 20 and full width the
"auto" layout streams: ``plane_accum`` per 16-row chunk, then
``plane_finish`` for a coverage round). The coverage masks and
multiplicity trees are built on ``device`` (None = CUDA).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.aggregation import (AGG_LAYOUTS, AGG_MODES,
                                          COVERAGE_POLICIES, client_weights,
                                          coverage_mask, fedavg,
                                          fedavg_masked, multiplicity,
                                          subset_weights)
from repro_torch.core.netchange import KeyedCache, round_embed_seed
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class FedADP:
    family: Any
    client_cfgs: Sequence[Any]
    n_samples: Sequence[int]
    narrow_mode: str = "paper"
    coverage: str = "loose"      # the loop-reference reading
    agg_mode: str = "filler"     # the paper's Eq. 1
    base_seed: int = 0
    agg_layout: Optional[str] = None   # None/"auto" resolves per cohort
                                       # shape; "plane" | "stream" |
                                       # "leaf" pin one
    k_chunk: Optional[int] = None      # streaming chunk rows (None = auto)
    device: DeviceLike = None          # where masks are built (None = CUDA)

    def __post_init__(self):
        if self.agg_layout not in (None, "auto") + AGG_LAYOUTS:
            raise ValueError(
                f"agg_layout={self.agg_layout!r}, expected None, 'auto' "
                f"or one of {AGG_LAYOUTS}")
        if self.k_chunk is not None and int(self.k_chunk) < 1:
            raise ValueError(f"k_chunk={self.k_chunk!r}, expected a "
                             f"positive int or None")
        if self.coverage not in COVERAGE_POLICIES:
            raise ValueError(f"coverage={self.coverage!r}, expected one of "
                             f"{COVERAGE_POLICIES}")
        if self.agg_mode not in AGG_MODES:
            raise ValueError(f"agg_mode={self.agg_mode!r}, expected one of "
                             f"{AGG_MODES}")
        self.global_cfg = self.family.union(list(self.client_cfgs))
        self.weights = client_weights(self.n_samples)
        # masks are seed-invariant on depth-only cohorts (the seed only
        # steers To-Wider duplication), so they cache per (client,
        # policy) there and per (client, policy, seed) otherwise; one
        # bounded KeyedCache holds masks and multiplicities
        self._depth_only = self.family.depth_only(list(self.client_cfgs))
        self._cache = KeyedCache(n_clients=len(self.client_cfgs))

    def init_global(self, generator=None, *, device: DeviceLike = None):
        dev = resolve_device(device if device is not None else self.device)
        return self.family.init(generator, self.global_cfg, device=dev)

    def _seed(self, round_idx: int, k: int) -> int:
        # one seed per (round, client), the unified engine's formula: the
        # distribute-fold and collect-widen mappings of a round are
        # mutual inverses, and both paths draw the same ones
        return round_embed_seed(self.base_seed, round_idx, k)

    def cache_stats(self) -> dict:
        """Hit/miss/size/bound of the mask / multiplicity cache."""
        return self._cache.stats()

    def distribute(self, global_params, round_idx: int, k: int):
        """Step 1: NetChange(omega^t, omega_k)."""
        return self.family.down(global_params, self.global_cfg,
                                self.client_cfgs[k],
                                seed=self._seed(round_idx, k),
                                mode=self.narrow_mode)

    def collect(self, client_params, round_idx: int, k: int):
        """Step 3: NetChange(omega_k, omega^t)."""
        return self.family.up(client_params, self.client_cfgs[k],
                              self.global_cfg,
                              seed=self._seed(round_idx, k))

    def coverage_mask(self, round_idx: int, k: int, *,
                      policy: Optional[str] = None):
        """Global-space 0/1 mask of the coordinates client k's expansion
        covers at this round, under this instance's ``coverage`` policy
        (or an explicit override) — ``core.aggregation.coverage_mask``,
        cached per (client, policy) on depth-only cohorts and per
        (client, policy, round seed) otherwise."""
        policy = policy or self.coverage
        seed = self._seed(round_idx, k)

        def build():
            return coverage_mask(self.family, self.client_cfgs[k],
                                 self.global_cfg, policy=policy, seed=seed,
                                 device=resolve_device(self.device))

        key = ("mask", k, policy, None if self._depth_only else seed)
        return self._cache.get(key, build)

    def coverage_multiplicity(self, round_idx: int, k: int):
        """Per-coordinate duplication counts of client k's expansion at
        this round — None on depth-only cohorts, where every count is 1.
        Cached like the masks."""
        if self._depth_only:
            return None
        seed = self._seed(round_idx, k)
        return self._cache.get(
            ("mult", k, seed),
            lambda: multiplicity(self.family, self.client_cfgs[k],
                                 self.global_cfg, seed=seed,
                                 device=resolve_device(self.device)))

    def aggregate(self, expanded: Sequence,
                  selected: Optional[Sequence[int]] = None, *,
                  round_idx: Optional[int] = None, global_params=None):
        """Step 4 (Eq. 1-2): FedAvg of the expanded client models, with
        W_k renormalized over the participating subset.

        ``agg_mode="coverage"`` replaces Eq. 1 with the per-coordinate
        renormalized average over covering clients; coordinates no
        participant covers keep ``global_params`` (both it and
        ``round_idx``, whose seeds the masks must use, are required)."""
        selected = list(selected if selected is not None
                        else range(len(self.client_cfgs)))
        w = subset_weights(self.n_samples, selected)
        if self.agg_mode == "coverage":
            if global_params is None:
                raise ValueError(
                    'agg_mode="coverage" needs global_params: coordinates '
                    "no participant covers keep the server's values")
            if round_idx is None:
                raise ValueError(
                    'agg_mode="coverage" needs round_idx: the coverage '
                    "masks must use the seed the updates were embedded "
                    "with")
            masks = [self.coverage_mask(round_idx, k) for k in selected]
            mults = [self.coverage_multiplicity(round_idx, k)
                     for k in selected]
            return fedavg_masked(expanded, w, masks,
                                 mult=(None if mults[0] is None else mults),
                                 renorm=True, fallback=global_params,
                                 layout=self.agg_layout,
                                 k_chunk=self.k_chunk)
        return fedavg(expanded, w, layout=self.agg_layout,
                      k_chunk=self.k_chunk)

    def round(self, global_params, local_train: Callable, round_idx: int,
              selected: Optional[Sequence[int]] = None):
        """One FedADP round. ``local_train(k, client_params)`` runs the
        client-side update and returns new client params."""
        selected = list(selected if selected is not None
                        else range(len(self.client_cfgs)))
        expanded = []
        for k in selected:
            ck = self.distribute(global_params, round_idx, k)
            ck = local_train(k, ck)
            expanded.append(self.collect(ck, round_idx, k))
        return self.aggregate(expanded, selected, round_idx=round_idx,
                              global_params=global_params)
