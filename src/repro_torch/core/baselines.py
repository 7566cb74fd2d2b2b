"""Baselines from the paper's evaluation (Section IV.A.3).

  * Standalone    — purely local training, no aggregation.
  * Clustered-FL  — clients clustered by identical architecture; FedAvg
    within each cluster (Sattler et al., model-agnostic clustering keyed
    here on architecture identity, the setting the paper evaluates).
  * FlexiFed (Clustered-Common) — the longest common PREFIX of layers
    (identical shape, scanning the sequential chain from the input) is
    aggregated across ALL clients; the remaining (personalized) layers are
    aggregated within same-architecture clusters.

Every average is ``core.aggregation.fedavg`` over client trees: on CUDA
tensors the fedavg kernels (``weighted_sum`` for a plane under 256 MiB,
``plane_accum`` for a streamed one), on CPU tensors their plain versions.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import tree as tu
from repro_torch.core.aggregation import fedavg, subset_weights
from repro_torch.core.family import VGGFamily


def _cluster_ids(cfgs) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = defaultdict(list)
    for i, c in enumerate(cfgs):
        out[c.name].append(i)
    return dict(out)


def _resolve_selected(selected, n: int) -> List[int]:
    return list(selected if selected is not None else range(n))


class Standalone:
    def __init__(self, client_cfgs, n_samples):
        self.client_cfgs = list(client_cfgs)

    def aggregate(self, client_params: List,
                  selected: Optional[Sequence[int]] = None) -> List:
        return list(client_params)

    def round(self, client_params: List, local_train: Callable, round_idx: int):
        return [local_train(k, p) for k, p in enumerate(client_params)]


class ClusteredFL:
    def __init__(self, client_cfgs, n_samples):
        self.client_cfgs = list(client_cfgs)
        self.n_samples = np.asarray(n_samples, np.float64)
        self.clusters = _cluster_ids(self.client_cfgs)

    def aggregate(self, client_params: List,
                  selected: Optional[Sequence[int]] = None) -> List:
        """FedAvg within each (architecture cluster ∩ selected); clients
        outside ``selected`` keep their parameters untouched."""
        sel = set(_resolve_selected(selected, len(client_params)))
        new = list(client_params)
        for ids in self.clusters.values():
            ids = [i for i in ids if i in sel]
            if not ids:
                continue
            agg = fedavg([new[i] for i in ids],
                         subset_weights(self.n_samples, ids))
            for i in ids:
                new[i] = agg
        return new

    def round(self, client_params: List, local_train: Callable, round_idx: int):
        return self.aggregate(
            [local_train(k, p) for k, p in enumerate(client_params)])


class FlexiFed:
    """Clustered-Common strategy. ``chain_fn(cfg, params)`` must return the
    ordered list of (layer-id, sub-tree) pairs of the sequential chain,
    the sub-trees being the client tree's own dicts (not copies)."""

    def __init__(self, client_cfgs, n_samples, chain_fn):
        self.client_cfgs = list(client_cfgs)
        self.n_samples = np.asarray(n_samples, np.float64)
        self.clusters = _cluster_ids(self.client_cfgs)
        self.chain_fn = chain_fn

    def _chains(self, client_params, ids: Sequence[int]) -> Dict[int, List]:
        return {i: self.chain_fn(self.client_cfgs[i], client_params[i])
                for i in ids}

    def _common_of(self, chains: Dict[int, List]) -> List:
        ordered = list(chains.values())
        common = []
        for pos in range(min(len(c) for c in ordered)):
            ids = {c[pos][0] for c in ordered}
            shapes0 = [tuple(t.shape) for t in tu.leaves(ordered[0][pos][1])]
            same_shape = all(
                [tuple(t.shape) for t in tu.leaves(c[pos][1])] == shapes0
                for c in ordered)
            if len(ids) == 1 and same_shape:
                common.append(pos)
            else:
                break
        return common

    def _common_prefix(self, client_params) -> List:
        return self._common_of(
            self._chains(client_params, range(len(client_params))))

    def aggregate(self, client_params: List,
                  selected: Optional[Sequence[int]] = None) -> List:
        """Clustered-Common over the participating subset: the common
        prefix of the SELECTED clients' chains is averaged across all of
        them, the remainder within (cluster ∩ selected). Non-participants
        are untouched. NOTE: writes the averages into the selected
        entries' param dicts in place (through the chain views) and
        returns the list."""
        sel = _resolve_selected(selected, len(client_params))
        new = list(client_params)
        chains = self._chains(new, sel)
        common = self._common_of(chains)
        w_all = subset_weights(self.n_samples, sel)
        for pos in common:
            agg = fedavg([chains[i][pos][1] for i in sel], w_all)
            for i in sel:
                _assign(chains[i][pos][1], agg)
        # aggregate the personalized remainder within clusters
        sel_set = set(sel)
        for ids in self.clusters.values():
            ids = [i for i in ids if i in sel_set]
            if not ids:
                continue
            w = subset_weights(self.n_samples, ids)
            for pos in range(len(common), len(chains[ids[0]])):
                agg = fedavg([chains[i][pos][1] for i in ids], w)
                for i in ids:
                    _assign(chains[i][pos][1], agg)
        return new

    def round(self, client_params: List, local_train: Callable, round_idx: int):
        return self.aggregate(
            [local_train(k, p) for k, p in enumerate(client_params)])


def _assign(container: Dict, values: Dict):
    for k, v in values.items():
        container[k] = v


def vgg_chain(cfg, params) -> List:
    """Sequential chain for the VGG family: (layer-id, param-dict) pairs,
    the dicts being ``params``' own. Ids and tree paths come from
    ``VGGFamily.chain_paths`` — the single source the unified engine's
    FlexiFed grouping also uses."""
    return [(lid, tu.get(params, path))
            for lid, path in VGGFamily().chain_paths(cfg)]
