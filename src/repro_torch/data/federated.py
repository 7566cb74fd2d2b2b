"""Federated partitioning: split a dataset across K clients.

``dirichlet_partition`` is the standard non-IID label-skew protocol
(Dir(alpha) over class proportions per client). ``iid_partition`` matches
the paper's main setting (it reports no explicit skew protocol; clients
draw 20% of their local data per round — see ``ClientSampler``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid_partition(n: int, k: int, *, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(part) for part in np.array_split(idx, k)]


def dirichlet_partition(labels: np.ndarray, k: int, *, alpha: float = 0.5,
                        seed: int = 0, min_size: int = 8,
                        max_retries: int = 1000) -> List[np.ndarray]:
    """Rejection-sample Dir(alpha) splits until every client holds at
    least ``min_size`` samples. Infeasible settings (e.g. ``k * min_size``
    close to or above ``len(labels)``, or a tiny ``alpha`` that
    concentrates whole classes on single clients) fail fast with a
    ``ValueError`` after ``max_retries`` draws instead of looping
    forever."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(max_retries):
        parts: List[List[int]] = [[] for _ in range(k)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * k)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx, cuts)):
                parts[i].extend(part.tolist())
        if min(len(p) for p in parts) >= min_size:
            return [np.sort(np.asarray(p)) for p in parts]
    raise ValueError(
        f"dirichlet_partition: no draw satisfied min_size={min_size} after "
        f"{max_retries} retries (n={len(labels)}, k={k}, alpha={alpha}); "
        "lower min_size or k, or raise alpha")


class ClientSampler:
    """Per-round local batch stream. The paper: 'Clients will use 20% of
    their datasets in each round of training', local epochs E over it.

    Tail handling: a trailing batch smaller than ``min_batch`` is MERGED
    into the previous batch (the last batch can grow up to
    ``batch_size + min_batch - 1``), so no drawn sample is silently
    dropped and a client with any data contributes at least one step per
    round — previously a <2-sample tail was discarded, which could leave
    a client at zero steps. When the whole per-round draw is smaller
    than ``min_batch`` it is yielded as-is (there is nothing to merge
    into)."""

    def __init__(self, data: Dict[str, np.ndarray], indices: np.ndarray, *,
                 round_fraction: float = 0.2, batch_size: int = 64,
                 seed: int = 0, min_batch: int = 2):
        self.data = data
        self.indices = np.asarray(indices)
        self.round_fraction = round_fraction
        self.batch_size = batch_size
        self.min_batch = min_batch
        self.rng = np.random.default_rng(seed)

    @property
    def n_samples(self) -> int:
        return len(self.indices)

    def _round_take(self) -> int:
        return min(max(self.batch_size,
                       int(len(self.indices) * self.round_fraction)),
                   len(self.indices))

    def _batch_starts(self, take: int):
        """Start offsets of one epoch's batches over a ``take``-sample
        draw — the single definition both ``round_batches`` and
        ``steps_per_epoch`` read, so they cannot desynchronize."""
        starts = list(range(0, take, self.batch_size))
        if len(starts) > 1 and take - starts[-1] < self.min_batch:
            starts.pop()               # merge the short tail into the
                                       # previous batch
        return starts

    def steps_per_epoch(self) -> int:
        """Exact number of batches one epoch of ``round_batches`` yields."""
        return len(self._batch_starts(self._round_take()))

    def round_batches(self, epochs: int = 1):
        sel = self.rng.choice(self.indices, size=self._round_take(),
                              replace=False)
        starts = self._batch_starts(len(sel))
        for _ in range(epochs):
            order = self.rng.permutation(len(sel))
            for j, i in enumerate(starts):
                end = starts[j + 1] if j + 1 < len(starts) else len(sel)
                batch_idx = sel[order[i:end]]
                yield {k: v[batch_idx] for k, v in self.data.items()}
