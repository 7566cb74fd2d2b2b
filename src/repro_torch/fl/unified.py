"""Unified-space FedADP with a caller's loss: a FedADP-shaped facade
over ``fl/engine.py``'s ``UnifiedEngine`` for callers that drive rounds
with pre-stacked batches and their own union-space loss.

The engine owns the mechanics: the packed ``(K, P)`` plane, the
mask- and segment-projected ``vmap(grad)`` step, and the aggregation
through the fedavg CUDA kernels. Exact for depth-heterogeneous cohorts
(the filler is the constant FedADP's ``up()`` inserts);
width-heterogeneous cohorts advance their To-Wider mappings with
``round()``'s ``round_idx``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence

from repro_torch.device import DeviceLike
from repro_torch.fl.engine import UnifiedEngine


@dataclass
class UnifiedFedADP:
    family: Any
    client_cfgs: Sequence[Any]
    n_samples: Sequence[int]
    loss_fn: Callable            # loss_fn(params, batch) under the UNION cfg
    lr: float = 0.05
    device: DeviceLike = None    # None = CUDA

    def __post_init__(self):
        self._engine = UnifiedEngine(
            self.family, self.client_cfgs, self.n_samples, lr=self.lr,
            momentum=0.0, method="fedadp", loss_fn=self.loss_fn,
            device=self.device)
        self.global_cfg = self._engine.global_cfg
        self.weights = self._engine.weights
        self.masks = self._engine.masks

    def init_global(self, generator=None):
        return self._engine.init_global(generator)

    def round(self, global_params, stacked_batches: List, *, epochs: int = 1,
              round_idx: int = 0):
        """``stacked_batches``: dicts whose leaves carry a leading K axis
        (one slice per client). One FedADP round, delegated to the
        engine so round start, training and aggregation share one round
        seed."""
        return self._engine.run_round(
            global_params, [b for _ in range(epochs) for b in stacked_batches],
            round_idx=round_idx)
