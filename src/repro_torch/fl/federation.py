"""Federation: the orchestrator that owns rounds, participation and
metrics callbacks::

    strategy = make_strategy("fedadp", family, cfgs, n_samples)
    backend  = UnifiedBackend(family, cfgs, samplers, local_epochs=2)
    result   = Federation(strategy, backend, rounds=20,
                          eval_batch=test).run(torch.Generator())

Participation schedules:
  * full            — ``Participation()``: every client, every round,
  * fixed fraction  — ``Participation.cycle(f)``: a deterministic rotating
                      window of ``max(1, round(f*K))`` clients,
  * seeded sampling — ``Participation.sample(f, seed)``: a fresh
                      without-replacement draw per round, derived from
                      ``(seed, round)`` only.

Checkpoint/resume comes with the loop slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

PARTICIPATION_MODES = ("sample", "cycle")


@dataclass(frozen=True)
class Participation:
    """Per-round client selection. ``fraction=1.0`` is full participation;
    otherwise ``max(1, round(fraction*K))`` clients per round, chosen by
    ``mode``."""
    fraction: float = 1.0
    seed: int = 0
    mode: str = "sample"

    def __post_init__(self):
        if not (0.0 < self.fraction <= 1.0):
            raise ValueError(f"participation fraction={self.fraction!r} "
                             "must be in (0, 1]")
        if self.mode not in PARTICIPATION_MODES:
            raise ValueError(f"participation mode={self.mode!r}, expected "
                             f"one of {PARTICIPATION_MODES}")

    @classmethod
    def sample(cls, fraction: float, seed: int = 0) -> "Participation":
        return cls(fraction=fraction, seed=seed, mode="sample")

    @classmethod
    def cycle(cls, fraction: float) -> "Participation":
        return cls(fraction=fraction, mode="cycle")

    @property
    def full(self) -> bool:
        return self.fraction >= 1.0

    def select(self, round_idx: int, n_clients: int) -> List[int]:
        if self.full:
            return list(range(n_clients))
        m = max(1, int(round(self.fraction * n_clients)))
        if self.mode == "cycle":
            start = (round_idx * m) % n_clients
            return sorted((start + i) % n_clients for i in range(m))
        rng = np.random.default_rng((self.seed, round_idx))
        return sorted(int(i) for i in
                      rng.choice(n_clients, size=m, replace=False))


class Federation:
    """Round orchestrator over a (strategy, backend) pair. ``callbacks``
    are called once per round with ``{"round", "selected", "wall_s"[,
    "acc"]}``."""

    def __init__(self, strategy, backend, *, rounds: int,
                 eval_batch=None, eval_every: int = 1,
                 participation: Optional[Participation] = None,
                 callbacks: Sequence[Callable[[Dict[str, Any]], None]] = ()):
        self.participation = participation or Participation()
        if rounds < 0:
            raise ValueError(f"rounds={rounds!r} must be >= 0")
        if eval_every < 1:
            raise ValueError(f"eval_every={eval_every!r} must be >= 1")
        self.strategy = strategy
        self.backend = backend.bind(strategy)
        self.rounds = rounds
        self.eval_batch = eval_batch
        self.eval_every = eval_every
        self.callbacks = list(callbacks)

    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[str, Any]:
        # re-bind: another Federation may have bound the shared backend
        self.backend.bind(self.strategy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        state = self.backend.init_state(generator)
        hist: List[float] = []
        t0 = time.time()
        for r in range(self.rounds):
            selected = self.participation.select(r, self.strategy.n_clients)
            state = self.backend.run_round(state, r, selected)
            record: Dict[str, Any] = {"round": r + 1, "selected": selected,
                                      "wall_s": time.time() - t0}
            if (r + 1) % self.eval_every == 0 and self.eval_batch is not None:
                acc = self.backend.evaluate(state, r + 1, self.eval_batch)
                hist.append(acc)
                record["acc"] = acc
            for cb in self.callbacks:
                cb(record)
        self.state = state
        return self._result(state, hist, t0)

    def _result(self, state, hist, t0) -> Dict[str, Any]:
        wall = time.time() - t0   # training time only: the final catch-up
                                  # eval below must not skew benchmarks
        final_acc = hist[-1] if hist else None
        if final_acc is None and self.eval_batch is not None:
            final_acc = self.backend.evaluate(state, self.rounds,
                                              self.eval_batch)
        return {"history": hist,
                "final_acc": final_acc,
                "client_params": self.backend.client_views(state,
                                                           self.rounds),
                "global_params": (state if self.strategy.kind == "global"
                                  else None),
                "wall_s": wall}
