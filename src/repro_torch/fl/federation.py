"""Federation: the orchestrator that owns rounds, participation, metrics
callbacks, and checkpoint/resume::

    strategy = make_strategy("fedadp", family, cfgs, n_samples)
    backend  = LoopBackend(family, cfgs, samplers, local_epochs=2)
    result   = Federation(strategy, backend, rounds=20,
                          eval_batch=test).run(torch.Generator())

(or ``UnifiedBackend`` for the cohort-parallel engine).

Participation schedules:
  * full            — ``Participation()``: every client, every round,
  * fixed fraction  — ``Participation.cycle(f)``: a deterministic rotating
                      window of ``max(1, round(f*K))`` clients,
  * seeded sampling — ``Participation.sample(f, seed)``: a fresh
                      without-replacement draw per round, derived from
                      ``(seed, round)`` only.

Checkpoints (``checkpoint_dir`` + ``checkpoint_every``) hold the
backend's state tree (the global tree; the stacked client tree on the
unified engine; the list of client trees for a per-client method on the
loop, keyed ``"<k>/<path>"`` as the JAX package keys it) plus ``round``, ``history`` and the data samplers'
numpy rng states in the manifest (``repro_torch.checkpoint``, the JAX
package's file layout), and for a compressed wire the per-client
error-feedback residual plane in a sibling ``round_XXXX.wire.npz`` —
exactly the state a run consumes, so ``run(resume_from=path)``
reproduces the uninterrupted run.

Under a client mesh (a backend whose ``cohort_ctx`` has one) every rank
holds the same round state and the same sampler rng states (every rank
draws every participant's batches and keeps its rows), so the files have
the one-process layout: the residual plane is gathered on every rank,
the mesh's first rank alone writes, and every rank waits at a barrier
after the write. Every rank resumes from the same file; a mesh's file
resumes in one process and the other way round.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import (load_plane, load_pytree, save_plane,
                                    save_pytree)

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


# ------------------------------------------------------------ checkpoints
def checkpoint_path(directory: str, round_idx: int) -> str:
    return os.path.join(directory, f"round_{round_idx:04d}.npz")


def wire_checkpoint_path(path: str) -> str:
    """The sibling file holding a compressed run's per-client
    error-feedback residual plane: ``round_XXXX.wire.npz`` next to
    ``round_XXXX.npz`` (``checkpoint.save_plane``, bit-exact)."""
    root, ext = os.path.splitext(path)
    return root + ".wire" + ext


def save_round_checkpoint(path: str, state, *, round_idx: int,
                          history: Sequence[float] = (),
                          samplers: Sequence = (),
                          meta: Optional[Dict[str, Any]] = None):
    """Persist ``(round, state, data-rng)``: the state tree into the npz
    payload, everything else into the JSON manifest (sampler rng states
    are numpy ``bit_generator.state`` dicts, plain JSON)."""
    save_pytree(path, state, extra={
        "round": int(round_idx),
        "history": [float(h) for h in history],
        "sampler_rng": [s.rng.bit_generator.state for s in samplers],
        "meta": meta or {}})


def load_round_checkpoint(path: str, like=None):
    """Returns ``(state, extra)``; ``like`` (a template state tree, e.g.
    a fresh ``backend.init_state``) arranges the tensors into its
    structure, dtypes and devices."""
    return load_pytree(path, like=like)


def restore_sampler_rngs(samplers: Sequence, extra: Dict[str, Any]):
    states = extra.get("sampler_rng") or []
    if states and len(states) != len(samplers):
        raise ValueError(
            f"checkpoint has {len(states)} sampler rng states, run has "
            f"{len(samplers)} samplers")
    for s, st in zip(samplers, states):
        s.rng.bit_generator.state = st


class Federation:
    """Round orchestrator over a (strategy, backend) pair. ``callbacks``
    are called once per round with ``{"round", "selected", "wall_s"[,
    "wire_bytes"][, "acc"]}``. ``checkpoint_every=N`` with
    ``checkpoint_dir`` writes ``round_XXXX.npz`` after every N-th round;
    ``run(resume_from=path)`` continues a run from such a file."""

    def __init__(self, strategy, backend, *, rounds: int,
                 eval_batch=None, eval_every: int = 1,
                 participation: Optional[Participation] = None,
                 callbacks: Sequence[Callable[[Dict[str, Any]], None]] = (),
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0):
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
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every

    def run(self, generator: Optional[torch.Generator] = None, *,
            resume_from: Optional[str] = None,
            init_state: Any = None) -> Dict[str, Any]:
        """Run the rounds from ``backend.init_state(generator)``, or from
        ``init_state`` (a state in the backend's layout, e.g. an earlier
        ``backend.init_state``; the rounds may write into it), or on from
        the checkpoint ``resume_from``."""
        # re-bind: another Federation may have bound the shared backend
        self.backend.bind(self.strategy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        state = (self.backend.init_state(generator) if init_state is None
                 else init_state)
        start, hist = 0, []
        if resume_from is not None:
            state, extra = load_round_checkpoint(resume_from, like=state)
            start, hist = extra["round"], list(extra["history"])
            restore_sampler_rngs(self.backend.samplers, extra)
            # a compressed run's error-feedback residuals ride a sibling
            # plane file: restore them so the resumed run matches
            wp = wire_checkpoint_path(resume_from)
            lw = getattr(self.backend, "load_wire_residuals", None)
            if os.path.exists(wp) and callable(lw):
                arr, _, _ = load_plane(wp)
                lw(arr)
        t0 = time.time()
        for r in range(start, self.rounds):
            selected = self.participation.select(r, self.strategy.n_clients)
            state = self.backend.run_round(state, r, selected)
            record: Dict[str, Any] = {"round": r + 1, "selected": selected,
                                      "wall_s": time.time() - t0}
            ws = getattr(self.backend, "wire_stats", None)
            wire_stats = ws() if callable(ws) else None
            if wire_stats:
                record["wire_bytes"] = wire_stats["bytes_per_round"]
            if (r + 1) % self.eval_every == 0 and self.eval_batch is not None:
                acc = self.backend.evaluate(state, r + 1, self.eval_batch)
                hist.append(acc)
                record["acc"] = acc
            for cb in self.callbacks:
                cb(record)
            if (self.checkpoint_dir and self.checkpoint_every
                    and (r + 1) % self.checkpoint_every == 0):
                self._checkpoint(state, r + 1, hist)
        self.state = state
        return self._result(state, hist, t0)

    def _checkpoint(self, state, round_idx: int, hist) -> None:
        ctx = getattr(self.backend, "cohort_ctx", None)
        # every rank gathers (a collective), one writes
        res_fn = getattr(self.backend, "wire_residuals", None)
        res = res_fn() if callable(res_fn) else None
        if ctx is None or ctx.writer:
            path = checkpoint_path(self.checkpoint_dir, round_idx)
            save_round_checkpoint(
                path, state, round_idx=round_idx, history=hist,
                samplers=self.backend.samplers,
                meta={"strategy": self.strategy.name,
                      "backend": self.backend.name})
            if res is not None:
                save_plane(wire_checkpoint_path(path), res,
                           self.backend.plane_spec,
                           extra={"round": round_idx,
                                  "kind": "wire_residuals"})
        if ctx is not None:
            ctx.barrier()

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
