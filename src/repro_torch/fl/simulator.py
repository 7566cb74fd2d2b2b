"""``Simulator``/``FLRunConfig`` — the entry point over ``Federation``:

    Simulator(family, client_cfgs, samplers, FLRunConfig(...), eval_batch)
        .run() -> {"history", "final_acc", "client_params",
                   "global_params", "wall_s"}

Methods: fedadp | flexifed | clustered | standalone (Section IV).
Protocol knobs follow Section IV.A.4 of the paper: K clients, local
epochs E over 20% of the client's data per round, SGD(lr, momentum).

Engines:
  * ``engine="loop"``    — the reference path: a Python loop over
                           clients, each trained in its own
                           architecture (``LoopBackend``),
  * ``engine="unified"`` — the cohort-parallel ``UnifiedBackend``: one
                           stacked program in the union architecture,
  * ``engine="auto"``    — unified when eligible, the loop otherwise;
                           the fallback reason is logged once (logger
                           ``repro_torch.fl``,
                           ``backends.unified_ineligible_reason``); a
                           compressed wire or a forced attention backend
                           cannot fall back and raises instead.
``device=None`` runs on CUDA and raises without a card; tests pass
``device="cpu"``.

All config values are validated eagerly at ``FLRunConfig`` construction.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.aggregation import AGG_MODES, COVERAGE_POLICIES
from repro_torch.core.quant import validate_tile
from repro_torch.data.federated import ClientSampler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.backends import (LoopBackend, UnifiedBackend,
                                     unified_ineligible_reason)
from repro_torch.fl.engine import ATTN_BACKENDS, COMPUTE_DTYPES, WIRE_FORMATS
from repro_torch.fl.federation import Federation, Participation
from repro_torch.fl.strategy import (FILLERS, METHODS, NARROW_MODES,
                                     make_strategy)

_ENGINES = ("loop", "unified", "auto")

_log = logging.getLogger("repro_torch.fl")


@dataclass
class FLRunConfig:
    method: str = "fedadp"
    rounds: int = 20
    local_epochs: int = 2
    lr: float = 0.01
    momentum: float = 0.0
    narrow_mode: str = "paper"
    filler: str = "zero"
    coverage: str = "loose"
    agg_mode: str = "filler"
    seed: int = 0
    embed_seed: Optional[int] = None     # NetChange base seed; None =
                                         # follow `seed`
    eval_every: int = 1
    engine: str = "auto"                 # loop | unified | auto
    participation: float = 1.0           # client fraction per round
    participation_seed: int = 0          # per-round sampling seed
    agg_layout: str = "auto"             # auto | plane | stream
    k_chunk: Optional[int] = None        # streaming chunk rows; pinning
                                         # it implies "stream" under auto
    wire: str = "f32"                    # client->server payload encoding
                                         # (core.quant): "f32" | "bf16" |
                                         # "int8"+error feedback; non-f32
                                         # needs method="fedadp" on the
                                         # unified engine and streams
    wire_tile: int = 256                 # int8 scale tile (128 multiple)
    wire_sparse: bool = False            # ship covered coordinates only;
                                         # needs agg_mode="coverage"
    compute_dtype: str = "f32"           # local-training compute: "f32" |
                                         # "bf16" (f32 master plane, one
                                         # cast at unpack; unified only)
    attn_backend: str = "auto"           # auto | flash | blockwise
    device: DeviceLike = None            # None = CUDA (raises without)

    def __post_init__(self):
        # fail at construction, not after `rounds` of work mid-run
        if self.method not in METHODS:
            raise ValueError(
                f"method={self.method!r}, expected one of {METHODS}")
        if self.filler not in FILLERS:
            raise ValueError(
                f"filler={self.filler!r}, expected one of {FILLERS}")
        if self.narrow_mode not in NARROW_MODES:
            raise ValueError(f"narrow_mode={self.narrow_mode!r}, expected "
                             f"one of {NARROW_MODES}")
        if self.coverage not in COVERAGE_POLICIES:
            raise ValueError(f"coverage={self.coverage!r}, expected one of "
                             f"{COVERAGE_POLICIES}")
        if self.agg_mode not in AGG_MODES:
            raise ValueError(f"agg_mode={self.agg_mode!r}, expected one of "
                             f"{AGG_MODES}")
        if self.engine not in _ENGINES:
            raise ValueError(
                f"engine={self.engine!r}, expected one of {_ENGINES}")
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(f"participation={self.participation!r} must "
                             "be in (0, 1]")
        if self.rounds < 0:
            raise ValueError(f"rounds={self.rounds!r} must be >= 0")
        if self.eval_every < 1:
            raise ValueError(f"eval_every={self.eval_every!r} must be >= 1")
        if self.local_epochs < 1:
            raise ValueError(
                f"local_epochs={self.local_epochs!r} must be >= 1")
        if self.embed_seed is not None and (
                isinstance(self.embed_seed, bool)
                or not isinstance(self.embed_seed, int)):
            raise ValueError(f"embed_seed={self.embed_seed!r} must be an "
                             "int (or None to follow `seed`)")
        if self.agg_layout not in ("auto", "plane", "stream"):
            raise ValueError(
                f"agg_layout={self.agg_layout!r}, expected 'auto', "
                "'plane' or 'stream'")
        if self.k_chunk is not None and (
                isinstance(self.k_chunk, bool)
                or not isinstance(self.k_chunk, int) or self.k_chunk < 1):
            raise ValueError(f"k_chunk={self.k_chunk!r} must be a "
                             "positive int (or None for auto)")
        if self.wire not in WIRE_FORMATS:
            raise ValueError(f"wire={self.wire!r}, expected one of "
                             f"{WIRE_FORMATS}")
        validate_tile(self.wire_tile)
        if self.wire != "f32":
            if self.method != "fedadp":
                raise ValueError(
                    f"wire={self.wire!r} compresses fedadp round "
                    f"payloads; method={self.method!r} has no wire layer")
            if self.engine == "loop":
                raise ValueError(
                    "wire compression needs the unified engine (the "
                    "fused dequantize-accumulate streaming kernel); "
                    "engine='loop' cannot honor it")
            if self.agg_layout == "plane":
                raise ValueError(
                    "wire compression aggregates on the streaming "
                    "layout; agg_layout='plane' contradicts it — use "
                    "'auto' or 'stream'")
        if self.wire_sparse:
            if self.wire == "f32":
                raise ValueError("wire_sparse needs a compressed wire "
                                 "(wire='bf16' or 'int8')")
            if self.agg_mode != "coverage":
                raise ValueError(
                    'wire_sparse is exact only under agg_mode="coverage"'
                    " (only covered coordinates enter the average); "
                    f"agg_mode={self.agg_mode!r} averages uncovered "
                    "coordinates too")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={self.compute_dtype!r}, "
                             f"expected one of {COMPUTE_DTYPES}")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend={self.attn_backend!r}, "
                             f"expected one of {ATTN_BACKENDS}")
        if self.compute_dtype != "f32" and self.engine == "loop":
            raise ValueError(
                "compute_dtype='bf16' is the unified engine's cast-at-"
                "unpack policy (f32 master plane, bf16 step); "
                "engine='loop' cannot honor it")
        if self.attn_backend != "auto" and self.engine == "loop":
            raise ValueError(
                "a forced attn_backend threads through the unified "
                "engine's training step; engine='loop' cannot honor it")
        resolve_device(self.device)

    @property
    def resolved_embed_seed(self) -> int:
        return self.seed if self.embed_seed is None else self.embed_seed


class Simulator:
    """Builds (strategy, backend, Federation) from the config, then
    delegates ``run()``. Backends are cached across runs keyed by the
    config fields they depend on."""

    def __init__(self, family, client_cfgs: Sequence,
                 samplers: List[ClientSampler], run_cfg: FLRunConfig,
                 eval_batch: Dict[str, Any], mesh=None):
        self.family = family
        self.client_cfgs = list(client_cfgs)
        self.samplers = samplers
        self.cfg = run_cfg
        self.eval_batch = eval_batch
        self.mesh = mesh
        self.n_samples = [s.n_samples for s in samplers]
        self._backends: Dict[tuple, Any] = {}
        self._fallback_logged = False

    def _resolve_engine(self, strategy) -> str:
        if self.cfg.engine != "auto":
            return self.cfg.engine
        reason = unified_ineligible_reason(
            strategy, self.family, self.client_cfgs, self.samplers)
        if reason is None:
            return "unified"
        if self.cfg.wire != "f32":
            # the loop backend has no wire layer
            raise ValueError(
                f"wire={self.cfg.wire!r} needs the unified engine, but "
                f"this run is unified-ineligible: {reason}")
        if self.cfg.compute_dtype != "f32":
            raise ValueError(
                f"compute_dtype={self.cfg.compute_dtype!r} needs the "
                f"unified engine, but this run is unified-ineligible: "
                f"{reason}")
        if self.cfg.attn_backend != "auto":
            raise ValueError(
                f"attn_backend={self.cfg.attn_backend!r} needs the "
                f"unified engine, but this run is unified-ineligible: "
                f"{reason}")
        if not self._fallback_logged:
            _log.info("engine='auto' falls back to the loop backend: %s",
                      reason)
            self._fallback_logged = True
        return "loop"

    def _strategy(self):
        return make_strategy(
            self.cfg.method, self.family, self.client_cfgs, self.n_samples,
            narrow_mode=self.cfg.narrow_mode, filler=self.cfg.filler,
            coverage=self.cfg.coverage, agg_mode=self.cfg.agg_mode,
            base_seed=self.cfg.resolved_embed_seed,
            agg_layout=self.cfg.agg_layout, k_chunk=self.cfg.k_chunk,
            wire=self.cfg.wire, wire_tile=self.cfg.wire_tile,
            wire_sparse=self.cfg.wire_sparse,
            compute_dtype=self.cfg.compute_dtype,
            attn_backend=self.cfg.attn_backend, device=self.cfg.device)

    def _backend(self, kind: str):
        cfg = self.cfg
        # key only on what each backend depends on
        bkey = (kind, cfg.local_epochs, cfg.lr, cfg.momentum,
                str(cfg.device)) + (
            (cfg.resolved_embed_seed, cfg.agg_layout, cfg.k_chunk, cfg.wire,
             cfg.wire_tile, cfg.wire_sparse, cfg.compute_dtype,
             cfg.attn_backend) if kind == "unified" else ())
        if bkey not in self._backends and kind == "loop":
            self._backends[bkey] = LoopBackend(
                self.family, self.client_cfgs, self.samplers,
                local_epochs=cfg.local_epochs, lr=cfg.lr,
                momentum=cfg.momentum, device=cfg.device)
        if bkey not in self._backends:
            self._backends[bkey] = UnifiedBackend(
                self.family, self.client_cfgs, self.samplers,
                local_epochs=cfg.local_epochs, lr=cfg.lr,
                momentum=cfg.momentum, mesh=self.mesh,
                seed=cfg.resolved_embed_seed,
                agg_layout=cfg.agg_layout, k_chunk=cfg.k_chunk,
                wire=cfg.wire, wire_tile=cfg.wire_tile,
                wire_sparse=cfg.wire_sparse,
                compute_dtype=cfg.compute_dtype,
                attn_backend=cfg.attn_backend, device=cfg.device)
        return self._backends[bkey]

    def _build(self) -> Federation:
        cfg = self.cfg
        strategy = self._strategy()
        backend = self._backend(self._resolve_engine(strategy))
        backend.samplers = self.samplers   # like cfg, mutable between runs
        return Federation(
            strategy, backend, rounds=cfg.rounds, eval_batch=self.eval_batch,
            eval_every=cfg.eval_every,
            participation=Participation(cfg.participation,
                                        cfg.participation_seed))

    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[str, Any]:
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return self._build().run(generator)
