"""The Strategy side of a federated round: FedADP's knobs and state.

A strategy defines a method's math (distribute -> local train -> collect
-> aggregate); a backend executes it. In this slice the unified engine
executes FedADP whole (``fl/backends.py:UnifiedBackend`` reads the
strategy's knobs and builds the engine), so ``FedADPStrategy`` carries
the knobs, the union configuration and the initial state. The per-client
contract (``distribute``/``collect``/``aggregate``) that the loop
backend drives, and the other methods, come with the loop slice
(ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import not_ported
from repro_torch.core.netchange import NARROW_MODES  # noqa: F401 (re-export)
from repro_torch.device import DeviceLike, resolve_device

METHODS = ("fedadp", "clustered", "flexifed", "standalone")
FILLERS = ("zero", "global")


class FedADPStrategy:
    """FedADP (Algorithm 1) as a strategy. State = the global tree.

    ``filler``: "zero" (the paper — the inserted filler participates in
    the average) | "global" (FedADP-U — uncovered coordinates keep the
    server's values). ``coverage``: "loose" | "strict".
    ``agg_mode="coverage"``: the HeteroFL-style renormalized average
    over covering clients (``filler`` is then irrelevant)."""
    name = "fedadp"
    kind = "global"

    def __init__(self, family, client_cfgs, n_samples, *,
                 narrow_mode: str = "paper", filler: str = "zero",
                 coverage: str = "loose", agg_mode: str = "filler",
                 base_seed: int = 0, agg_layout: str = "auto",
                 k_chunk: Optional[int] = None, wire: str = "f32",
                 wire_tile: int = 256, wire_sparse: bool = False,
                 compute_dtype: str = "f32", attn_backend: str = "auto"):
        if filler not in FILLERS:
            raise ValueError(f"filler={filler!r}, expected one of {FILLERS}")
        self.family = family
        self.client_cfgs = list(client_cfgs)
        self.n_samples = list(n_samples)
        self.global_cfg = family.union(self.client_cfgs)
        self.filler = filler
        self.coverage = coverage
        self.agg_mode = agg_mode
        self.narrow_mode = narrow_mode   # the engine must down() the same
        self.base_seed = base_seed       # way and draw the same mappings
        self.agg_layout = agg_layout
        self.k_chunk = k_chunk
        self.wire = wire                 # client->server payload encoding
        self.wire_tile = wire_tile       # (core.quant; the unified engine
        self.wire_sparse = wire_sparse   # validates the combination)
        self.compute_dtype = compute_dtype
        self.attn_backend = attn_backend

    @property
    def n_clients(self) -> int:
        return len(self.client_cfgs)

    def init_state(self, generator: Optional[torch.Generator] = None, *,
                   device: DeviceLike = None):
        """The initial global model (``device=None`` means CUDA)."""
        return self.family.init(generator, self.global_cfg,
                                device=resolve_device(device))


def make_strategy(method: str, family, client_cfgs, n_samples, *,
                  narrow_mode: str = "paper", filler: str = "zero",
                  coverage: str = "loose", agg_mode: str = "filler",
                  base_seed: int = 0, agg_layout: str = "auto",
                  k_chunk: Optional[int] = None, wire: str = "f32",
                  wire_tile: int = 256, wire_sparse: bool = False,
                  compute_dtype: str = "f32",
                  attn_backend: str = "auto") -> FedADPStrategy:
    """Strategy factory keyed on the method names ``FLRunConfig`` uses."""
    if method == "fedadp":
        return FedADPStrategy(family, client_cfgs, n_samples,
                              narrow_mode=narrow_mode, filler=filler,
                              coverage=coverage, agg_mode=agg_mode,
                              base_seed=base_seed, agg_layout=agg_layout,
                              k_chunk=k_chunk, wire=wire,
                              wire_tile=wire_tile, wire_sparse=wire_sparse,
                              compute_dtype=compute_dtype,
                              attn_backend=attn_backend)
    if method in METHODS:
        raise not_ported(f"method={method!r}", "the loop path")
    raise ValueError(f"method={method!r}, expected one of {METHODS}")
