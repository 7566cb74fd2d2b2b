"""The Strategy protocol: every FL method as one round contract.

A federated round is ``distribute -> local train -> collect ->
aggregate`` (the paper's Algorithm 1), and every method here is an
instance of that contract:

  * ``init_state(generator)``                server state at round 0,
  * ``distribute(state, r, k)``              params client k trains on,
  * ``collect(state, r, k, trained)``        client k's server-side update,
  * ``aggregate(state, r, updates)``         next server state from the
                                             participating ``(k, update)``
                                             pairs,
  * ``client_view(state, k, r)``             client k's current params.

State shape is strategy-owned: FedADP's state is the single global
parameter tree (``kind = "global"``); the per-client baselines
(Standalone, Clustered-FL, FlexiFed) carry a list of per-client trees
(``kind = "per_client"``). Strategies define only the method's math, by
delegating to ``repro_torch.core`` (``FedADP``, ``ClusteredFL``,
``FlexiFed``, ``Standalone``). Execution is the backend's
(``fl/backends.py``): ``LoopBackend`` drives this contract client by
client in each client's own architecture; ``UnifiedBackend`` reads the
strategy's knobs and runs the same math as one stacked program on the
packed plane. ``init_state`` builds on ``device`` (None = CUDA); a
per-client state draws client k's tree from its own generator, seeded
from the caller's.
"""
from __future__ import annotations

from typing import (Any, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import torch

from repro_torch import tree as tu
from repro_torch.core import (ClusteredFL, FedADP, FlexiFed, Standalone,
                              vgg_chain)
from repro_torch.core.netchange import NARROW_MODES  # noqa: F401 (re-export)
from repro_torch.device import DeviceLike, resolve_device

Update = Tuple[int, Any]          # (client index, collected update)

METHODS = ("fedadp", "clustered", "flexifed", "standalone")
FILLERS = ("zero", "global")


@runtime_checkable
class Strategy(Protocol):
    """Round contract every FL method implements (module docstring)."""
    name: str                     # method id ("fedadp", "clustered", ...)
    kind: str                     # "global" | "per_client" state shape
    n_samples: Sequence[int]      # per-client dataset sizes (W_k weights)

    @property
    def n_clients(self) -> int: ...

    def init_state(self, generator=None, *, device: DeviceLike = None
                   ) -> Any: ...

    def distribute(self, state, round_idx: int, k: int) -> Any: ...

    def collect(self, state, round_idx: int, k: int, trained) -> Any: ...

    def aggregate(self, state, round_idx: int,
                  updates: Sequence[Update]) -> Any: ...

    def client_view(self, state, k: int, round_idx: int = 0) -> Any: ...


class FedADPStrategy:
    """FedADP (Algorithm 1) as a strategy. State = the global tree.

    ``filler``: "zero" (the paper — the inserted filler participates in
    the average) | "global" (FedADP-U — uncovered coordinates keep the
    server's values: the update is mask-folded onto the global tree,
    ``u·m + g·(1−m)``, before averaging). ``coverage``: "loose" |
    "strict". ``agg_mode="coverage"``: the HeteroFL-style renormalized
    average over covering clients (``filler`` is then irrelevant)."""
    name = "fedadp"
    kind = "global"

    def __init__(self, family, client_cfgs, n_samples, *,
                 narrow_mode: str = "paper", filler: str = "zero",
                 coverage: str = "loose", agg_mode: str = "filler",
                 base_seed: int = 0, agg_layout: str = "auto",
                 k_chunk: Optional[int] = None, wire: str = "f32",
                 wire_tile: int = 256, wire_sparse: bool = False,
                 compute_dtype: str = "f32", attn_backend: str = "auto",
                 device: DeviceLike = None):
        if filler not in FILLERS:
            raise ValueError(f"filler={filler!r}, expected one of {FILLERS}")
        self.algo = FedADP(family, client_cfgs, n_samples,
                           narrow_mode=narrow_mode, coverage=coverage,
                           agg_mode=agg_mode, base_seed=base_seed,
                           agg_layout=agg_layout, k_chunk=k_chunk,
                           device=device)
        self.family = family
        self.client_cfgs = list(self.algo.client_cfgs)
        self.n_samples = list(n_samples)
        self.global_cfg = self.algo.global_cfg
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
        self.device = device

    @property
    def n_clients(self) -> int:
        return len(self.client_cfgs)

    def init_state(self, generator: Optional[torch.Generator] = None, *,
                   device: DeviceLike = None):
        """The initial global model (on ``device``, else the strategy's;
        None means CUDA)."""
        return self.algo.init_global(
            generator, device=device if device is not None else self.device)

    def distribute(self, state, round_idx: int, k: int):
        return self.algo.distribute(state, round_idx, k)

    def collect(self, state, round_idx: int, k: int, trained):
        up = self.algo.collect(trained, round_idx, k)
        if self.filler == "zero" or self.agg_mode == "coverage":
            # a coverage round reads its own masks: no fold here
            return up
        mask = self.algo.coverage_mask(round_idx, k)
        return tu.tree_map(lambda u, m, g: u * m + g * (1 - m),
                           up, mask, state)

    def aggregate(self, state, round_idx: int, updates: Sequence[Update]):
        selected = [k for k, _ in updates]
        return self.algo.aggregate([u for _, u in updates], selected,
                                   round_idx=round_idx, global_params=state)

    def client_view(self, state, k: int, round_idx: int = 0):
        return self.algo.distribute(state, round_idx, k)


def client_generators(generator: Optional[torch.Generator], n: int
                      ) -> List[torch.Generator]:
    """``n`` generators, client k's seeded from the k-th of ``n`` draws
    of ``generator`` (the port's stand-in for ``fold_in(key, k)``)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


class _PerClientStrategy:
    """Shared scaffolding for methods whose state is the list of client
    parameter trees; subclasses plug the core algorithm in ``_algo``."""
    kind = "per_client"

    def __init__(self, family, client_cfgs, n_samples, *,
                 device: DeviceLike = None):
        self.family = family
        self.client_cfgs = list(client_cfgs)
        self.n_samples = list(n_samples)
        self.device = device

    @property
    def n_clients(self) -> int:
        return len(self.client_cfgs)

    def init_state(self, generator: Optional[torch.Generator] = None, *,
                   device: DeviceLike = None) -> List:
        """One tree per client in its own architecture, each drawn from
        its own generator (``client_generators``)."""
        dev = resolve_device(device if device is not None else self.device)
        gens = client_generators(generator, self.n_clients)
        return [self.family.init(g, c, device=dev)
                for g, c in zip(gens, self.client_cfgs)]

    def distribute(self, state, round_idx: int, k: int):
        return state[k]

    def collect(self, state, round_idx: int, k: int, trained):
        return trained

    def aggregate(self, state, round_idx: int, updates: Sequence[Update]):
        new = list(state)
        for k, u in updates:
            new[k] = u
        return self._algo.aggregate(new, [k for k, _ in updates])

    def client_view(self, state, k: int, round_idx: int = 0):
        return state[k]


class StandaloneStrategy(_PerClientStrategy):
    """Purely local training — aggregate is the identity."""
    name = "standalone"

    def __init__(self, family, client_cfgs, n_samples, *,
                 device: DeviceLike = None):
        super().__init__(family, client_cfgs, n_samples, device=device)
        self._algo = Standalone(self.client_cfgs, self.n_samples)


class ClusteredStrategy(_PerClientStrategy):
    """FedAvg within same-architecture clusters (∩ participants)."""
    name = "clustered"

    def __init__(self, family, client_cfgs, n_samples, *,
                 device: DeviceLike = None):
        super().__init__(family, client_cfgs, n_samples, device=device)
        self._algo = ClusteredFL(self.client_cfgs, self.n_samples)


class FlexiFedStrategy(_PerClientStrategy):
    """Clustered-Common: shared chain prefix across participants, the
    personalized remainder within (cluster ∩ participants)."""
    name = "flexifed"

    def __init__(self, family, client_cfgs, n_samples, chain_fn=vgg_chain,
                 *, device: DeviceLike = None):
        super().__init__(family, client_cfgs, n_samples, device=device)
        self._algo = FlexiFed(self.client_cfgs, self.n_samples, chain_fn)


def make_strategy(method: str, family, client_cfgs, n_samples, *,
                  narrow_mode: str = "paper", filler: str = "zero",
                  coverage: str = "loose", agg_mode: str = "filler",
                  base_seed: int = 0, agg_layout: str = "auto",
                  k_chunk: Optional[int] = None, wire: str = "f32",
                  wire_tile: int = 256, wire_sparse: bool = False,
                  compute_dtype: str = "f32", attn_backend: str = "auto",
                  device: DeviceLike = None) -> Strategy:
    """Strategy factory keyed on the method names ``FLRunConfig`` uses."""
    if method == "fedadp":
        return FedADPStrategy(family, client_cfgs, n_samples,
                              narrow_mode=narrow_mode, filler=filler,
                              coverage=coverage, agg_mode=agg_mode,
                              base_seed=base_seed, agg_layout=agg_layout,
                              k_chunk=k_chunk, wire=wire,
                              wire_tile=wire_tile, wire_sparse=wire_sparse,
                              compute_dtype=compute_dtype,
                              attn_backend=attn_backend, device=device)
    if method == "standalone":
        return StandaloneStrategy(family, client_cfgs, n_samples,
                                  device=device)
    if method == "clustered":
        return ClusteredStrategy(family, client_cfgs, n_samples,
                                 device=device)
    if method == "flexifed":
        return FlexiFedStrategy(family, client_cfgs, n_samples,
                                device=device)
    raise ValueError(f"method={method!r}, expected one of {METHODS}")
