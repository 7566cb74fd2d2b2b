"""Model registry (the JAX package's ``models/registry.py``): uniform
handles over the transformer stack.

Besides the per-architecture :class:`Model` handle, the registry is the
enumerable surface for static tooling: ``arch_ids()`` lists every
architecture, ``Model.param_shapes()`` gives the parameter tree on the
``meta`` device (shapes and dtypes, no memory; the reference uses
``jax.eval_shape``), and ``plane_spec()`` its packed-plane layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.plane import PlaneSpec
from repro_torch.models import transformer as T
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx


def arch_ids() -> Tuple[str, ...]:
    """Every registered architecture id, in registry order."""
    return tuple(configs.ARCH_IDS)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator], *, device=None):
        return T.init_params(generator, self.cfg, device=device)

    def param_shapes(self):
        """The parameter tree on the ``meta`` device: no draws, no
        memory."""
        return self.init(None, device="meta")

    def forward(self, params, tokens, *, ctx: ShardCtx = CPU_CTX, aux=None):
        return T.forward(params, self.cfg, tokens, ctx=ctx, aux=aux)

    def prefill(self, params, tokens, *, ctx: ShardCtx = CPU_CTX, aux=None,
                cache_len=None):
        return T.prefill(params, self.cfg, tokens, ctx=ctx, aux=aux,
                         cache_len=cache_len)

    def decode_step(self, params, token, cache, pos, *,
                    ctx: ShardCtx = CPU_CTX):
        return T.decode_step(params, self.cfg, token, cache, pos, ctx=ctx)

    def init_cache(self, B, S_max, dtype=None, *, device=None,
                   ctx: ShardCtx = CPU_CTX):
        return T.init_cache(self.cfg, B, S_max, dtype, device=device,
                            ctx=ctx)


def get_model(arch_or_cfg) -> Model:
    cfg = (arch_or_cfg if isinstance(arch_or_cfg, ModelConfig)
           else get_config(arch_or_cfg))
    return Model(cfg)


def plane_spec(arch_or_cfg) -> PlaneSpec:
    """Packed-plane layout of an architecture's parameter tree, from its
    shapes alone."""
    return PlaneSpec.from_tree(get_model(arch_or_cfg).param_shapes())
