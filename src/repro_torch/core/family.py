"""Family abstraction: the architecture lattice FedADP operates over.

A *family* knows how to (a) compute the union architecture of a cohort,
(b) move parameters up (client->global) and down (global->client) with
NetChange, and (c) init/evaluate members. Two concrete families:

  * VGGFamily          — the paper's own setting (conv chains).
  * TransformerFamily  — beyond-paper: transformer configs, variants over
                         depth, FFN width, expert count and the RG-LRU's
                         d_rnn.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch.func import grad_and_value

from repro_torch import tree as tu
from repro_torch.configs.vgg_family import VGGConfig, union_config
from repro_torch.core import tfamily, vggops
from repro_torch.launch.steps import lm_loss
from repro_torch.models import transformer, vgg
from repro_torch.sharding.ctx import CPU_CTX


@dataclass(frozen=True)
class VGGFamily:
    # the unified engine's vmap runs this many clients' convolutions
    # together: 1 keeps each client's convs the shapes (and cuDNN
    # algorithms) the per-client loop runs — a full-width VGG's f32
    # gradients differ by up to ~2% of a leaf's largest entry between
    # cuDNN's grouped and ungrouped algorithms, and the loop is the
    # reference the engine is held against
    client_chunk = 1

    def union(self, cfgs: Sequence[VGGConfig]) -> VGGConfig:
        return union_config(list(cfgs))

    def depth_only(self, cfgs: Sequence[VGGConfig]) -> bool:
        """True when the cohort differs ONLY in depth (layer counts):
        width layers agree wherever two clients both have them, and every
        non-stage config field matches."""
        for si in range(max(len(c.stages) for c in cfgs)):
            for li in range(max(len(c.stages[si]) for c in cfgs
                                if si < len(c.stages))):
                ws = {c.stages[si][li] for c in cfgs
                      if si < len(c.stages) and li < len(c.stages[si])}
                if len(ws) > 1:
                    return False
        norm = {dataclasses.replace(c, name="", stages=()) for c in cfgs}
        return len(norm) == 1

    def segment_representable(self, cfgs: Sequence[VGGConfig]) -> bool:
        """True when every client's embedding into the cohort union is a
        segment operator — the unified engine's eligibility domain: depth
        and width may vary; non-structural fields, stage and classifier
        arity must match, and trailing union positions a client doesn't
        own must carry the client's stage-final width."""
        cfgs = list(cfgs)
        norm = {dataclasses.replace(c, name="", stages=(), classifier=())
                for c in cfgs}
        if len(norm) != 1:
            return False
        if (len({len(c.stages) for c in cfgs}) != 1
                or len({len(c.classifier) for c in cfgs}) != 1):
            return False
        union = union_config(cfgs)
        for c in cfgs:
            for si, ws in enumerate(c.stages):
                uw = union.stages[si]
                if any(uw[li] != ws[-1] for li in range(len(ws), len(uw))):
                    return False
        return True

    def segment_spec(self, client_cfg: VGGConfig, global_cfg: VGGConfig, *,
                     seed: int = 0):
        return vggops.segment_spec(client_cfg, global_cfg, seed=seed)

    def chain_paths(self, cfg: VGGConfig):
        """The sequential chain as (layer id, tree path) pairs. The ids
        carry the widths, so FlexiFed's shared prefix stops at the first
        width or depth divergence; the paths locate each layer in the
        (stacked) parameter tree."""
        out = []
        for si, ws in enumerate(cfg.stages):
            for li, w in enumerate(ws):
                out.append((("conv", si, li, w),
                            ("stages", f"s{si}", f"c{li}")))
        for fi, wd in enumerate(cfg.classifier):
            out.append((("fc", fi, wd), ("fc", f"f{fi}")))
        out.append((("out",), ("out",)))
        return out

    def init(self, generator: Optional[torch.Generator], cfg, *,
             device=None):
        return vgg.init_params(cfg, generator, device=device)

    def shapes(self, cfg):
        """The parameter tree as meta tensors (shapes and dtypes only)."""
        return self.init(None, cfg, device="meta")

    def up(self, params, from_cfg, to_cfg, *, seed=0):
        return vggops.up(params, from_cfg, to_cfg, seed=seed)

    def down(self, params, from_cfg, to_cfg, *, seed=0, mode="paper"):
        return vggops.down(params, from_cfg, to_cfg, seed=seed, mode=mode)

    def loss_and_grad(self, cfg):
        """``f(params, batch) -> ((loss, acc), grads)`` — a functional
        gradient (``torch.func``), vmappable over stacked clients."""
        gv = grad_and_value(lambda p, b: vgg.loss_fn(p, cfg, b),
                            has_aux=True)

        def f(params, batch):
            grads, (loss, acc) = gv(params, batch)
            return (loss, acc), grads
        return f

    def evaluate(self, params, cfg, batch) -> float:
        dev = tu.leaves(params)[0].device
        x = torch.as_tensor(batch["x"], device=dev)
        y = torch.as_tensor(batch["y"], device=dev).long()
        with torch.no_grad():
            logits = vgg.apply(params, cfg, x)
        return float((logits.argmax(-1) == y).float().mean())


@dataclass(frozen=True)
class TransformerFamily:
    def union(self, cfgs):
        return tfamily.union(list(cfgs))

    def depth_only(self, cfgs) -> bool:
        """True when variants differ only in n_layers (zero-block padding
        is exact under pre-norm residuals)."""
        norm = {dataclasses.replace(c, name="", n_layers=0) for c in cfgs}
        return len(norm) == 1

    def segment_representable(self, cfgs) -> bool:
        """Depth (n_layers) and FFN width (d_ff) may vary — both embed as
        segment operators (zero blocks / deterministic duplication).
        Expert count is affine (router-bias shift) and d_rnn stays out of
        the unified engine's domain, as the reference's does, so any other
        config difference keeps the loop."""
        norm = {dataclasses.replace(c, name="", n_layers=0, d_ff=0)
                for c in cfgs}
        return len(norm) == 1

    def segment_spec(self, client_cfg, global_cfg, *, seed: int = 0):
        return tfamily.segment_spec(client_cfg, global_cfg, seed=seed)

    def chain_paths(self, cfg):
        raise NotImplementedError(
            "FlexiFed's sequential-prefix grouping is defined for the VGG "
            "chain only (paper Section IV.A.3)")

    def init(self, generator: Optional[torch.Generator], cfg, *,
             device=None):
        return transformer.init_params(generator, cfg, device=device)

    def shapes(self, cfg):
        """The parameter tree as meta tensors (shapes and dtypes only)."""
        return self.init(None, cfg, device="meta")

    def up(self, params, from_cfg, to_cfg, *, seed=0):
        return tfamily.up(params, from_cfg, to_cfg, seed=seed)

    def down(self, params, from_cfg, to_cfg, *, seed=0, mode="paper"):
        return tfamily.down(params, from_cfg, to_cfg, seed=seed, mode=mode)

    def loss_and_grad(self, cfg, *, ctx=None):
        """``f(params, batch) -> ((loss, aux), grads)`` over ``lm_loss`` —
        a functional gradient (``torch.func``), vmappable over stacked
        clients. ``ctx`` (a ``ShardCtx``) forces the attention backend."""
        ctx = CPU_CTX if ctx is None else ctx
        gv = grad_and_value(lambda p, b: lm_loss(p, cfg, b, ctx=ctx),
                            has_aux=True)

        def f(params, batch):
            grads, (loss, aux) = gv(params, batch)
            return (loss, aux), grads
        return f

    def evaluate(self, params, cfg, batch) -> float:
        """Eval loss of one batch (no gradients)."""
        dev = tu.leaves(params)[0].device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            return float(lm_loss(params, cfg, b)[0])
