"""Family abstraction: the architecture lattice FedADP operates over.

A *family* knows how to (a) compute the union architecture of a cohort,
(b) move parameters up (client->global) and down (global->client) with
NetChange, and (c) init/evaluate members. The port has the paper's own
family, ``VGGFamily``; the transformer family comes with its slice
(ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch.func import grad_and_value

from repro_torch import tree as tu
from repro_torch.configs.vgg_family import VGGConfig, union_config
from repro_torch.core import vggops
from repro_torch.models import vgg


@dataclass(frozen=True)
class VGGFamily:
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
