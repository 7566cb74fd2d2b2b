"""Optimizers of the JAX package's ``optim/optimizers.py``: SGD with
momentum (the paper's local-update rule, Eq. 3) and AdamW with f32
master copies (the standalone trainer's, ``launch/train.py``).

An ``Optimizer`` is a pair of functions:
  init(params)                       -> state
  update(grads, state, params, step) -> (params, state)
``update`` works IN PLACE: it writes the new values into ``params`` (and
the optimizer's buffers) and returns them. The arithmetic is the JAX
package's: ``sgd``: ``mu = momentum·mu + g``, ``p = p − lr·mu``;
``adamw``: below.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch import tree as tu

Schedule = Callable[[int], float]


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: float(lr)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tu.tree_map(lambda p: p.new_zeros(p.shape), params)}

    def update(grads, state, params, step=0):
        lr_t = sched(step)
        if momentum == 0.0:
            tu.tree_map(lambda p, g: p.sub_(lr_t * g.float()), params, grads)
            return params, state
        tu.tree_map(lambda m, g: m.mul_(momentum).add_(g.float()),
                    state["mu"], grads)
        tu.tree_map(lambda p, m: p.sub_(lr_t * m), params, state["mu"])
        return params, state

    return Optimizer(init, update)


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          master_fp32: bool = True) -> Optimizer:
    """AdamW: ``m = b1·m + (1−b1)·g``, ``v = b2·v + (1−b2)·g²`` (f32),
    ``p32 −= lr·(m̂ / (√v̂ + eps) + wd·p32)`` with bias corrections
    ``1 − b^(step+1)``. With ``master_fp32`` every leaf keeps an f32 master
    copy that takes the update; the parameter is then that copy cast to
    its own dtype (bf16 leaves train on an f32 copy)."""
    sched = _as_schedule(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"m": tu.tree_map(zeros, params),
                 "v": tu.tree_map(zeros, params)}
        if master_fp32:
            state["master"] = tu.tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    def update(grads, state, params, step=0):
        lr_t = sched(step)
        t = int(step) + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t

        def one(p, g, m, v, p32):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(p32, alpha=weight_decay)
            p32.sub_(upd.mul_(lr_t))
            if p32 is not p:
                p.copy_(p32)

        masters = state.get("master", params)
        tu.tree_map(one, params, grads, state["m"], state["v"], masters)
        return params, state

    return Optimizer(init, update)
