"""SGD with momentum — the paper's local-update rule (Eq. 3).

An ``Optimizer`` is a pair of functions:
  init(params)                       -> state
  update(grads, state, params, step) -> (params, state)
``update`` works IN PLACE: it writes the new values into ``params`` (and
the momentum buffers) and returns them. The arithmetic is the JAX
package's ``sgd``: ``mu = momentum·mu + g``, ``p = p − lr·mu``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

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
