"""Sharding rules of the JAX package's ``sharding/rules.py`` that the
port's mesh paths read: the client-axis divisibility rule, the cohort
mesh, and the expert-parallel MoE placement.

A "spec" here is the tuple of mesh dimension names a leading axis is
split over; ``()`` means replicated (the reference's ``P()``). The
parameter and cache placement plans (``param_specs`` / ``cache_specs``)
place tensor-parallel layouts over ``model``, which the port does not
have yet (ROADMAP.md).
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.sharding.ctx import ShardCtx, axis_size

EXPERT_LEAF = re.compile(r"(^|/)moe/(wg|wu|wd)$")


def stacked_client_spec(mesh, client_axes: Tuple[str, ...],
                        n_clients: int) -> Tuple[str, ...]:
    """The split of a unified cohort's leading K (client) axis: over
    ``client_axes`` when K divides their extent, else replicated (``()``)
    — the divisibility rule the reference applies to every dimension."""
    if mesh is None or not client_axes:
        return ()
    extent = 1
    for a in client_axes:
        extent *= axis_size(mesh, a)
    if extent <= 1 or n_clients % extent != 0:
        return ()
    return tuple(client_axes)


def cohort_mesh(n_clients: int, *, axis: str = "clients",
                device_type: Optional[str] = None):
    """1-D ``DeviceMesh`` for splitting a K-client unified cohort over the
    ranks of the initialised process group: the largest rank count n
    that divides K (ranks 0..n-1), with dimension ``axis``. Returns None
    when only one rank would take part (no process group, world size 1,
    or no n > 1 divides K).

    Building the mesh makes its process group, which every rank of the
    default group must join: call this on every rank. A rank at or past
    n is outside the mesh and gets None; given None, the engine runs the
    whole cohort there on its own (the same round, computed once more),
    so every rank ends with the same globals. ``device_type`` defaults
    to "cuda" when a card is present, else "cpu"."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    n = world
    while n > 1 and n_clients % n != 0:
        n -= 1
    if n <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis,))
    return mesh if dist.get_rank() < n else None


def moe_spec(n_experts: int, model_size: int) -> str:
    """Placement of a MoE block's expert stacks (``wg``/``wu``/``wd``):
    "experts" (expert-parallel: E over ``model``) when E divides the
    model extent; otherwise "whole" — every rank holds every expert (the
    reference shards the experts' F axis over ``model`` there, a
    tensor-parallel layout the port does not have)."""
    if model_size > 1 and n_experts % model_size == 0:
        return "experts"
    return "whole"


def expert_slice(params, ctx: ShardCtx, n_experts: int):
    """A whole parameter tree -> this rank's part under ``ctx``: every
    expert stack (a ``moe/wg|wu|wd`` leaf, experts on axis -3, stacked
    units or not) cut to the rank's ``E/m`` experts
    ``[rank·E/m, (rank+1)·E/m)`` (copies, so the whole tree can be freed);
    every other leaf as it is. Under an expert-parallel-free ctx the tree
    comes back unchanged."""
    m = ctx.model_size
    if moe_spec(n_experts, m) != "experts":
        return params
    per = n_experts // m
    lo = ctx.model_rank * per

    def one(path, leaf):
        if EXPERT_LEAF.search("/".join(path)):
            assert leaf.shape[-3] == n_experts, (path, leaf.shape)
            return leaf.narrow(leaf.dim() - 3, lo, per).clone()
        return leaf
    return tu.map_with_path(one, params)
