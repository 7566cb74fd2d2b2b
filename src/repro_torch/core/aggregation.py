"""Aggregation weights, coverage semantics and the layout rule — what the
unified engine reads (paper Eq. 1-2).

Coverage (HeteroFL, Diao et al. 2021): FedADP's Eq. 1-2 averages in the
*unified* space, so every coordinate a client doesn't own contributes
filler (zeros / identity-conv taps) to the average. ``coverage_mask``
defines which coordinates count as covered — one policy, two readings:

  * ``"strict"``  — ``|up(ones) - up(zeros)| > 0``: exactly where a
                    client parameter lands (the trainable mask),
  * ``"loose"``   — ``|up(ones)| > 0``: additionally counts the nonzero
                    filler constants (identity-conv center taps).

The constant trees pushed through ``up`` are built on the caller's
``device``; shapes come from the family's meta-tensor init.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core import plane
from repro_torch.core import segments as sg

COVERAGE_POLICIES = ("loose", "strict")
AGG_MODES = ("filler", "coverage")

_log = logging.getLogger("repro_torch.core.aggregation")


def client_weights(n_samples: Sequence[int]) -> np.ndarray:
    """W_k = n_k / n  (paper Eq. 2)."""
    n = np.asarray(n_samples, np.float64)
    return (n / n.sum()).astype(np.float32)


def subset_weights(n_samples: Sequence[int],
                   selected: Optional[Sequence[int]] = None) -> np.ndarray:
    """W_k renormalized over the participating subset (Eq. 2 on the
    subset)."""
    n = np.asarray(n_samples, np.float64)
    if selected is not None:
        n = n[np.asarray(list(selected))]
    return (n / n.sum()).astype(np.float32)


# ------------------------------------------------------------- coverage
def _mask01(tree):
    return tu.tree_map(lambda a: (a.abs() > 0).float(), tree)


def _client_fill(family, client_cfg, value: float, device):
    """A constant client-shaped tree without running the random init."""
    return tu.tree_map(
        lambda s: torch.full(tuple(s.shape), value, dtype=s.dtype,
                             device=device),
        family.shapes(client_cfg))


def coverage_and_filler(family, client_cfg, global_cfg, *, seed: int = 0,
                        device=None):
    """(strict coverage mask, filler) for embedding one client:
    filler = up(zeros), strict = |up(ones) - up(zeros)| > 0."""
    up0 = family.up(_client_fill(family, client_cfg, 0.0, device),
                    client_cfg, global_cfg, seed=seed)
    up1 = family.up(_client_fill(family, client_cfg, 1.0, device),
                    client_cfg, global_cfg, seed=seed)
    strict = tu.tree_map(lambda a, b: ((a - b).abs() > 0).float(), up1, up0)
    return strict, up0


def loosen(strict_mask, filler):
    """loose = strict ∪ nonzero-filler sites (exactly ``|up(ones)| > 0``:
    landing sites and filler constants are disjoint by construction)."""
    return tu.tree_map(
        lambda m, f: torch.maximum(m, (f.abs() > 0).to(m.dtype)),
        strict_mask, filler)


_SHAPE_MEMO: dict = {}


def global_shapes(family, global_cfg):
    """The family's parameter tree at ``global_cfg`` as meta tensors,
    memoized per (family type, config)."""
    key = (type(family).__name__, global_cfg)
    if key not in _SHAPE_MEMO:
        _SHAPE_MEMO[key] = family.shapes(global_cfg)
        while len(_SHAPE_MEMO) > 64:
            _SHAPE_MEMO.pop(next(iter(_SHAPE_MEMO)))
    return _SHAPE_MEMO[key]


def multiplicity(family, client_cfg, global_cfg, *, seed: int = 0,
                 device=None):
    """Per-coordinate duplication counts of a client's width embedding
    (1 everywhere for depth-only embeddings), from ``segment_spec``."""
    shapes = global_shapes(family, global_cfg)
    spec_fn = getattr(family, "segment_spec", None)
    spec = spec_fn(client_cfg, global_cfg, seed=seed) if spec_fn else {}
    return sg.multiplicity_tree(spec, shapes, device=device)


def coverage_mask(family, client_cfg, global_cfg, *,
                  policy: str = "strict", seed: int = 0, device=None):
    """Global-space 0/1 mask of the coordinates a client covers, under
    the given policy."""
    if policy not in COVERAGE_POLICIES:
        raise ValueError(
            f"coverage policy={policy!r}, expected one of {COVERAGE_POLICIES}")
    if policy == "loose":
        return _mask01(family.up(_client_fill(family, client_cfg, 1.0,
                                              device),
                                 client_cfg, global_cfg, seed=seed))
    strict, _ = coverage_and_filler(family, client_cfg, global_cfg,
                                    seed=seed, device=device)
    return strict


# ---------------------------------------------------------------- layout
AGG_LAYOUTS = ("plane", "stream", "leaf")

# "stream" once the materialized cohort plane would cross this (or K
# grows past _AUTO_STREAM_K): past here the O(P·K_chunk) accumulator
# beats holding (K, P) + the kernel's operands resident
_AUTO_STREAM_K = 32
_AUTO_STREAM_BYTES = 256 * 2 ** 20
_auto_logged: set = set()


def resolve_agg_layout(layout: Optional[str], *, backend: Optional[str] = None,
                       k: Optional[int] = None, p: Optional[int] = None,
                       k_chunk: Optional[int] = None) -> str:
    """The ONE ``agg_layout="auto"`` rule. Explicit layouts pass through;
    ``"auto"``/``None`` picks ``"stream"`` when the caller pinned a
    ``k_chunk`` or the cohort plane is large (K > 32 or K·P·4 bytes >
    256 MiB), ``"plane"`` otherwise. ``"leaf"`` is never auto-selected.
    The decision is logged once per distinct (backend, choice)."""
    if layout in AGG_LAYOUTS:
        return layout
    if layout not in (None, "auto"):
        raise ValueError(f"agg_layout={layout!r}, expected 'auto' or one "
                         f"of {AGG_LAYOUTS}")
    big = (k is not None and k > _AUTO_STREAM_K) or (
        k is not None and p is not None
        and 4 * k * p > _AUTO_STREAM_BYTES)
    choice = "stream" if (k_chunk is not None or big) else "plane"
    key = (backend, choice)
    if key not in _auto_logged:
        _auto_logged.add(key)
        _log.info("agg_layout='auto' -> %r (backend=%s, K=%s, P=%s, "
                  "k_chunk=%s)", choice, backend, k, p, k_chunk)
    return choice


def default_k_chunk(k: int, k_chunk: Optional[int] = None) -> int:
    """The streaming chunk size: the caller's pin, else 16 rows."""
    return max(1, min(k_chunk if k_chunk is not None else 16, k))


def stack_trees(trees: Sequence):
    """Stack K same-structure trees on a new leading axis; ragged input
    raises naming the offending leaf path and both shapes."""
    trees = list(trees)
    assert trees, "stack_trees: no trees"
    flat0 = tu.flatten(trees[0])
    paths0 = [p for p, _ in flat0]
    cols = [[leaf for _, leaf in flat0]]
    for i, t in enumerate(trees[1:], start=1):
        flat = tu.flatten(t)
        if [p for p, _ in flat] != paths0:
            raise ValueError(
                f"stack_trees: tree {i} structure does not match tree 0")
        for (path, leaf), leaf0 in zip(flat, cols[0]):
            if tuple(leaf.shape) != tuple(leaf0.shape):
                raise plane.ragged_leaf_error(
                    f"stack_trees (tree {i} vs tree 0)", path, leaf.shape,
                    leaf0.shape)
        cols.append([leaf for _, leaf in flat])
    return tu.unflatten(paths0, [torch.stack(ls) for ls in zip(*cols)])
