"""Model aggregation (paper Eq. 1-2) and coverage semantics: the
weights, the coverage masks, the layout rule the unified engine reads,
and the tree-facing aggregation entry points.

Two layouts in, one implementation underneath:
  * list-of-trees — ``fedavg`` / ``fedavg_masked`` over K client trees,
  * stacked tree  — ``fedavg_stacked``: every leaf has a leading K axis.
``fedavg_stacked`` aggregates on one of three layouts: "plane" packs the
stacked tree into one ``(K, P)`` f32 plane and aggregates in a single
kernel pass (``kernels/fedavg.plane_agg``); "stream" consumes the cohort
in ``(k_chunk, P)`` row chunks through a ``PlaneAccumulator`` (O(P·k_chunk)
memory); "leaf" launches one kernel per leaf (``weighted_sum`` /
``weighted_sum_masked[_mult]``) — the tree-shaped reference the other two
are pinned against. On CUDA tensors each launches the hand-written
kernels; on CPU tensors it runs their plain versions.

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
from repro_torch.kernels.fedavg import ops as kops

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


_last_stats: dict = {}


def last_agg_stats() -> dict:
    """Stats of the most recent ``fedavg_stacked`` call on this process:
    ``layout``, ``k_chunk`` (streaming only), ``rows``/``n`` (cohort
    shape) and ``peak_bytes`` — the resident aggregation footprint
    (whole ``4·K·P`` plane for "plane"/"leaf"; the accumulator triple
    plus one ``4·k_chunk·P`` chunk for "stream",
    ``PlaneAccumulator.stats``). A diagnostic, not part of the math."""
    return dict(_last_stats)


def _record_stats(**kw) -> None:
    _last_stats.clear()
    _last_stats.update(kw)


def default_k_chunk(k: int, k_chunk: Optional[int] = None) -> int:
    """The streaming chunk size: the caller's pin, else 16 rows."""
    return max(1, min(k_chunk if k_chunk is not None else 16, k))


def fedavg(trees: Sequence, weights, *, layout: Optional[str] = None,
           k_chunk: Optional[int] = None):
    """omega^{t+1} = sum_k W_k omega_k  (paper Eq. 1): stack, then one
    ``fedavg_stacked`` pass."""
    assert len(trees) == len(weights)
    return fedavg_stacked(stack_trees(trees), weights, layout=layout,
                          k_chunk=k_chunk)


def _plane_pass(stacked, w, masks, mult, fallback, *, spec, renorm: bool,
                use_kernel: Optional[bool]):
    """The whole aggregation on the packed plane: pack, one
    ``plane_agg`` pass, unpack (leaf dtypes restored)."""
    x = plane.pack_stacked(stacked, spec, what="fedavg_stacked")
    m = (plane.pack_stacked(masks, spec, what="fedavg_stacked/masks")
         if masks is not None else None)
    mu = (plane.pack_stacked(mult, spec, what="fedavg_stacked/mult")
          if mult is not None else None)
    fb = (plane.pack(fallback, spec, what="fedavg_stacked/fallback")
          if fallback is not None else None)
    out = kops.plane_agg(x, w, masks=m, mult=mu, fallback=fb, renorm=renorm,
                         use_kernel=use_kernel)
    return plane.unpack(out, spec)


def _stream_pass(stacked, w, masks, mult, fallback, *, spec, renorm: bool,
                 use_kernel: Optional[bool], k_chunk: int):
    """The streaming realization: pack each ``k_chunk``-row slice on its
    own (``plane.stacked_rows`` + ``pack_stacked``), fold it into a
    ``PlaneAccumulator``, close with the one divide/fallback pass —
    never more than one ``(k_chunk, P)`` chunk resident."""
    acc = kops.PlaneAccumulator(spec.size, use_kernel=use_kernel,
                                device=w.device)
    for lo, hi in plane.chunk_bounds(int(w.shape[0]), k_chunk):
        x = plane.pack_stacked(plane.stacked_rows(stacked, lo, hi), spec,
                               what="fedavg_stacked/stream")
        m = (plane.pack_stacked(plane.stacked_rows(masks, lo, hi), spec,
                                what="fedavg_stacked/stream-masks")
             if masks is not None else None)
        mu = (plane.pack_stacked(plane.stacked_rows(mult, lo, hi), spec,
                                 what="fedavg_stacked/stream-mult")
              if mult is not None else None)
        acc.update(x, w[lo:hi], masks=m, mult=mu)
        del x, m, mu
    fb = (plane.pack(fallback, spec, what="fedavg_stacked/fallback")
          if fallback is not None else None)
    out = acc.finish(renorm=(masks is not None and renorm), fallback=fb)
    _record_stats(layout="stream", k_chunk=k_chunk, **acc.stats())
    return plane.unpack(out, spec)


def plane_partials(x, w, masks=None, mult=None, *,
                   use_kernel: Optional[bool] = None):
    """Edge-reduce unit of the two-level hierarchy: one sub-cohort's
    packed rows ``x (K_g, P)`` with GLOBAL subset weights ``w (K_g,)`` ->
    the partial ``(num, den, cov)`` triple, each ``(P,)`` (one
    ``plane_accum`` into zeroed buffers). Summing triples across groups
    and finishing once (``finish_partials``) equals the flat
    aggregation: the masked weighted sum is associative."""
    acc = kops.PlaneAccumulator(int(x.shape[-1]), use_kernel=use_kernel,
                                device=x.device)
    acc.update(x, w, masks=masks, mult=mult)
    return acc.partials()


def group_partials(x, groups, *, use_kernel: Optional[bool] = None):
    """The per-client methods' edge-reduce unit: a rank's packed rows
    ``x (K_l, P)`` and ``groups``, each a ``(rows, weights)`` pair of
    indices into ``x`` and their GLOBAL weights (a cluster's subset
    weights, or the whole subset's for FlexiFed's prefix) -> ``(G, P)``
    f32, row g the partial Eq. 1 sum of group g's rows (one
    ``weighted_sum`` pass), zero where the rank holds none of them.
    Summing the partials over the ranks gives every group's average;
    with every row on one rank it is the average itself."""
    out = torch.zeros((len(groups), int(x.shape[-1])), dtype=torch.float32,
                      device=x.device)
    for g, (rows, w) in enumerate(groups):
        if len(rows):
            idx = torch.as_tensor(list(rows), device=x.device)
            out[g] = kops.plane_agg(
                x.index_select(0, idx),
                torch.as_tensor(w, dtype=torch.float32, device=x.device),
                use_kernel=use_kernel)
    return out


def finish_partials(num, den, cov, *, renorm: bool = True, fallback=None,
                    use_kernel: Optional[bool] = None):
    """Global reduce tail: close summed ``(P,)`` partial triples with the
    one divide/fallback pass (``plane_finish``)."""
    return kops.plane_finish(num, den, cov, fallback=fallback, renorm=renorm,
                             use_kernel=use_kernel)


def fedavg_hierarchical(stacked, weights, *, groups, masks=None, mult=None,
                        renorm: bool = True, fallback=None,
                        use_kernel: Optional[bool] = None,
                        k_chunk: Optional[int] = None):
    """Two-level hierarchical aggregation: ``groups`` (a partition of
    ``range(K)`` into edge sub-cohorts, any sizes and order) each stream
    their rows into their OWN ``PlaneAccumulator`` (the edge reduce,
    ``k_chunk`` rows a ``plane_accum``), the partial triples merge by
    summation (the global reduce), and ONE finish pass closes — equal to
    the flat aggregation for every split. Weights are the GLOBAL subset
    weights throughout (per-group renormalization would be wrong).
    ``masks`` / ``mult`` / ``fallback`` / ``renorm`` follow
    ``fedavg_stacked``; groups that do not partition ``range(K)`` raise
    ``ValueError``."""
    spec, _ = plane.PlaneSpec.from_stacked(stacked)
    dev = tu.leaves(stacked)[0].device
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    K = int(w.shape[0])
    flat_idx = sorted(int(i) for g in groups for i in g)
    if flat_idx != list(range(K)):
        raise ValueError(
            f"groups must partition range({K}) exactly, got {groups!r}")
    if mult is not None:
        assert masks is not None, "mult needs masks (coverage aggregation)"
    kc = default_k_chunk(K, k_chunk)

    def packed_rows(tree, sel, what):
        rows = tu.tree_map(lambda a: a.index_select(0, sel), tree)
        return plane.pack_stacked(rows, spec, what=what)

    total = None
    for g in groups:
        idx = torch.as_tensor([int(i) for i in g], dtype=torch.long,
                              device=dev)
        acc = kops.PlaneAccumulator(spec.size, use_kernel=use_kernel,
                                    device=dev)
        for lo in range(0, int(idx.numel()), kc):
            sel = idx[lo:lo + kc]
            acc.update(
                packed_rows(stacked, sel, "fedavg_hierarchical"), w[sel],
                masks=(packed_rows(masks, sel, "fedavg_hierarchical/masks")
                       if masks is not None else None),
                mult=(packed_rows(mult, sel, "fedavg_hierarchical/mult")
                      if mult is not None else None))
        total = acc if total is None else total.merge(acc)
    fb = (plane.pack(fallback, spec, what="fedavg_hierarchical/fallback")
          if fallback is not None else None)
    out = total.finish(renorm=(masks is not None and renorm), fallback=fb)
    return plane.unpack(out, spec)


def _aligned(tree, name: str, spec, *, stacked: bool):
    """``tree``'s leaves in the spec's order, or Nones. A structure that
    differs from the stacked tree's raises naming ``name`` (the JAX
    package's message); a leaf of the wrong shape raises naming it."""
    if tree is None:
        return [None] * spec.n_leaves
    got = [p for p, _ in tu.flatten(tree)]
    if got != list(spec.paths):
        bad = next((("/".join(a), "/".join(b))
                    for a, b in zip(got, spec.paths) if a != b),
                   (f"{len(got)} leaves", f"{spec.n_leaves}"))
        raise ValueError(f"{name} tree structure does not match stacked: "
                         f"{bad[0]} vs {bad[1]}")
    return [leaf for _, leaf in spec.validate(
        tree, what=f"fedavg_stacked/{name}", stacked=stacked)]


def _fedavg_stacked_leaf(stacked, w, *, masks, mult, renorm, fallback,
                         use_kernel):
    """Per-leaf dispatch, one kernel launch per leaf (``weighted_sum``
    unmasked, ``weighted_sum_masked[_mult]`` with masks): the tree-shaped
    semantics the plane and stream layouts reproduce to 1e-6. Coordinates
    no client covers (no mask > 0) take the fallback leaf."""
    flat = tu.flatten(stacked)
    spec, _ = plane.PlaneSpec.from_stacked(stacked)
    ms = _aligned(masks, "masks", spec, stacked=True)
    mus = _aligned(mult, "mult", spec, stacked=True)
    fbs = _aligned(fallback, "fallback", spec, stacked=False)
    out = []
    for (_, leaf), m, mu, fb in zip(flat, ms, mus, fbs):
        if m is None:
            agg = kops.weighted_sum(leaf, w, use_kernel=use_kernel)
        else:
            agg = kops.weighted_sum_masked(leaf, w, m, mult=mu,
                                           renorm=renorm,
                                           use_kernel=use_kernel)
            if fb is not None:
                agg = torch.where((m > 0).any(0), agg, fb.float())
        out.append(agg.to(leaf.dtype))
    return tu.unflatten(spec.paths, out)


def fedavg_stacked(stacked, weights, *, masks=None, mult=None,
                   renorm: bool = True, fallback=None,
                   use_kernel: Optional[bool] = None,
                   layout: Optional[str] = None,
                   k_chunk: Optional[int] = None):
    """Aggregate a stacked tree: every leaf (K, ...) -> (...).

    Without ``masks`` this is Eq. 1 verbatim. With ``masks`` (a stacked
    0/1 tree of the same shape) it is the coverage-weighted average: per
    coordinate only covering clients contribute, their weights
    renormalized over the covering subset when ``renorm``; coordinates no
    client covers take the matching ``fallback`` leaf (or 0). With
    ``mult`` (stacked per-coordinate duplication counts) the client
    weight becomes ``W_k m_k / mult_k``. Leaf dtypes are restored.

    ``layout=None``/"auto" resolves per ``resolve_agg_layout``; "plane",
    "stream" (``k_chunk`` rows at a time) and "leaf" compute the same
    function (module docstring). ``use_kernel`` follows the ``ops`` rule
    for the tensors' device. Masks / mult / fallback trees are validated
    leaf by leaf: a structure or shape mismatch raises naming the leaf.
    """
    if mult is not None:
        assert masks is not None, "mult needs masks (coverage aggregation)"
    spec, _ = plane.PlaneSpec.from_stacked(stacked)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=tu.leaves(stacked)[0].device)
    K = int(w.shape[0])
    layout = resolve_agg_layout(layout, backend=w.device.type, k=K,
                                p=spec.size, k_chunk=k_chunk)
    if layout == "plane":
        _record_stats(layout="plane", k_chunk=None, rows=K, n=spec.size,
                      peak_bytes=4 * K * spec.size)
        return _plane_pass(stacked, w, masks, mult, fallback, spec=spec,
                           renorm=renorm, use_kernel=use_kernel)
    if layout == "stream":
        return _stream_pass(stacked, w, masks, mult, fallback, spec=spec,
                            renorm=renorm, use_kernel=use_kernel,
                            k_chunk=default_k_chunk(K, k_chunk))
    _record_stats(layout="leaf", k_chunk=None, rows=K, n=spec.size,
                  peak_bytes=4 * K * spec.size)
    return _fedavg_stacked_leaf(stacked, w, masks=masks, mult=mult,
                                renorm=renorm, fallback=fallback,
                                use_kernel=use_kernel)


def fedavg_masked(trees: Sequence, weights, masks: Sequence, *,
                  mult: Optional[Sequence] = None, renorm: bool = True,
                  fallback=None, use_kernel: Optional[bool] = None,
                  layout: Optional[str] = None,
                  k_chunk: Optional[int] = None):
    """List-of-trees layout of the coverage-weighted average (the
    HeteroFL rule, optionally multiplicity-aware via ``mult``, a list of
    per-client duplication-count trees); delegates to
    ``fedavg_stacked``."""
    assert len(trees) == len(masks)
    return fedavg_stacked(stack_trees(trees), weights,
                          masks=stack_trees(masks),
                          mult=stack_trees(mult) if mult is not None else None,
                          renorm=renorm, fallback=fallback,
                          use_kernel=use_kernel, layout=layout,
                          k_chunk=k_chunk)


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
