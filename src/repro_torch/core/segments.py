"""Segment operators — the width embedding as an explicit linear map.

NetChange's To-Wider is deterministic in ``(tag, old, new, seed)``
(``netchange.dup_mapping``), so a client's place in the union
architecture is a linear operator: ``up(p) = E p + filler`` where E
duplicates client coordinates into union *segments* and scales outgoing
duplicates by the inverse group size (Net2Net split).

  * a family's ``segment_spec(client_cfg, global_cfg, seed)`` names, per
    union-tree leaf, the widened axes and the segment id of every union
    index along them (``AxisSeg``);
  * ``grad_matrix`` builds the axis factor of ``E Eᵀ`` — the operator
    that makes union-space SGD equal client-space SGD (segment-sum, with
    ``1/c²`` on split axes);
  * ``mean_matrix`` builds the axis factor of the projector onto
    image(E) — the segment mean;
  * ``multiplicity_tree`` gives per-coordinate duplication counts for
    the multiplicity-aware coverage average.

Matrices are numpy (small: one union extent squared per widened axis);
the engine stacks them per client onto the device (``stack_matrices``)
and applies them to stacked gradients (``project_stacked``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tu

Path = Tuple[str, ...]


@dataclass(frozen=True)
class AxisSeg:
    """One widened axis of a union-shaped leaf: ``ids[j]`` labels the
    client coordinate union index ``j`` duplicates (equal ids = one
    segment). ``out_role`` marks the Net2Net split side."""
    axis: int
    ids: np.ndarray
    out_role: bool = False

    @property
    def counts(self) -> np.ndarray:
        """Per-position segment sizes c_j (length = union extent)."""
        _, inv, cnt = np.unique(np.asarray(self.ids), return_inverse=True,
                                return_counts=True)
        return cnt[inv].astype(np.int32)


def _same(seg: AxisSeg) -> np.ndarray:
    ids = np.asarray(seg.ids)
    return (ids[:, None] == ids[None, :]).astype(np.float32)


def grad_matrix(seg: AxisSeg) -> np.ndarray:
    """Axis factor of ``E Eᵀ``: segment-sum, with 1/c² on split axes."""
    b = _same(seg)
    if not seg.out_role:
        return b
    r = 1.0 / seg.counts.astype(np.float32)
    return b * r[:, None] * r[None, :]


def mean_matrix(seg: AxisSeg) -> np.ndarray:
    """Axis factor of the orthogonal projector onto image(E): the
    segment mean ``P[v, u] = [same segment] / c_v``."""
    return _same(seg) / seg.counts.astype(np.float32)[:, None]


def path_str(path: Path) -> str:
    return "/".join(path)


def leaf_shape(shapes, path: Path) -> Tuple[int, ...]:
    return tuple(tu.get(shapes, path).shape)


def union_axes(specs: Sequence[Dict[Path, List[AxisSeg]]],
               shapes) -> Dict[Path, Tuple[int, ...]]:
    """Union over clients of (leaf path -> widened axes), axes
    canonicalized to non-negative leaf axes — the seed-invariant static
    structure of the engine's step."""
    out: Dict[Path, set] = {}
    for spec in specs:
        for path, segs in spec.items():
            nd = len(leaf_shape(shapes, path))
            out.setdefault(path, set()).update(s.axis % nd for s in segs)
    return {p: tuple(sorted(a)) for p, a in sorted(out.items())}


def client_matrices(spec: Dict[Path, List[AxisSeg]],
                    axes_map: Dict[Path, Tuple[int, ...]], shapes, *,
                    kind: str = "grad") -> Dict[Path, List[np.ndarray]]:
    """Per-leaf, per-axis matrices for one client, aligned with the
    cohort's ``axes_map``; identity where this client has no widening
    (so every client shares one structure and the matrices stack).
    Leaves widened along the same segments (a transformer's gate, up
    and down projections share the d_ff segments) share one array."""
    build = grad_matrix if kind == "grad" else mean_matrix
    built: Dict[tuple, np.ndarray] = {}
    out: Dict[Path, List[np.ndarray]] = {}
    for path, axes in axes_map.items():
        shape = leaf_shape(shapes, path)
        by_axis = {s.axis % len(shape): s for s in spec.get(path, [])}
        mats = []
        for ax in axes:
            s = by_axis.get(ax)
            key = ((shape[ax],) if s is None else
                   (np.asarray(s.ids).tobytes(), s.out_role))
            if key not in built:
                built[key] = (np.eye(shape[ax], dtype=np.float32)
                              if s is None else build(s))
            mats.append(built[key])
        out[path] = mats
    return out


def stack_matrices(per_client: Sequence[Dict[Path, List[np.ndarray]]],
                   device=None) -> Dict[str, List[torch.Tensor]]:
    """Stack aligned per-client matrix dicts into ``{path-str:
    [(K, U, U), ...]}`` tensors on ``device``; leaves whose per-client
    arrays are the same objects share one tensor."""
    if not per_client:
        return {}
    stacked: Dict[tuple, torch.Tensor] = {}
    out: Dict[str, List[torch.Tensor]] = {}
    for path in per_client[0]:
        mats = []
        for i in range(len(per_client[0][path])):
            arrays = [c[path][i] for c in per_client]
            key = tuple(id(a) for a in arrays)
            if key not in stacked:
                stacked[key] = torch.as_tensor(np.stack(arrays),
                                               device=device)
            mats.append(stacked[key])
        out[path_str(path)] = mats
    return out


def apply_leaf(x, axes: Tuple[int, ...], mats: Sequence, *, stacked: bool):
    """Apply per-axis matrices ``out[v] = Σ_u M[v,u] x[u]`` along each
    widened axis. ``stacked`` marks a leading K axis on ``x`` (and on
    every matrix)."""
    out = x.float()
    for ax, m in zip(axes, mats):
        a = ax + 1 if stacked else ax
        moved = out.movedim(a, -1)
        eq = "kvu,k...u->k...v" if stacked else "vu,...u->...v"
        moved = torch.einsum(eq, m, moved)
        out = moved.movedim(-1, a)
    return out.to(x.dtype)


def project_stacked(tree, axes_map: Dict[str, Tuple[int, ...]],
                    mats: Dict[str, List[torch.Tensor]]):
    """Apply the stacked per-client segment operators to a stacked tree
    (leaves without widened axes pass through). Used on gradients inside
    the engine's step: masks handle depth, this handles width."""
    if not axes_map:
        return tree

    def fix(path, g):
        axes = axes_map.get(path_str(path))
        if not axes:
            return g
        return apply_leaf(g, axes, mats[path_str(path)], stacked=True)

    return tu.map_with_path(fix, tree)


def multiplicity_tree(spec: Dict[Path, List[AxisSeg]], shapes, device=None):
    """Per-coordinate duplication counts of one client's embedding: the
    product over widened axes of the segment size (1 everywhere for
    depth-only embeddings), built on ``device``."""

    def build(path, s):
        arr = torch.ones(tuple(s.shape), dtype=torch.float32, device=device)
        for seg in spec.get(path, []):
            shape = [1] * len(s.shape)
            shape[seg.axis % len(s.shape)] = -1
            c = torch.as_tensor(seg.counts.astype(np.float32), device=device)
            arr = arr * c.reshape(shape)
        return arr

    return tu.map_with_path(build, shapes)
