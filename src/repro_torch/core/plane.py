"""Packed parameter plane — ONE contiguous layout for a whole cohort.

The union tree flattens into a single contiguous ``(K, P)`` f32 *plane*
plus a static, hashable :class:`PlaneSpec` describing where each leaf
lives, so a cohort aggregates in one kernel pass over the plane,
coverage/filler/multiplicity trees become row-aligned planes, and
participant gathers become row slices.

The flatten order is JAX's (dict keys sorted, ``repro_torch.tree``), so
a torch plane and a JAX plane of the same tree have identical offsets
and are interchangeable column for column.

Dtype contract: the plane is always f32 — packing casts each leaf up,
unpacking casts back to the leaf's recorded dtype. ``unpack`` and
``unpack_stacked`` return VIEWS of the plane (``narrow`` + ``view``) for
f32 leaves: writing the plane in place is seen through them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tu

Path = Tuple[str, ...]

_F32 = "float32"


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX package's spelling)."""
    return str(dtype).replace("torch.", "")


def ragged_leaf_error(what: str, path, got, want) -> ValueError:
    """The ragged-input message contract: name the leaf path and the two
    mismatched shapes."""
    name = "/".join(path) if isinstance(path, tuple) else str(path)
    return ValueError(
        f"{what}: leaf '{name}' has shape {tuple(got)}, expected "
        f"{tuple(want)} — trees must agree leaf-by-leaf")


@dataclass(frozen=True)
class PlaneSpec:
    """Static description of a packed plane: for each leaf (in flatten
    order) its path, shape (WITHOUT the stacked K axis), dtype name and
    column offset. Hashable; two specs are equal iff the packed layout
    is identical."""
    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    offsets: Tuple[int, ...]
    size: int                    # P: total packed coordinates

    @classmethod
    def _build(cls, items) -> "PlaneSpec":
        paths, shapes, dtypes, offsets = [], [], [], []
        off = 0
        for path, shape, dtype in items:
            paths.append(path)
            shapes.append(tuple(int(s) for s in shape))
            dtypes.append(dtype_name(dtype))
            offsets.append(off)
            off += int(np.prod(shape)) if len(shape) else 1
        return cls(tuple(paths), tuple(shapes), tuple(dtypes),
                   tuple(offsets), off)

    @classmethod
    def from_tree(cls, tree) -> "PlaneSpec":
        """Spec of an un-stacked tree (tensors, meta tensors included)."""
        flat = tu.flatten(tree)
        if not isinstance(tree, dict) or not flat:
            raise ValueError("PlaneSpec: tree has no leaves")
        return cls._build([(p, l.shape, l.dtype) for p, l in flat])

    @classmethod
    def from_stacked(cls, stacked) -> Tuple["PlaneSpec", int]:
        """Spec of a stacked tree (every leaf ``(K, ...)``); returns
        ``(spec, K)``. Ragged leading axes raise naming the leaf."""
        flat = tu.flatten(stacked)
        if not flat:
            raise ValueError("PlaneSpec: tree has no leaves")
        k = None
        items = []
        for path, leaf in flat:
            if leaf.dim() < 1:
                raise ragged_leaf_error("PlaneSpec.from_stacked", path,
                                        leaf.shape, ("K", "..."))
            if k is None:
                k = int(leaf.shape[0])
            elif int(leaf.shape[0]) != k:
                raise ragged_leaf_error(
                    "PlaneSpec.from_stacked", path, leaf.shape,
                    (k,) + tuple(leaf.shape[1:]))
            items.append((path, leaf.shape[1:], leaf.dtype))
        return cls._build(items), k

    @property
    def n_leaves(self) -> int:
        return len(self.paths)

    @property
    def all_f32(self) -> bool:
        return all(d == _F32 for d in self.dtypes)

    def leaf_sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s)) if s else 1 for s in self.shapes)

    def col_mask(self, pred) -> np.ndarray:
        """0/1 ``(P,)`` f32 column mask selecting every leaf whose path
        tuple satisfies ``pred`` (e.g. the FlexiFed common-prefix
        columns), built from the layout alone."""
        out = np.zeros((self.size,), np.float32)
        for path, off, n in zip(self.paths, self.offsets,
                                self.leaf_sizes()):
            if pred(path):
                out[off:off + n] = 1.0
        return out

    def validate(self, tree, *, what: str = "tree", stacked: bool = False,
                 check_dtypes: bool = False):
        """Check ``tree`` matches this layout leaf-by-leaf; returns its
        flattened ``[(path, leaf), ...]``.

        ``check_dtypes`` is opt-in: packing casts every leaf to f32, so
        mask and multiplicity planes are built from f32 trees against
        specs that record bf16 leaves; a loader whose storage dtype is
        the contract passes ``check_dtypes=True``."""
        flat = tu.flatten(tree)
        if len(flat) != self.n_leaves:
            raise ValueError(
                f"{what}: {len(flat)} leaves, expected {self.n_leaves}")
        for (path, leaf), spath, sshape, sdtype in zip(
                flat, self.paths, self.shapes, self.dtypes):
            if path != spath:
                raise ValueError(f"{what}: leaf '{'/'.join(path)}' where "
                                 f"'{'/'.join(spath)}' was expected — "
                                 "tree structure does not match the spec")
            got = tuple(leaf.shape)
            if stacked:
                if len(got) < 1 or got[1:] != sshape:
                    raise ragged_leaf_error(what, path, got,
                                            ("K",) + sshape)
            elif got != sshape:
                raise ragged_leaf_error(what, path, got, sshape)
            if check_dtypes and dtype_name(leaf.dtype) != sdtype:
                raise ValueError(
                    f"{what}: leaf '{'/'.join(path)}' has dtype "
                    f"{dtype_name(leaf.dtype)}, expected {sdtype} — storage "
                    "dtypes must match the spec")
        return flat

    def to_manifest(self) -> Dict[str, Any]:
        """JSON-serializable layout, interchangeable with the JAX
        package's ``PlaneSpec.to_manifest``."""
        return {"paths": ["/".join(p) for p in self.paths],
                "shapes": [list(s) for s in self.shapes],
                "dtypes": list(self.dtypes)}

    @classmethod
    def from_manifest(cls, man: Dict[str, Any]) -> "PlaneSpec":
        paths = [tuple(p.split("/")) for p in man["paths"]]
        leaves = [torch.empty(tuple(s), dtype=getattr(torch, d),
                              device="meta")
                  for s, d in zip(man["shapes"], man["dtypes"])]
        return cls.from_tree(tu.unflatten(paths, leaves))


# ----------------------------------------------------------------- packing
def pack(tree, spec: PlaneSpec, *, what: str = "pack") -> torch.Tensor:
    """Flatten an un-stacked tree into a contiguous ``(P,)`` f32 plane in
    the spec's layout (validates paths + shapes)."""
    flat = spec.validate(tree, what=what)
    return torch.cat([leaf.reshape(-1).float() for _, leaf in flat])


def pack_stacked(stacked, spec: PlaneSpec, *,
                 what: str = "pack_stacked") -> torch.Tensor:
    """Flatten a stacked tree (leaves ``(K, ...)``) into a ``(K, P)`` f32
    plane; rows are clients, columns follow the spec layout."""
    flat = spec.validate(stacked, what=what, stacked=True)
    k = int(flat[0][1].shape[0])
    for path, leaf in flat:
        if int(leaf.shape[0]) != k:
            raise ragged_leaf_error(what, path, leaf.shape,
                                    (k,) + tuple(leaf.shape[1:]))
    return torch.cat([leaf.reshape(k, -1).float() for _, leaf in flat],
                     dim=1)


def pack_trees(trees: Sequence, spec: PlaneSpec, *,
               what: str = "pack_trees") -> torch.Tensor:
    """Pack a list of un-stacked trees into a row-aligned ``(K, P)``
    plane (row k = tree k)."""
    return torch.stack([pack(t, spec, what=f"{what}[{i}]")
                        for i, t in enumerate(trees)])


def _restore(x: torch.Tensor, dtype: str) -> torch.Tensor:
    return x if dtype == _F32 else x.to(getattr(torch, dtype))


def unpack(plane: torch.Tensor, spec: PlaneSpec):
    """``(P,)`` plane -> tree of views (leaf shapes, dtypes restored)."""
    return tu.unflatten(spec.paths, [
        _restore(plane.narrow(0, o, n).view(s), d)
        for o, n, s, d in zip(spec.offsets, spec.leaf_sizes(), spec.shapes,
                              spec.dtypes)])


def unpack_stacked(plane: torch.Tensor, spec: PlaneSpec):
    """``(K, P)`` plane -> stacked tree of views (leading K on every
    leaf)."""
    k = plane.shape[0]
    return tu.unflatten(spec.paths, [
        _restore(plane.narrow(1, o, n).view((k,) + s), d)
        for o, n, s, d in zip(spec.offsets, spec.leaf_sizes(), spec.shapes,
                              spec.dtypes)])


def requantize(plane: torch.Tensor, spec: PlaneSpec) -> torch.Tensor:
    """Round the plane's columns through their leaf storage dtypes (cast
    down, cast back to f32), matching the tree-shaped reference's
    per-step storage rounding. Returns the plane itself when every leaf
    is f32."""
    if spec.all_f32:
        return plane
    pieces = []
    for o, n, d in zip(spec.offsets, spec.leaf_sizes(), spec.dtypes):
        seg = plane.narrow(-1, o, n)
        if d != _F32:
            seg = seg.to(getattr(torch, d)).float()
        pieces.append(seg)
    return torch.cat(pieces, dim=-1)


# ----------------------------------------------------- streaming helpers
def chunk_bounds(k: int, k_chunk: int) -> Tuple[Tuple[int, int], ...]:
    """Row-chunk bounds ``((lo, hi), ...)`` covering ``k`` rows in
    ``k_chunk``-sized chunks (the last one ragged when ``k_chunk`` does
    not divide ``k``)."""
    if k_chunk < 1:
        raise ValueError(f"k_chunk={k_chunk!r} must be >= 1")
    k_chunk = min(k_chunk, k)
    return tuple((lo, min(lo + k_chunk, k)) for lo in range(0, k, k_chunk))


def stacked_rows(stacked, lo: int, hi: int):
    """Row-slice a stacked tree: every leaf ``(K, ...)`` ->
    ``(hi - lo, ...)`` views — the tree-level face of a plane row chunk."""
    return tu.tree_map(lambda a: a[lo:hi], stacked)


# ------------------------------------------------- packed cohort builders
def cohort_planes(family, client_cfgs: Sequence, global_cfg, *,
                  seed: int = 0, coverage: str = "loose", device=None):
    """The four row-aligned ``(K, P)`` planes of a cohort's embedding —
    strict mask, filler, aggregation-coverage mask (``coverage``
    "loose": strict ∪ nonzero filler; "strict": the mask), multiplicity —
    built once per (cohort, seed), and the spec. Multiplicity is None
    for a family without segment metadata (depth-only: every count 1)."""
    from repro_torch.core.aggregation import (coverage_and_filler,
                                              global_shapes, loosen,
                                              multiplicity)
    spec = PlaneSpec.from_tree(global_shapes(family, global_cfg))
    masks, fillers, covs, mults = [], [], [], []
    spec_fn = getattr(family, "segment_spec", None)
    for cfg in client_cfgs:
        m, f = coverage_and_filler(family, cfg, global_cfg, seed=seed,
                                   device=device)
        masks.append(pack(m, spec, what="cohort_planes/mask"))
        fillers.append(pack(f, spec, what="cohort_planes/filler"))
        cov = m if coverage == "strict" else loosen(m, f)
        covs.append(pack(cov, spec, what="cohort_planes/cov"))
        if spec_fn is not None:
            mults.append(pack(multiplicity(family, cfg, global_cfg,
                                           seed=seed, device=device),
                              spec, what="cohort_planes/mult"))
    return (spec, torch.stack(masks), torch.stack(fillers),
            torch.stack(covs), torch.stack(mults) if mults else None)
