"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Models in this repository are plain nested dicts of arrays. These helpers
flatten them in JAX's order — dict keys sorted, depth first, as
``jax.tree_util.tree_flatten_with_path`` does — so a packed plane's
column offsets match the JAX package's exactly. Anything that is not a
dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

Path = Tuple[str, ...]


def flatten(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in sorted-key, depth-first order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], prefix + (str(k),)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(paths: Sequence[Path], values: Sequence[Any]) -> Dict:
    """Nested dict with ``values[i]`` at ``paths[i]``."""
    out: Dict = {}
    for path, v in zip(paths, values):
        cur = out
        for p in path[:-1]:
            cur = cur.setdefault(p, {})
        cur[path[-1]] = v
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def map_with_path(fn: Callable, tree, prefix: Path = ()):
    """``fn(path, leaf)`` leafwise, structure preserved."""
    if not isinstance(tree, dict):
        return fn(prefix, tree)
    return {k: map_with_path(fn, v, prefix + (str(k),))
            for k, v in tree.items()}


def get(tree, path: Path):
    node = tree
    for k in path:
        node = node[k]
    return node
