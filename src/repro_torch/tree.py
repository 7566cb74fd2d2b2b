"""Nested parameter trees: the port's stand-in for JAX pytrees.

Models in this repository are plain nested dicts of arrays; the
per-client state of the loop path is a list of such dicts. These helpers
flatten them in JAX's order — dict keys sorted, lists in index order,
depth first, as ``jax.tree_util.tree_flatten_with_path`` does — so a
packed plane's column offsets match the JAX package's exactly, and a
path's ``"/".join`` is the key the JAX package's checkpoints use
(``"3/stages/s0/c0/w"`` for client 3 of a list). Anything that is not a
dict or a list is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

Path = Tuple[str, ...]


def _items(tree):
    """``[(key, child), ...]`` of a container in flatten order: sorted
    dict keys, list indices (as strings) in index order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), c) for i, c in enumerate(tree)]


def flatten(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in JAX's order (sorted keys, list index
    order), depth first."""
    if not isinstance(tree, (dict, list)):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for k, child in _items(tree):
        out.extend(flatten(child, prefix + (k,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(paths: Sequence[Path], values: Sequence[Any]) -> Dict:
    """Nested dict with ``values[i]`` at ``paths[i]`` (list indices come
    back as string keys, as the JAX package's template-free checkpoint
    load gives them)."""
    out: Dict = {}
    for path, v in zip(paths, values):
        cur = out
        for p in path[:-1]:
            cur = cur.setdefault(p, {})
        cur[path[-1]] = v
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, c, *(r[i] for r in rest))
                for i, c in enumerate(tree)]
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, prefix: Path = ()):
    """``fn(path, leaf)`` leafwise, structure preserved."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, c, prefix + (str(i),))
                for i, c in enumerate(tree)]
    return fn(prefix, tree)


def get(tree, path: Path):
    node = tree
    for k in path:
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node
