"""NetChange — FedADP's structure-transformation primitives (paper §III.B).

  To-Wider   (Alg. 2)  new neurons duplicate randomly-chosen existing ones;
                       each duplicate group's OUTGOING weights are divided
                       by the group size  => function preserving (Net2Net).
  To-Deeper            insert missing layers initialized to identity.
  To-Narrower (Alg. 3) delete neurons beyond N_tar; the summed outgoing
                       weights of deleted neurons are redistributed evenly
                       (s / N_tar added to each survivor)  => lossy.
  To-Shallower         drop the layers the target doesn't have.

Beyond paper: ``narrow_fold`` — the exact inverse of To-Wider given the
expansion mapping (mean incoming copies, sum outgoing splits).

Mappings are deterministic in (tag, old_width, new_width, seed): the same
sha256-seeded numpy stream as the JAX package, so both packages draw
identical duplications. The To-Wider gathers go through the port's
``widen_2d`` kernel (``kernels/netchange``: the CUDA kernel on CUDA
tensors, ``index_select`` on CPU ones); segment sums are ``index_add_``;
every op is functional (new tensors, inputs untouched).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.netchange import ops as widen_ops

NARROW_MODES = ("paper", "fold")


def round_embed_seed(base_seed: int, round_idx: int, k: int) -> int:
    """The per-(round, client) NetChange seed — one formula for every
    path that draws a round's To-Wider mappings."""
    return (base_seed * 1_000_003 + round_idx * 997 + k) % (2 ** 31)


class KeyedCache:
    """Bounded get-or-build LRU for seed-keyed embedding artifacts
    (coverage masks, segment matrices, packed coverage/multiplicity
    rows): ``max(128, 4·n_clients)`` entries by default, keys namespaced
    tuples, ``stats()`` exposes hit/miss/size/bound counters."""

    def __init__(self, *, n_clients: int = 0, bound: Optional[int] = None):
        self.bound = bound if bound is not None else max(128, 4 * n_clients)
        self._d: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, build):
        if key in self._d:
            self.hits += 1
            self._d.move_to_end(key)
            return self._d[key]
        self.misses += 1
        val = self._d[key] = build()
        while len(self._d) > self.bound:
            self._d.popitem(last=False)
        return val

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._d), "bound": self.bound}

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d


def dup_mapping(old: int, new: int, *, tag: str = "",
                seed: int = 0) -> np.ndarray:
    """Mapping m: [new] -> [old]. First ``old`` slots are the identity; the
    remaining ``new - old`` duplicate sources are chosen uniformly from a
    deterministic stream (Alg. 2 line 6)."""
    assert new >= old > 0, (old, new)
    h = int.from_bytes(hashlib.sha256(f"{tag}:{old}:{new}:{seed}".encode())
                       .digest()[:8], "big")
    rng = np.random.default_rng(h)
    extra = rng.integers(0, old, size=new - old)
    return np.concatenate([np.arange(old), extra]).astype(np.int32)


def mapping_counts(mapping: np.ndarray, old: int) -> np.ndarray:
    return np.bincount(mapping, minlength=old).astype(np.int32)


def _index(mapping, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mapping), dtype=torch.long,
                           device=device)


# -------------------------------------------------------------- To-Wider
def widen_in(w, mapping, axis: int = -1):
    """Incoming weights: duplicate columns per ``mapping`` (Alg. 2 l.7-8).
    The To-Wider gather kernel on CUDA tensors, its plain version
    (``index_select``) on CPU ones."""
    return widen_ops.widen(w, mapping, axis=axis).to(w.dtype)


def widen_out(w, mapping, old: int, axis: int = 0):
    """Outgoing weights: duplicate rows and divide each duplicate group by
    its size (Alg. 2 l.11-14). Dispatched as ``widen_in``."""
    del old                     # the group sizes come from ``mapping``
    return widen_ops.widen(w, mapping, axis=axis, split=True).to(w.dtype)


# ------------------------------------------------------------- To-Narrower
def narrow_in(w, n_tar: int, axis: int = -1):
    """Incoming weights: drop columns of deleted neurons (> N_tar)."""
    return w.narrow(axis, 0, n_tar)


def narrow_out_paper(w, n_tar: int, axis: int = 0):
    """Alg. 3: s = sum of deleted rows; survivors += s / N_tar."""
    kept = w.narrow(axis, 0, n_tar)
    dropped = w.narrow(axis, n_tar, w.shape[axis] - n_tar)
    s = dropped.sum(dim=axis, keepdim=True)
    return kept + (s / n_tar).to(kept.dtype)


def _segment_sum(w_moved, mapping, old: int):
    out = torch.zeros((old,) + tuple(w_moved.shape[1:]), dtype=w_moved.dtype,
                      device=w_moved.device)
    return out.index_add_(0, _index(mapping, w_moved.device), w_moved)


def narrow_fold_in(w, mapping, old: int, axis: int = -1):
    """Beyond-paper inverse of ``widen_in``: mean over each duplicate
    group."""
    counts = torch.as_tensor(mapping_counts(np.asarray(mapping), old),
                             device=w.device)
    summed = _segment_sum(w.movedim(axis, 0), mapping, old)
    mean = summed / counts.reshape((-1,) + (1,) * (summed.dim() - 1)).to(
        w.dtype)
    return mean.movedim(0, axis)


def narrow_fold_out(w, mapping, old: int, axis: int = 0):
    """Beyond-paper inverse of ``widen_out``: sum over each duplicate
    group."""
    return _segment_sum(w.movedim(axis, 0), mapping, old).movedim(0, axis)


# ----------------------------------------------------- To-Deeper (identity)
def identity_conv(channels: int, ksize: int = 3, dtype=torch.float32,
                  device=None):
    """3x3 HWIO conv kernel acting as identity (center tap = channel
    diagonal). Exact identity after ReLU since activations are >= 0."""
    w = torch.zeros((ksize, ksize, channels, channels), dtype=dtype,
                    device=device)
    c = ksize // 2
    w[c, c] = torch.eye(channels, dtype=dtype, device=device)
    return w


def identity_fc(width: int, dtype=torch.float32, device=None):
    return torch.eye(width, dtype=dtype, device=device)
