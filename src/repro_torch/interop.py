"""Parameters across the two packages, through numpy.

The JAX package's parameters are nested dicts of arrays in its own
layout (HWIO convs, ``(Din, Dout)`` fcs and projections, transformer
blocks stacked on a leading ``n_units`` axis under ``units/b{i}``); the
port keeps the same layout, so crossing over is a dtype-preserving copy
leaf by leaf. Lists of such dicts (the per-client state of the loop
path) cross over element by element.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tu


def params_from_numpy(tree, device=None):
    """Nested dicts / lists of array-likes (numpy, or anything
    ``np.asarray`` takes) -> the same structure of tensors on
    ``device``."""
    return tu.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(tree):
    """Nested dicts / lists of tensors -> the same structure of numpy
    arrays."""
    return tu.tree_map(lambda t: t.detach().cpu().numpy(), tree)
