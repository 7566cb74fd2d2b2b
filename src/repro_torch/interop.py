"""Parameters across the two packages, through numpy.

The JAX package's parameters are nested dicts of arrays in its own
layout (HWIO convs, ``(Din, Dout)`` fcs and projections, transformer
blocks stacked on a leading ``n_units`` axis under ``units/b{i}``); the
port keeps the same layout, so crossing over is a dtype-preserving copy
leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tu


def params_from_numpy(tree, device=None):
    """Nested dict of array-likes (numpy, or anything ``np.asarray``
    takes) -> the same dict of tensors on ``device``."""
    return tu.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> the same dict of numpy arrays."""
    return tu.tree_map(lambda t: t.detach().cpu().numpy(), tree)
