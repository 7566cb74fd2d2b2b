"""VGG family in functional PyTorch — the paper's own experimental models.

Parameters are a nested dict in the JAX package's layout, so planes and
NetChange ops agree column for column:
  params = {
    "stages": {"s0": {"c0": {"w": (3,3,Cin,Cout) HWIO, "b": (Cout,)}, ...}},
    "fc":     {"f0": {"w": (Din,Dout), "b": (Dout,)}, ...},
    "out":    {"w": (D, n_classes), "b": (n_classes,)},
  }
Max-pool (2x2) after every stage; ReLU after every conv / fc. Inputs are
NHWC. The conv stack runs in PyTorch's NCHW (the input is permuted once,
each HWIO kernel is permuted to OIHW at its conv call), and the features
are permuted back to NHWC before the flatten, so fc0's rows are
(spatial, channel) pairs with channel fastest, as in the JAX model.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.vgg_family import VGGConfig


def init_params(cfg: VGGConfig, generator: Optional[torch.Generator] = None,
                *, device=None, dtype=torch.float32) -> Dict[str, Any]:
    """He-normal weights, zero biases, drawn on the CPU from
    ``generator`` then moved to ``device``. ``device="meta"`` gives the
    shapes only (no draws)."""
    meta = device is not None and torch.device(device).type == "meta"

    def normal(shape, fan_in):
        if meta:
            return torch.empty(shape, dtype=dtype, device="meta")
        w = torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)
        return w.to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    params: Dict[str, Any] = {"stages": {}, "fc": {}}
    cin = cfg.in_channels
    for si, widths in enumerate(cfg.stages):
        stage = {}
        for li, cout in enumerate(widths):
            stage[f"c{li}"] = {"w": normal((3, 3, cin, cout), 9 * cin),
                               "b": zeros(cout)}
            cin = cout
        params["stages"][f"s{si}"] = stage
    spatial = cfg.image_size // (2 ** len(cfg.stages))
    din = cin * spatial * spatial
    for fi, dout in enumerate(cfg.classifier):
        params["fc"][f"f{fi}"] = {"w": normal((din, dout), din),
                                  "b": zeros(dout)}
        din = dout
    params["out"] = {"w": normal((din, cfg.n_classes), din),
                     "b": zeros(cfg.n_classes)}
    return params


def apply(params, cfg: VGGConfig, x):
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    h = x.permute(0, 3, 1, 2)                        # NHWC -> NCHW
    for si in range(len(params["stages"])):
        stage = params["stages"][f"s{si}"]
        for li in range(len(stage)):
            p = stage[f"c{li}"]
            h = F.relu(F.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"],
                                padding=1))          # HWIO -> OIHW, SAME
        h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
    for fi in range(len(params["fc"])):
        p = params["fc"][f"f{fi}"]
        h = F.relu(h @ p["w"] + p["b"])
    out = params["out"]
    return h @ out["w"] + out["b"]


def loss_fn(params, cfg: VGGConfig, batch):
    """batch: {'x': (B,H,W,C), 'y': (B,) int labels} -> (loss, acc)."""
    logits = apply(params, cfg, batch["x"]).float()
    y = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y[:, None])[:, 0]
    loss = (logz - ll).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc
