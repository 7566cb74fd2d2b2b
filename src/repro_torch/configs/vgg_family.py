"""The paper's own experimental family: VGG-13..VGG-19(-Wider) variants.

Section IV of FedADP: 8 architecture types — VGG-13, VGG-14, VGG-15,
VGG-16-Wider, VGG-17, VGG-18, VGG-19, VGG-19-Wider — across 20 clients
(6 clients on VGG-19, 2 on each of the other 7).

We express a VGG variant as a ``VGGConfig``: a tuple of conv stages, each
stage a tuple of channel widths (one entry per conv layer; max-pool after
every stage), followed by a classifier MLP. "-Wider" widens one layer of
the corresponding base net (the paper's Fig. 1 highlights the widened
layers) — we widen the last conv layer of stage 4 by 1.5x, rounded to a
multiple of 16, matching the illustrated pattern.

The *global* architecture of the cohort is the elementwise union
(max depth per stage, max width per layer) => VGG-19-Wider, exactly as
the paper states.

For the offline reproduction (repro band 2/5: CIFAR/MNIST not available)
we additionally provide ``scaled(cfg, f)`` reduced variants used with the
synthetic datasets; the architectural *relationships* between variants
(which layers are missing / narrower) are preserved exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class VGGConfig:
    name: str
    # conv stages: one tuple per stage, entries = output channels per conv
    stages: Tuple[Tuple[int, ...], ...]
    classifier: Tuple[int, ...] = (4096, 4096)
    n_classes: int = 10
    in_channels: int = 3
    image_size: int = 32


def _wider(stages, stage_idx=3, layer_idx=0, factor=1.5):
    # layer_idx=0: depth variants align at the front (To-Deeper appends
    # missing layers at the END of a stage), so widening the first conv of
    # stage 4 makes union(cohort) == VGG-19-Wider exactly as the paper says.
    st = [list(s) for s in stages]
    w = st[stage_idx][layer_idx]
    st[stage_idx][layer_idx] = int(round(w * factor / 16) * 16)
    return tuple(tuple(s) for s in st)


_C = (64, 128, 256, 512, 512)  # canonical VGG stage widths

# layers-per-stage for each depth variant (conv counts; totals = depth-3 FC)
_DEPTHS = {
    "vgg13": (2, 2, 2, 2, 2),
    "vgg14": (2, 2, 3, 2, 2),
    "vgg15": (2, 2, 3, 3, 2),
    "vgg16": (2, 2, 3, 3, 3),
    "vgg17": (2, 2, 4, 3, 3),
    "vgg18": (2, 2, 4, 4, 3),
    "vgg19": (2, 2, 4, 4, 4),
}


def _mk(name: str, depths, wider: bool = False, **kw) -> VGGConfig:
    stages = tuple(tuple(_C[i] for _ in range(n)) for i, n in enumerate(depths))
    if wider:
        stages = _wider(stages)
    return VGGConfig(name=name, stages=stages, **kw)


def vgg(name: str, **kw) -> VGGConfig:
    base, _, suffix = name.partition("-")
    return _mk(name, _DEPTHS[base], wider=(suffix == "wider"), **kw)


# The paper's 8-architecture cohort.
PAPER_COHORT = (
    "vgg13", "vgg14", "vgg15", "vgg16-wider",
    "vgg17", "vgg18", "vgg19", "vgg19-wider",
)

# client -> architecture assignment: 6 clients on VGG-19, 2 on each other.
def paper_client_archs() -> Tuple[str, ...]:
    out = []
    for a in PAPER_COHORT:
        out.extend([a] * (6 if a == "vgg19" else 2))
    assert len(out) == 20
    return tuple(out)


def union_config(cfgs) -> VGGConfig:
    """Global architecture = union (max depth per stage, max width per layer,
    elementwise) of the cohort — Section III.B of the paper."""
    n_stages = max(len(c.stages) for c in cfgs)
    stages = []
    for si in range(n_stages):
        depth = max(len(c.stages[si]) for c in cfgs if si < len(c.stages))
        layer_ws = []
        for li in range(depth):
            ws = [c.stages[si][li] for c in cfgs
                  if si < len(c.stages) and li < len(c.stages[si])]
            layer_ws.append(max(ws))
        stages.append(tuple(layer_ws))
    cls_depth = max(len(c.classifier) for c in cfgs)
    classifier = tuple(
        max(c.classifier[i] for c in cfgs if i < len(c.classifier))
        for i in range(cls_depth))
    c0 = cfgs[0]
    return VGGConfig(name="union", stages=tuple(stages), classifier=classifier,
                     n_classes=c0.n_classes, in_channels=c0.in_channels,
                     image_size=c0.image_size)


def scaled(cfg: VGGConfig, f: float = 0.125, classifier: int = 128) -> VGGConfig:
    """Reduced-width variant for offline (synthetic-data) experiments.

    Widths scale by ``f`` (rounded to multiples of 4 so that the wider
    variants stay strictly wider); depth structure is preserved exactly.
    """
    def r(w):
        return max(4, int(round(w * f / 4) * 4))
    stages = tuple(tuple(r(w) for w in s) for s in cfg.stages)
    cls = tuple(classifier for _ in cfg.classifier)
    return replace(cfg, name=cfg.name + f"-x{f}", stages=stages, classifier=cls)
