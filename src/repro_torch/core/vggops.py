"""NetChange wired to the VGG family — the paper's own setting.

A VGG variant is a sequential chain  conv* (pool) ... conv* (pool) fc* out.
``up()`` transforms client params to the global architecture (To-Deeper +
To-Wider, Alg. 2); ``down()`` transforms global params to a client
architecture (To-Shallower + To-Narrower, Alg. 3 — or the beyond-paper
``fold`` inverse).

Parameters keep the JAX package's layout (HWIO convs, ``(Din, Dout)``
fcs): the conv->fc flatten boundary groups fc0's rows as (spatial,
channel) pairs, channel fastest — the NHWC flatten ``models/vgg.py``
performs before fc0.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.vgg_family import VGGConfig
from repro_torch.core import netchange as nc
from repro_torch.core import segments as sg


def _chain(cfg: VGGConfig) -> List[Tuple]:
    out = []
    for si, ws in enumerate(cfg.stages):
        for li in range(len(ws)):
            out.append(("conv", si, li))
    for fi in range(len(cfg.classifier)):
        out.append(("fc", fi))
    out.append(("out",))
    return out


def _get(params, node):
    if node[0] == "conv":
        return params["stages"][f"s{node[1]}"][f"c{node[2]}"]
    if node[0] == "fc":
        return params["fc"][f"f{node[1]}"]
    return params["out"]


def _set(params, node, value):
    if node[0] == "conv":
        params["stages"][f"s{node[1]}"][f"c{node[2]}"] = value
    elif node[0] == "fc":
        params["fc"][f"f{node[1]}"] = value
    else:
        params["out"] = value


def _width_of(cfg: VGGConfig, node) -> int:
    if node[0] == "conv":
        return cfg.stages[node[1]][node[2]]
    if node[0] == "fc":
        return cfg.classifier[node[1]]
    return cfg.n_classes


def _spatial_after_convs(cfg: VGGConfig) -> int:
    return cfg.image_size // (2 ** len(cfg.stages))


def _widen_next_in(nxt, nxt_node, mapping, old, cfg, *, fold=False,
                   flatten=False):
    """Duplicate (or fold) the incoming channels of the next layer.
    ``flatten`` marks the conv→fc boundary: fc0's rows are (spatial,
    channel) pairs, channel fastest."""
    w = nxt["w"]
    if nxt_node[0] == "conv":
        nxt["w"] = (nc.narrow_fold_out(w, mapping, old, axis=2) if fold
                    else nc.widen_out(w, mapping, old, axis=2))
        return nxt
    if not flatten:
        nxt["w"] = (nc.narrow_fold_out(w, mapping, old, axis=0) if fold
                    else nc.widen_out(w, mapping, old, axis=0))
        return nxt
    sp = _spatial_after_convs(cfg) ** 2
    w3 = w.reshape(sp, -1, w.shape[1])
    w3 = (nc.narrow_fold_out(w3, mapping, old, axis=1) if fold
          else nc.widen_out(w3, mapping, old, axis=1))
    nxt["w"] = w3.reshape(-1, w.shape[1])
    return nxt


def _narrow_next_in_paper(nxt, nxt_node, n_tar, cfg, *, flatten=False):
    w = nxt["w"]
    if nxt_node[0] == "conv":
        nxt["w"] = nc.narrow_out_paper(w, n_tar, axis=2)
        return nxt
    if not flatten:
        nxt["w"] = nc.narrow_out_paper(w, n_tar, axis=0)
        return nxt
    sp = _spatial_after_convs(cfg) ** 2
    w3 = w.reshape(sp, -1, w.shape[1])
    nxt["w"] = nc.narrow_out_paper(w3, n_tar, axis=1).reshape(-1, w.shape[1])
    return nxt


def _copy(params):
    """New dicts, same leaves (every op below is functional)."""
    if isinstance(params, dict):
        return {k: _copy(v) for k, v in params.items()}
    return params


def _mid_widths(from_cfg: VGGConfig, to_cfg: VGGConfig) -> Dict[Tuple, int]:
    """Chain-node -> width AFTER To-Deeper but BEFORE To-Wider (inserted
    identity convs carry their stage's last client width) — the "old"
    side of every To-Wider mapping, shared by ``up`` and
    ``segment_spec``."""
    mid = tuple(
        tuple(list(from_cfg.stages[si]) + [from_cfg.stages[si][-1]]
              * (len(to_cfg.stages[si]) - len(from_cfg.stages[si])))
        for si in range(len(to_cfg.stages)))
    return {**{("conv", si, li): mid[si][li]
               for si in range(len(mid)) for li in range(len(mid[si]))},
            **{("fc", fi): from_cfg.classifier[fi]
               for fi in range(len(from_cfg.classifier))}}


def up(params, from_cfg: VGGConfig, to_cfg: VGGConfig, *, seed: int = 0):
    """Client -> global: To-Deeper then To-Wider (both function preserving)."""
    params = _copy(params)
    # --- To-Deeper: append identity convs at the end of each stage
    for si, ws_to in enumerate(to_cfg.stages):
        ws_from = from_cfg.stages[si]
        assert len(ws_to) >= len(ws_from), (si, ws_from, ws_to)
        ch = ws_from[-1]
        stage = params["stages"][f"s{si}"]
        w0, b0 = stage["c0"]["w"], stage["c0"]["b"]
        for li in range(len(ws_from), len(ws_to)):
            stage[f"c{li}"] = {
                "w": nc.identity_conv(ch, dtype=w0.dtype, device=w0.device),
                "b": b0.new_zeros((ch,))}
    # --- To-Wider over the whole chain (Alg. 2)
    chain = _chain(to_cfg)
    cur_widths = _mid_widths(from_cfg, to_cfg)
    for idx, node in enumerate(chain[:-1]):
        old = cur_widths[node]
        new = _width_of(to_cfg, node)
        if new == old:
            continue
        tag = "/".join(map(str, node))
        mapping = nc.dup_mapping(old, new, tag=tag, seed=seed)
        layer = dict(_get(params, node))
        out_axis = 3 if node[0] == "conv" else 1
        layer["w"] = nc.widen_in(layer["w"], mapping, axis=out_axis)
        layer["b"] = nc.widen_in(layer["b"], mapping, axis=0)
        _set(params, node, layer)
        nxt_node = chain[idx + 1]
        nxt = dict(_get(params, nxt_node))
        nxt = _widen_next_in(nxt, nxt_node, mapping, old, to_cfg, fold=False,
                             flatten=(node[0] == "conv"))
        _set(params, nxt_node, nxt)
    return params


def segment_spec(from_cfg: VGGConfig, to_cfg: VGGConfig, *, seed: int = 0):
    """Width-segment metadata of ``up(·, from_cfg, to_cfg, seed=seed)``:
    per client-owned union leaf, which axes To-Wider duplicated and the
    segment id of every union index along them. Mirrors ``up()``'s chain
    walk; the conv→fc flatten boundary lifts the channel mapping to
    (spatial, channel) rows, channel fastest."""
    spec = {}
    chain = _chain(to_cfg)
    cur_widths = _mid_widths(from_cfg, to_cfg)

    def is_client(node):
        if node[0] == "conv":
            return node[2] < len(from_cfg.stages[node[1]])
        return True

    def path_of(node):
        if node[0] == "conv":
            return ("stages", f"s{node[1]}", f"c{node[2]}")
        if node[0] == "fc":
            return ("fc", f"f{node[1]}")
        return ("out",)

    prev = prev_node = None          # previous chain node's (mapping, new)
    for node in chain:
        segs_w, segs_b = [], []
        if prev is not None and is_client(node):
            mapping_p, new_p = prev
            if node[0] == "conv":
                segs_w.append(sg.AxisSeg(2, mapping_p, out_role=True))
            elif prev_node[0] == "conv":
                sp = _spatial_after_convs(to_cfg) ** 2
                ids = (np.arange(sp)[:, None] * new_p
                       + np.asarray(mapping_p)[None, :]).reshape(-1)
                segs_w.append(sg.AxisSeg(0, ids.astype(np.int32),
                                         out_role=True))
            else:
                segs_w.append(sg.AxisSeg(0, mapping_p, out_role=True))
        own = None
        if node != ("out",):
            old = cur_widths[node]
            new = _width_of(to_cfg, node)
            if new != old:
                tag = "/".join(map(str, node))
                own = (nc.dup_mapping(old, new, tag=tag, seed=seed), new)
        if own is not None and is_client(node):
            out_axis = 3 if node[0] == "conv" else 1
            segs_w.append(sg.AxisSeg(out_axis, own[0], out_role=False))
            segs_b.append(sg.AxisSeg(0, own[0], out_role=False))
        if is_client(node):
            p = path_of(node)
            if segs_w:
                spec[p + ("w",)] = segs_w
            if segs_b:
                spec[p + ("b",)] = segs_b
        prev, prev_node = own, node
    return spec


def down(params, from_cfg: VGGConfig, to_cfg: VGGConfig, *, seed: int = 0,
         mode: str = "paper"):
    """Global -> client: To-Narrower (Alg. 3 or fold) then To-Shallower."""
    assert mode in ("paper", "fold")
    params = _copy(params)
    # --- To-Narrower over the chain (widths of layers the client keeps)
    chain = _chain(from_cfg)
    for idx, node in enumerate(chain[:-1]):
        if node[0] == "conv":
            si, li = node[1], node[2]
            if li >= len(to_cfg.stages[si]):
                continue                       # layer will be dropped
            new = to_cfg.stages[si][li]
        else:
            new = to_cfg.classifier[node[1]]
        old = _width_of(from_cfg, node)
        if new == old:
            continue
        assert new < old
        layer = dict(_get(params, node))
        out_axis = 3 if node[0] == "conv" else 1
        nxt_node = chain[idx + 1]
        nxt = dict(_get(params, nxt_node))
        if mode == "paper":
            layer["w"] = nc.narrow_in(layer["w"], new, axis=out_axis)
            layer["b"] = nc.narrow_in(layer["b"], new, axis=0)
            nxt = _narrow_next_in_paper(nxt, nxt_node, new, from_cfg,
                                        flatten=(node[0] == "conv"))
        else:
            tag = "/".join(map(str, node))
            mapping = nc.dup_mapping(new, old, tag=tag, seed=seed)
            layer["w"] = nc.narrow_fold_in(layer["w"], mapping, new,
                                           axis=out_axis)
            layer["b"] = nc.narrow_fold_in(layer["b"], mapping, new, axis=0)
            nxt = _widen_next_in(nxt, nxt_node, mapping, new, from_cfg,
                                 fold=True, flatten=(node[0] == "conv"))
        _set(params, node, layer)
        _set(params, nxt_node, nxt)

    # --- To-Shallower: drop trailing convs per stage
    for si, ws_to in enumerate(to_cfg.stages):
        stage = params["stages"][f"s{si}"]
        for li in range(len(ws_to), len(from_cfg.stages[si])):
            del stage[f"c{li}"]
    return params
