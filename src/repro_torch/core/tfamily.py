"""NetChange for the transformer families (the JAX package's
``core/tfamily.py``; beyond the paper, which treats VGG only).

Client variants of a family vary in depth (number of pattern units,
the stacked leading axis), FFN width (``d_ff``, the MoE expert width
``d_ff_expert`` and the shared experts' width), expert count and the
RG-LRU's recurrent width ``d_rnn``. d_model,
heads and vocab are held fixed within a family: widening d_model through
an RMSNorm is not function preserving.

  up():   To-Wider (Net2Net duplicate+split, exact) + To-Deeper (all-zero
          blocks => identity under the pre-norm residual, exact).
  down(): To-Narrower (paper Alg. 3, lossy; or the ``fold`` inverse) +
          To-Shallower (slice the stack).

MoE expert duplication copies whole experts (``widen_in`` on axis -3 of
the stacked expert leaves, the ``widen_2d`` kernel on the card) and
shifts the duplicated router columns by -log(group size) in the router
bias: exact under soft routing, approximate under top-k.

The whisper encoder's FFN follows ``d_ff`` too, through one mapping
shared by its stacked layers (tag ``e/ffn``); its depth
(``cfg.encoder.n_layers``) never varies inside a family.

The width mappings come from ``core/netchange.py``'s ``dup_mapping`` with
the JAX package's tags (``u/b{i}/ffn``, ``.../effn``, ``.../sffn``,
``.../exp``, ``.../rnn``, ``e/ffn``), so both packages draw the same
duplications.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig
from repro_torch.core import netchange as nc
from repro_torch.core import segments as sg
from repro_torch.models import transformer as T

# ----------------------------------------------------------------- variants
def make_variant(cfg: ModelConfig, *, n_units: Optional[int] = None,
                 ffn_scale: float = 1.0, n_experts: Optional[int] = None,
                 d_rnn: Optional[int] = None) -> ModelConfig:
    kw: Dict[str, Any] = {}
    if n_units is not None:
        assert 1 <= n_units <= cfg.n_units
        kw["n_layers"] = n_units * cfg.pattern_len + len(cfg.rem_kinds)
    if ffn_scale != 1.0 and cfg.d_ff:
        kw["d_ff"] = _round8(cfg.d_ff * ffn_scale)
    if cfg.moe is not None:
        m = cfg.moe
        e = n_experts if n_experts is not None else m.n_experts
        # ffn_scale=1.0 is the identity: rounding an unscaled width through
        # _round8 would change the config (and the cohort's engine)
        kw["moe"] = dataclasses.replace(
            m, n_experts=e, top_k=min(m.top_k, e),
            d_ff_expert=(_round8(m.d_ff_expert * ffn_scale)
                         if ffn_scale != 1.0 else m.d_ff_expert),
            d_ff_shared=(_round8(m.d_ff_shared * ffn_scale)
                         if ffn_scale != 1.0 and m.n_shared
                         else m.d_ff_shared))
    if d_rnn is not None and cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_rnn=d_rnn)
    name = cfg.name + f"-u{n_units or cfg.n_units}f{ffn_scale}e{n_experts or 0}"
    return dataclasses.replace(cfg, name=name, **kw)


def _round8(x: float) -> int:
    return max(8, int(round(x / 8) * 8))


def union(cfgs) -> ModelConfig:
    """Global architecture = elementwise max (paper §III.B)."""
    base = max(cfgs, key=lambda c: c.n_layers)
    kw: Dict[str, Any] = {"n_layers": max(c.n_layers for c in cfgs),
                          "d_ff": max(c.d_ff for c in cfgs),
                          "name": cfgs[0].name.split("-u")[0] + "-union"}
    if base.moe is not None:
        kw["moe"] = dataclasses.replace(
            base.moe,
            n_experts=max(c.moe.n_experts for c in cfgs),
            top_k=max(c.moe.top_k for c in cfgs),
            d_ff_expert=max(c.moe.d_ff_expert for c in cfgs),
            d_ff_shared=max(c.moe.d_ff_shared for c in cfgs))
    if base.ssm is not None:
        kw["ssm"] = dataclasses.replace(base.ssm,
                                        d_rnn=max(c.d_rnn for c in cfgs))
    return dataclasses.replace(base, **kw)


# ----------------------------------------------------- per-block transforms
# role and axis (from the end) of each MLP leaf along d_ff; bd (the
# output bias) is width-invariant
_MLP_SPEC = {"wg": ("in", -1), "wu": ("in", -1), "wi": ("in", -1),
             "bi": ("in", -1), "wd": ("out", -2)}


def _apply_width(w, role, axis, mapping, old, mode):
    """One leaf through a width mapping: "widen" (To-Wider) or
    "narrow_fold" (its inverse)."""
    if mode == "widen":
        return (nc.widen_in(w, mapping, axis=axis) if role == "in"
                else nc.widen_out(w, mapping, old, axis=axis))
    return (nc.narrow_fold_in(w, mapping, old, axis=axis) if role == "in"
            else nc.narrow_fold_out(w, mapping, old, axis=axis))


def _transform_mlp(mlp, old: int, new: int, tag: str, seed: int, mode: str):
    out = dict(mlp)
    if mode == "widen":
        mapping = nc.dup_mapping(old, new, tag=tag, seed=seed)
        for k, (role, ax) in _MLP_SPEC.items():
            if k in out:
                out[k] = _apply_width(out[k], role, ax, mapping, old, mode)
    elif mode == "narrow_paper":
        for k, (role, ax) in _MLP_SPEC.items():
            if k in out:
                out[k] = (nc.narrow_in(out[k], new, axis=ax) if role == "in"
                          else nc.narrow_out_paper(out[k], new, axis=ax))
    else:  # narrow_fold: the client->global mapping is dup(new, old)
        mapping = nc.dup_mapping(new, old, tag=tag, seed=seed)
        for k, (role, ax) in _MLP_SPEC.items():
            if k in out:
                out[k] = _apply_width(out[k], role, ax, mapping, new, mode)
    return out


# the expert axis of the stacked expert leaves
_EXPERT_AXIS = {"wg": -3, "wu": -3, "wd": -3}


def _transform_experts(moe, old_e: int, new_e: int, tag: str, seed: int,
                       mode: str):
    """Expert-count change: duplicate whole experts; the router columns
    follow, the duplicates' router bias shifted by -log(group size) (the
    group's softmax mass is then the original expert's: exact under soft
    routing)."""
    out = dict(moe)
    if mode == "widen":
        mapping = nc.dup_mapping(old_e, new_e, tag=tag + "/exp", seed=seed)
        counts = nc.mapping_counts(mapping, old_e)
        for k, ax in _EXPERT_AXIS.items():
            out[k] = nc.widen_in(out[k], mapping, axis=ax)
        out["router"] = nc.widen_in(out["router"], mapping, axis=-1)
        b = nc.widen_in(out["router_b"], mapping, axis=-1)
        shift = torch.as_tensor(np.log(counts[mapping]).astype(np.float32),
                                device=b.device)
        out["router_b"] = b - shift.to(b.dtype)
    elif mode == "narrow_paper":
        for k, ax in _EXPERT_AXIS.items():
            out[k] = nc.narrow_in(out[k], new_e, axis=ax)
        out["router"] = nc.narrow_in(out["router"], new_e, axis=-1)
        out["router_b"] = nc.narrow_in(out["router_b"], new_e, axis=-1)
    else:
        mapping = nc.dup_mapping(new_e, old_e, tag=tag + "/exp", seed=seed)
        counts = nc.mapping_counts(mapping, new_e)
        for k, ax in _EXPERT_AXIS.items():
            out[k] = nc.narrow_fold_in(out[k], mapping, new_e, axis=ax)
        out["router"] = nc.narrow_fold_in(out["router"], mapping, new_e,
                                          axis=-1)
        b = nc.narrow_fold_in(out["router_b"], mapping, new_e, axis=-1)
        shift = torch.as_tensor(np.log(counts).astype(np.float32),
                                device=b.device)
        out["router_b"] = b + shift.to(b.dtype)
    return out


# role and axis (from the end) of each RG-LRU leaf along d_rnn; "both":
# the square recurrent-gate matrices move on their rows (out) and their
# columns (in)
_RG_SPEC = {"win": ("in", -1), "wgate": ("in", -1), "conv": ("in", -1),
            "ba": ("in", -1), "bx": ("in", -1), "lam": ("in", -1),
            "wa": ("both", None), "wx": ("both", None),
            "wout": ("out", -2)}


def _transform_rg(rg, old: int, new: int, tag: str, seed: int, mode: str):
    out = dict(rg)
    if mode == "narrow_paper":
        for k, (role, ax) in _RG_SPEC.items():
            if role == "in":
                out[k] = nc.narrow_in(out[k], new, axis=ax)
            elif role == "out":
                out[k] = nc.narrow_out_paper(out[k], new, axis=ax)
            else:  # both: rows redistribute, columns drop
                out[k] = nc.narrow_in(
                    nc.narrow_out_paper(out[k], new, axis=-2), new, axis=-1)
        return out
    if mode == "widen":
        mapping = nc.dup_mapping(old, new, tag=tag + "/rnn", seed=seed)
        base = old
    else:  # narrow_fold: the client->global mapping is dup(new, old)
        mapping = nc.dup_mapping(new, old, tag=tag + "/rnn", seed=seed)
        base = new
    for k, (role, ax) in _RG_SPEC.items():
        if role == "both":
            out[k] = _apply_width(
                _apply_width(out[k], "out", -2, mapping, base, mode),
                "in", -1, mapping, base, mode)
        else:
            out[k] = _apply_width(out[k], role, ax, mapping, base, mode)
    return out


def _transform_block(block, from_cfg: ModelConfig, to_cfg: ModelConfig,
                     tag: str, seed: int, mode: str):
    out = dict(block)
    if "mlp" in out and from_cfg.d_ff != to_cfg.d_ff:
        out["mlp"] = _transform_mlp(out["mlp"], from_cfg.d_ff, to_cfg.d_ff,
                                    tag + "/ffn", seed, mode)
    if "moe" in out:
        mf, mt = from_cfg.moe, to_cfg.moe
        moe = dict(out["moe"])
        if mf.d_ff_expert != mt.d_ff_expert:
            sub = {k: moe[k] for k in ("wg", "wu", "wd")}
            moe.update(_transform_mlp(sub, mf.d_ff_expert, mt.d_ff_expert,
                                      tag + "/effn", seed, mode))
        if "shared" in moe and mf.d_ff_shared != mt.d_ff_shared:
            moe["shared"] = _transform_mlp(
                moe["shared"], mf.n_shared * mf.d_ff_shared,
                mt.n_shared * mt.d_ff_shared, tag + "/sffn", seed, mode)
        if mf.n_experts != mt.n_experts:
            moe = _transform_experts(moe, mf.n_experts, mt.n_experts, tag,
                                     seed, mode)
        out["moe"] = moe
    if "rg" in out and from_cfg.d_rnn != to_cfg.d_rnn:
        out["rg"] = _transform_rg(out["rg"], from_cfg.d_rnn, to_cfg.d_rnn,
                                  tag, seed, mode)
    return out


def _param_shapes(cfg: ModelConfig):
    return T.init_params(None, cfg, device="meta")


def segment_spec(from_cfg: ModelConfig, to_cfg: ModelConfig, *,
                 seed: int = 0):
    """Width-segment metadata of ``up(·, from_cfg, to_cfg, seed=seed)``
    (``core.segments``) for every linear width ``_transform_block``
    moves: FFN d_ff (the whisper encoder's too), MoE expert width
    d_ff_expert, the shared experts' width and the RG-LRU's d_rnn. Per
    widened leaf: in-role duplication on the hidden axis (−1), out-role
    split on the down-projection rows (−2), both on the recurrent square
    matrices, with each block's own deterministic mapping (the tags
    ``up()`` uses, so the ids match it exactly).

    Expert-count duplication is not emitted: its router-bias shift makes
    the embedding affine per expert group, so such cohorts carry no
    segment metadata (and ``segment_representable`` keeps them on the
    loop)."""
    spec = {}
    mf, mt = from_cfg.moe, to_cfg.moe
    ffn = (from_cfg.d_ff, to_cfg.d_ff)
    effn = (mf.d_ff_expert, mt.d_ff_expert) if mf and mt else (0, 0)
    sffn = ((mf.n_shared * mf.d_ff_shared, mt.n_shared * mt.d_ff_shared)
            if mf and mt else (0, 0))
    rnn = ((from_cfg.d_rnn, to_cfg.d_rnn)
           if from_cfg.ssm and to_cfg.ssm else (0, 0))
    if all(a == b for a, b in (ffn, effn, sffn, rnn)):
        return spec
    for path, _ in tu.flatten(_param_shapes(to_cfg)):
        if (path[:2] == ("encoder", "units") and len(path) == 4
                and path[2] == "mlp" and path[3] in _MLP_SPEC):
            # the encoder's FFN: one mapping for all its stacked layers
            (old, new), tag, (role, ax) = ffn, "e/ffn", _MLP_SPEC[path[3]]
        elif len(path) < 3 or path[0] not in ("units", "rem"):
            continue
        else:
            hit = _block_hit(path, ffn, effn, sffn, rnn)
            if hit is None:
                continue
            (old, new), tag, (role, ax) = hit
        if old != new:
            mapping = nc.dup_mapping(old, new, tag=tag, seed=seed)
            spec[path] = ([sg.AxisSeg(-2, mapping, out_role=True),
                           sg.AxisSeg(-1, mapping, out_role=False)]
                          if role == "both" else
                          [sg.AxisSeg(ax, mapping, out_role=(role == "out"))])
    return spec


def _block_hit(path, ffn, effn, sffn, rnn):
    """(widths, tag, (role, axis)) of a block leaf that a width moves,
    else None."""
    tag0 = ("u" if path[0] == "units" else "r") + f"/{path[1]}"
    rest = path[2:]
    if rest[0] == "mlp" and len(rest) == 2 and rest[1] in _MLP_SPEC:
        return ffn, tag0 + "/ffn", _MLP_SPEC[rest[1]]
    if rest[0] == "moe" and len(rest) == 2 and rest[1] in ("wg", "wu", "wd"):
        return effn, tag0 + "/effn", _MLP_SPEC[rest[1]]
    if (len(rest) == 3 and rest[:2] == ("moe", "shared")
            and rest[2] in _MLP_SPEC):
        return sffn, tag0 + "/sffn", _MLP_SPEC[rest[2]]
    if rest[0] == "rg" and len(rest) == 2 and rest[1] in _RG_SPEC:
        return rnn, tag0 + "/rnn", _RG_SPEC[rest[1]]
    return None


# ------------------------------------------------------------------ up/down
def _zeros_block_like(cfg: ModelConfig, kind: str, device):
    shapes = T.block_init(None, cfg, kind, device="meta",
                          dtype=getattr(torch, cfg.dtype))
    return tu.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                             device=device), shapes)


def _device_of(params):
    return tu.leaves(params)[0].device


def _transform_encoder(params, from_cfg: ModelConfig, to_cfg: ModelConfig,
                       seed: int, mode: str):
    """The whisper encoder's FFN follows ``d_ff`` as the decoder blocks'
    does: one mapping (tag ``e/ffn``) for its stacked layers, matching
    ``segment_spec``. Its depth never varies inside a family."""
    if "encoder" not in params or from_cfg.d_ff == to_cfg.d_ff:
        return params
    enc = dict(params["encoder"])
    units = dict(enc["units"])
    units["mlp"] = _transform_mlp(units["mlp"], from_cfg.d_ff, to_cfg.d_ff,
                                  "e/ffn", seed, mode)
    enc["units"] = units
    params["encoder"] = enc
    return params


def up(params, from_cfg: ModelConfig, to_cfg: ModelConfig, *, seed: int = 0):
    """Client -> global: To-Wider (exact) + To-Deeper (zero blocks, exact)."""
    assert from_cfg.layer_pattern == to_cfg.layer_pattern
    params = dict(params)
    # widths first (existing blocks), at client depth
    for part, t in (("units", "u"), ("rem", "r")):
        if part in params:
            params[part] = {
                k: _transform_block(v, from_cfg, to_cfg, f"{t}/{k}", seed,
                                    "widen")
                for k, v in params[part].items()}
    params = _transform_encoder(params, from_cfg, to_cfg, seed, "widen")
    # depth: pad the stacked axis with zero blocks (identity via residual)
    nu_from, nu_to = from_cfg.n_units, to_cfg.n_units
    if nu_to > nu_from:
        dev = _device_of(params)
        units = dict(params["units"])
        for i, kind in enumerate(to_cfg.layer_pattern):
            zb = _zeros_block_like(to_cfg, kind, dev)
            units[f"b{i}"] = tu.tree_map(
                lambda a, z: torch.cat(
                    [a, z[None].expand(nu_to - nu_from, *z.shape)], dim=0),
                units[f"b{i}"], zb)
        params["units"] = units
    return params


def down(params, from_cfg: ModelConfig, to_cfg: ModelConfig, *, seed: int = 0,
         mode: str = "paper"):
    """Global -> client: To-Shallower (slice) + To-Narrower (Alg.3 | fold)."""
    assert from_cfg.layer_pattern == to_cfg.layer_pattern
    nmode = "narrow_paper" if mode == "paper" else "narrow_fold"
    params = dict(params)
    nu_to = to_cfg.n_units
    if nu_to < from_cfg.n_units:
        params["units"] = tu.tree_map(lambda x: x[:nu_to], params["units"])
    for part, t in (("units", "u"), ("rem", "r")):
        if part in params:
            params[part] = {
                k: _transform_block(v, from_cfg, to_cfg, f"{t}/{k}", seed,
                                    nmode)
                for k, v in params[part].items()}
    return _transform_encoder(params, from_cfg, to_cfg, seed, nmode)
