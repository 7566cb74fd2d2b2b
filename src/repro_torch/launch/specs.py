"""Shapes and placements of a step's inputs (the JAX package's
``launch/specs.py``): tensors on the ``meta`` device stand in for the
reference's ``ShapeDtypeStruct``s (shapes and dtypes, no allocation),
and a placement is the plan's tuple of entries a dimension
(``sharding.rules``), entry for entry the spec of the reference's
``NamedSharding``. ``mesh`` is a ``DeviceMesh`` or a mapping of axis
names to sizes, in mesh order; its data axes are those named "pod" or
"data".

  batch_specs(cfg, shape_name)      -> {"tokens", ["labels"], ["aux"]} or
                                       {"token", "cache", "pos"} (decode)
  step_specs(cfg, kind, B, S)       -> the same at any batch and length
  param_sds(cfg)                    -> the parameter tree's shapes
  opt_sds(cfg, optimizer, params)   -> the optimizer state's shapes
  data_shardings(cfg, shape_name, mesh, batch) -> the batch's placement
  param_shardings(cfg, mesh, params, embed_tp=) -> the parameters'
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding import rules


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Shapes of the data part of a step's inputs at ``INPUT_SHAPES
    [shape_name]``: training and prefill take ``tokens`` (and training
    ``labels``) of the text's length, a front end's ``aux`` (the vision
    prefix's rows count in the sequence); decode takes one ``token``
    against a cache of the sequence's length and a scalar ``pos``."""
    shp = INPUT_SHAPES[shape_name]
    return step_specs(cfg, shp.kind, shp.global_batch, shp.seq_len)


def step_specs(cfg: ModelConfig, kind: str, B: int, S: int
               ) -> Dict[str, Any]:
    """``batch_specs`` of a step of ``kind`` ("train", "prefill",
    "decode") at global batch ``B`` and length ``S``."""
    adt = getattr(torch, cfg.dtype)
    if kind in ("train", "prefill"):
        n_text = S
        out: Dict[str, Any] = {}
        if cfg.frontend is not None and cfg.frontend.kind == "vision":
            n_text = S - cfg.frontend.n_prefix
            out["aux"] = _sds((B, cfg.frontend.n_prefix, cfg.d_model), adt)
        if cfg.encoder is not None:
            out["aux"] = _sds((B, cfg.encoder.n_ctx, cfg.d_model), adt)
        out["tokens"] = _sds((B, n_text), torch.int32)
        if kind == "train":
            out["labels"] = _sds((B, n_text), torch.int32)
        return out
    return {"token": _sds((B, 1), torch.int32),
            "cache": T.init_cache(cfg, B, S, device="meta"),
            "pos": _sds((), torch.int32)}


def param_sds(cfg: ModelConfig):
    return T.init_params(None, cfg, device="meta")


def opt_sds(cfg: ModelConfig, optimizer, params_sds):
    """The state ``optimizer.init`` makes for ``params_sds`` (on ``meta``:
    AdamW's f32 ``m``, ``v`` and ``master`` copies)."""
    return optimizer.init(params_sds)


def _data_axes(sizes: dict):
    return tuple(a for a in sizes if a in ("pod", "data"))


def data_shardings(cfg: ModelConfig, shape_name: str, mesh,
                   batch_sds) -> Dict[str, Any]:
    """The placement of ``batch_specs``' tree: the batch's rows over the
    data axes when their extent divides the global batch, else whole;
    the cache by ``rules.cache_specs`` (its sequence over the data axes
    when the batch does not split); ``pos`` replicated."""
    sizes = rules.mesh_sizes(mesh)
    da = _data_axes(sizes)
    B = INPUT_SHAPES[shape_name].global_batch
    extent = 1
    for a in da:
        extent *= sizes[a]
    shardable = B % extent == 0 and B >= extent
    dp = da if shardable else None

    def batch_leaf(leaf):
        spec = [None] * leaf.dim()
        if dp and leaf.shape[0] % extent == 0:
            spec[0] = dp if len(dp) > 1 else dp[0]
        return tuple(spec)

    out = {}
    for k, v in batch_sds.items():
        if k == "cache":
            out[k] = rules.cache_specs(v, sizes, da,
                                       batch_shardable=shardable)
        elif k == "pos":
            out[k] = ()
        else:
            out[k] = tu.tree_map(batch_leaf, v)
    return out


def param_shardings(cfg: ModelConfig, mesh, params_sds, *,
                    embed_tp: bool = False):
    sizes = rules.mesh_sizes(mesh)
    return rules.param_specs(params_sds, sizes, _data_axes(sizes),
                             embed_tp=embed_tp)
