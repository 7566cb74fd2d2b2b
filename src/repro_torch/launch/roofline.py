"""Roofline model of one step on an NVIDIA H100 (the JAX package's
``launch/roofline.py``, whose peaks are a TPU's).

Terms per (arch x shape x mesh), all in seconds a step a card:

  compute_s    = dot_flops_per_rank / PEAK_FLOPS
                 (dot_flops counted on meta tensors by ``launch.op_count``
                 — matmul FLOPs dominate; elementwise ops are folded into
                 the memory term)
  memory_s     = hbm_bytes_per_rank / HBM_BW
                 (the analytic traffic model below, the reference's)
  collective_s = collective_bytes_per_rank / LINK_BW
                 (``op_count``'s collective bytes; an all_reduce counted
                 2x)

MODEL_FLOPS (6*N_active*D for training, 2*N_active*tokens for inference)
gives the useful-compute ratio that catches remat/redundancy waste.

The peaks are NVIDIA's published dense rates of the H100 SXM at its full
power limit of 700 W: bf16 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s
each way between two cards of one host (900 GB/s in all). A card set
below 700 W runs slower under load. The collective term takes every
axis at NVLink's rate; an axis wider than 8 cards leaves one host's
NVLink domain (e.g. the 16 x 16 mesh's), so there the term is
optimistic. These are counts against published peaks, not
measurements.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs import (INPUT_SHAPES, ModelConfig,
                                 active_param_count, param_count)

PEAK_FLOPS = 989e12     # bf16 dense / card (H100 SXM, 700 W)
HBM_BW = 3.35e12        # bytes/s / card (HBM3)
LINK_BW = 450e9         # bytes/s / card, NVLink, one direction


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Global useful FLOPs per step (the 6ND / 2ND convention)."""
    shp = INPUT_SHAPES[shape_name]
    n_active = active_param_count(cfg)
    if shp.kind == "train":
        return 6.0 * n_active * shp.global_batch * shp.seq_len
    if shp.kind == "prefill":
        return 2.0 * n_active * shp.global_batch * shp.seq_len
    return 2.0 * n_active * shp.global_batch          # decode: one token


def _bytes_per_param_train() -> float:
    # bf16 param r+w (4) + fp32 master r+w (8) + fp32 m r+w (8)
    # + fp32 v r+w (8) + bf16 grad w+r (4)
    return 32.0


def hbm_bytes(cfg: ModelConfig, shape_name: str, n_chips: int) -> float:
    """Per-card HBM traffic per step (analytic, documented model)."""
    shp = INPUT_SHAPES[shape_name]
    n_params = param_count(cfg)
    B, S = shp.global_batch, shp.seq_len
    D, L = cfg.d_model, cfg.n_layers
    p_local = n_params / n_chips                       # fully sharded
    b_local = max(B / max(n_chips // 16, 1), 1)        # data axes extent
    act_unit = b_local * S * D * 2.0                   # one bf16 activation
    if shp.kind == "train":
        # fwd+bwd touch ~8 activation tensors per layer; remat re-runs fwd
        act = 12.0 * L * act_unit
        return p_local * _bytes_per_param_train() + act
    if shp.kind == "prefill":
        act = 6.0 * L * act_unit
        cache_w = _cache_bytes(cfg, B, S) / n_chips
        return p_local * 2.0 + act + cache_w
    # decode: weights once + the whole cache read per token
    cache_r = _cache_bytes(cfg, B, S) / n_chips
    return p_local * 2.0 + cache_r + 4.0 * L * (b_local * D * 2.0)


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("global", "crossdec"):
            if cfg.mla is not None:
                total += B * S * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
            else:
                total += 2 * B * S * cfg.n_kv_heads * hd * 2
            if kind == "crossdec":
                total += 2 * B * cfg.encoder.n_ctx * cfg.n_heads * hd * 2
        elif kind == "local":
            total += 2 * B * min(cfg.window, S) * cfg.n_kv_heads * hd * 2
        elif kind == "rglru":
            total += B * cfg.d_rnn * 4
        elif kind == "mlstm":
            H = cfg.ssm.n_heads
            dm = 2 * cfg.d_model
            total += B * H * (dm // H) ** 2 * 4
        elif kind == "slstm":
            total += 4 * B * cfg.d_model * 4
    return total


def terms(cfg: ModelConfig, shape_name: str, counts: Dict[str, float],
          n_chips: int) -> Dict[str, Any]:
    """The roofline terms of one rank's ``counts`` (``op_count``'s
    ``dot_flops`` and ``coll_total``) on ``n_chips`` cards."""
    comp = counts.get("dot_flops", 0.0) / PEAK_FLOPS
    mem = hbm_bytes(cfg, shape_name, n_chips) / HBM_BW
    coll = counts.get("coll_total", 0.0) / LINK_BW
    mf = model_flops(cfg, shape_name)
    dev_flops = counts.get("dot_flops", 0.0)
    out = {
        "compute_s": comp,
        "memory_s": mem,
        "collective_s": coll,
        "model_flops_global": mf,
        "useful_ratio": (mf / n_chips) / dev_flops if dev_flops else 0.0,
        "dominant": max((("compute", comp), ("memory", mem),
                         ("collective", coll)), key=lambda kv: kv[1])[0],
        "step_s_lower_bound": max(comp, mem, coll),
    }
    return out
