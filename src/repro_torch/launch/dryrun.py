"""Dry run: every (architecture x input shape) step of the port at full
published width, counted on ``meta`` tensors as rank 0 of a production
mesh, with its roofline on an NVIDIA H100 (the JAX package's
``launch/dryrun.py``, which lowers and compiles each pair for a TPU pod
and reads the compiled HLO).

Each run happens in one process. A fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once) stands in for the ranks, and rank 0's step is built as
the plan cuts it: its parameters ``sharding.rules.tp_slice`` (the model
cut, then the data cut of FSDP), its rows of the batch
(``data_rows``; serving ``cache_rows`` with ``batch_ctx``: a batch the
data axes do not split is whole on every data rank and the caches' slots
are cut instead, ``cache_slot_cut``), its cache ``init_cache(...,
ctx=)``, under ``ShardCtx(remat=True)`` as the reference's
``lower_one`` (``BLOCKS``: 4096-row attention blocks, but the ShardCtx
default for a config with sliding-window layers).
``launch.op_count`` counts the step: dot FLOPs, the
collectives by axis and issuer, the live bytes at their peak. Nothing is
computed and nothing allocated, so the CPU is enough.

Meshes: ``--mesh 16x16`` (default; ``data`` x ``model``, the reference's
production mesh), ``--multi-pod`` (2 x 16 x 16, ``pod`` x ``data`` x
``model``), or any ``--mesh DxM`` (the card's meshes: 2x1, 2x2, 1x2,
1x4). long_500k is skipped for architectures that are not
``sub_quadratic``, as in the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-small \\
      --shape decode_32k --mesh 2x1 --dtype float32

A serve run (a prefill and its decode steps) or a cut depth is
``count_pair``'s (``serve=``, ``n_layers=``), as ``chip_smoke.py`` calls it.

Each pair prints one JSON line: ``status`` (OK / SKIP / FAIL),
``t_lower_s`` (the counting time), ``counts`` (``dot_flops``,
``coll_total``, the collectives by axis and issuer), the rank's
``param_bytes`` / ``opt_bytes`` / ``cache_bytes`` /
``activation_peak_bytes``, and ``roofline`` (``launch.roofline``). A
failure exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import op_count
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding.collectives import (dp_active, gather_padded,
                                              vocab_argmax)
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.sharding.rules import (batch_ctx, cache_rows, data_rows,
                                        tp_slice)

META = torch.device("meta")
PRODUCTION = (16, 16)
# the blockwise attention's blocks on meta: each block pair is a few
# dozen ops of ~0.3 ms each on meta tensors, so 512-row blocks (the
# ShardCtx default) make a 32k prefill 4096 pairs a layer. Where every
# block pair is computed the dot FLOPs are the same at 4096 rows; a
# sliding-window layer computes only its band's blocks, whose keys grow
# with the block, so a config with one keeps the default
BLOCKS = {"block_q": 4096, "block_kv": 4096}


def fake_store():
    """The store of torch's fake process group, from the private module
    of torch's tests that defines it (the one place the port imports
    it). Raises ``RuntimeError`` where this torch lacks it."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), "
            f"which this torch ({torch.__version__}) lacks: {e}") from e
    return FakeStore()


def parse_mesh(text: str) -> Tuple[int, ...]:
    """"16x16" -> (16, 16); "2x16x16" -> (2, 16, 16)."""
    return tuple(int(x) for x in text.lower().split("x"))


def mesh_names(shape: Sequence[int]) -> Tuple[str, ...]:
    return (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))


def fake_mesh(shape: Sequence[int], rank: int = 0):
    """Rank ``rank`` of a fake process group of ``prod(shape)`` ranks and
    the ``DeviceMesh`` of ``shape`` over it (an earlier fake group of
    this process is ended first)."""
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    world = math.prod(shape)
    dist.init_process_group("fake", store=fake_store(), rank=rank,
                            world_size=world)
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=mesh_names(shape))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tu.leaves(tree)
               if isinstance(t, torch.Tensor))


def _rows(batch, rows: slice):
    return {k: v[rows] for k, v in batch.items()}


def rank_params(cfg, ctx):
    """The rank's parameter tree on ``meta``: the whole tree's shapes cut by
    ``tp_slice`` (model part, then data part)."""
    return tp_slice(T.init_params(None, cfg, device="meta"), ctx, cfg)


def _serve(params, cfg, ctx, batch: int, prompt_len: int, gen: int):
    """``launch.serve.run``'s steps on ``meta``: the prefill of ``batch``
    prompts (and a front end's ``aux``), the greedy token, ``gen``
    decode steps each with its pick, and under data axes that split the
    batch the tokens gathered. Returns the last cache."""
    npx = T.vision_prefix(cfg)
    cache_len = npx + prompt_len + gen
    ctx = batch_ctx(batch, ctx)
    rows = cache_rows(batch, ctx)
    n = rows.stop - rows.start
    prefill = make_prefill_step(cfg, ctx=ctx, cache_len=cache_len)
    decode = make_decode_step(cfg, ctx=ctx, cache_len=cache_len)
    lo = T.vocab_lo(params, cfg, ctx)

    def pick(logits):
        if lo is None:
            return logits.argmax(-1)[:, None]
        return vocab_argmax(logits, ctx, lo)[:, None]

    b = {"tokens": torch.empty((n, prompt_len), dtype=torch.int32,
                               device=META)}
    shape = T.aux_shape(cfg, batch)
    if shape is not None:
        b["aux"] = torch.empty((n,) + tuple(shape[1:]),
                               dtype=T._param_dtype(cfg), device=META)
    logits, cache = prefill(params, b)
    tok = pick(logits).to(torch.int32)
    toks = []
    for i in range(gen):
        toks.append(tok)
        logits, cache = decode(params, tok, cache, npx + prompt_len + i)
        tok = pick(logits).to(torch.int32)
    if toks and dp_active(ctx) and not ctx.batch_whole:
        gather_padded(torch.cat(toks, dim=1), 0, ctx.data_rank,
                      ctx.data_size, ctx.data_sum)
    return cache


def count_pair(arch: str, shape_name: Optional[str] = None, *,
               mesh_shape: Sequence[int] = PRODUCTION,
               dtype: str = "bfloat16", n_layers: Optional[int] = None,
               batch: Optional[int] = None, seq: Optional[int] = None,
               serve: Optional[Tuple[int, int]] = None, loss_chunk: int = 512,
               ctx_kw: Optional[Dict[str, Any]] = None, cfg=None,
               rank: int = 0) -> Dict[str, Any]:
    """Count one step of rank ``rank`` (0: the dry run's) on a fake mesh
    of ``mesh_shape``.

    ``shape_name`` is an ``INPUT_SHAPES`` entry (its kind, global batch
    and length; ``batch`` / ``seq`` override them), or None with
    ``serve=(prompt_len, gen)``: a serve run, ``launch.serve.run``'s
    prefill and ``gen`` decode steps at ``batch`` rows. ``n_layers``
    cuts the config's depth as the launchers do; ``dtype`` is its
    parameter dtype (the reference's dry run: bfloat16); ``cfg`` replaces
    the registry's config of ``arch``. ``mesh_shape`` None counts one
    process (no process group)."""
    # the roofline is of the published config at the shape's size
    published = (cfg, batch, seq, n_layers) == (None,) * 4
    cfg = (cfg or get_config(arch)).with_dtype(dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cfg.validate()
    label = shape_name or f"serve_{serve[0]}+{serve[1]}"
    res: Dict[str, Any] = {"arch": arch, "shape": label,
                           "mesh": "x".join(map(str, mesh_shape or (1,))),
                           "dtype": dtype}
    if shape_name is not None:
        shp = INPUT_SHAPES[shape_name]
        if shp.name == "long_500k" and not cfg.sub_quadratic:
            return {**res, "status": "SKIP",
                    "reason": "full-attention architecture"}
        kind = shp.kind
        B = batch or shp.global_batch
        S = seq or shp.seq_len
    else:
        kind, B, S = "serve", batch or 1, serve[0]
    blocks = {} if "local" in cfg.layer_kinds() else BLOCKS
    kw = {"remat": True, **blocks, **(ctx_kw or {})}
    if mesh_shape is None:
        mesh, ctx = None, ShardCtx(**kw)
    else:
        mesh = fake_mesh(mesh_shape, rank)
        ctx = ShardCtx(mesh=mesh, data_axes=mesh_names(mesh_shape)[:-1],
                       model_axis="model", **kw)
    params = rank_params(cfg, ctx)
    res.update(kind=kind, batch=B, seq=S,
               params=sum(t.numel() for t in tu.leaves(params)),
               param_bytes=_nbytes(params), opt_bytes=0, cache_bytes=0)
    groups = op_count.mesh_groups(mesh)
    t0 = time.perf_counter()
    if kind == "train":
        opt = adamw(1e-4)
        state = opt.init(params)
        res["opt_bytes"] = _nbytes(state)
        rows = data_rows(B, ctx)
        b = _rows(SP.step_specs(cfg, kind, B, S), rows)
        step = make_train_step(cfg, opt, ctx=ctx, loss_chunk=loss_chunk)
        with op_count.count(groups) as counts:
            step(params, state, 0, b)
    elif kind == "prefill":
        sctx = batch_ctx(B, ctx)
        b = _rows(SP.step_specs(cfg, kind, B, S),
                  cache_rows(B, sctx))
        step = make_prefill_step(cfg, ctx=sctx, cache_len=S)
        with torch.inference_mode(), \
                op_count.count(groups) as counts:
            _, cache = step(params, b)
        res["cache_bytes"] = _nbytes(cache)
    elif kind == "decode":
        sctx = batch_ctx(B, ctx)
        rows = cache_rows(B, sctx)
        n = rows.stop - rows.start
        cache = T.init_cache(cfg, B, S, device=META, ctx=sctx)
        res["cache_bytes"] = _nbytes(cache)
        token = torch.empty((n, 1), dtype=torch.int32, device=META)
        step = make_decode_step(cfg, ctx=sctx, cache_len=S)
        with torch.inference_mode(), \
                op_count.count(groups) as counts:
            step(params, token, cache, S - 1)
    else:
        with torch.inference_mode(), \
                op_count.count(groups) as counts:
            cache = _serve(params, cfg, ctx, B, serve[0], serve[1])
        res["cache_bytes"] = _nbytes(cache)
    res["t_lower_s"] = time.perf_counter() - t0
    res["status"] = "OK"
    res["counts"] = counts.to_dict()
    res["activation_peak_bytes"] = counts.peak_bytes
    if mesh_shape is not None and shape_name is not None and published:
        res["roofline"] = RL.terms(cfg, shape_name, res["counts"],
                                   math.prod(mesh_shape))
    return res


def run_pair(arch: str, shape_name: Optional[str], **kw) -> Dict[str, Any]:
    """``count_pair`` with a failure as ``"status": "FAIL"`` and its
    error (a failure here is a fault of the port)."""
    try:
        return count_pair(arch, shape_name, **kw)
    except Exception as e:
        return {"arch": arch, "shape": shape_name or "serve",
                "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 (pod, data, model) mesh")
    ap.add_argument("--mesh", default="16x16",
                    help="DxM (data x model), e.g. 2x1, 2x2, 1x2, 1x4")
    ap.add_argument("--dtype", default="bfloat16",
                    help="the parameters' dtype (bfloat16, float32)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    mesh_shape = (2, 16, 16) if args.multi_pod else parse_mesh(args.mesh)
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
                 if not s.startswith("_")]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]
    results = []
    t0 = time.perf_counter()
    for a, s in pairs:
        r = run_pair(a, s, mesh_shape=mesh_shape, dtype=args.dtype)
        print(json.dumps(r, default=float))
        sys.stdout.flush()
        results.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=float)
    n_bad = sum(1 for r in results if r["status"] == "FAIL")
    print(f"# done: {len(results)} pairs, {n_bad} failures, "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
