"""Training launcher: language-model training of a transformer config
with AdamW and a cosine schedule (the JAX package's ``launch/train.py``),
on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
      --reduced --device cpu --steps 5 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
      --n-layers 2 --steps 10 --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch deepseek-v2-236b --n-layers 1 --n-experts 16 --steps 5 \
      --batch 1 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \
      --steps 10 --batch 4 --seq 448

Random weights from ``--seed`` (a ``torch.Generator``: not JAX's numbers,
so parity tests carry parameters across through numpy and pass them as
``params``), batches from ``LMPipeline`` (byte-identical to the
reference's). ``--n-layers`` cuts the depth at the published widths (the
way to fit a large config's f32 weights and optimizer state on one
card), ``--n-experts`` a MoE config's routed experts (top-k and the
shared experts kept); ``--reduced`` shrinks the widths as the
reference's does.
``--attn`` picks the attention backend: "auto" (the flash kernels on the
card, ``blockwise_attention`` on the CPU) or "blockwise". A config with
a front end trains on stub ``aux`` embeddings (``modality_aux``): (B,
n_prefix, D) patch embeddings ahead of each sequence for the vision
front end (the loss skips their rows), (B, n_ctx, D) frames for the
whisper encoder; ``--aux zeros`` (the default) as the reference's
trainer, ``--aux normal`` drawn N(0, 1) from the seed. Zero embeddings
stay exact zero rows through every layer, and an RMSNorm's Jacobian at
a zero row is 1/sqrt(eps) = 1000: at internvl2-1b's depth the gradient
through the prefix overflows f32 in the first step, in the reference as
here (ROADMAP.md, the JAX package's known faults).

``run(..., ctx=)`` trains under a ``ShardCtx`` with a model axis and
data axes (every rank of the mesh calls ``run``): each rank draws the
whole model (or takes the whole ``params``) and keeps its part
(``sharding.rules.tp_slice``: its model part, and under data axes of
d > 1 ranks (FSDP) its data part of that). Every rank reads the same
batches; under data axes it trains on its contiguous ``batch / d`` rows
of each (and of ``modality_aux``), the model gathers each unit's leaves
over the data axes as it runs and sums their gradients back to the
rank's part, and the optimizer updates the parts as they are (AdamW is
elementwise). Every rank reports the whole batch's loss. ``ckpt`` there
gathers the whole tree (``sharding.rules.tp_gather``) and the mesh's
first rank writes it, with the one-process run's tree and shapes; every
rank waits for the write. The same code runs on gloo ranks of the CPU
and on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config, reduced
from repro_torch.data import LMPipeline
from repro_torch.device import DeviceLike, resolve_device, strict_f32
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.sharding.collectives import dp_active, tp_active
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.sharding.rules import data_rows, tp_gather, tp_slice


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


AUX_KINDS = ("zeros", "normal")


def modality_aux(cfg, batch: int, kind: str = "zeros", *, seed: int = 0,
                 device=None) -> Optional[torch.Tensor]:
    """The trainer's stub front-end embeddings for ``cfg`` (None without a
    front end): zeros, or N(0, 1) from a generator seeded ``seed + 1`` on
    ``device``; the same for every step."""
    if kind not in AUX_KINDS:
        raise ValueError(f"aux={kind!r}, expected one of {AUX_KINDS}")
    shape = T.aux_shape(cfg, batch)
    if shape is None:
        return None
    dt = T._param_dtype(cfg)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randn(shape, generator=g, device=device, dtype=dt)


def run(arch: str, *, use_reduced: bool = True, steps: int = 100,
        batch: int = 8, seq: int = 128, lr: float = 3e-4,
        log_every: int = 10, ckpt: Optional[str] = None, seed: int = 0,
        d_model: int = 256, n_units: int = 1, device: DeviceLike = None,
        n_layers: Optional[int] = None, n_experts: Optional[int] = None,
        attn: str = "auto", params=None, aux: str = "zeros",
        ctx: Optional[ShardCtx] = None) -> dict:
    """Train ``steps`` AdamW steps (cosine schedule, ``steps // 10``
    warm-up steps) on ``LMPipeline(vocab, batch, seq, seed)``, with
    ``modality_aux(cfg, batch, aux, seed=seed)`` for a front end.
    ``params`` (a tree of tensors in ``init_params``'s layout) replaces
    the random init. Returns ``losses`` (floats), ``params``, ``cfg`` and
    ``ms_per_step`` (the steps after the first). Under ``ctx``'s mesh
    (module docstring) ``params`` is the rank's part; data axes must
    split ``batch`` evenly (``sharding.rules.data_rows`` raises
    ``ValueError`` otherwise: the reference's train shapes all divide;
    only serving takes a batch they do not split)."""
    dev = resolve_device(device)
    strict_f32(dev)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg, d_model=d_model, n_units=n_units)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_experts,
            top_k=min(cfg.moe.top_k, n_experts)))
    cfg.validate()
    ctx = dataclasses.replace(ctx or ShardCtx(), attn_backend=attn)
    if params is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        params = T.init_params(g, cfg, device=dev)
    else:
        params = tu.tree_map(
            lambda x: (x.to(dev) if isinstance(x, torch.Tensor)
                       else torch.as_tensor(np.array(x), device=dev)),
            params)
    rows = data_rows(batch, ctx)
    params = tp_slice(params, ctx, cfg)
    n_params = sum(int(p.numel()) for p in tu.leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params/1e6:.1f}M"
          f" device={dev}")

    opt = adamw(cosine_with_warmup(lr, steps // 10, steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, ctx=ctx)
    pipe = LMPipeline(cfg.vocab_size, batch, seq, seed=seed)
    emb = modality_aux(cfg, batch, aux, seed=seed, device=dev)
    if emb is not None:
        emb = emb[rows]

    losses = []
    t0 = t1 = time.perf_counter()
    for step, host_batch in zip(range(steps), pipe):
        b = {k: torch.as_tensor(v[rows], device=dev)
             for k, v in host_batch.items()}
        if emb is not None:
            b["aux"] = emb
        params, opt_state, metrics = step_fn(params, opt_state, step, b)
        losses.append(float(metrics["loss"]))
        if step == 0:
            _sync(dev)
            t1 = time.perf_counter()
        if (step + 1) % log_every == 0:
            dt = (time.perf_counter() - t0) / (step + 1)
            print(f"step {step+1:5d} loss {losses[-1]:.4f} "
                  f"({dt*1e3:.0f} ms/step)")
    _sync(dev)
    ms = ((time.perf_counter() - t1) / (steps - 1) * 1e3 if steps > 1
          else float("nan"))
    if ckpt:
        cut = tp_active(ctx) or dp_active(ctx)
        whole = (tp_gather(params, ctx, cfg,
                           T.init_params(None, cfg, device="meta"))
                 if cut else params)
        if not cut or dist.get_rank() == int(ctx.mesh.mesh.flatten()[0]):
            save_pytree(ckpt, whole, extra={"arch": cfg.name,
                                            "steps": steps})
            print(f"saved {ckpt}")
        del whole
        if cut:
            for a in ctx.mesh.mesh_dim_names:
                dist.barrier(group=ctx.mesh.get_group(a))
    return {"losses": losses, "params": params, "cfg": cfg,
            "ms_per_step": ms}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--n-experts", type=int, default=None,
                    help="cut a MoE config's routed experts to this many")
    ap.add_argument("--attn", default="auto", choices=("auto", "blockwise"),
                    help="attention backend")
    ap.add_argument("--aux", default="zeros", choices=AUX_KINDS,
                    help="a front end's stub embeddings")
    args = ap.parse_args()
    res = run(args.arch, use_reduced=args.reduced, steps=args.steps,
              batch=args.batch, seq=args.seq, lr=args.lr, ckpt=args.ckpt,
              seed=args.seed, d_model=args.d_model, device=args.device,
              n_layers=args.n_layers, n_experts=args.n_experts,
              attn=args.attn, aux=args.aux)
    l0 = np.mean(res["losses"][:10])
    l1 = np.mean(res["losses"][-10:])
    print(f"loss {l0:.3f} -> {l1:.3f} ({'improved' if l1 < l0 else 'FLAT'})")


if __name__ == "__main__":
    main()
