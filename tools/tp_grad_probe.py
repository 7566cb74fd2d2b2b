#!/usr/bin/env python3
"""How far tensor parallelism's gradients sit from one process's, and
from float64, on the card.

    python3 tools/tp_grad_probe.py                    # glm4 and mixtral
    python3 tools/tp_grad_probe.py --model mixtral

The step is ``chip_smoke.py``'s ``tp_path`` step (``TP``): glm4-9b at 2
layers or mixtral-8x7b at 1 layer with 3 experts, its published widths,
2 × 2048 tokens, seed 0, one AdamW ``make_train_step`` step's gradients.
It computes them in one process in f32 (the flash kernels, TF32 off) and
in float64 (``attn_backend="blockwise"``; the norms and the router's
softmax still compute in f32), then on 2 gloo ranks of the card for
placements: every leaf cut by ``tp_slice`` ("full"); for mixtral also
the MoE stacks whole ("moe_whole": attention and vocabulary over the
ranks) and only the MoE stacks cut ("moe_only"). For each it prints
the six leaves farthest from each reference, as max |diff| over the
leaf's own max|g|: whether a difference from the single process is one
the single process's own f32 rounding (its distance to float64) also
makes. The card's name and power limit come first and last.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402

VARIANTS = {"glm4": ("full",),
            "mixtral": ("full", "moe_whole", "moe_only")}


def f64_grads(cfg, dev):
    from repro_torch import tree as tu
    from repro_torch.launch.steps import lm_loss
    from repro_torch.sharding import ShardCtx
    c64 = cfg.with_dtype("float64")
    params = tu.tree_map(lambda t: t.double(), C._tp_init(cfg, dev))
    batch = C._ep_batch(cfg, dev)
    ctx = ShardCtx(attn_backend="blockwise")
    return torch.func.grad(
        lambda p, b: lm_loss(p, c64, b, ctx=ctx)[0])(params, batch)


def leaf_errs(got: dict, want: dict) -> dict:
    return {k: (float((got[k].double() - want[k].double()).abs().max()),
                float(want[k].abs().max())) for k in want}


def worst(errs: dict, n: int = 6) -> str:
    rows = sorted(((e / max(s, 1e-30), k) for k, (e, s) in errs.items()),
                  reverse=True)[:n]
    return "; ".join(f"{k} {q:.2e}" for q, k in rows)


def probe_rank(rank, world, ref_dir, name):
    """One rank: the step under each placement, against the rank's slices
    of the single-process f32 and float64 gradients."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as tu
    from repro_torch.sharding import ShardCtx, tp_slice
    from repro_torch.sharding.rules import EXPERT_LEAF

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    spec = C.TP["models"][name]
    cfg = C._tp_cfg(spec, spec["grad_layers"])
    # the references stay on the host: on the card beside the step they
    # do not fit two ranks
    refs = {t: torch.load(os.path.join(ref_dir, f"{t}_{rank}.pt"),
                          mmap=True) for t in ("f32", "f64")}
    out = {}
    for variant in VARIANTS[name]:
        mine = None
        for r in range(world):
            if r == rank:
                full = C._tp_init(cfg, dev)
                part = tp_slice(full, ctx, cfg)
                if variant != "full":
                    keep_cut = variant == "moe_only"

                    def pick(path, t):
                        moe = bool(EXPERT_LEAF.search("/".join(path)))
                        return t if moe == keep_cut else tu.get(
                            full, path).clone()
                    part = tu.map_with_path(pick, part)
                mine = part
                del full, part
                C.free_device()
            dist.barrier()
        batch = C._ep_batch(cfg, dev)
        loss, g = C._ep_step(cfg, mine, batch, ctx)
        g = {"/".join(p): t.cpu() for p, t in tu.flatten(g)}
        out[variant] = {"loss": loss}
        for t, ref in refs.items():
            # a leaf held whole here but cut in the reference slices (or
            # the other way round) is left out
            same = {k: v for k, v in ref.items() if v.shape == g[k].shape}
            out[variant][t] = leaf_errs(g, same)
        del mine, g, batch
        C.free_device()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=tuple(VARIANTS), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_grad_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import tree as tu
    from repro_torch.device import strict_f32
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.sharding import ShardCtx
    from repro_torch.sharding.rules import tp_slice_rank

    print(C.card_line())
    dev = torch.device("cuda", 0)
    strict_f32(dev)
    C.build_kernels()
    for name in ([args.model] if args.model else list(VARIANTS)):
        d = C.rank_dir(f"tp_probe_{name}")
        spec = C.TP["models"][name]
        cfg = C._tp_cfg(spec, spec["grad_layers"])
        params = C._tp_init(cfg, dev)
        loss, g32 = C._ep_step(cfg, params, C._ep_batch(cfg, dev),
                               ShardCtx())
        del params
        C.free_device()
        g64 = f64_grads(cfg, dev)
        flat = {t: {"/".join(k): v for k, v in tu.flatten(g)}
                for t, g in (("f32", g32), ("f64", g64))}
        print(f"{name}: one process, f32 vs float64: "
              f"{worst(leaf_errs(flat['f32'], flat['f64']))}")
        for r in range(2):
            for t, g in (("f32", g32), ("f64", g64)):
                part = tp_slice_rank(g, cfg, 2, r)
                torch.save({"/".join(k): v.cpu() for k, v in
                            tu.flatten(part)},
                           os.path.join(d, f"{t}_{r}.pt"))
                del part
        del g32, g64, flat
        C.free_device()
        outs = run_ranks(probe_rank, 2, (d, name), rdv_dir=d,
                         backend="gloo", device_type="cuda", timeout_s=300,
                         wall_s=900)
        for o in outs:
            for variant, r in o.items():
                for t in ("f32", "f64"):
                    print(f"{name} {variant} rank {outs.index(o)} vs one "
                          f"process {'f32' if t == 'f32' else 'float64'}: "
                          f"{worst(r[t])}")
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
