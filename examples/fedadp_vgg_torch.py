"""The paper's experiment on the PyTorch port, end to end: 20 clients,
8 VGG architectures (6x VGG-19, 2x each of the others), 4 methods,
synthetic Table-1 proxy datasets — ``examples/fedadp_vgg.py`` with the
same options and defaults, run by ``repro_torch`` on the card (or on the
CPU with ``--device cpu``).

  PYTHONPATH=src python examples/fedadp_vgg_torch.py [--rounds 12]
      [--clients 20] [--task synth-easy|synth-medium|synth-hard|synth-hardest]
      [--narrow-mode paper|fold] [--filler zero|global]
      [--engine auto|loop|unified] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.vgg_family import paper_client_archs, scaled, vgg
from repro_torch.core import VGGFamily
from repro_torch.data import (ClientSampler, TABLE1_TASKS,
                              image_classification, iid_partition)
from repro_torch.fl import FLRunConfig, Simulator

TASKS = {t.name: t for t in TABLE1_TASKS}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--train", type=int, default=4000)
    ap.add_argument("--task", default="synth-easy", choices=sorted(TASKS))
    ap.add_argument("--methods", default="fedadp,flexifed,clustered,standalone")
    ap.add_argument("--narrow-mode", default="paper", choices=["paper", "fold"])
    ap.add_argument("--filler", default="zero", choices=["zero", "global"])
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "loop", "unified"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    archs = paper_client_archs()
    if args.clients < len(archs):
        idx = np.linspace(0, len(archs) - 1, args.clients).round().astype(int)
        archs = tuple(archs[i] for i in idx)
    cfgs = [scaled(vgg(a), 0.125, 64) for a in archs]
    task = TASKS[args.task]
    data = image_classification(task, args.train, seed=args.seed)
    test = image_classification(task, 800, seed=args.seed + 999)
    parts = iid_partition(args.train, len(cfgs), seed=args.seed)

    print(f"# task={task.name} clients={len(cfgs)} rounds={args.rounds}")
    results = {}
    for method in args.methods.split(","):
        samplers = [ClientSampler(data, p, round_fraction=0.2, batch_size=64,
                                  seed=args.seed * 100 + i)
                    for i, p in enumerate(parts)]
        rc = FLRunConfig(method=method, rounds=args.rounds, local_epochs=2,
                         lr=0.03, momentum=0.9, seed=args.seed,
                         narrow_mode=args.narrow_mode, filler=args.filler,
                         eval_every=max(1, args.rounds // 6),
                         engine=args.engine, device=args.device)
        res = Simulator(VGGFamily(), cfgs, samplers, rc, test).run(
            torch.Generator().manual_seed(args.seed))
        results[method] = res
        print(f"{method:11s} final={res['final_acc']:.4f} "
              f"history=" + "|".join(f"{a:.3f}" for a in res["history"])
              + f"  ({res['wall_s']:.0f}s)")
    if "fedadp" in results and "flexifed" in results:
        d = results["fedadp"]["final_acc"] - results["flexifed"]["final_acc"]
        print(f"# FedADP - FlexiFed = {d:+.4f} "
              f"(paper: positive, up to +0.233 on CIFAR-100)")
    return results


if __name__ == "__main__":
    main()
