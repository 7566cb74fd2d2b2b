"""Table 1 proxy on the PyTorch port: FedADP vs FlexiFed vs
Clustered-FL vs Standalone — ``benchmarks/table1.py`` run by
``repro_torch``.

The paper's Table 1 reports final accuracy on MNIST / F-MNIST / CIFAR-10
/ CIFAR-100; those are not downloadable here, so the 4-method protocol
runs on the synthetic proxies (``repro_torch.data.TABLE1_TASKS``) with
the paper's 8-architecture VGG cohort at reduced width, and checks the
paper's qualitative claim that FedADP beats the local baselines. The
engine is the unified one where it is eligible, the per-client loop
otherwise (``unified_eligible``).

Scaled-down default; FEDADP_BENCH_FULL=1 runs closer to the paper's
protocol (20 clients, more rounds). CSV rows to stdout:

  PYTHONPATH=src python benchmarks/table1_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.vgg_family import paper_client_archs, scaled, vgg
from repro_torch.core import VGGFamily
from repro_torch.data import (ClientSampler, TABLE1_TASKS,
                              image_classification, iid_partition)
from repro_torch.fl import (Federation, LoopBackend, UnifiedBackend,
                            make_strategy, unified_eligible)

METHODS = ("fedadp", "flexifed", "clustered", "standalone")


def cohort(n_clients: int):
    archs = paper_client_archs()
    if n_clients < len(archs):
        # keep the architecture mix: sample evenly
        idx = np.linspace(0, len(archs) - 1, n_clients).round().astype(int)
        archs = tuple(archs[i] for i in idx)
    return [scaled(vgg(a), 0.125, 64) for a in archs]


def run_task(task, *, n_clients: int, rounds: int, n_train: int,
             local_epochs: int, seed: int = 0, device=None
             ) -> Dict[str, Dict]:
    cfgs = cohort(n_clients)
    data = image_classification(task, n_train, seed=seed)
    test = image_classification(task, max(200, n_train // 5), seed=seed + 999)
    parts = iid_partition(n_train, len(cfgs), seed=seed)
    out: Dict[str, Dict] = {}
    family = VGGFamily()
    for method in METHODS:
        samplers = [ClientSampler(data, p, round_fraction=0.2, batch_size=64,
                                  seed=100 * seed + i)
                    for i, p in enumerate(parts)]
        strategy = make_strategy(method, family, cfgs,
                                 [s.n_samples for s in samplers],
                                 base_seed=seed, device=device)
        backend_cls = (UnifiedBackend if unified_eligible(
            strategy, family, cfgs, samplers) else LoopBackend)
        kw = {"seed": seed} if backend_cls is UnifiedBackend else {}
        backend = backend_cls(family, cfgs, samplers,
                              local_epochs=local_epochs, lr=0.03,
                              momentum=0.9, device=device, **kw)
        fed = Federation(strategy, backend, rounds=rounds, eval_batch=test,
                         eval_every=max(1, rounds // 6))
        res = fed.run(torch.Generator().manual_seed(seed))
        out[method] = {"final": res["final_acc"], "history": res["history"],
                       "wall_s": res["wall_s"], "engine": backend.name}
    return out


def main(csv: List[str], device=None):
    full = os.environ.get("FEDADP_BENCH_FULL") == "1"
    kw = (dict(n_clients=20, rounds=30, n_train=4000, local_epochs=2) if full
          else dict(n_clients=8, rounds=6, n_train=1200, local_epochs=1))
    tasks = TABLE1_TASKS if full else TABLE1_TASKS[:2]
    for task in tasks:
        t0 = time.time()
        res = run_task(task, device=device, **kw)
        dt = time.time() - t0
        accs = {m: res[m]["final"] for m in METHODS}
        order_ok = (accs["fedadp"] >= accs["clustered"]
                    and accs["fedadp"] >= accs["standalone"])
        for m in METHODS:
            csv.append(f"table1_torch/{task.name}/{m},"
                       f"{res[m]['wall_s'] * 1e6 / max(kw['rounds'], 1):.0f},"
                       f"acc={accs[m]:.4f},engine={res[m]['engine']}")
        csv.append(f"table1_torch/{task.name}/ordering,{dt * 1e6:.0f},"
                   f"fedadp_beats_locals={order_ok}")
    return csv


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    rows = main([], device=ap.parse_args().device)
    print("name,us_per_round,derived")
    print("\n".join(rows))
