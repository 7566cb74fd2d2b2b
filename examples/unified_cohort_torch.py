"""Cohort-parallel FedADP on the PyTorch port: the unified backend vs
the per-client loop — ``examples/unified_cohort.py`` run by
``repro_torch``.

A depth+width-heterogeneous VGG cohort is trained twice with identical
data, initial model and SGD+momentum through the same ``Federation`` +
``FedADPStrategy``, swapping only the execution backend: once through
the per-client ``LoopBackend`` (each client in its own architecture),
once as one stacked program on the packed plane (``UnifiedBackend``
around ``fl/engine.py``). The two accuracy histories should agree, and
the global models to float tolerance.

  PYTHONPATH=src python examples/unified_cohort_torch.py [--device cpu]

Under ``torchrun`` the unified backend splits the cohort over the ranks
(``sharding.cohort_mesh``: each rank trains its clients, one
``all_reduce`` of the partial aggregates per round); the loop backend
ignores the mesh. The example makes the process group: NCCL when every
rank has a card of its own, gloo otherwise (ranks sharing a card, or the
CPU):

  PYTHONPATH=src torchrun --nproc-per-node 4 examples/unified_cohort_torch.py --device cpu

``--method`` runs a baseline instead of FedADP (clustered, flexifed,
standalone: the per-client state, its cluster and prefix averages summed
over the ranks under a mesh) and ``--wire`` compresses the unified
run's payloads (bf16, int8: the loop has no wire, so only the unified
backend runs, and its wire bytes are printed); both reach the mesh:

  PYTHONPATH=src torchrun --nproc-per-node 4 examples/unified_cohort_torch.py \
      --device cpu --method clustered
  PYTHONPATH=src torchrun --nproc-per-node 4 examples/unified_cohort_torch.py \
      --device cpu --wire int8
"""
import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.configs.vgg_family import scaled, vgg
from repro_torch.core import VGGFamily
from repro_torch.data import (EASY, ClientSampler, image_classification,
                              iid_partition)
from repro_torch.fl import Federation, LoopBackend, UnifiedBackend
from repro_torch.fl.strategy import make_strategy
from repro_torch.sharding import cohort_mesh


def init_ranks(device) -> None:
    """Join torchrun's process group (no-op in one process)."""
    if "RANK" not in os.environ or dist.is_initialized():
        return
    world = int(os.environ["WORLD_SIZE"])
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    own_cards = on_card and torch.cuda.device_count() >= world
    dist.init_process_group("nccl" if own_cards else "gloo")


def main(*, rounds=4, local_epochs=1, eval_every=2, width=64,
         archs=("vgg13", "vgg16-wider", "vgg17", "vgg19-wider"),
         per_arch=2, n_per_client=160, n_test=400, method="fedadp",
         wire="f32", device=None):
    family = VGGFamily()
    client_cfgs = [scaled(vgg(a), 0.125, width)
                   for a in archs for _ in range(per_arch)]
    K = len(client_cfgs)
    data = image_classification(EASY, n_per_client * K, seed=0)
    test = image_classification(EASY, n_test, seed=99)
    parts = iid_partition(n_per_client * K, K, seed=0)
    init_ranks(device)
    on_card = device is None or torch.device(device).type == "cuda"
    mesh = cohort_mesh(K, device_type="cuda" if on_card else "cpu")
    print(f"{K} clients, client mesh: {mesh}")      # None in one process

    results = {}
    engines = ("loop", "unified") if wire == "f32" else ("unified",)
    for engine in engines:
        samplers = [ClientSampler(data, p, round_fraction=0.5, batch_size=32,
                                  seed=i) for i, p in enumerate(parts)]
        strategy = make_strategy(method, family, client_cfgs,
                                 [s.n_samples for s in samplers], wire=wire,
                                 device=device)
        backend_cls = UnifiedBackend if engine == "unified" else LoopBackend
        mesh_kw = {"mesh": mesh} if engine == "unified" else {}
        backend = backend_cls(family, client_cfgs, samplers,
                              local_epochs=local_epochs, lr=0.05,
                              momentum=0.9, device=device, **mesh_kw)
        fed = Federation(strategy, backend, rounds=rounds, eval_batch=test,
                         eval_every=eval_every)
        res = fed.run(torch.Generator().manual_seed(0))
        print(f"{engine:8s} acc by round: "
              + "  ".join(f"{a:.3f}" for a in res["history"])
              + f"   wall {res['wall_s']:.1f}s")
        if wire != "f32":
            print(f"{wire} wire: {backend.wire_stats()['bytes_per_round']}"
                  f" bytes a round")
        results[engine] = res
    if len(results) == 2 and method == "fedadp":
        diff = max(float((a - b).abs().max()) for a, b in zip(
            tu.leaves(results["loop"]["global_params"]),
            tu.leaves(results["unified"]["global_params"])))
        print(f"loop vs unified global params: max |diff| = {diff:.3e}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    ap.add_argument("--method", default="fedadp",
                    choices=("fedadp", "clustered", "flexifed", "standalone"))
    ap.add_argument("--wire", default="f32", choices=("f32", "bf16", "int8"))
    args = ap.parse_args()
    main(method=args.method, wire=args.wire, device=args.device)
