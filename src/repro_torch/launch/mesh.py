"""Meshes over the initialised process group, and a launcher of ranks
(functions, so importing never touches device or process state).

``make_host_mesh`` is the reference's smoke-scale mesh: every rank of the
process group on a ``(data, model)`` = ``(n, 1)`` ``DeviceMesh``; a
``ShardCtx(mesh=, data_axes=("data",), model_axis="model")`` over it
runs FSDP over the n ranks (``sharding/ctx.py``: the batch split, the
parameters gathered a unit at a time, the gradients reduce-scattered).
Tensor and expert parallelism take ``(1, m)``, and both together
``(d, m)`` (``init_device_mesh(device_type, (d, m),
mesh_dim_names=("data", "model"))``). The reference's
``make_production_mesh`` describes TPU pods and is not ported
(ROADMAP.md). ``run_ranks`` spawns the ranks of one process group
on this host (the multi-rank tests on the CPU, the mesh phases of
``chip_smoke.py`` on one card); ``torchrun`` does the same for scripts.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in (mesh.mesh_dim_names or ())
                 if a in ("pod", "data"))


def make_host_mesh(device_type: Optional[str] = None):
    """Every rank of the initialised process group (world size 1 without
    one: then no process group is made and None is returned) as a
    ``(data, model)`` = ``(n, 1)`` mesh. Every rank must call it (it
    makes the mesh's process groups). ``device_type`` defaults to "cuda"
    when a card is present, else "cpu"."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def _rank_main(rank, fn, world, args, backend, rdv, timeout_s, device_type,
               threads):
    """One spawned rank: join the process group, run ``fn``, save its
    result for the parent, leave the group."""
    if threads:
        torch.set_num_threads(threads)
    if device_type == "cuda":
        # ranks share the cards round-robin (all on card 0 when there is
        # one): the device must be set before any mesh exists
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(rdv, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *, rdv_dir: str,
              backend: str = "gloo", device_type: str = "cpu",
              timeout_s: float = 60.0, wall_s: float = 300.0,
              threads: int = 0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    process group and return the ranks' results in rank order.

    ``fn`` must be importable by name (a module-level function): each
    rank starts from a fresh interpreter. The ranks meet through a file
    in ``rdv_dir`` (which must be empty of an earlier run's files, so two
    runs never share a rendezvous) and hand their results back through
    ``torch.save`` files there. ``timeout_s`` bounds every collective;
    ``wall_s`` bounds the whole run: past it every rank is killed and
    ``TimeoutError`` raised. A rank that raises ends the others and the
    error is raised here. ``device_type="cuda"`` puts rank r on card
    ``r % device_count()``; ``backend`` is the caller's choice (gloo
    when ranks share a card: NCCL takes one card per rank).
    ``threads`` > 0 sets each rank's intra-op threads."""
    os.makedirs(rdv_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, args, backend, rdv_dir, timeout_s,
                          device_type, threads),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + wall_s
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline
                                                - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"run_ranks: {world} ranks of "
                                   f"{fn.__name__} ran past {wall_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(rdv_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
