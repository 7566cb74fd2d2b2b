"""Rank bodies of ``test_torch_mesh_methods.py``: the per-client methods,
the compressed wires and checkpoints on a client mesh, and a checkpoint
and remat "dots" on a model axis. Spawned through
``repro_torch.launch.mesh.run_ranks``; imports torch and ``repro_torch``
only (no JAX), and holds no tests. Every run returns plain numpy /
Python values for the parent to hold against the single-process port and
the JAX package.
"""
import dataclasses
import os

import numpy as np
import torch

import test_torch_mesh_ranks as MR
from repro_torch import tree as tu
from repro_torch.data import ClientSampler
from repro_torch.fl import Federation, FLRunConfig, Simulator
from repro_torch.sharding import cohort_mesh, tp_slice

PER_CLIENT = tuple((cohort, method, part)
                   for cohort in ("depth4", "width4")
                   for method in ("clustered", "flexifed", "standalone")
                   for part in (1.0, 0.5))
# (wire, participation, sparse): sparse int8 rides agg_mode="coverage"
WIRES = (("int8", 0.5, False), ("bf16", 1.0, False), ("int8", 1.0, True))
CKPT_WIRE = ("int8", 0.5, False)
ROUNDS = 2


def run_cfg(method, part, *, wire="f32", sparse=False, rounds=ROUNDS):
    """The per-client and wire runs' config: the mesh test's protocol
    (``test_torch_mesh_ranks.run_cfg``) at ``participation`` ``part``."""
    return FLRunConfig(
        method=method, rounds=rounds, local_epochs=1, lr=0.05, momentum=0.9,
        engine="unified", participation=part, participation_seed=10,
        agg_mode="coverage" if sparse else "filler", wire=wire,
        wire_sparse=sparse, device="cpu")


def samplers(K):
    data, test, parts = MR.vgg_data(K)
    return [ClientSampler(data, p, round_fraction=0.5, batch_size=8, seed=i)
            for i, p in enumerate(parts)], test


def _tree_np(tree):
    return {"/".join(p): v.detach().numpy().copy()
            for p, v in tu.flatten(tree)}


def _state(out, method):
    """A run's end state: the globals (fedadp), or every client's row of
    the per-client state, stacked (path -> (K, ...))."""
    if method == "fedadp":
        return _tree_np(out["global_params"])
    return {k: np.stack([c[k] for c in map(_tree_np, out["client_params"])])
            for k in _tree_np(out["client_params"][0])}


def _engine(sim):
    return next(b for k, b in sim._backends.items()
                if k[0] == "unified").engine


def pc_run(mesh, cohort, method, part):
    """A per-client method through ``Simulator``: history, end state and
    the engine's collectives."""
    cfgs = list(MR.COHORTS[cohort])
    ss, test = samplers(len(cfgs))
    sim = Simulator(MR.SeededVGG(), cfgs, ss, run_cfg(method, part), test,
                    mesh=mesh)
    out = sim.run()
    return {"history": [float(a) for a in out["history"]],
            "state": _state(out, method),
            "comm": _engine(sim).comm_stats()}


def wire_run(mesh, wire, part, sparse):
    """fedadp on a compressed wire: history, globals, the cohort's wire
    accounting and the whole residual plane (a collective on a mesh)."""
    cfgs = list(MR.DEPTH4)
    ss, test = samplers(4)
    sim = Simulator(MR.SeededVGG(), cfgs, ss,
                    run_cfg("fedadp", part, wire=wire, sparse=sparse), test,
                    mesh=mesh)
    out = sim.run()
    eng = _engine(sim)
    return {"history": [float(a) for a in out["history"]],
            "state": _state(out, "fedadp"),
            "wire_stats": eng.wire_stats(),
            "residuals": eng.wire_residuals().numpy().copy(),
            "comm": eng.comm_stats()}


def ckpt_federation(mesh, rounds, **kw):
    """The checkpoint case's Federation (``CKPT_WIRE`` fedadp on the
    depth cohort), built as ``Simulator`` builds it."""
    wire, part, sparse = CKPT_WIRE
    cfgs = list(MR.DEPTH4)
    ss, test = samplers(4)
    sim = Simulator(MR.SeededVGG(), cfgs, ss,
                    run_cfg("fedadp", part, wire=wire, sparse=sparse,
                            rounds=rounds), test, mesh=mesh)
    fed = sim._build()
    return Federation(fed.strategy, fed.backend, rounds=rounds,
                      eval_batch=test, participation=fed.participation,
                      **kw)


def ckpt_run(mesh, ckdir):
    """A mesh run that checkpoints every round, and a run resumed from
    its round-1 file, on the mesh."""
    fed = ckpt_federation(mesh, ROUNDS, checkpoint_dir=ckdir,
                          checkpoint_every=1)
    full = fed.run(torch.Generator().manual_seed(0))
    files = sorted(os.listdir(ckdir))
    resumed = ckpt_federation(mesh, ROUNDS).run(
        torch.Generator().manual_seed(0),
        resume_from=os.path.join(ckdir, "round_0001.npz"))
    return {"files": files,
            "full": {"history": [float(a) for a in full["history"]],
                     "state": _state(full, "fedadp")},
            "resumed": {"history": [float(a) for a in resumed["history"]],
                        "state": _state(resumed, "fedadp")}}


# ------------------------------------------------------- the model axis
TP_CASE = "glm4"
TP_TRAIN = dict(arch="glm4-9b", steps=2, batch=2, seq=16, d_model=64,
                device="cpu", log_every=100)


def tp_run(rank, world, ckpt):
    """``launch.train.run`` on a (data=1, model=world) mesh writing
    ``ckpt``, and the remat "dots" gradients beside "full" and plain."""
    from repro_torch.launch import train
    ctx = MR.tp_ctx(world)
    t = train.run(**TP_TRAIN, ctx=ctx, ckpt=ckpt)
    cfg = MR.tp_cfg(TP_CASE)
    mine = tp_slice(MR.tp_params(cfg), ctx, cfg)
    batch = MR.tp_batch(cfg)
    grads = {}
    for pol in ("plain", "full", "dots"):
        c = (ctx if pol == "plain"
             else dataclasses.replace(ctx, remat=True, remat_policy=pol))
        grads[pol] = MR.sgd_grads(mine, cfg, batch, c)
    return {"model_rank": ctx.model_rank, "losses": t["losses"],
            "params": _tree_np(t["params"]), "grads": grads}


def mesh_methods(rank, world, ckdir):
    """Every scenario on ``world`` (= 2) ranks."""
    mesh = cohort_mesh(4, device_type="cpu")
    res = {"rank": rank, "mesh": mesh.mesh.tolist()}
    res["per_client"] = {v: pc_run(mesh, *v) for v in PER_CLIENT}
    res["wires"] = {v: wire_run(mesh, *v) for v in WIRES}
    res["ckpt"] = ckpt_run(mesh, os.path.join(ckdir, "client_mesh"))
    res["tp"] = tp_run(rank, world, os.path.join(ckdir, "tp.npz"))
    return res
