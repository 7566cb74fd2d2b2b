"""Rank bodies of the port's multi-rank tests, spawned through
``repro_torch.launch.mesh.run_ranks`` by ``test_torch_mesh.py``,
``test_torch_expert_parallel.py`` and ``test_torch_tp.py``. This module imports torch and
``repro_torch`` only, so a rank starts without JAX; it holds no tests.
Each body returns plain numpy / Python values for the parent to hold
against the single-process port and the JAX package.
"""
import dataclasses
import os

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import tree as tu
from repro_torch.configs import get_config, reduced
from repro_torch.configs.vgg_family import VGGConfig
from repro_torch.core import VGGFamily
from repro_torch.data import (EASY, ClientSampler, image_classification,
                              iid_partition)
from repro_torch.fl import Federation, FLRunConfig, Simulator
from repro_torch.launch.mesh import data_axes, make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import sgd
from repro_torch.sharding import (CohortCtx, ShardCtx, cohort_mesh,
                                  expert_slice, stacked_client_spec,
                                  tp_slice)
from repro_torch.models.registry import arch_ids
from repro_torch.sharding.rules import (batch_ctx, cache_slot_cut, data_rows,
                                        tp_gather)

K_RULES = (3, 4, 6, 20)


def tiny(name, stages):
    return VGGConfig(name=name, stages=stages, classifier=(16,),
                     n_classes=4, image_size=8)


# the reference's mesh test cohort (tests/test_streaming.py): depth only
DEPTH4 = (tiny("t2", ((8,), (8,))), tiny("t3", ((8,), (8, 8))),
          tiny("t4", ((8, 8), (8, 8))), tiny("t2b", ((8,), (8,))))
# widths too (NetChange's To-Wider at round start, multiplicity)
_W = (tiny("w1", ((8,), (8,))), tiny("w2", ((8,), (12, 8))),
      tiny("w3", ((12, 8), (12, 8))))
WIDTH4 = tuple(_W[k % 3] for k in range(4))
DEPTH6 = DEPTH4 + DEPTH4[:2]
COHORTS = {"depth4": DEPTH4, "width4": WIDTH4, "depth6": DEPTH6}

# (cohort, agg_mode, filler, agg_layout) of the mesh round runs
VARIANTS = tuple(
    ("depth4", mode, filler, layout)
    for layout in ("plane", "stream")
    for mode, filler in (("coverage", "zero"), ("filler", "zero"),
                         ("filler", "global"))) + (
    ("width4", "coverage", "zero", "plane"),)

# six clients, one round: rows that do not split over four ranks
K6 = ("depth6", "coverage", "zero", "plane", 1)

MOE_ARCH = "mixtral-8x7b"


def numpy_init(shapes, seed=4):
    """Leaves drawn from one numpy stream in flatten (sorted-key) order —
    the JAX tree's order too, so both packages start from one model."""
    rng = np.random.default_rng(seed)
    out = []
    for _, s in tu.flatten(shapes):
        shape = tuple(s.shape)
        scale = np.sqrt(2.0 / np.prod(shape[:-1])) if len(shape) > 1 else 0.1
        out.append((rng.standard_normal(shape) * scale).astype(np.float32))
    return out


class SeededVGG(VGGFamily):
    """VGG whose every init is ``numpy_init`` (the generator unused)."""

    def init(self, generator, cfg, *, device=None):
        if str(device) == "meta":
            return super().init(generator, cfg, device=device)
        shapes = self.shapes(cfg)
        return tu.unflatten([p for p, _ in tu.flatten(shapes)],
                            [torch.from_numpy(a).to(device)
                             for a in numpy_init(shapes)])


def vgg_data(K):
    spec = dataclasses.replace(EASY, image_size=8, n_classes=4)
    data = image_classification(spec, 16 * K, seed=0)
    test = image_classification(spec, 32, seed=9)
    return data, test, iid_partition(16 * K, K, seed=0)


def run_cfg(mode, filler, layout, rounds=2):
    return FLRunConfig(method="fedadp", rounds=rounds, local_epochs=1, lr=0.05,
                       momentum=0.9, engine="unified", agg_mode=mode,
                       filler=filler, agg_layout=layout,
                       k_chunk=1 if layout == "stream" else None,
                       device="cpu")


def vgg_round(mesh, cohort, mode, filler, layout, rounds=2):
    """``rounds`` fedadp rounds of a tiny VGG cohort through
    ``Simulator``: history, globals (path -> array) and the engine's
    ``agg_stats``."""
    cfgs = list(COHORTS[cohort])
    data, test, parts = vgg_data(len(cfgs))
    samplers = [ClientSampler(data, p, round_fraction=0.5, batch_size=8,
                              seed=i) for i, p in enumerate(parts)]
    sim = Simulator(SeededVGG(), cfgs, samplers,
                    run_cfg(mode, filler, layout, rounds), test, mesh=mesh)
    out = sim.run()
    eng = next(b for k, b in sim._backends.items()
               if k[0] == "unified").engine
    return {"history": [float(a) for a in out["history"]],
            "globals": {"/".join(p): v.detach().numpy().copy()
                        for p, v in tu.flatten(out["global_params"])},
            "stats": eng.agg_stats()}


def once_refused(mesh, ckdir):
    """What the client mesh refused before it was ported, one round each
    through ``Simulator`` / ``Federation`` on the depth cohort: a
    per-client method, a compressed wire, and a checkpoint (the files it
    wrote). The histories and the wire's cohort payload."""
    cfgs = list(DEPTH4)
    data, test, parts = vgg_data(4)

    def sim(**kw):
        ss = [ClientSampler(data, p, round_fraction=0.5, batch_size=8,
                            seed=i) for i, p in enumerate(parts)]
        cfg = dataclasses.replace(run_cfg("filler", "zero", "auto", 1),
                                  **kw)
        return Simulator(SeededVGG(), cfgs, ss, cfg, test, mesh=mesh)
    out = {"clustered": sim(method="clustered").run()["history"]}
    w = sim(wire="int8")
    out["wire"] = (w.run()["history"], next(
        b for k, b in w._backends.items()
        if k[0] == "unified").engine.wire_stats()["bytes_per_round"])
    fed = sim()._build()
    Federation(fed.strategy, fed.backend, rounds=1, eval_batch=test,
               checkpoint_dir=ckdir, checkpoint_every=1).run()
    out["checkpoint"] = sorted(os.listdir(ckdir))
    return out


def mesh_rounds(rank, world, ckdir):
    """The client-mesh scenarios on ``world`` (= 4) ranks; checkpoints go
    to ``ckdir``."""
    res = {"rank": rank}
    # the rules: cohort_mesh at this world size, and the row placement of
    # meshes of 1..world ranks (ranks outside a mesh record nothing)
    res["cohort_mesh"] = {}
    for K in K_RULES:
        m = cohort_mesh(K, device_type="cpu")
        res["cohort_mesh"][K] = None if m is None else m.mesh.tolist()
    res["placement"] = {}
    for n in range(1, world + 1):
        m = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("clients",))
        if m.get_coordinate() is None:
            continue
        ctx = CohortCtx(mesh=m)
        for K in K_RULES:
            rows = ctx.local_rows(K)
            res["placement"][(n, K)] = {
                "extent": ctx.edge_extent,
                "groups": ctx.edge_groups(range(K)),
                "spec": stacked_client_spec(m, ("clients",), K),
                "rows": None if rows is None else (rows.start, rows.stop)}
    host = make_host_mesh("cpu")
    res["host_mesh"] = (tuple(host.shape), host.mesh_dim_names,
                        data_axes(host))
    mesh = cohort_mesh(4, device_type="cpu")
    res["runs"] = {v: vgg_round(mesh, *v) for v in VARIANTS}
    # six clients over a four-rank mesh do not split: the flat round on
    # every rank; cohort_mesh(6) takes three ranks and leaves rank 3 out
    mesh4 = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("clients",))
    res["k6_mesh4"] = vgg_round(mesh4, *K6)
    m6 = cohort_mesh(6, device_type="cpu")
    res["k6_cohort"] = vgg_round(m6, *K6)
    res["k6_cohort"]["mesh"] = None if m6 is None else m6.mesh.tolist()
    # what the mesh refused before it was ported now runs
    res["once_refused"] = once_refused(mesh, ckdir)
    return res


def moe_cfg():
    cfg = reduced(get_config(MOE_ARCH), n_units=2, d_model=32)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=4, top_k=2))


def moe_inputs(cfg):
    """The parameters (seed 0) and a token batch (seed 1) both sides
    use."""
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12),
                                         dtype=np.int64))
    x = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)
                                             ).astype(np.float32))
    return params, {"tokens": toks, "labels": toks}, x


def sgd_grads(params, cfg, batch, ctx):
    """One ``make_train_step`` step under SGD(lr=1): the loss and the
    gradients, read back as ``p - p'``. The step updates a copy of
    ``params`` (the optimizer writes in place)."""
    before = params
    params = tu.tree_map(lambda t: t.clone(), params)
    step = make_train_step(cfg, sgd(1.0), ctx=ctx)
    after, _, m = step(params, sgd(1.0).init(params), 0, batch)
    return float(m["loss"]), {
        "/".join(p): (b - a).numpy().copy() for (p, b), (_, a) in
        zip(tu.flatten(before), tu.flatten(after))}


def expert_parallel(rank, world):
    """The MoE block and a training step with the experts split over a
    (data=1, model=world) mesh."""
    cfg = moe_cfg()
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    params, batch, x = moe_inputs(cfg)
    mine = expert_slice(params, ctx, cfg.moe.n_experts)
    layer0 = tu.tree_map(lambda t: t[0], mine["units"]["b0"]["moe"])
    with torch.no_grad():
        y = M.moe_apply(layer0, cfg, x, ctx).numpy().copy()
        y_a2a = M.moe_apply(layer0, cfg, x, dataclasses.replace(
            ctx, moe_all_to_all=True)).numpy().copy()
        logits = T.forward(mine, cfg, batch["tokens"], ctx=ctx).numpy()
    loss, grads = sgd_grads(mine, cfg, batch, ctx)
    return {"rank": ctx.model_rank, "moe": y, "moe_a2a": y_a2a,
            "logits": logits, "loss": loss, "grads": grads,
            "expert_rows": int(layer0["wg"].shape[0])}


# ------------------------------------------------ tensor parallelism
# reduced configs (d_model 64, 2 layers) of the tensor-parallel tests
# (test_torch_tp.py), by name: (arch, replacements)
TP_CASES = {
    "glm4": ("glm4-9b", {}),                          # H 4 on KV 2, QKV bias
    "gemma": ("gemma-7b", {}),                        # geglu, tied, scale
    "replicate": ("glm4-9b", {"n_heads": 6, "n_kv_heads": 2,
                              "head_dim": 16}),
    # "expand" with a kv head split between ranks' query heads: rank 0
    # reads kv heads 0, 0, 1, rank 1 heads 1, 2, 2 (decode repeats them)
    "expand_uneven": ("glm4-9b", {"n_heads": 6, "n_kv_heads": 3,
                                  "head_dim": 16}),
    "vocab511": ("glm4-9b", {"vocab_size": 511}),
    "mixtral_ep": ("mixtral-8x7b", {"moe": {"n_experts": 4}}),
    "mixtral_ffn": ("mixtral-8x7b", {"moe": {"n_experts": 3}}),
    # MLA (H = KV = 4), experts over the ranks, the shared MLP's d_ff split
    "deepseek": ("deepseek-v2-236b", {"moe": {"d_ff_shared": 32}}),
    # (rglru, rglru, local): d_rnn 64, MQA local layer ("expand"), a
    # window of 8 so the 16-token prompt wraps the ring
    "recurrentgemma": ("recurrentgemma-9b", {"window": 8}),
    # 3 mLSTM + 1 sLSTM of 4 heads (1 a rank at model 4)
    "xlstm": ("xlstm-125m", {"ssm": {"n_heads": 4}}),
    # 2 crossdec layers over a 2-layer encoder of 16 frames (H = KV = 4)
    "whisper": ("whisper-small", {}),
    # 8 patch rows ahead of the text, vocabulary 512, d_ff split
    "internvl2": ("internvl2-1b", {"d_ff": 256}),
}
TP_RANKS = {2: ("glm4", "gemma", "expand_uneven", "vocab511", "mixtral_ep",
                "mixtral_ffn", "deepseek", "recurrentgemma", "xlstm",
                "whisper", "internvl2"),
            4: ("glm4", "replicate", "deepseek", "xlstm", "whisper")}
# the cases whose seq_parallel forward and step are held to the plain ones
TP_SP_CASES = ("recurrentgemma", "xlstm", "whisper")
TP_BATCH, TP_PROMPT, TP_GEN = 2, 16, 3
# MLA, the recurrent blocks and the front ends: under FSDP each cuts its
# parameters over data, and a decode batch the data extent does not
# divide cuts its caches' slots instead (the sequence-split cache)
TP_OUT_OF_SCOPE = ("deepseek-v2-236b", "recurrentgemma-9b", "xlstm-125m",
                   "whisper-small", "internvl2-1b")
# the sequence-split cache's executed shapes (``fsdp``, every
# architecture of the registry at both meshes): a batch of 1 over these
# slots (a local layer's ring of the reduced window 8 or 16 cut too)
SEQ_SHAPE_SLOTS = 24
# FSDP over a data axis of 2 in the same spawns: (data 2, model 1) on
# the 2 ranks (the MoE stacks "whole"), (data 2, model 2) on the 4
# (mixtral_ep "experts", mixtral_ffn "ffn"); the batch's 2 rows, one a
# data rank
FSDP_RANKS = {2: ("glm4", "mixtral_ep", "mixtral_ffn", "deepseek",
                  "recurrentgemma", "xlstm", "whisper", "internvl2"),
              4: ("glm4", "mixtral_ep", "mixtral_ffn", "deepseek",
                  "recurrentgemma", "xlstm", "whisper", "internvl2")}
# the cases whose remat step is held to the plain one (the gathers inside
# the checkpointed units; whisper: the encoder's units are not remat'd)
FSDP_REMAT = ("glm4", "mixtral_ep")
# serving at batch 1 on the same meshes (``fsdp_seq_case``): the batch
# is whole on both data ranks and the attention caches' slots are cut in
# two. One slot past the prompt and the decode steps (an even length:
# the prompt fills slots of both halves, every decode write lands on
# data rank 1; recurrentgemma's ring of 8 wraps across its halves, and
# its decode writes land on rank 0); glm4 also at the odd length, whose
# caches stay whole (``FSDP_SEQ_ODD``)
FSDP_SEQ_PAD = 1
FSDP_SEQ_ODD = "glm4"


def tp_cfg(name):
    arch, kw = TP_CASES[name]
    cfg = reduced(get_config(arch), d_model=64)
    kw = dict(kw)
    for sub in ("moe", "ssm"):
        if sub in kw:
            kw[sub] = dataclasses.replace(getattr(cfg, sub), **kw[sub])
    return dataclasses.replace(cfg, **kw)


def tp_params(cfg, seed=0):
    """The whole parameter tree both packages use: numpy draws in flatten
    order — matrices N(0, 1/fan_in), the embedding N(0, 0.02²), biases,
    norm scales and the router bias N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    shapes = T.init_params(None, cfg, device="meta")
    out = []
    for path, s in tu.flatten(shapes):
        shape = tuple(s.shape)
        if path[-1] == "embed":
            a = 0.02 * rng.standard_normal(shape)
        elif len(shape) >= 2 and path[-1] not in ("ln1", "ln2"):
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        else:
            a = 0.1 * rng.standard_normal(shape)
        out.append(torch.from_numpy(a.astype(np.float32)))
    return tu.unflatten([p for p, _ in tu.flatten(shapes)], out)


def tp_batch(cfg, seed=1):
    """Tokens, labels and, for a front end, N(0, 1) ``aux`` embeddings."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TP_BATCH, TP_PROMPT + 1), dtype=np.int64))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    shape = T.aux_shape(cfg, TP_BATCH)
    if shape is not None:
        out["aux"] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
    return out


def _np_tree(tree):
    return {"/".join(p): t.detach().float().numpy().copy()
            for p, t in tu.flatten(tree)}


def tp_serve(params, cfg, batch, ctx, pad=0):
    """Prefill the prompts, then ``TP_GEN`` greedy tokens: the prefill
    logits, every decode step's logits (the rank's vocabulary columns
    where they are split), the tokens (the argmax across ranks) and the
    cache after the last step. The cache holds ``pad`` slots past the
    last token."""
    from repro_torch.sharding.collectives import vocab_argmax
    npx = T.vision_prefix(cfg)
    L = npx + TP_PROMPT + TP_GEN + pad
    lo = T.vocab_lo(params, cfg, ctx)

    def greedy(logits):
        if lo is None:
            return logits.argmax(-1)
        return vocab_argmax(logits, ctx, lo)

    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, batch["tokens"], ctx=ctx,
                                  aux=batch.get("aux"), cache_len=L)
        out = {"prefill": logits.numpy().copy(), "decode": [], "tokens": []}
        tok = greedy(logits)[:, None]
        for i in range(TP_GEN):
            out["tokens"].append(tok[:, 0].numpy().copy())
            logits, cache = T.decode_step(params, cfg, tok, cache,
                                          npx + TP_PROMPT + i, ctx=ctx,
                                          cache_len=L)
            out["decode"].append(logits.numpy().copy())
            tok = greedy(logits)[:, None]
        if cfg.mla is not None:
            # the absorbed form's last step, again at the last position
            # (the cache slot it writes holds the same latents already)
            absorbed, _ = T.decode_step(
                params, cfg, torch.from_numpy(out["tokens"][-1])[:, None],
                cache, npx + TP_PROMPT + TP_GEN - 1,
                ctx=dataclasses.replace(ctx, mla_absorb=True), cache_len=L)
            out["absorbed"] = absorbed.numpy().copy()
    out["cache"] = _np_tree(cache)
    out["init_cache"] = {"/".join(p): tuple(t.shape) for p, t in tu.flatten(
        T.init_cache(cfg, TP_BATCH, L, device="meta", ctx=ctx))}
    return out


def tp_ctx(world, **kw):
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    return ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model", **kw)


def tp_case(name, ctx):
    """One config on this rank's slice: serving, a train step (SGD lr 1,
    the gradient read back), and the forward logits."""
    cfg = tp_cfg(name)
    whole = tp_params(cfg)
    mine = tp_slice(whole, ctx, cfg)
    batch = tp_batch(cfg)
    out = tp_serve(mine, cfg, batch, ctx)
    out["loss"], out["grads"] = sgd_grads(mine, cfg, batch, ctx)
    out["held_numel"] = sum(t.numel() for t in tu.leaves(mine))
    if name in TP_SP_CASES:
        sp = dataclasses.replace(ctx, seq_parallel=True)
        with torch.no_grad():
            for key, c in (("forward", ctx), ("forward_sp", sp)):
                out[key] = T.forward(mine, cfg, batch["tokens"], ctx=c,
                                     aux=batch.get("aux")).numpy()
        out["loss_sp"], out["grads_sp"] = sgd_grads(mine, cfg, batch, sp)
    return out


TP_SERVE = dict(arch="glm4-9b", batch=2, prompt_len=8, gen=3, device="cpu")
TP_TRAIN = dict(arch="glm4-9b", steps=2, batch=2, seq=16, d_model=64,
                device="cpu", log_every=100)
# the launchers on whisper too: its frames drawn as ``aux`` on every rank
TP_LAUNCH_ARCHS = ("glm4-9b", "whisper-small")


def tp_launch(ctx):
    """The serving and training launchers (``launch/serve.py``,
    ``launch/train.py``) under ``ctx``, per arch of ``TP_LAUNCH_ARCHS``:
    greedy tokens and losses."""
    from repro_torch.launch import serve, train
    out = {}
    for arch in TP_LAUNCH_ARCHS:
        s = serve.run(**dict(TP_SERVE, arch=arch), ctx=ctx)
        t = train.run(**dict(TP_TRAIN, arch=arch), aux="normal", ctx=ctx)
        out[arch] = {"tokens": s["tokens"].numpy(), "losses": t["losses"]}
    return out


def fsdp_ctx(world, **kw):
    """A (data=2, model=world/2) mesh over the spawn's ranks."""
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    return ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model", **kw)


def fsdp_case(name, ctx):
    """``tp_case`` under FSDP: the rank's data part of its model part of
    the same whole tree, its rows of the batch (serving and a train
    step), and under ``FSDP_REMAT`` the remat step; ``round_trip``:
    whether ``tp_gather`` of the part is the whole tree and ``tp_slice``
    of that the part, bit for bit (what a checkpoint writes and reads)."""
    cfg = tp_cfg(name)
    whole = tp_params(cfg)
    mine = tp_slice(whole, ctx, cfg)
    back = tp_gather(mine, ctx, cfg, T.init_params(None, cfg, device="meta"))
    again = tp_slice(back, ctx, cfg)
    round_trip = all(torch.equal(a, b) for a, b in zip(
        tu.leaves(back), tu.leaves(whole))) and all(
        torch.equal(a, b) for a, b in zip(tu.leaves(again), tu.leaves(mine)))
    del whole, back, again
    rows = data_rows(TP_BATCH, ctx)
    batch = {k: v[rows] for k, v in tp_batch(cfg).items()}
    out = tp_serve(mine, cfg, batch, ctx)
    out["loss"], out["grads"] = sgd_grads(mine, cfg, batch, ctx)
    out["held_numel"] = sum(t.numel() for t in tu.leaves(mine))
    out["round_trip"] = round_trip
    if name in FSDP_REMAT:
        out["loss_remat"], out["grads_remat"] = sgd_grads(
            mine, cfg, batch, dataclasses.replace(ctx, remat=True))
    return out


def fsdp_seq_case(name, ctx, pad=FSDP_SEQ_PAD):
    """``name`` served at batch 1 (the batch's first row) on the rank's
    data part of its model part: the batch is whole on every data rank
    (``batch_ctx``), and each attention cache holds the rank's block of
    its ``L + pad`` slots; the cache's slot cuts (``cache_slot_cut``)."""
    cfg = tp_cfg(name)
    mine = tp_slice(tp_params(cfg), ctx, cfg)
    batch = {k: v[:1] for k, v in tp_batch(cfg).items()}
    seq = batch_ctx(1, ctx)
    out = tp_serve(mine, cfg, batch, seq, pad=pad)
    out["batch_whole"] = seq.batch_whole
    out["slot_cuts"] = {path: cache_slot_cut(path, shape, seq) for path, shape
                        in seq_whole_shapes(cfg, pad).items()}
    return out


def seq_whole_shapes(cfg, pad):
    """The whole batch-1 cache's leaf shapes at ``tp_serve``'s length."""
    L = T.vision_prefix(cfg) + TP_PROMPT + TP_GEN + pad
    return {"/".join(p): tuple(t.shape) for p, t in tu.flatten(
        T.init_cache(cfg, 1, L, device="meta"))}


def fsdp_launch(ctx, ckdir):
    """``tp_launch`` under FSDP, the trainer writing a checkpoint: the
    tokens (every rank's rows), the losses, the file and the rank's
    trained parameters."""
    from repro_torch.launch import serve, train
    out = {}
    for arch in TP_LAUNCH_ARCHS:
        path = os.path.join(ckdir, f"{arch}.npz")
        s = serve.run(**dict(TP_SERVE, arch=arch), ctx=ctx)
        t = train.run(**dict(TP_TRAIN, arch=arch), aux="normal", ctx=ctx,
                      ckpt=path)
        out[arch] = {"tokens": s["tokens"].numpy(), "losses": t["losses"],
                     "ckpt": path, "params": _np_tree(t["params"])}
    return out


def fsdp(world, ckdir):
    """The FSDP scenarios on a (data=2, model=world/2) mesh."""
    ctx = fsdp_ctx(world)
    os.makedirs(os.path.join(ckdir, f"w{world}"), exist_ok=True)
    res = {"data_rank": ctx.data_rank, "model_rank": ctx.model_rank,
           "cases": {n: fsdp_case(n, ctx) for n in FSDP_RANKS[world]},
           "seq": {n: fsdp_seq_case(n, ctx) for n in FSDP_RANKS[world]},
           "seq_odd": fsdp_seq_case(FSDP_SEQ_ODD, ctx, pad=0),
           "launch": fsdp_launch(ctx, os.path.join(ckdir, f"w{world}"))}
    # every architecture cuts over data: its parameters (at world 2) and,
    # at a batch of 1, its caches' slots (the executed shapes)
    res["seq_shapes"] = {}
    for arch in arch_ids():
        c = reduced(get_config(arch), d_model=64)
        res["seq_shapes"][arch] = {"/".join(q): tuple(t.shape) for q, t in
                                   tu.flatten(T.init_cache(
                                       c, 1, SEQ_SHAPE_SLOTS, device="meta",
                                       ctx=ctx))}
    if world == 2:
        res["out_of_scope"] = {}
        for arch in TP_OUT_OF_SCOPE:
            c = reduced(get_config(arch), d_model=64)
            p = T.init_params(None, c, device="meta")
            res["out_of_scope"][arch] = {
                "held": {"/".join(q): tuple(t.shape) for q, t in
                         tu.flatten(tp_slice(p, ctx, c))}}
    return res


def tensor_parallel(rank, world, ckdir):
    """The tensor-parallel scenarios on a (data=1, model=world) mesh, then
    FSDP's on a (data=2, model=world/2) one (``fsdp``)."""
    import torch.distributed as dist
    ctx = tp_ctx(world)
    res = {"rank": rank, "model_rank": ctx.model_rank,
           "cases": {n: tp_case(n, ctx) for n in TP_RANKS[world]}}
    cfg = tp_cfg("glm4")
    mine = tp_slice(tp_params(cfg), ctx, cfg)
    batch = tp_batch(cfg)
    sp = dataclasses.replace(ctx, seq_parallel=True)
    with torch.no_grad():
        res["forward"] = T.forward(mine, cfg, batch["tokens"],
                                   ctx=ctx).numpy()
        res["forward_sp"] = T.forward(mine, cfg, batch["tokens"],
                                      ctx=sp).numpy()
        # a length the axis does not divide runs without the split
        res["forward_sp_odd"] = T.forward(mine, cfg, batch["tokens"][:, :-1],
                                          ctx=sp).numpy()
        res["forward_odd"] = T.forward(mine, cfg, batch["tokens"][:, :-1],
                                       ctx=ctx).numpy()
    res["serve_sp"] = tp_serve(mine, cfg, batch, sp)
    res["loss_sp"], res["grads_sp"] = sgd_grads(mine, cfg, batch, sp)
    res["loss_remat"], res["grads_remat"] = sgd_grads(
        mine, cfg, batch, dataclasses.replace(ctx, remat=True))
    res["loss_sp_remat"], res["grads_sp_remat"] = sgd_grads(
        mine, cfg, batch, dataclasses.replace(sp, remat=True))
    if world == 2:
        et = dataclasses.replace(ctx, embed_tp=True)
        res["serve_embed_tp"] = tp_serve(mine, cfg, batch, et)
        # bf16 parameters and activations: the reduce in f32 and in bf16
        b16 = dataclasses.replace(cfg, dtype="bfloat16")
        p16 = tu.tree_map(lambda t: t.to(torch.bfloat16), mine)
        with torch.no_grad():
            for key, c in (("bf16_f32_reduce", ctx), ("bf16_bf16_reduce",
                           dataclasses.replace(ctx, tp_bf16_reduce=True))):
                res[key] = T.forward(p16, b16, batch["tokens"],
                                     ctx=c).float().numpy()
        res["launch"] = tp_launch(ctx)
    res["fsdp"] = fsdp(world, ckdir)
    dist.barrier()
    return res
