#!/usr/bin/env python3
"""Where the per-client loop and the unified engine part on the card.

    python3 tools/loop_vs_unified_probe.py

Under each float32 setting of cuDNN / cuBLAS it prints:
  * the flags as torch reports them;
  * one 3x3 convolution (40 x 64 x 32 x 32 images, 64 -> 64 channels)
    and one fc matmul against the same in float64: max |diff| over
    max |out| (TF32 shows as ~1e-3, IEEE f32 as ~1e-6);
  * one VGG-13 client at full width: its logits in its own architecture
    and embedded into the union VGG-19-Wider, each against float64;
  * one clustered round of a 5-client cohort (2x VGG-13, 2x VGG-16-Wider,
    1x VGG-19-Wider, full width) on the loop and on the unified engine
    from the same init and data: max over clients of max |logits diff|
    over max |logits| on 16 test images (``chip_smoke.py``'s check).
Then, with the port's setting (``strict_f32``): the same measure
between two runs of one engine (the card's run-to-run spread), and loop
vs unified for one and two local steps and smaller learning rates — how
far local training carries a difference it starts with — beside max
|logits| of a fresh client and after the round.
Then one client's gradient: VGG-13 embedded into the union VGG-19-Wider
at full width, one batch of 40 images: the union gradient projected
as the engine's step projects it (E Eᵀ, the trainable mask) against the
client's own gradient pushed forward (``up(g) - up(0)``), leaf by leaf,
in float32 and in float64 — where the two paths' SGD steps part before
any training carries the difference on.

And the engine's own step: the cohort's stacked, embedded clients
through ``torch.func.vmap`` (convolutions grouped over the clients)
against each client alone in the union architecture — logits and
per-leaf gradients — with cuDNN's default and deterministic choices
and with cuDNN off.

Section ``layout`` takes the per-client gradients in float64 as the
truth and holds against them the float32 per-client gradients (cuDNN on
and off) and the vmapped ones (cuDNN; ``chunk_size=1``; each
convolution's output cloned into a contiguous tensor; each 2x2 max-pool
computed as a max over a reshaped view).

Section ``split`` takes one clustered round apart per client: the
unified client view against the loop's client params embedded at the
engine's seed (per-leaf), and the logits difference as the part the
parameters make (both in the union architecture) and the part the
architecture makes (the loop's params in its own and in the union's);
then, on each client's first training batch at its initial params, the
fc0 pre-activations in its own architecture and in the union's: how
many (sample, unit) pairs have ReLU open in one and shut in the other.

Section ``cohort`` runs the paper's 20-client cohort at full width, one
round of each per-client method on both engines, and prints per
architecture the loop-vs-unified logits difference and its architecture
part (the loop's trained params in the client's architecture against
the same params embedded in the union), over max |logits|.

    python3 tools/loop_vs_unified_probe.py [ops] [rounds] [grad] [vmap]
                                           [layout] [split] [cohort]

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def flags() -> dict:
    out = {"cudnn.enabled": torch.backends.cudnn.enabled,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "cudnn.deterministic": torch.backends.cudnn.deterministic}
    for name, obj in (("cudnn.conv.fp32_precision",
                       getattr(torch.backends.cudnn, "conv", None)),
                      ("cuda.matmul.fp32_precision",
                       getattr(torch.backends.cuda, "matmul", None))):
        if obj is not None and hasattr(obj, "fp32_precision"):
            out[name] = obj.fp32_precision
    return out


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def op_errors(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 64, 32, 32, generator=g).relu().to(dev)
    w = (torch.randn(64, 64, 3, 3, generator=g) / 24).to(dev)
    conv = rel(F.conv2d(x, w, padding=1),
               F.conv2d(x.double(), w.double(), padding=1))
    a = torch.randn(40, 4096, generator=g).to(dev)
    b = torch.randn(4096, 4096, generator=g).to(dev) / 64
    mm = rel(a @ b, a.double() @ b.double())
    return conv, mm


def forward_errors(dev):
    from repro_torch.configs.vgg_family import vgg
    from repro_torch.core import VGGFamily
    from repro_torch import tree as tu
    from repro_torch.models import vgg as vmodel
    fam = VGGFamily()
    cfg = vgg("vgg13")
    gcfg = fam.union([cfg, vgg("vgg19-wider")])
    p = fam.init(torch.Generator().manual_seed(1), cfg, device=dev)
    up = fam.up(p, cfg, gcfg, seed=0)
    x = torch.randn(16, 32, 32, 3, generator=torch.Generator().manual_seed(2)
                    ).to(dev)
    with torch.no_grad():
        ref = vmodel.apply(tu.tree_map(lambda t: t.double(), p), cfg,
                           x.double())
        lc = vmodel.apply(p, cfg, x)
        lu = vmodel.apply(up, gcfg, x)
    return rel(lc, ref), rel(lu, ref), rel(lc, lu)


def clustered_round(dev, pair=("loop", "unified"), epochs=2, lr=0.03,
                    with_scale=False):
    from repro_torch.configs.vgg_family import vgg
    from repro_torch.core import VGGFamily
    from repro_torch.data import (EASY, ClientSampler, image_classification,
                                  iid_partition)
    from repro_torch.fl import FLRunConfig, Simulator
    from repro_torch.models import vgg as vmodel
    cfgs = [vgg(a) for a in ("vgg13", "vgg13", "vgg16-wider", "vgg16-wider",
                             "vgg19-wider")]
    data = image_classification(EASY, 1000, seed=0)
    test = image_classification(EASY, 16, seed=999)
    parts = iid_partition(1000, len(cfgs), seed=0)
    res = []
    for eng in pair:
        samplers = [ClientSampler(data, q, round_fraction=0.2, batch_size=64,
                                  seed=i) for i, q in enumerate(parts)]
        rc = FLRunConfig(method="clustered", rounds=1, local_epochs=epochs,
                         lr=lr, momentum=0.9, engine=eng, device=dev)
        res.append(Simulator(VGGFamily(), cfgs, samplers, rc, test).run(
            torch.Generator().manual_seed(0))["client_params"])
    gcfg = VGGFamily().union(cfgs)
    x = torch.as_tensor(test["x"], device=dev)

    def logits(eng, p, c):
        return vmodel.apply(p, gcfg if eng == "unified" else c, x)
    with torch.no_grad():
        err = max(rel(logits(pair[1], b, c), logits(pair[0], a, c))
                  for a, b, c in zip(res[0], res[1], cfgs))
        if not with_scale:
            return err
        after = max(float(logits(pair[0], a, c).abs().max())
                    for a, c in zip(res[0], cfgs))
        init = VGGFamily().init(torch.Generator().manual_seed(5), cfgs[0],
                                device=dev)
        before = float(vmodel.apply(init, cfgs[0], x).abs().max())
    return err, before, after


def grad_errors(dev, dtype):
    """Per-leaf max |proj(g_union) - E g_client| / max |E g_client|."""
    from repro_torch import tree as tu
    from repro_torch.configs.vgg_family import vgg
    from repro_torch.core import VGGFamily, plane
    from repro_torch.core import segments as sg
    from repro_torch.data import EASY, image_classification
    from repro_torch.fl import UnifiedEngine
    fam = VGGFamily()
    cfgs = [vgg("vgg13"), vgg("vgg19-wider")]
    eng = UnifiedEngine(fam, cfgs, [1, 1], method="standalone", device=dev)
    gcfg = eng.global_cfg
    p = fam.init(torch.Generator().manual_seed(1), cfgs[0], device=dev)
    p = tu.tree_map(lambda t: t.to(dtype), p)
    u = fam.up(p, cfgs[0], gcfg, seed=eng.embed_seed)
    data = image_classification(EASY, 40, seed=3)
    batch = {"x": torch.as_tensor(data["x"], device=dev).to(dtype),
             "y": torch.as_tensor(data["y"], device=dev)}
    _, g_p = fam.loss_and_grad(cfgs[0])(p, batch)
    _, g_u = fam.loss_and_grad(gcfg)(u, batch)
    mats = {k: [m[:1].to(dtype) for m in ms]
            for k, ms in eng._seg_mats0.items()}
    def project(path, g):
        # segments.apply_leaf at the gradient's own precision
        axes = eng._seg_axes.get(sg.path_str(path), ())
        out = g[None]
        for ax, m in zip(axes, mats.get(sg.path_str(path), ())):
            moved = torch.einsum("kvu,k...u->k...v", m,
                                 out.movedim(ax + 1, -1))
            out = moved.movedim(-1, ax + 1)
        return out

    proj = tu.map_with_path(project, g_u)
    mask = plane.unpack(eng._umask_p[0], eng.plane_spec)
    zeros = tu.tree_map(torch.zeros_like, p)
    want = tu.tree_map(lambda a, b: a - b,
                       fam.up(g_p, cfgs[0], gcfg, seed=eng.embed_seed),
                       fam.up(zeros, cfgs[0], gcfg, seed=eng.embed_seed))
    out = {}
    for (path, a), (_, m), (_, b) in zip(tu.flatten(proj), tu.flatten(mask),
                                         tu.flatten(want)):
        scale = float(b.abs().max())
        out["/".join(path)] = (float((a[0] * m.to(dtype) - b).abs().max())
                               / scale if scale else 0.0)
    return out


def vmap_errors(dev, chunk_size=None):
    """(logits, losses, worst leaves, ms a vmapped grad call) of vmap
    over the embedded cohort against each client alone, both in the
    union architecture; ``chunk_size`` is ``torch.func.vmap``'s."""
    import time
    from torch.func import vmap
    from repro_torch import tree as tu
    from repro_torch.configs.vgg_family import vgg
    from repro_torch.core import VGGFamily
    from repro_torch.data import EASY, image_classification
    from repro_torch.fl import UnifiedEngine
    from repro_torch.models import vgg as vmodel
    fam = VGGFamily()
    cfgs = [vgg(a) for a in ("vgg13", "vgg13", "vgg16-wider", "vgg16-wider",
                             "vgg19-wider")]
    K = len(cfgs)
    eng = UnifiedEngine(fam, cfgs, [1] * K, method="standalone", device=dev)
    gcfg = eng.global_cfg
    state = eng.embed([fam.init(torch.Generator().manual_seed(k), c,
                                device=dev) for k, c in enumerate(cfgs)])
    data = image_classification(EASY, 40 * K, seed=3)
    batch = {"x": torch.as_tensor(data["x"], device=dev).reshape(
                 K, 40, 32, 32, 3),
             "y": torch.as_tensor(data["y"], device=dev).reshape(K, 40)}
    gf = fam.loss_and_grad(gcfg)
    with torch.no_grad():
        lv = vmap(lambda p, x: vmodel.apply(p, gcfg, x),
                  chunk_size=chunk_size)(state, batch["x"])
        l1 = torch.stack([vmodel.apply(eng.client_view(state, k), gcfg,
                                       batch["x"][k]) for k in range(K)])
    stepped = vmap(lambda p, b: gf(p, b), chunk_size=chunk_size)
    (lossv, _), gv = stepped(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        stepped(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    one = [gf(eng.client_view(state, k),
              {n: v[k] for n, v in batch.items()}) for k in range(K)]
    loss1 = torch.stack([o[0][0] for o in one])
    errs = {}
    for path, a in tu.flatten(gv):
        for k in range(K):
            b = tu.get(one[k][1], path)
            scale = float(b.abs().max())
            e = float((a[k] - b).abs().max()) / scale if scale else 0.0
            key = "/".join(path)
            errs[key] = max(errs.get(key, 0.0), e)
    return (rel(lv, l1), rel(lossv, loss1),
            sorted(errs.items(), key=lambda kv: -kv[1])[:6], ms)


def layout_errors(dev):
    """Worst leaf of each gradient mode against cuDNN-off per-client."""
    from torch.func import vmap
    from repro_torch import tree as tu
    from repro_torch.configs.vgg_family import vgg
    from repro_torch.core import VGGFamily
    from repro_torch.data import EASY, image_classification
    from repro_torch.fl import UnifiedEngine
    from repro_torch.models import vgg as vmodel
    fam = VGGFamily()
    cfgs = [vgg(a) for a in ("vgg13", "vgg13", "vgg16-wider", "vgg16-wider",
                             "vgg19-wider")]
    K = len(cfgs)
    eng = UnifiedEngine(fam, cfgs, [1] * K, method="standalone", device=dev)
    gcfg = eng.global_cfg
    state = eng.embed([fam.init(torch.Generator().manual_seed(k), c,
                                device=dev) for k, c in enumerate(cfgs)])
    data = image_classification(EASY, 40 * K, seed=3)
    batch = {"x": torch.as_tensor(data["x"], device=dev).reshape(
                 K, 40, 32, 32, 3),
             "y": torch.as_tensor(data["y"], device=dev).reshape(K, 40)}
    gf = fam.loss_and_grad(gcfg)

    def per_client():
        return [gf(eng.client_view(state, k),
                   {n: v[k] for n, v in batch.items()})[1]
                for k in range(K)]

    def vmapped():
        gv = vmap(lambda p, b: gf(p, b)[1])(state, batch)
        return [tu.tree_map(lambda t: t[k], gv) for k in range(K)]

    f32_state, f32_batch = state, batch
    state = tu.tree_map(lambda t: t.double(), state)
    batch = {"x": batch["x"].double(), "y": batch["y"]}
    truth = per_client()
    state, batch = f32_state, f32_batch

    def worst(gs):
        out = ("", 0.0)
        for k in range(K):
            for path, b in tu.flatten(truth[k]):
                a = tu.get(gs[k], path)
                scale = float(b.abs().max())
                e = float((a - b).abs().max()) / scale if scale else 0.0
                if e > out[1]:
                    out = ("/".join(path), e)
        return out

    rows = [("per-client, cuDNN", worst(per_client()))]
    torch.backends.cudnn.enabled = False
    rows.append(("per-client, cuDNN off", worst(per_client())))
    rows.append(("vmap, cuDNN off", worst(vmapped())))
    torch.backends.cudnn.enabled = True
    rows.append(("vmap, cuDNN", worst(vmapped())))
    gv = vmap(lambda p, b: gf(p, b)[1], chunk_size=1)(state, batch)
    rows.append(("vmap chunk_size=1, cuDNN",
                 worst([tu.tree_map(lambda t: t[k], gv) for k in range(K)])))
    conv, pool = F.conv2d, F.max_pool2d
    try:
        F.conv2d = lambda *a, **k: conv(*a, **k).clone(
            memory_format=torch.contiguous_format)
        rows.append(("vmap, cuDNN, conv outputs cloned contiguous",
                     worst(vmapped())))
        F.conv2d = conv

        def pool2(h, k):
            n, c, hh, ww = h.shape
            return h.reshape(n, c, hh // 2, 2, ww // 2, 2).amax((3, 5))
        F.max_pool2d = pool2
        rows.append(("vmap, cuDNN, max-pool as a reshaped max",
                     worst(vmapped())))
    finally:
        F.conv2d, F.max_pool2d = conv, pool
    return rows


def split_errors(dev, epochs=2):
    """Per client: (arch, worst param leaf, logits from params, logits
    from architecture, total)."""
    from repro_torch import tree as tu
    from repro_torch.configs.vgg_family import vgg
    from repro_torch.core import VGGFamily
    from repro_torch.data import (EASY, ClientSampler, image_classification,
                                  iid_partition)
    from repro_torch.fl import FLRunConfig, Simulator
    from repro_torch.models import vgg as vmodel
    fam = VGGFamily()
    cfgs = [vgg(a) for a in ("vgg13", "vgg13", "vgg18", "vgg18",
                             "vgg19-wider")]
    data = image_classification(EASY, 1000, seed=0)
    test = image_classification(EASY, 16, seed=999)
    parts = iid_partition(1000, len(cfgs), seed=0)
    res = {}
    for eng in ("loop", "unified"):
        samplers = [ClientSampler(data, q, round_fraction=0.2, batch_size=64,
                                  seed=i) for i, q in enumerate(parts)]
        rc = FLRunConfig(method="clustered", rounds=1, local_epochs=epochs,
                         lr=0.03, momentum=0.9, engine=eng, device=dev)
        res[eng] = Simulator(fam, cfgs, samplers, rc, test).run(
            torch.Generator().manual_seed(0))["client_params"]
    gcfg = fam.union(cfgs)
    x = torch.as_tensor(test["x"], device=dev)
    rows = []
    with torch.no_grad():
        for k, c in enumerate(cfgs):
            lp, up_ = res["loop"][k], res["unified"][k]
            emb = fam.up(lp, c, gcfg, seed=0)
            worst = max(((("/".join(p)), float((tu.get(up_, p) - b).abs()
                                               .max() / b.abs().max()))
                         for p, b in tu.flatten(emb)), key=lambda t: t[1])
            l_loop = vmodel.apply(lp, c, x)
            l_emb = vmodel.apply(emb, gcfg, x)
            l_uni = vmodel.apply(up_, gcfg, x)
            rows.append((c.name, worst, rel(l_uni, l_emb), rel(l_emb, l_loop),
                         rel(l_uni, l_loop)))
    return rows


def cohort_errors(dev, method):
    """{arch: (depth-embedded?, total, architecture part)} for one round
    of ``method`` on the paper's cohort (``chip_smoke.py``'s run)."""
    from repro_torch.configs.vgg_family import paper_client_archs, vgg
    from repro_torch.core import VGGFamily
    from repro_torch.data import (EASY, ClientSampler, image_classification,
                                  iid_partition)
    from repro_torch.fl import FLRunConfig, Simulator
    from repro_torch.models import vgg as vmodel
    fam = VGGFamily()
    cfgs = [vgg(a) for a in paper_client_archs()]
    data = image_classification(EASY, 4000, seed=0)
    test = image_classification(EASY, 16, seed=999)
    parts = iid_partition(4000, len(cfgs), seed=0)
    res = {}
    for eng in ("loop", "unified"):
        samplers = [ClientSampler(data, q, round_fraction=0.2, batch_size=64,
                                  seed=i) for i, q in enumerate(parts)]
        rc = FLRunConfig(method=method, rounds=1, local_epochs=2, lr=0.03,
                         momentum=0.9, engine=eng, device=dev)
        res[eng] = Simulator(fam, cfgs, samplers, rc, test).run(
            torch.Generator().manual_seed(0))["client_params"]
    gcfg = fam.union(cfgs)
    x = torch.as_tensor(test["x"], device=dev)
    out = {}
    with torch.no_grad():
        for k, c in enumerate(cfgs):
            lp = res["loop"][k]
            l_loop = vmodel.apply(lp, c, x)
            total = rel(vmodel.apply(res["unified"][k], gcfg, x), l_loop)
            arch = rel(vmodel.apply(fam.up(lp, c, gcfg, seed=0), gcfg, x),
                       l_loop)
            prev = out.get(c.name, (0, 0.0, 0.0))
            out[c.name] = (fam.depth_only([c, gcfg]), max(prev[1], total),
                           max(prev[2], arch))
    del res
    torch.cuda.empty_cache()
    return out


def fc0_flips(dev):
    """Per client of ``split_errors``' cohort: (arch, ReLU flips at fc0,
    max |z| of a flipped pre-activation, max |z_own - z_union| / max
    |z|) on its first training batch at its initial params."""
    import torch.nn.functional as Fn
    from repro_torch.configs.vgg_family import vgg
    from repro_torch.core import VGGFamily
    from repro_torch.data import (EASY, ClientSampler, image_classification,
                                  iid_partition)
    from repro_torch.fl import make_strategy
    fam = VGGFamily()
    cfgs = [vgg(a) for a in ("vgg13", "vgg13", "vgg18", "vgg18",
                             "vgg19-wider")]
    gcfg = fam.union(cfgs)
    data = image_classification(EASY, 1000, seed=0)
    parts = iid_partition(1000, len(cfgs), seed=0)
    init = make_strategy("clustered", fam, cfgs, [200] * 5).init_state(
        torch.Generator().manual_seed(0), device=dev)

    def pre_fc0(params, x):
        h = x.permute(0, 3, 1, 2)
        for si in range(len(params["stages"])):
            st = params["stages"][f"s{si}"]
            for li in range(len(st)):
                h = Fn.relu(Fn.conv2d(h, st[f"c{li}"]["w"].permute(3, 2, 0, 1),
                                      st[f"c{li}"]["b"], padding=1))
            h = Fn.max_pool2d(h, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return h @ params["fc"]["f0"]["w"] + params["fc"]["f0"]["b"]

    rows = []
    with torch.no_grad():
        for k, c in enumerate(cfgs):
            batch = next(iter(ClientSampler(data, parts[k], round_fraction=0.2,
                                            batch_size=64, seed=k)
                              .round_batches(1)))
            x = torch.as_tensor(batch["x"], device=dev)
            z1 = pre_fc0(init[k], x)
            z2 = pre_fc0(fam.up(init[k], c, gcfg, seed=0), x)
            flip = (z1 > 0) != (z2 > 0)
            zmax = float(torch.maximum(z1.abs(), z2.abs())[flip].max()) \
                if bool(flip.any()) else 0.0
            rows.append((c.name, int(flip.sum()), zmax, rel(z2, z1)))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    from repro_torch.device import strict_f32
    dev = torch.device("cuda", 0)

    def ieee():
        strict_f32(dev)
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cuda.matmul.fp32_precision = "ieee"

    settings = (("defaults", lambda: None),
                ("strict_f32", lambda: strict_f32(dev)),
                ("strict_f32 + fp32_precision ieee", ieee),
                ("strict_f32 + cudnn off", lambda: (
                    strict_f32(dev),
                    setattr(torch.backends.cudnn, "enabled", False))))
    sections = sys.argv[1:] or ["ops", "rounds", "grad", "vmap", "layout",
                                "split", "cohort"]
    for name, apply in (settings[:2] if "ops" in sections else ()):
        apply()
        print(f"== {name}: {flags()}")
        conv, mm = op_errors(dev)
        print(f"  conv rel err {conv:.3e}  matmul rel err {mm:.3e}")
        fc, fu, cu = forward_errors(dev)
        print(f"  vgg13 logits vs f64: client {fc:.3e}  union {fu:.3e}; "
              f"client vs union {cu:.3e}")
        print(f"  clustered round, loop vs unified logits: "
              f"{clustered_round(dev):.3e}")
        torch.cuda.empty_cache()
    torch.backends.cudnn.enabled = True
    if "rounds" in sections:
        strict_f32(dev)
        print(f"== the port's setting: {flags()}")
        for pair in (("loop", "loop"), ("unified", "unified")):
            print(f"  {pair[0]} run vs {pair[1]} run: "
                  f"{clustered_round(dev, pair):.3e}")
        for epochs, lr in ((1, 0.03), (2, 0.03), (2, 0.003), (2, 0.0003)):
            err, before, after = clustered_round(dev, epochs=epochs, lr=lr,
                                                 with_scale=True)
            print(f"  loop vs unified, {epochs} step(s), lr {lr}: {err:.3e}"
                  f" (max|logits| {before:.3e} at init, {after:.3e} after)")
    if "vmap" in sections:
        for name, det, on, bench, chunk in (
                ("default", False, True, False, None),
                ("deterministic", True, True, False, None),
                ("benchmark", False, True, True, None),
                ("vmap chunk_size=1", False, True, False, 1),
                ("cudnn off", False, False, False, None)):
            strict_f32(dev)
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.enabled = on
            torch.backends.cudnn.benchmark = bench
            lg, ls, worst, ms = vmap_errors(dev, chunk)
            print(f"== vmap vs per-client, union arch, {name}: logits "
                  f"{lg:.3e}, losses {ls:.3e}, vmapped grad call {ms:.1f} "
                  f"ms; gradient leaves, worst first:")
            for k, v in worst:
                print(f"  {k:24s} {v:.3e}")
            torch.cuda.empty_cache()
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.benchmark = False
    if "cohort" in sections:
        strict_f32(dev)
        for method in ("clustered", "flexifed", "standalone"):
            print(f"== {method}, paper cohort: per architecture, "
                  "depth-embedded?, loop vs unified, architecture part")
            for name, (depth, tot, arch) in cohort_errors(dev,
                                                           method).items():
                print(f"  {name:12s} {str(depth):5s} {tot:.3e} {arch:.3e}")
    if "split" in sections:
        strict_f32(dev)
        for epochs in (1, 2):
            print(f"== one clustered round, {epochs} step(s): per client, the "
                  "worst param leaf, logits from params / from architecture"
                  " / total")
            for name, (leaf, pe), lp, la, lt in split_errors(dev, epochs):
                print(f"  {name:12s} {leaf:20s} {pe:.3e}  {lp:.3e} / "
                      f"{la:.3e} / {lt:.3e}")
        print("== fc0 pre-activations at init, own vs union architecture: "
              "ReLU flips, largest flipped |z|, max |diff| / max |z|")
        for name, n, zmax, d in fc0_flips(dev):
            print(f"  {name:12s} {n:4d} {zmax:.3e} {d:.3e}")
    if "layout" in sections:
        strict_f32(dev)
        torch.backends.cudnn.deterministic = False
        print("== f32 gradients against per-client float64, worst leaf")
        for name, (leaf, e) in layout_errors(dev):
            print(f"  {name:48s} {e:.3e} ({leaf})")
    if "grad" in sections:
        strict_f32(dev)
        torch.backends.cudnn.deterministic = False
        for dtype in (torch.float32,):
            errs = grad_errors(dev, dtype)
            worst = sorted(errs.items(), key=lambda kv: -kv[1])
            print(f"== gradient, {dtype}: max |proj(g_union) - E g_client|"
                  f" / max |E g_client| per leaf, worst first")
            for k, v in worst[:12]:
                print(f"  {k:24s} {v:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
