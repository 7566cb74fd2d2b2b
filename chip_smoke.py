#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the smoke test below
    python3 chip_smoke.py --profile    # where one round's time goes

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, and builds the fedavg CUDA kernels from
   ``src/repro_torch/kernels/csrc/fedavg.cu``.
2. Kernel phase: holds each hand-written kernel (``weighted_sum``,
   ``plane_agg``, ``plane_accum``, ``plane_finish``) against its plain
   PyTorch version on the card — at the main path's shapes (the plane of
   the paper's union VGG-19-Wider, P = 40,717,642, K = 20 clients,
   stream chunks of 16 and 4 rows), at a lane-odd P, at k_chunk in
   {1, 2, K-1, K}, on the w = 0 corner, and streamed == whole-plane —
   and times kernel, the op that wraps it as the engine calls it, the
   plain version, the bound and, where one PyTorch call computes the
   same function (``weighted_sum``: the GEMV ``w @ x``), that call.
3. Main-path phase: the paper's 20-client fedadp round at full VGG width
   through ``FLRunConfig`` -> ``Simulator`` -> ``UnifiedEngine``:
   ``agg_layout="auto"`` (which resolves to the streaming layout), the
   streaming layout under ``agg_mode="coverage"``, then the whole-plane
   layout under "filler" and "coverage". The launch counts show that
   each kernel ran; the streamed coverage round must equal the
   whole-plane coverage round; accuracies must be finite.

``--profile`` instead traces one warm round of the streamed filler and
of the whole-plane coverage layout with ``torch.profiler`` and prints,
per round, its wall time, training share, device time by kernel name
(summed event durations) and the device's busy share (the union of
device-activity intervals inside the round's window, over the window).

Tolerance for kernel vs plain version: max |diff| <= 1e-6 * max|x| *
sum|w|. Both sum the same <= 20 f32 products per coordinate, in
different orders (the kernel sequentially per column, the plain version
in the library's order), so they differ by a few f32 roundings of the
weighted sum, which is bounded by max|x| * sum|w|.

Any failure raises (exit code != 0). The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

K_MAIN = 20
REPS = 20
TOL = 1e-6
TPU_KERNELS = "src/repro/kernels/fedavg/fedavg.py"
SOURCE = "src/repro_torch/kernels/csrc/fedavg.cu"
# data-sheet HBM bandwidth by card name (bytes/s); the SXM H100 otherwise
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("H100", 3.35e12))
F32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside tensor cores


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    return 3.35e12


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Errors:
    """Largest error seen per kernel, each check against the tolerance."""

    def __init__(self):
        self.max = {}

    def hold(self, kernel: str, got, want, scale: float, what: str) -> None:
        err = float((got.float() - want.float()).abs().max())
        tol = TOL * scale
        print(f"  {kernel:12s} {what:44s} max_abs_err={err:.3e} "
              f"tol={tol:.3e}")
        check(math.isfinite(err) and err <= tol,
              f"{kernel} {what}: max abs err {err} > {tol}")
        self.max[kernel] = max(self.max.get(kernel, 0.0), err)


def cohort_inputs(K, n, gen, dev, *, zero_rows=0):
    """Random plane x, weights w (normalized, the first ``zero_rows``
    zero), coverage masks m, multiplicities mu (0 where m is 0) and
    fallback fb — built on the card."""
    x = torch.randn(K, n, generator=gen, device=dev)
    w = torch.rand(K, generator=gen, device=dev) + 0.1
    w[:zero_rows] = 0.0
    w /= w.sum()
    m = (torch.rand(K, n, generator=gen, device=dev) < 0.6).float()
    if zero_rows:
        # columns 0:256 are covered only by the zero-weight clients
        m[:, :256] = 0.0
        m[:zero_rows, :256] = 1.0
    m[:, -128:] = 0.0                         # uncovered tail -> fallback
    mu = torch.randint(1, 4, (K, n), generator=gen, device=dev).float() * m
    fb = torch.randn(n, generator=gen, device=dev)
    return x, w, m, mu, fb


def stream(ops, n, K, kc, x, w, m=None, mu=None, fb=None, renorm=True):
    acc = ops.PlaneAccumulator(n, device=x.device)
    for lo in range(0, K, kc):
        hi = min(lo + kc, K)
        acc.update(x[lo:hi], w[lo:hi],
                   masks=None if m is None else m[lo:hi],
                   mult=None if mu is None else mu[lo:hi])
    return acc.finish(renorm=renorm, fallback=fb)


def kernel_phase(dev, P: int, errs: Errors):
    """Correctness everywhere; timings at the main path's shapes."""
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.fedavg import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)

    # -- the corners: lane-odd P, every chunking, the w = 0 corner
    for n, zero_rows in ((1000, 0), (1_000_003, 0), (1_000_003, 5)):
        x, w, m, mu, fb = cohort_inputs(K_MAIN, n, gen, dev,
                                        zero_rows=zero_rows)
        scale = float(x.abs().max()) * float(w.abs().sum())
        tag = f"P={n} zero_rows={zero_rows}"
        plain_f = ref.weighted_sum_ref(x, w)
        plain_c = ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb)
        plane_f = ops.plane_agg(x, w)
        plane_c = ops.plane_agg(x, w, masks=m, mult=mu, fallback=fb)
        errs.hold("weighted_sum", plane_f, plain_f, scale, tag)
        errs.hold("plane_agg", plane_c, plain_c, scale, tag + " m,mu,fb")
        plain_m = ref.plane_agg_ref(x, w, masks=m, renorm=False)
        errs.hold("plane_agg", ops.plane_agg(x, w, masks=m, renorm=False),
                  plain_m, scale, tag + " m no-renorm")
        for kc in (1, 2, K_MAIN - 1, K_MAIN):
            s_f = stream(ops, n, K_MAIN, kc, x, w, renorm=False)
            s_c = stream(ops, n, K_MAIN, kc, x, w, m, mu, fb)
            errs.hold("plane_accum", s_f, plain_f, scale,
                      f"{tag} kc={kc} filler vs plain")
            errs.hold("plane_finish", s_c, plain_c, scale,
                      f"{tag} kc={kc} coverage vs plain")
            errs.hold("plane_accum", s_c, plane_c, scale,
                      f"{tag} kc={kc} stream == plane")
        # the functional faces of the streaming pair
        z = torch.zeros(n, device=dev)
        trip = ops.plane_accum(z, z, z, x, w, masks=m, mult=mu)
        want = ref.plane_accum_ref(z, z, z, x, w, m, mu)
        for got, exp in zip(trip, want):
            errs.hold("plane_accum", got, exp, scale, tag + " functional")
        errs.hold("plane_finish", ops.plane_finish(*trip, fallback=fb),
                  ref.plane_finish_ref(*want, fb), scale,
                  tag + " functional")
        errs.hold("plane_finish",
                  fk.plane_finish_2d(*[t[None] for t in trip], fb[None],
                                     renorm=False)[0],
                  ref.plane_finish_ref(*want, fb, renorm=False), scale,
                  tag + " fb no-renorm")
        del x, w, m, mu, fb

    # -- the main path's shapes: K = 20 rows of the full-width plane
    x, w, m, mu, fb = cohort_inputs(K_MAIN, P, gen, dev)
    scale = float(x.abs().max()) * float(w.abs().sum())
    errs.hold("weighted_sum", ops.plane_agg(x, w),
              ref.weighted_sum_ref(x, w), scale, f"P={P} K=20")
    want_c = ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb)
    errs.hold("plane_agg", ops.plane_agg(x, w, masks=m, mult=mu,
                                         fallback=fb),
              want_c, scale, f"P={P} K=20 m,mu,fb")
    errs.hold("plane_accum", stream(ops, P, K_MAIN, 16, x, w, renorm=False),
              ref.weighted_sum_ref(x, w), scale, f"P={P} kc=16 filler")
    errs.hold("plane_finish", stream(ops, P, K_MAIN, 16, x, w, m, mu, fb),
              want_c, scale, f"P={P} kc=16 coverage")
    del want_c
    torch.cuda.empty_cache()

    # -- times: the kernel, the op that wraps it as the engine calls it,
    # the plain version, and one library call where there is one
    rate = hbm_rate(torch.cuda.get_device_name(0))
    acc = [torch.zeros(1, P, device=dev) for _ in range(3)]
    op_acc = ops.PlaneAccumulator(P, device=dev)
    fb2 = fb[None]
    rows = {}

    def row(name, kernel_fn, op_fn, plain_fn, nbytes, flops,
            library_fn=None):
        ms = cuda_ms(kernel_fn)
        op_ms = cuda_ms(op_fn)
        plain_ms = cuda_ms(plain_fn)
        lib_ms = cuda_ms(library_fn) if library_fn is not None else None
        bytes_ms = nbytes / rate * 1e3
        flops_ms = flops / F32_FLOPS_PER_S * 1e3
        rows[name] = {"ms": ms, "op_ms": op_ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, flops_ms),
                      "bound_by": ("bytes" if bytes_ms >= flops_ms
                                   else "operations"),
                      "library_ms": lib_ms, "bytes": nbytes, "flops": flops}
        print(f"  time {name:30s} kernel={ms:.4f} op={op_ms:.4f} "
              f"plain={plain_ms:.4f} bound={rows[name]['bound_ms']:.4f} ms"
              + (f" library={lib_ms:.4f} ms" if lib_ms is not None else ""))

    col = P * 4                                  # one f32 row of the plane
    x16, w16 = x[:16], w[:16].contiguous()
    x4, w4 = x[16:], w[16:].contiguous()
    m16, mu16 = m[:16], mu[:16]
    row("weighted_sum K=20",
        lambda: fk.weighted_sum_2d(x, w),
        lambda: ops.plane_agg(x, w),
        lambda: ref.weighted_sum_ref(x, w),
        K_MAIN * col + col, 2 * K_MAIN * P, lambda: w @ x)
    row("plane_agg K=20 m,mu,fb",
        lambda: fk.plane_agg_2d(x, w, m, mu, fb),
        lambda: ops.plane_agg(x, w, masks=m, mult=mu, fallback=fb),
        lambda: ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb),
        3 * K_MAIN * col + 2 * col, 6 * K_MAIN * P + 2 * P)
    row("plane_accum filler kc=16",
        lambda: fk.plane_accum_2d(*acc, x16, w16),
        lambda: op_acc.update(x16, w16),
        lambda: ref.plane_accum_ref(*acc, x16, w16),
        16 * col + 6 * col, 4 * 16 * P + 3 * P)
    row("plane_accum filler kc=4",
        lambda: fk.plane_accum_2d(*acc, x4, w4),
        lambda: op_acc.update(x4, w4),
        lambda: ref.plane_accum_ref(*acc, x4, w4),
        4 * col + 6 * col, 4 * 4 * P + 3 * P)
    row("plane_accum coverage kc=16",
        lambda: fk.plane_accum_2d(*acc, x16, w16, m16, mu16),
        lambda: op_acc.update(x16, w16, masks=m16, mult=mu16),
        lambda: ref.plane_accum_ref(*acc, x16, w16, m16, mu16),
        3 * 16 * col + 6 * col, 6 * 16 * P + 3 * P)
    row("plane_finish renorm+fb",
        lambda: fk.plane_finish_2d(*acc, fb2, renorm=True),
        lambda: op_acc.finish(fallback=fb),
        lambda: ref.plane_finish_ref(*acc, fb2, renorm=True),
        5 * col, 3 * P)
    print(json.dumps({"kernel_variants": rows, "P": P,
                      "hbm_bytes_per_s": rate,
                      "f32_flops_per_s": F32_FLOPS_PER_S}))
    del x, w, m, mu, fb, acc, op_acc, x16, x4, m16, mu16
    torch.cuda.empty_cache()
    return rows


def paper_cohort():
    """The main path's cohort: the paper's 20 clients at full VGG width
    on synth-easy (4000 train samples, 20% per round, batch 64), and the
    run config of its fedadp protocol."""
    from repro_torch.configs.vgg_family import paper_client_archs, vgg
    from repro_torch.data import (EASY, ClientSampler, image_classification,
                                  iid_partition)
    from repro_torch.fl import FLRunConfig

    cfgs = [vgg(a) for a in paper_client_archs()]
    n_train = 4000
    data = image_classification(EASY, n_train, seed=0)
    test = image_classification(EASY, 800, seed=999)
    parts = iid_partition(n_train, len(cfgs), seed=0)

    def samplers():
        return [ClientSampler(data, p, round_fraction=0.2, batch_size=64,
                              seed=i) for i, p in enumerate(parts)]

    def run_cfg(layout, agg_mode, rounds):
        return FLRunConfig(method="fedadp", rounds=rounds, local_epochs=2,
                           lr=0.03, momentum=0.9, seed=0, eval_every=1,
                           agg_layout=layout, agg_mode=agg_mode)

    return cfgs, samplers, test, run_cfg


def main_path():
    """The paper's 20-client cohort at full width, one run per layout;
    returns per-kernel launch counts summed over the runs."""
    from repro_torch.core import VGGFamily
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch import tree as tu

    # a vmap over the convs that silently loops per client is a fault
    warnings.filterwarnings("error", message=".*batching rule.*")
    cfgs, samplers, test, run_cfg = paper_cohort()
    launches = dict.fromkeys(fk.KERNELS, 0)
    results = {}
    runs = (("auto", "filler", 2), ("stream", "coverage", 1),
            ("plane", "filler", 1), ("plane", "coverage", 1))
    for layout, agg_mode, rounds in runs:
        rc = run_cfg(layout, agg_mode, rounds)
        sim = Simulator(VGGFamily(), cfgs, samplers(), rc, test)
        fed = sim._build()
        engine = fed.backend.engine
        engine.timing = True
        records = []
        fed.callbacks.append(records.append)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        t0 = time.perf_counter()
        res = fed.run(torch.Generator().manual_seed(rc.seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fk.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        stats = engine.agg_stats()
        gleaves = tu.leaves(res["global_params"])
        finite = all(bool(torch.isfinite(t).all()) for t in gleaves)
        round_walls = [records[0]["wall_s"]] + [
            b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
        info = {
            "agg_layout": layout, "agg_mode": agg_mode, "rounds": rounds,
            "resolved_layout": stats["layout"], "k_chunk": stats["k_chunk"],
            "round_wall_s": round_walls, "run_wall_s": wall,
            "phase_stats": engine.phase_stats(), "agg_stats": stats,
            "history": res["history"], "final_acc": res["final_acc"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts, "P": engine.plane_spec.size}
        print(json.dumps({"main_path_run": info}))
        check(finite, f"{layout}/{agg_mode}: non-finite global params")
        check(all(math.isfinite(a) for a in res["history"]),
              f"{layout}/{agg_mode}: non-finite accuracy")
        check(len(gleaves) == engine.plane_spec.n_leaves,
              "global params do not match the union layout")
        # keep only the global model: the next run's peak memory is its own
        results[(layout, agg_mode)] = (res["global_params"], stats)
        del sim, fed, engine, res, gleaves
        torch.cuda.empty_cache()

    check(results[("auto", "filler")][1]["layout"] == "stream",
          "agg_layout='auto' did not resolve to 'stream' at K=20, full width")
    check(launches["plane_accum"] >= 2 and launches["plane_finish"] >= 1,
          f"streamed rounds did not launch the streaming pair: {launches}")
    check(launches["weighted_sum"] >= 1 and launches["plane_agg"] >= 1,
          f"whole-plane rounds did not launch their kernels: {launches}")
    # one coverage round, streamed and whole-plane: the same math on the
    # same data and init
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tu.leaves(results[("stream", "coverage")][0]),
        tu.leaves(results[("plane", "coverage")][0])))
    print(f"  stream vs plane coverage round: max |diff| of global params "
          f"= {diff:.3e} (tol 1e-4)")
    check(diff <= 1e-4, f"stream round != plane round: {diff}")
    return launches


def profile_rounds():
    """One warm round per layout under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import VGGFamily
    from repro_torch.fl import Simulator

    cfgs, samplers, test, run_cfg = paper_cohort()
    selected = list(range(len(cfgs)))
    for layout, agg_mode in (("auto", "filler"), ("plane", "coverage")):
        fed = Simulator(VGGFamily(), cfgs, samplers(),
                        run_cfg(layout, agg_mode, 2), test)._build()
        backend, engine = fed.backend, fed.backend.engine
        engine.timing = True
        state = backend.init_state(torch.Generator().manual_seed(0))
        state = backend.run_round(state, 0, selected)       # warm-up round
        torch.cuda.synchronize()
        engine.phase_stats(reset=True)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("fedadp_round"):
                state = backend.run_round(state, 1, selected)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        window = next(e.time_range for e in events
                      if e.name == "fedadp_round"
                      and e.device_type == DeviceType.CPU)
        # device activity: kernels, copies and sets — not the annotation's
        # own device-side span, which covers the whole window; an event
        # listed twice (same name and interval) counts once
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != "fedadp_round"
                  and not getattr(e, "is_user_annotation", False)]
        unique = {(e.name, e.time_range.start, e.time_range.end)
                  for e in device}
        spans = sorted((lo, hi) for _, lo, hi in unique)
        by_name = {}
        for name, lo, hi in unique:
            n_us = by_name.setdefault(name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += hi - lo
        busy_us, cur_lo, cur_hi = 0.0, None, None
        for lo, hi in spans:                 # union of device intervals
            lo, hi = max(lo, window.start), min(hi, window.end)
            if hi <= lo:
                continue
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    busy_us += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            busy_us += cur_hi - cur_lo
        window_us = window.end - window.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        print(json.dumps({"profile": {
            "agg_layout": layout, "agg_mode": agg_mode,
            "resolved_layout": engine.agg_stats()["layout"],
            "round_wall_s": wall, "train_s": engine.phase_stats()["train"],
            "window_s": window_us / 1e6,
            "device_events": len(device), "unique_device_events": len(unique),
            "device_event_s": sum(hi - lo for lo, hi in spans) / 1e6,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / window_us,
            "device_span_s": (spans[-1][1] - spans[0][0]) / 1e6,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "top": [{"name": name[:100], "count": c, "device_ms": us / 1e3}
                    for name, (c, us) in top[:25]]}}))
        del fed, backend, engine, state, prof
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm round per layout instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs.vgg_family import paper_client_archs, vgg
    from repro_torch.core import PlaneSpec, VGGFamily
    from repro_torch.device import strict_f32
    from repro_torch.kernels.fedavg import fedavg as fk

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    strict_f32(dev)
    t0 = time.perf_counter()
    print(f"built {fk.build().name} in {time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_rounds()
        print(card)
        return 0

    family = VGGFamily()
    union = family.union([vgg(a) for a in paper_client_archs()])
    P = PlaneSpec.from_tree(family.shapes(union)).size
    errs = Errors()
    print("kernel phase")
    rows = kernel_phase(dev, P, errs)
    print("main-path phase")
    launches = main_path()

    main_row = {"weighted_sum": ("weighted_sum K=20", 425),
                "plane_agg": ("plane_agg K=20 m,mu,fb", 403),
                "plane_accum": ("plane_accum filler kc=16", 265),
                "plane_finish": ("plane_finish renorm+fb", 363)}
    kernels = []
    for name in fk.KERNELS:
        variant, line = main_row[name]
        r = rows[variant]
        check(launches[name] > 0, f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{TPU_KERNELS}:{line}", "launches": launches[name],
            "max_abs_err": errs.max[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
