#!/usr/bin/env python3
"""Where the unified engine's memory goes in one fedadp round of a
mixtral depth cohort, on the card.

    python3 tools/unified_memory_probe.py --experts 3 --k-chunk 1
    python3 tools/unified_memory_probe.py --experts 2 --trace
    python3 tools/unified_memory_probe.py --experts 2 --src DIR/src

The cohort is ``chip_smoke.py``'s depth cohort: mixtral-8x7b at its
published widths, 2 clients of 1 and 2 layers on ``--experts`` of the 8
experts (top-2), the 512-token vocabulary, S 2048, batch 2, 2 SGD steps,
fedadp filler, one round on ``engine="unified"`` (``--k-chunk`` clients
a chunk; default all). For each phase of the round (the engine's set-up,
each round start, local training, each accumulate, the finish) it prints
the memory allocated before, the peak within and the memory after, in GB
and in units of the union plane P (f32). A round that runs out of memory
is reported as such, with the phases before it. ``--trace`` records
every allocation (``torch.cuda.memory._record_memory_history``) and
prints the blocks live at the round's peak, grouped by the lines of the
port that allocated them (blocks the backward allocates carry no Python
line; they are grouped by size). ``--src`` runs the port found under
another tree's ``src`` (for example an unpacked ``git archive`` of an
earlier commit), with the kernels built from this one. The card's name
and power limit come first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GB = 1e9


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experts", type=int, default=3)
    ap.add_argument("--k-chunk", type=int, default=None)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("unified_memory_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import PlaneSpec, TransformerFamily, tfamily
    from repro_torch.data import ClientSampler, iid_partition
    from repro_torch.device import strict_f32
    from repro_torch.fl import FLRunConfig, Simulator
    from repro_torch.fl import engine as eng
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.fedavg import ops as kops

    kbuild.BUILD_DIR = ROOT / "build"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; the engine of {eng.__file__}")
    strict_f32(torch.device("cuda", 0))
    rows = []

    def measured(owner, name, tag):
        fn = getattr(owner, name)

        def inner(*a, **k):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rows.append((tag, before, torch.cuda.max_memory_allocated(),
                         torch.cuda.memory_allocated()))
            return out
        setattr(owner, name, inner)

    measured(eng.UnifiedEngine, "__post_init__", "engine set-up")
    measured(eng, "_fused_round_start", "round start")
    measured(eng.UnifiedEngine, "_train_packed", "local training")
    measured(kops.PlaneAccumulator, "update", "accumulate")
    measured(kops.PlaneAccumulator, "finish", "finish")

    S, batch, vocab, n = 2048, 2, 512, 16
    family = TransformerFamily()
    base = dataclasses.replace(get_config("mixtral-8x7b"), vocab_size=vocab,
                               n_layers=2)
    base = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=args.experts))
    cfgs = [tfamily.make_variant(base, n_units=u) for u in (1, 2)]
    P = PlaneSpec.from_tree(family.shapes(family.union(cfgs))).size
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, size=(n, S + 1)).astype(np.int32)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    test = {"tokens": toks[:4, :-1], "labels": toks[:4, 1:]}
    samplers = [ClientSampler(data, p, round_fraction=0.5, batch_size=batch,
                              seed=i)
                for i, p in enumerate(iid_partition(n, 2, seed=0))]
    rc = FLRunConfig(method="fedadp", rounds=1, local_epochs=1, lr=0.05,
                     momentum=0.0, seed=0, eval_every=1, engine="unified",
                     k_chunk=args.k_chunk)
    if args.trace:
        torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                                 stacks="python")
    t0 = time.perf_counter()
    status = "ran"
    try:
        fed = Simulator(family, cfgs, samplers, rc, test)._build()
        fed.run(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        status = "ran out of memory"
    print(f"{args.experts} experts (top-2), k_chunk {args.k_chunk}, P = {P}"
          f" ({P * 4 / GB:.3f} GB): {status} in "
          f"{time.perf_counter() - t0:.1f} s")
    for tag, before, peak, after in rows:
        print(f"  {tag:16s} before {before / GB:6.2f} GB "
              f"({before / (4 * P):5.2f} P), peak {peak / GB:6.2f} GB "
              f"({peak / (4 * P):5.2f} P), after {after / GB:6.2f} GB")
    if args.trace:
        trace(torch.cuda.memory._snapshot(), P)
        torch.cuda.memory._record_memory_history(enabled=None)
    print(card)
    return 0


def trace(snap, P: int) -> None:
    """The blocks live at the largest total of the recorded allocations,
    grouped by the port's lines that allocated them."""
    live, cur, best, at_best = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            cur += ev["size"]
            if cur > best:
                best, at_best = cur, dict(live)
        elif ev["action"] in ("free_requested", "free_completed"):
            if ev["addr"] in live:
                cur -= live.pop(ev["addr"])[0]
    groups = {}
    for size, frames in at_best.values():
        ours = [f for f in frames if "repro_torch" in f["filename"]]
        key = " < ".join(f"{os.path.basename(f['filename'])}:{f['line']} "
                         f"{f['name']}" for f in ours[:3])
        key = key or f"no Python line, {size / 2 ** 20:.0f} MiB blocks"
        count, total = groups.get(key, (0, 0))
        groups[key] = (count + 1, total + size)
    print(f"  live at the peak, {best / GB:.2f} GB ({best / (4 * P):.2f} P):")
    for key, (count, total) in sorted(groups.items(),
                                      key=lambda kv: -kv[1][1]):
        if total >= 0.01 * best:
            print(f"  {total / GB:7.3f} GB {total / (4 * P):5.2f} P "
                  f"x{count:4d}  {key}")


if __name__ == "__main__":
    sys.exit(main())
