#!/usr/bin/env python3
"""Build and time the attention forwards at several key steps on one card.

    python3 tools/attn_fwd_variants.py                 # steps 16 .. 48
    python3 tools/attn_fwd_variants.py --steps 32,48

``flash_fwd_kernel`` (``flash_attention.cu``) and ``swa_prefill_kernel``
(``swa_attention.cu``) share their core, ``csrc/attn_fwd.cuh``, whose
key step (``ATTN_FWD_STEP``, keys of k and v a block takes at a time)
is a compile-time constant. For each step whose shared memory fits a
block, this builds both sources with nvcc (the flags of
``kernels/build.py`` plus ``-DATTN_FWD_STEP``, all builds started
together) into ``build/variants/``, prints ptxas's registers, shared
memory and spills of the forward kernels at hd = 128, holds each build
against the plain versions on a small case (2e-5 x the largest finite
|value|), and times it with CUDA events at the main paths' shapes:
``flash_fwd`` at the transformer cohort's (B 8, KV 2, G 16, S 2048,
hd 128, causal) and ``swa_prefill`` at the serve path's (B 4, KV 16,
G 2, S 4096, hd 128, window 1024; f32 and bf16). The builds run in
turns (first to last, then last to first) and each time is the mean of
the two turns. Each line of output is one JSON object; the card's name
and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.flash_attention import flash as ff  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.swa_attention import ref as sref  # noqa: E402
from repro_torch.kernels.swa_attention import swa as sk  # noqa: E402

SMEM_LIMIT = 232448           # bytes a block may use on the H100
TOL = 2e-5                    # x the largest finite |value|, card tests


def fwd_smem(step: int, hd: int = 128) -> int:
    """Shared memory of flash_fwd_kernel (attn_fwd.cuh's layout): q, two
    stages of k and v, the small parts of the tiles in use, positions."""
    ld = hd + 4
    return 4 * (128 * ld + 6 * step * ld) + 4 * (2 * step + 24)


def build(step: int, name: str) -> Path:
    from torch.utils.cpp_extension import CUDA_HOME

    out = ROOT / "build" / "variants" / f"lib{name}_step{step}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *kbuild.NVCC_FLAGS,
           f"-DATTN_FWD_STEP={step}", "-o", str(out),
           str(kbuild.source(name))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} step {step}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    return out


def ptxas(path: Path, pattern: str):
    lines, cur = [], None
    for line in path.with_suffix(".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "'" in line else line
            cur = cur if re.search(pattern, cur) else None
        elif cur and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return lines


def ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def scale_of(t) -> float:
    x = t.abs()
    x = x[x < 1e29]
    return max(1.0, float(x.max())) if x.numel() else 1.0


def flash_call(lib, q, k, v, qp, kp, window=0):
    B, KV, G, Sq, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], device=q.device)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
                       lse.data_ptr(), B, KV, G, Sq, k.shape[1], hd,
                       hd ** -0.5, 1, window,
                       torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_fwd launch failed ({rc})")
    return out, lse


def prefill_call(lib, q, k, v, window):
    B, KV, G, S, hd = q.shape
    out = torch.empty(q.shape, device=q.device)
    rc = lib.swa_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         int(q.dtype == torch.bfloat16), out.data_ptr(), B,
                         KV, G, S, hd, 1, window, hd ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"swa_prefill launch failed ({rc})")
    return out


def randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda")


def check(libs, gen):
    """Each variant vs the plain versions on small ragged cases."""
    fl, sw = libs
    q, k, v = randn(gen, 1, 2, 4, 300, 128), randn(gen, 1, 300, 2, 128), \
        randn(gen, 1, 300, 2, 128)
    qp = torch.arange(300, dtype=torch.int32, device="cuda")
    kp = qp.clone()
    qp[40:70] = -1                           # rows that see no key
    for window in (0, 50):
        out, lse = flash_call(fl, q, k, v, qp, kp, window)
        w_out, w_lse = fref.flash_fwd_ref(q, k, v, qp, kp, window=window,
                                          block_kv=300)
        for got, want in ((out, w_out), (lse, w_lse)):
            err = float((got - want).abs().max()) / scale_of(want)
            if not err <= TOL:
                raise AssertionError(f"flash_fwd window {window}: {err}")
    for dt in (torch.float32, torch.bfloat16):
        qs, ks, vs = (t.to(dt) for t in (q, k, v))
        got = prefill_call(sw, qs, ks, vs, 100)
        want = sref.prefill_ref(qs, ks, vs, window=100)
        err = float((got - want).abs().max()) / scale_of(want)
        if not err <= TOL:
            raise AssertionError(f"swa_prefill {dt}: {err}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="16,24,32,48")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}))
    steps = [s for s in map(int, args.steps.split(","))
             if fwd_smem(s) <= SMEM_LIMIT]
    with ThreadPoolExecutor(max_workers=2 * len(steps)) as pool:
        futs = {step: (pool.submit(build, step, "flash_attention"),
                       pool.submit(build, step, "swa_attention"))
                for step in steps}
        paths = {step: (a.result(), b.result()) for step, (a, b) in
                 futs.items()}
    libs = {}
    for step, (pf, ps) in paths.items():
        fl, sw = ctypes.CDLL(str(pf)), ctypes.CDLL(str(ps))
        ff._declare(fl)
        sk._declare(sw)
        libs[step] = (fl, sw)
        print(json.dumps({
            "step": step, "smem": fwd_smem(step),
            "ptxas_flash_fwd": ptxas(pf, r"flash_fwd_kernelILi128E"),
            "ptxas_swa_prefill": ptxas(ps, r"swa_prefill_kernelILi128E")}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for step in steps:
        check(libs[step], gen)
    # the main shapes
    B, KV, G, S, hd = 8, 2, 16, 2048, 128
    fq, fk, fv = randn(gen, B, KV, G, S, hd), randn(gen, B, S, KV, hd), \
        randn(gen, B, S, KV, hd)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    B2, KV2, G2, S2, W = 4, 16, 2, 4096, 1024
    sq, skk, sv = randn(gen, B2, KV2, G2, S2, hd), \
        randn(gen, B2, S2, KV2, hd), randn(gen, B2, S2, KV2, hd)
    sqb, skb, svb = (t.bfloat16() for t in (sq, skk, sv))
    times = {step: {"flash_fwd": 0.0, "swa_prefill": 0.0,
                   "swa_prefill_bf16": 0.0} for step in steps}
    for order in (steps, steps[::-1]):
        for step in order:
            fl, sw = libs[step]
            t = times[step]
            t["flash_fwd"] += ms(lambda: flash_call(fl, fq, fk, fv, pos,
                                                    pos)) / 2
            t["swa_prefill"] += ms(lambda: prefill_call(sw, sq, skk, sv,
                                                        W)) / 2
            t["swa_prefill_bf16"] += ms(lambda: prefill_call(
                sw, sqb, skb, svb, W)) / 2
    for step in steps:
        print(json.dumps({"step": step, "ms": times[step]}))
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
