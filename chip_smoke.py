#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the smoke test below
    python3 chip_smoke.py --profile    # where one VGG round's time goes

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, and builds the port's CUDA sources
   (``src/repro_torch/kernels/csrc/fedavg.cu``, ``flash_attention.cu``,
   ``swa_attention.cu`` and ``netchange.cu``, one nvcc each, started
   together).
2. fedavg kernel phase: holds each aggregation kernel (``weighted_sum``,
   ``plane_agg``, ``plane_accum``, ``plane_finish``) against its plain
   PyTorch version on the card — at the VGG main path's shapes (the plane
   of the paper's union VGG-19-Wider, P = 40,717,642, K = 20 clients,
   stream chunks of 16 and 4 rows), at a lane-odd P, at k_chunk in
   {1, 2, K-1, K}, on the w = 0 corner, and streamed == whole-plane —
   and times kernel, the op that wraps it as the engine calls it, the
   plain version, the bound and, where one PyTorch call computes the
   same function (``weighted_sum``: the GEMV ``w @ x``; the unmasked
   ``plane_accum``: ``num.addmv_(x.t(), w)``), that call. Then the same
   for this slice's kernels: ``plane_accum_q`` (int8 chunks with per-tile
   scales: plain, masks + mult and the fold, at the main path's 16- and
   4-row chunks, at a lane-odd N with an all-zero tile and tile 512),
   ``weighted_sum_masked`` and ``weighted_sum_masked_mult`` at K = 20,
   and ``plane_accum`` on a bf16 chunk.
3. VGG main path: the paper's 20-client fedadp round at full VGG width
   through ``FLRunConfig`` -> ``Simulator`` -> ``UnifiedEngine``:
   ``agg_layout="auto"`` (which resolves to the streaming layout), the
   streaming layout under ``agg_mode="coverage"``, then the whole-plane
   layout under "filler" and "coverage". The launch counts show that
   each kernel ran (``widen_2d`` too: NetChange's To-Wider at every
   round start); the streamed coverage round must equal the
   whole-plane coverage round; accuracies must be finite.
4. The compressed wire on the same cohort through the same entry points:
   (a) ``wire="int8"``, ``agg_layout="auto"``, filler, 2 rounds; (b)
   ``wire="bf16"``, filler, 1 round; (c) ``wire="int8"``,
   ``wire_sparse=True``, ``agg_mode="coverage"``, 1 round. Checks: the
   int8 round ships exactly 20 x (P + 4 ceil(P/256)) = 827,077,160
   bytes, bf16 exactly half of f32, the sparse wire >= 4x fewer;
   ``plane_accum_q`` launches twice per int8 round (``plane_accum``,
   on bf16 chunks, twice per bf16 round); finite results; and the
   round-1 identity: from the same init and data as the f32 run of 3,
   ``max |g_wire - (g_f32 - sum_k w_k e'_k)| <= 1e-4`` after round 1,
   e' the error-feedback residuals (``engine.wire_residuals()``).
5. ``fedavg_stacked`` at full width: the 20 clients' round-start models
   in the union VGG-19-Wider as a stacked tree (3.26 GB), with their
   coverage masks, multiplicity trees and the global model as the
   fallback, aggregated on the plane, stream and leaf layouts (unmasked,
   masks, masks + mult + fallback). The layouts must agree within the
   fedavg tolerance; the leaf layout launches ``weighted_sum`` /
   ``weighted_sum_masked`` / ``weighted_sum_masked_mult`` once per leaf.
6. Flash kernel phase: holds ``flash_fwd`` (out, lse), ``flash_bwd_dq``
   (dq) and ``flash_bwd_dkv`` (dk, dv) against the plain versions
   (``kernels/flash_attention/ref.py``) at the transformer main path's
   shapes (B = 4 clients x 2 sequences, 2 KV heads x 16 query heads,
   S = 2048, hd = 128, causal), at S = 1000 padded to 1024 with -1
   positions, with a 256-token window, with KV = 4, G = 1, and with query
   rows that see no key; times kernel, plain version, the bound and
   ``torch.nn.functional.scaled_dot_product_attention`` (forward, and its
   backward for the two backward kernels) at the main shapes.
7. Transformer main path: FedADP over a K = 4 cohort of glm4-9b at its
   published widths (d_model 4096, 32 query / 2 KV heads of 128, d_ff
   13696 and 6848 alternating, QKV bias, SwiGLU, RoPE) cut to 2 layers
   and a 512-token vocabulary, S = 2048, 2 sequences per client step,
   2 steps per round, SGD lr 0.05, through ``Simulator``:
   2 rounds with ``attn_backend="auto"`` (the flash kernels, one launch
   per layer per step for all 4 clients — the launch counts must say
   exactly that), a breakdown of one training step, then 1 round with
   ``"blockwise"`` from the same init and data (streamed 2 clients per
   chunk, ``k_chunk=2``: blockwise attention keeps its score blocks for
   the backward), whose global model must match the flash run's first
   round. Eval losses must be finite.
8. Serving kernel phase: holds ``swa_decode`` against its plain version
   (``kernels/swa_attention/ref.py``) on a partly written ring (W = 1024,
   q_pos 37), bf16 k/v, an odd S, a query that sees no slot (the mean of
   v), the serve path's local (ring) and global caches and the JAX
   benchmark's shape (S = 16384, window 1024); ``swa_prefill`` on the
   JAX tests' four cases, an odd S, bf16, full bidirectional, the serve
   shape (B = 4, KV = 16, G = 2, S = 4096, window 1024; also against
   ``flash_fwd`` with the same window) and its refusal of
   ``causal=False`` with a window; ``widen_2d`` at the JAX benchmark's
   shape and the transformer cohort's FFN widening (8192 x 6848 ->
   13696, duplicate and split, columns and rows), bit-equal to its plain
   version and to ``core.netchange.widen_in`` / ``widen_out``. Times
   kernel, op, plain version, bound, SDPA with the same mask (attention)
   or ``index_select`` (widen), and ``flash_fwd`` beside ``swa_prefill``.
9. Serve path: ``repro_torch.launch.serve.run("gemma3-27b", n_layers=12,
   batch=4, prompt_len=4096, gen=32)`` at the published widths, greedy.
   Its launch counts must be one ``swa_prefill`` per local layer and one
   ``flash_fwd`` per global layer in prefill, one ``swa_decode`` per
   layer per token. Prefill's last logits must match ``forward_hidden``
   of the prompt (flash kernels on every layer) within 2e-4 x
   max|logits|, the last step's those of prompt + generated tokens
   within 2e-3 x max|logits| (``tests/test_smoke_archs.py``'s
   tolerances); ``ops.decode_attention`` on a local (ring) and a global
   layer's real cache, after prefill and after the last step, must match
   the model's plain ``decode_attention`` within 1e-4
   (``tests/test_kernels.py``'s). Prints prefill s (and a warm second
   prefill), decode ms per token (the first step apart), the peak and the
   decode step's bound (every weight read once per token), and where one
   decode step's time goes (a local block, a global block, the
   vocabulary projection, the rest), each part beside its bound, and the
   host's time to enqueue one step.

``--profile`` instead traces one warm round of the streamed filler and
of the whole-plane coverage layout of the VGG path with ``torch.profiler``
and prints, per round, its wall time, training share, device time by
kernel name (summed event durations) and the device's busy share (the
union of device-activity intervals inside the round's window, over the
window).

Tolerance for a fedavg kernel vs its plain version: max |diff| <= 1e-6 *
max|x| * sum|w| (x the dequantized chunk for ``plane_accum_q``, or the
base row it folds in; for the den and cov buffers sum|w| and the row
count). Both sum the same <= 20 f32 products per coordinate, in
different orders (the kernel sequentially per column, the plain version
in the library's order), so they differ by a few f32 roundings of the
weighted sum, which is bounded by max|x| * sum|w|.

Tolerance for the wire's round-1 identity: 1e-4, the JAX package's
width-cohort tolerance, as for the streamed vs whole-plane round: the
two runs' training differs only by cuDNN's run-to-run summation order,
and the aggregation by f32 summation order.

Tolerance for a flash kernel vs its plain version: max |diff| <= 1e-4 *
the largest finite |value| of the plain version (at least 1). Both sum
the same f32 terms in different orders — 128 products per score, up to
2048 keys per softmax row and output entry, up to G * S = 32768 (query,
key) terms per dk/dv entry — and f32 reordering error grows as sqrt(n)
* 6e-8 typically and n * 6e-8 at worst, relative to the summed
magnitudes. Rows that see no key carry lse = -1e30 in both and must
match exactly.

Tolerance for ``swa_decode`` / ``swa_prefill`` vs their plain versions:
that of the flash kernels (1e-4 x the largest |value|), for the same
reason; ``widen_2d`` must be bit-equal (a gather times one f32 scale).

Tolerance for the flash round vs the blockwise round: max |diff| of the
global parameters <= 1e-4, the JAX package's width-cohort tolerance: the
two differ only in the attention's and the aggregation's f32 summation
order, carried through two SGD steps.

The ``kernels`` line lists all 13 CUDA kernels (the 12 TPU kernels;
``flash_bwd`` is two), each with its launches on its main path.

Any failure raises (exit code != 0). The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

K_MAIN = 20
REPS = 20
TOL = 1e-6
FLASH_TOL = 1e-4
TFFN_TOL = 1e-4
TPU_KERNELS = "src/repro/kernels/fedavg/fedavg.py"
SOURCE = "src/repro_torch/kernels/csrc/fedavg.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_TPU = {"flash_fwd": "src/repro/kernels/flash_attention/fwd.py:92",
             "flash_bwd_dq": "src/repro/kernels/flash_attention/bwd.py:146",
             "flash_bwd_dkv": "src/repro/kernels/flash_attention/bwd.py:160"}
# the transformer main path: K clients x batch sequences of S tokens, the
# glm4-9b attention geometry
TFFN = dict(K=4, batch=2, S=2048, n_per_client=8, n_layers=2, vocab=512)
FLASH_MAIN = dict(B=TFFN["K"] * TFFN["batch"], KV=2, G=16, S=TFFN["S"],
                  hd=128)
# the serve path: gemma3-27b at its published widths, 12 of 62 layers
SERVE = dict(arch="gemma3-27b", n_layers=12, batch=4, prompt_len=4096,
             gen=32)
SERVE_GEOM = dict(KV=16, G=2, hd=128, window=1024)   # gemma3-27b attention
# the JAX package's decode benchmark shape (benchmarks/kernels.py:54)
DECODE_BENCH = dict(B=1, KV=8, G=2, hd=128, S=16384, window=1024)
SERVE_PREFILL_TOL = 2e-4      # x max|logits|, tests/test_smoke_archs.py:74
SERVE_DECODE_TOL = 2e-3       # x max|logits|, tests/test_smoke_archs.py:79
SERVE_KERNEL_TOL = 1e-4       # tests/test_kernels.py:140
SWA_SOURCE = "src/repro_torch/kernels/csrc/swa_attention.cu"
SWA_TPU = {"swa_decode": "src/repro/kernels/swa_attention/decode.py:79",
           "swa_prefill": "src/repro/kernels/swa_attention/prefill.py:105"}
WIDEN_SOURCE = "src/repro_torch/kernels/csrc/netchange.cu"
WIDEN_TPU = "src/repro/kernels/netchange/widen.py:57"
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

    def hold(self, kernel: str, got, want, scale: float, what: str,
             tol_factor: float = TOL) -> None:
        err = float((got.float() - want.float()).abs().max())
        tol = tol_factor * scale
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


def time_row(rows, rate, name, kernel_fn, op_fn, plain_fn, nbytes, flops,
             library_fn=None):
    """Time one kernel variant: the kernel, the op that wraps it as the
    engine calls it, the plain version and, where one PyTorch call
    computes the same function, that call; the bound from the bytes the
    function must move and its f32 operations."""
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
    print(f"  time {name:32s} kernel={ms:.4f} op={op_ms:.4f} "
          f"plain={plain_ms:.4f} bound={rows[name]['bound_ms']:.4f} ms"
          + (f" library={lib_ms:.4f} ms" if lib_ms is not None else ""))


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

    def row(*args, **kw):
        time_row(rows, rate, *args, **kw)

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
        16 * col + 6 * col, 4 * 16 * P + 3 * P,
        lambda: acc[0][0].addmv_(x16.t(), w16))
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


def wire_kernel_phase(dev, P: int, errs: Errors):
    """This slice's kernels vs their plain versions: ``plane_accum_q``
    (int8 chunks: plain, masks + mult, fold) at the VGG main path's
    16- and 4-row chunks, at a lane-odd N with an all-zero tile and tile
    512; ``weighted_sum_masked[_mult]`` at K = 20; ``plane_accum`` on a
    bf16 chunk. Times at the main shapes, as ``kernel_phase``'s."""
    from repro_torch.core import quant
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.fedavg import ops, ref

    gen = torch.Generator(device=dev).manual_seed(2)

    def hold_q(tag, xq, s, w, tile, m=None, mu=None, base=None):
        """num within 1e-6 · max|x| · Σ|w| (x the dequantized chunk, or
        the base row it folds in), den within 1e-6 · Σ|w|, cov (sums of
        0/1) within 1e-6 · rows."""
        n = xq.shape[1]
        z = torch.zeros(n, device=dev)
        kw = dict(masks=m, mult=mu, base=base, tile=tile)
        got = ops.plane_accum_q(z, z, z, xq, s, w, **kw)
        want = ops.plane_accum_q(z, z, z, xq, s, w, use_kernel=False, **kw)
        big = float((xq.abs().amax(1).float() * s.amax(1)).max())
        if base is not None:
            big = max(big, float(base.abs().max()))
        wsum = float(w.abs().sum())
        for what, g, e, sc in zip(("num", "den", "cov"), got, want,
                                  (big * wsum, wsum, xq.shape[0])):
            errs.hold("plane_accum_q", g, e, sc, f"{tag} {what}")

    # -- the corners: lane-odd N, a straddling last tile, all-zero tile,
    # tile 512, rows at odd byte offsets
    for n, tile, kc in ((1_000_003, 512, 3), (1_000_003, 256, 16),
                        (4_097, 128, 4)):
        x, w, m, mu, fb = cohort_inputs(kc, n, gen, dev)
        x[:, :tile] = 0.0                    # an all-zero tile
        xq, s = quant.quantize(x, "int8", tile=tile)
        tag = f"N={n} tile={tile} kc={kc}"
        hold_q(tag + " plain", xq, s, w, tile)
        hold_q(tag + " m,mu", xq, s, w, tile, m, mu)
        hold_q(tag + " fold", xq, s, w, tile, m, base=fb)
        check(float(s[:, 0].abs().max()) == 0.0, "all-zero tile scale")
        del x, w, m, mu, fb, xq, s

    # -- the main shapes: K = 20 rows of the full-width plane
    x, w, m, mu, fb = cohort_inputs(K_MAIN, P, gen, dev)
    scale = float(x.abs().max()) * float(w.abs().sum())
    errs.hold("weighted_sum_masked", ops.weighted_sum_masked(x, w, m),
              ref.weighted_sum_masked_ref(x, w, m), scale, f"P={P} K=20")
    errs.hold("weighted_sum_masked",
              ops.weighted_sum_masked(x, w, m, renorm=False),
              ref.weighted_sum_masked_ref(x, w, m, renorm=False), scale,
              f"P={P} K=20 no-renorm")
    errs.hold("weighted_sum_masked_mult",
              ops.weighted_sum_masked(x, w, m, mult=mu),
              ref.weighted_sum_masked_ref(x, w, m, mult=mu), scale,
              f"P={P} K=20")
    tile = 256
    x16, w16, m16, mu16 = x[:16], w[:16].contiguous(), m[:16], mu[:16]
    x4, w4 = x[16:], w[16:].contiguous()
    xq16, s16 = quant.quantize(x16, "int8", tile=tile)
    xq4, s4 = quant.quantize(x4, "int8", tile=tile)
    hold_q(f"P={P} kc=16 plain", xq16, s16, w16, tile)
    hold_q(f"P={P} kc=4 plain", xq4, s4, w4, tile)
    hold_q(f"P={P} kc=16 m,mu", xq16, s16, w16, tile, m16, mu16)
    hold_q(f"P={P} kc=16 fold", xq16, s16, w16, tile, m16, base=fb)
    xb16 = x16.to(torch.bfloat16)
    z = torch.zeros(P, device=dev)
    bf_want = ref.plane_accum_ref(z, z, z, xb16, w16)
    bf_got = ops.PlaneAccumulator(P, device=dev).update(xb16,
                                                        w16).partials()
    wsum = float(w16.abs().sum())
    for what, g, e, sc in zip(("num", "den", "cov"), bf_got, bf_want,
                              (float(xb16.abs().max()) * wsum, wsum, 16)):
        errs.hold("plane_accum", g, e, sc, f"P={P} kc=16 bf16 chunk {what}")
    del bf_want, bf_got
    torch.cuda.empty_cache()

    # -- times at the main shapes
    rate = hbm_rate(torch.cuda.get_device_name(0))
    acc = [torch.zeros(1, P, device=dev) for _ in range(3)]
    op_q = ops.PlaneAccumulator(P, device=dev, q_tile=tile)
    op_f = ops.PlaneAccumulator(P, device=dev)
    base = fb[None]
    rows = {}
    col = P * 4
    nt = quant.n_tiles(P, tile)
    bufs = 6 * col                          # num, den, cov read + written

    def row(*args, **kw):
        time_row(rows, rate, *args, **kw)

    row("plane_accum_q filler kc=16",
        lambda: fk.plane_accum_q_2d(*acc, xq16, s16, w16, tile=tile),
        lambda: op_q.update_q(xq16, s16, w16),
        lambda: ref.plane_accum_q_ref(*acc, xq16, s16, w16, tile=tile),
        16 * P + 16 * nt * 4 + bufs, 5 * 16 * P + 3 * P)
    row("plane_accum_q filler kc=4",
        lambda: fk.plane_accum_q_2d(*acc, xq4, s4, w4, tile=tile),
        lambda: op_q.update_q(xq4, s4, w4),
        lambda: ref.plane_accum_q_ref(*acc, xq4, s4, w4, tile=tile),
        4 * P + 4 * nt * 4 + bufs, 5 * 4 * P + 3 * P)
    row("plane_accum_q coverage kc=16",
        lambda: fk.plane_accum_q_2d(*acc, xq16, s16, w16, m16, mu16,
                                    tile=tile),
        lambda: op_q.update_q(xq16, s16, w16, masks=m16, mult=mu16),
        lambda: ref.plane_accum_q_ref(*acc, xq16, s16, w16, m16, mu16,
                                      tile=tile),
        16 * P + 16 * nt * 4 + 2 * 16 * col + bufs, 7 * 16 * P + 3 * P)
    row("plane_accum_q fold kc=16",
        lambda: fk.plane_accum_q_2d(*acc, xq16, s16, w16, m16, None, base,
                                    tile=tile),
        lambda: op_q.update_q(xq16, s16, w16, masks=m16, base=fb),
        lambda: ref.plane_accum_q_ref(*acc, xq16, s16, w16, m16, None,
                                      base, tile=tile),
        16 * P + 16 * nt * 4 + 16 * col + col + bufs, 9 * 16 * P + 3 * P)
    row("weighted_sum_masked K=20",
        lambda: fk.weighted_sum_masked_2d(x, w, m),
        lambda: ops.weighted_sum_masked(x, w, m),
        lambda: ref.weighted_sum_masked_ref(x, w, m),
        2 * K_MAIN * col + col, 4 * K_MAIN * P + P)
    row("weighted_sum_masked_mult K=20",
        lambda: fk.weighted_sum_masked_mult_2d(x, w, m, mu),
        lambda: ops.weighted_sum_masked(x, w, m, mult=mu),
        lambda: ref.weighted_sum_masked_ref(x, w, m, mult=mu),
        3 * K_MAIN * col + col, 5 * K_MAIN * P + P)
    row("plane_accum bf16 kc=16",
        lambda: fk.plane_accum_2d(*acc, xb16, w16),
        lambda: op_f.update(xb16, w16),
        lambda: ref.plane_accum_ref(*acc, xb16, w16),
        16 * P * 2 + bufs, 4 * 16 * P + 3 * P)
    print(json.dumps({"wire_kernel_variants": rows, "P": P, "tile": tile,
                      "hbm_bytes_per_s": rate}))
    del x, w, m, mu, fb, acc, op_q, op_f, xq16, s16, xq4, s4, xb16, base
    del x16, x4, m16, mu16
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

    def run_cfg(layout, agg_mode, rounds, **wire):
        return FLRunConfig(method="fedadp", rounds=rounds, local_epochs=2,
                           lr=0.03, momentum=0.9, seed=0, eval_every=1,
                           agg_layout=layout, agg_mode=agg_mode, **wire)

    return cfgs, samplers, test, run_cfg


def after_round1(fed, fn):
    """Call ``fn(engine, global_after_round_1)`` inside the run, right
    after its first round (before round 2 overwrites what it reads)."""
    run_round = fed.backend.run_round

    def wrapped(state, r, selected):
        out = run_round(state, r, selected)
        if r == 0:
            fn(fed.backend.engine, out)
        return out
    fed.backend.run_round = wrapped


def main_path():
    """The paper's 20-client cohort at full width, one run per layout;
    returns per-kernel launch counts summed over the runs and the global
    model after round 1 of the ``auto`` filler run, packed, on the host
    (what the wire runs are held against)."""
    from repro_torch.core import VGGFamily, plane
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch import tree as tu

    # a vmap over the convs that silently loops per client is a fault
    warnings.filterwarnings("error", message=".*batching rule.*")
    cfgs, samplers, test, run_cfg = paper_cohort()
    launches = dict.fromkeys(fk.KERNELS + wk.KERNELS, 0)
    results = {}
    round1 = {}
    runs = (("auto", "filler", 2), ("stream", "coverage", 1),
            ("plane", "filler", 1), ("plane", "coverage", 1))
    for layout, agg_mode, rounds in runs:
        rc = run_cfg(layout, agg_mode, rounds)
        sim = Simulator(VGGFamily(), cfgs, samplers(), rc, test)
        fed = sim._build()
        engine = fed.backend.engine
        if (layout, agg_mode) == ("auto", "filler"):
            after_round1(fed, lambda eng, g: round1.setdefault(
                "g", plane.pack(g, eng.plane_spec).cpu()))
        engine.timing = True
        records = []
        fed.callbacks.append(records.append)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = fed.run(torch.Generator().manual_seed(rc.seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**fk.launch_counts(), **wk.launch_counts()}
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
    return launches, round1["g"]


def wire_path(g_f32):
    """The compressed wire on the paper's cohort through ``FLRunConfig``
    -> ``Simulator`` -> ``UnifiedEngine``: (a) int8, ``auto`` (stream,
    chunks of 16 + 4), filler, 2 rounds; (b) bf16, filler, 1 round; (c)
    int8 on the sparse coverage wire, 1 round. Checks the wire bytes,
    the launches, finite results, and the round-1 identity: from the
    same init and data the wire round's global equals the f32 round's
    (``g_f32``) minus ``Σ_k w_k e'_k``, e' the residuals after round 1
    (e = 0 before it). Returns the launch counts summed over the runs."""
    from repro_torch import tree as tu
    from repro_torch.core import VGGFamily, plane, quant
    from repro_torch.core.aggregation import subset_weights
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk

    cfgs, samplers, test, run_cfg = paper_cohort()
    launches = dict.fromkeys(fk.KERNELS + wk.KERNELS, 0)
    f32_bytes = None
    runs = (("a", dict(wire="int8"), "filler", 2),
            ("b", dict(wire="bf16"), "filler", 1),
            ("c", dict(wire="int8", wire_sparse=True), "coverage", 1))
    for tag, wire, agg_mode, rounds in runs:
        rc = run_cfg("auto", agg_mode, rounds, **wire)
        fed = Simulator(VGGFamily(), cfgs, samplers(), rc, test)._build()
        engine = fed.backend.engine
        engine.timing = True
        records = []
        fed.callbacks.append(records.append)
        ident = {}

        def identity(eng, g, ident=ident):
            w = torch.as_tensor(subset_weights(eng.n_samples),
                                device=eng.device)
            corr = w @ eng.wire_residuals()        # Σ_k w_k e'_k
            gw = plane.pack(g, eng.plane_spec)
            ident["err"] = float((gw - (g_f32.to(gw.device) - corr)
                                  ).abs().max())
            ident["max_abs_residual"] = float(
                eng.wire_residuals().abs().max())
        if agg_mode == "filler":
            after_round1(fed, identity)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = fed.run(torch.Generator().manual_seed(rc.seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**fk.launch_counts(), **wk.launch_counts()}
        for k, v in counts.items():
            launches[k] += v
        ws = engine.wire_stats()
        round_walls = [records[0]["wall_s"]] + [
            b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
        info = {"run": tag, **wire, "agg_mode": agg_mode, "rounds": rounds,
                "resolved_layout": engine.agg_stats()["layout"],
                "k_chunk": engine.agg_stats()["k_chunk"],
                "round_wall_s": round_walls, "run_wall_s": wall,
                "phase_stats": engine.phase_stats(),
                "agg_stats": engine.agg_stats(), "wire_stats": ws,
                "wire_bytes_records": [r.get("wire_bytes") for r in records],
                "history": res["history"],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "launches": counts, "round1_identity": ident}
        print(json.dumps({"wire_run": info}))
        gleaves = tu.leaves(res["global_params"])
        check(all(bool(torch.isfinite(t).all()) for t in gleaves),
              f"wire run {tag}: non-finite global params")
        check(all(math.isfinite(a) for a in res["history"]),
              f"wire run {tag}: non-finite accuracy")
        check(engine.agg_stats()["layout"] == "stream",
              f"wire run {tag} did not stream")
        check(all(r.get("wire_bytes") == ws["bytes_per_round"]
                  for r in records), f"wire run {tag}: record wire_bytes")
        f32_bytes = ws["f32_bytes"]
        if tag == "a":
            # 20 x (P + 4 ceil(P / 256)): 827,077,160 at P = 40,717,642
            want = len(cfgs) * quant.payload_nbytes(
                "int8", engine.plane_spec.size, tile=rc.wire_tile)
            check(ws["bytes_per_round"] == want,
                  f"int8 wire bytes {ws['bytes_per_round']} != {want}")
            check(counts["plane_accum_q"] == 2 * rounds
                  and counts["plane_accum"] == 0,
                  f"int8 rounds: launches {counts}")
        elif tag == "b":
            check(2 * ws["bytes_per_round"] == f32_bytes
                  and ws["reduction"] == 2.0, f"bf16 wire bytes {ws}")
            check(counts["plane_accum"] == 2 * rounds
                  and counts["plane_accum_q"] == 0,
                  f"bf16 round: launches {counts}")
        else:
            check(ws["reduction"] >= 4.0, f"sparse wire reduction {ws}")
            check(counts["plane_accum_q"] == 2 * rounds
                  and counts["plane_finish"] == rounds,
                  f"sparse coverage round: launches {counts}")
        if agg_mode == "filler":
            print(f"  wire {tag} round-1 identity: max |g_wire - (g_f32 - "
                  f"sum_k w_k e'_k)| = {ident['err']:.3e} (tol 1e-4)")
            check(ident["err"] <= 1e-4,
                  f"wire run {tag}: round-1 identity off by {ident['err']}")
        del fed, engine, res, gleaves
        free_device()
    return launches


def stacked_path(dev):
    """``fedavg_stacked`` at full width: the 20 clients' round-start
    models in the union VGG-19-Wider as a stacked ``(20, ...)`` tree with
    their coverage masks, multiplicity trees and the global model as the
    fallback, aggregated on the plane, stream and leaf layouts —
    unmasked, with masks, and with masks + mult + fallback. The three
    layouts must agree within the fedavg tolerance; the leaf layout
    launches one kernel per leaf. Returns the launch counts."""
    from repro_torch import tree as tu
    from repro_torch.core import VGGFamily, plane
    from repro_torch.core import aggregation as agg
    from repro_torch.fl import UnifiedEngine
    from repro_torch.kernels.fedavg import fedavg as fk

    cfgs = paper_cohort()[0]
    n = [200] * len(cfgs)
    engine = UnifiedEngine(VGGFamily(), cfgs, n, agg_mode="coverage",
                           device=dev)
    spec = engine.plane_spec
    gp = engine.init_global(torch.Generator().manual_seed(0))
    ks = list(range(len(cfgs)))
    seeds = [engine._round_seed(0, k) for k in ks]

    def tree_of(rows):
        """A contiguous stacked tree from a (20, P) plane (then freed)."""
        out = tu.tree_map(lambda t: t.contiguous(),
                          plane.unpack_stacked(rows, spec))
        del rows
        return out

    stacked = tree_of(engine._round_start_width(gp, None, 0))
    masks = tree_of(torch.stack([engine._client_cov_row(k, s)
                                 for k, s in zip(ks, seeds)]))
    mult = tree_of(torch.stack([engine._client_mult_row(k, s)
                                for k, s in zip(ks, seeds)]))
    del engine
    free_device()
    w = agg.subset_weights(n)
    scale = max(float(t.abs().max()) for t in tu.leaves(stacked)) * \
        float(np.abs(w).sum())
    launches = dict.fromkeys(fk.KERNELS, 0)
    modes = (("unmasked", {}, "weighted_sum"),
             ("masks", dict(masks=masks), "weighted_sum_masked"),
             ("masks,mult,fb", dict(masks=masks, mult=mult, fallback=gp),
              "weighted_sum_masked_mult"))
    info = {"P": spec.size, "leaves": spec.n_leaves, "layouts": {}}
    for mode, kw, leaf_kernel in modes:
        outs = {}
        for layout in ("plane", "stream", "leaf"):
            fk.reset_launch_counts()
            out, t, peak = _synced(lambda: agg.fedavg_stacked(
                stacked, w, layout=layout, **kw))
            counts = fk.launch_counts()
            for k, v in counts.items():
                launches[k] += v
            outs[layout] = out
            info["layouts"][f"{mode}/{layout}"] = {
                "s": t, "peak_bytes": peak, "launches": counts,
                "stats": agg.last_agg_stats()}
            print(f"  fedavg_stacked {mode:14s} {layout:6s} {t:.4f} s "
                  f"peak {peak / 1e9:.2f} GB launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
        check(info["layouts"][f"{mode}/leaf"]["launches"][leaf_kernel]
              == spec.n_leaves,
              f"leaf layout ({mode}) did not launch {leaf_kernel} once per "
              f"leaf")
        for layout in ("stream", "leaf"):
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(tu.leaves(outs["plane"]),
                                       tu.leaves(outs[layout])))
            info["layouts"][f"{mode}/{layout}"]["vs_plane"] = diff
            print(f"  fedavg_stacked {mode:14s} {layout} vs plane: "
                  f"max |diff| {diff:.3e} (tol {TOL * scale:.3e})")
            check(diff <= TOL * scale,
                  f"fedavg_stacked {mode} {layout} != plane: {diff}")
        check(all(bool(torch.isfinite(t).all())
                  for t in tu.leaves(outs["plane"])),
              f"fedavg_stacked {mode}: non-finite")
        del outs, out
        free_device()
    print(json.dumps({"fedavg_stacked": info}))
    del stacked, masks, mult, gp
    free_device()
    return launches


# ------------------------------------------------------------ flash
def finite_scale(t) -> float:
    """The largest finite |value| (rows that see no key carry lse =
    -1e30 and are held exactly instead), at least 1."""
    a = t.abs()
    a = a[a < 1e29]
    return max(1.0, float(a.max())) if a.numel() else 1.0


def flash_case(dev, gen, errs, tag, *, B, KV, G, Sq, Sk, hd, causal=True,
               window=0, qp=None, kp=None):
    """Kernels vs plain versions on one shape; returns the operands."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref

    if qp is None:
        qp = torch.arange(Sq, dtype=torch.int32, device=dev)
    if kp is None:
        kp = torch.arange(Sk, dtype=torch.int32, device=dev)
    q = torch.randn(B, KV, G, Sq, hd, generator=gen, device=dev)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev)
    dout = torch.randn(B, KV, G, Sq, hd, generator=gen, device=dev)
    kw = dict(causal=causal, window=window)
    out, lse = ff.flash_fwd(q, k, v, qp, kp, **kw)
    delta = (dout * out).sum(-1)
    dq = ff.flash_bwd_dq(q, k, v, qp, kp, lse, delta, dout, **kw)
    dk, dv = ff.flash_bwd_dkv(q, k, v, qp, kp, lse, delta, dout, **kw)
    torch.cuda.synchronize()
    bk = 128 if Sk % 128 == 0 else Sk
    w_out, w_lse = fref.flash_fwd_ref(q, k, v, qp, kp, block_kv=bk, **kw)
    w_dq, w_dk, w_dv = fref.flash_bwd_ref(q, k, v, qp, kp, w_out, w_lse,
                                          dout, block_kv=bk, **kw)
    for name, got, want, what in (
            ("flash_fwd", out, w_out, "out"), ("flash_fwd", lse, w_lse, "lse"),
            ("flash_bwd_dq", dq, w_dq, "dq"), ("flash_bwd_dkv", dk, w_dk, "dk"),
            ("flash_bwd_dkv", dv, w_dv, "dv")):
        errs.hold(name, got, want, finite_scale(want), f"{tag} {what}",
                  FLASH_TOL)
    dead = w_lse <= -1e29                 # rows that see no key
    check(bool((lse[dead] == w_lse[dead]).all()),
          f"{tag}: lse of rows that see no key differs")
    print(f"  {'':12s} {tag}: {int(dead.sum())} (row, head) entries see "
          f"no key")
    return q, k, v, dout, qp, kp, out, lse, delta


def flash_kernel_phase(dev, errs: Errors):
    """The flash kernels vs their plain versions in every case; times at
    the transformer main path's shapes."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref

    gen = torch.Generator(device=dev).manual_seed(1)
    m = FLASH_MAIN
    # -- the corners first, the main shapes last (kept for the timings)
    pad = torch.arange(1024, dtype=torch.int32, device=dev)
    pad[1000:] = -1                       # S = 1000 block-padded to 1024
    flash_case(dev, gen, errs, "S=1000 padded to 1024", B=2, KV=2, G=16,
               Sq=1024, Sk=1024, hd=128, qp=pad, kp=pad)
    flash_case(dev, gen, errs, "window=256", B=2, KV=2, G=16, Sq=2048,
               Sk=2048, hd=128, window=256)
    flash_case(dev, gen, errs, "KV=4 G=1", B=2, KV=4, G=1, Sq=2048, Sk=2048,
               hd=128)
    dead_q = torch.arange(1024, dtype=torch.int32, device=dev)
    dead_q[100:228] = -1                  # query rows that see no key
    dead_k = torch.arange(1024, dtype=torch.int32, device=dev)
    dead_k[:3] = -1
    flash_case(dev, gen, errs, "rows with no key", B=1, KV=2, G=16,
               Sq=1024, Sk=1024, hd=128, qp=dead_q, kp=dead_k)
    torch.cuda.empty_cache()
    q, k, v, dout, qp, kp, out, lse, delta = flash_case(
        dev, gen, errs, "main B=8 KV=2 G=16 S=2048", B=m["B"], KV=m["KV"],
        G=m["G"], Sq=m["S"], Sk=m["S"], hd=m["hd"])

    # -- times at the main shapes: kernel, plain version, bound, library
    B, KV, G, S, hd = m["B"], m["KV"], m["G"], m["S"], m["hd"]
    H = KV * G
    rate = hbm_rate(torch.cuda.get_device_name(0))
    pairs = int(fref._block_mask(qp, kp, True, 0).sum()) * B * H
    f32 = 4
    qb, kb, rowb = B * H * S * hd * f32, B * KV * S * hd * f32, B * H * S * f32
    posb = 2 * S * 4
    work = {   # (bytes moved, products of hd-long dot products per pair)
        "flash_fwd": (2 * qb + 2 * kb + rowb + posb, 2),
        "flash_bwd_dq": (3 * qb + 2 * kb + 2 * rowb + posb, 3),
        "flash_bwd_dkv": (2 * qb + 4 * kb + 2 * rowb + posb, 4)}
    qh = q.reshape(B, H, S, hd)            # head h = kv * G + g: SDPA's GQA
    kh = k.permute(0, 2, 1, 3).contiguous()
    vh = v.permute(0, 2, 1, 3).contiguous()
    doh = dout.reshape(B, H, S, hd)
    qg, kg, vg = (t.clone().requires_grad_() for t in (qh, kh, vh))
    oh = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        enable_gqa=True)
    sdpa_err = float((oh.detach() - out.reshape(B, H, S, hd)).abs().max())
    print(f"  SDPA forward vs flash_fwd: max |diff| {sdpa_err:.3e}")
    args = (q, k, v, qp, kp, lse, delta, dout)
    timers = {
        "flash_fwd": (lambda: ff.flash_fwd(q, k, v, qp, kp),
                      lambda: fref.flash_fwd_ref(q, k, v, qp, kp),
                      lambda: F.scaled_dot_product_attention(
                          qh, kh, vh, is_causal=True, enable_gqa=True)),
        "flash_bwd_dq": (lambda: ff.flash_bwd_dq(*args),
                         lambda: fref.flash_bwd_ref(q, k, v, qp, kp, out,
                                                    lse, dout),
                         lambda: torch.autograd.grad(oh, (qg, kg, vg), doh,
                                                     retain_graph=True)),
    }
    timers["flash_bwd_dkv"] = (lambda: ff.flash_bwd_dkv(*args),
                               *timers["flash_bwd_dq"][1:])
    rows = {}
    plain_cache = {}
    for name, (kern, plain, lib) in timers.items():
        nbytes, products = work[name]
        flops = 2 * hd * products * pairs
        ms = cuda_ms(kern, reps=5)
        # the two backward kernels share one plain version and one
        # library call (each computes dq, dk and dv together)
        key = id(plain) if name == "flash_fwd" else "bwd"
        if key not in plain_cache:
            plain_cache[key] = (cuda_ms(plain, reps=3), cuda_ms(lib, reps=5))
        plain_ms, lib_ms = plain_cache[key]
        bytes_ms = nbytes / rate * 1e3
        flops_ms = flops / F32_FLOPS_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, flops_ms),
                      "bound_by": ("bytes" if bytes_ms >= flops_ms
                                   else "operations"),
                      "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
                      "tflops_per_s": flops / ms / 1e9}
        print(f"  time {name:14s} kernel={ms:.3f} plain={plain_ms:.3f} "
              f"bound={rows[name]['bound_ms']:.3f} ms "
              f"({rows[name]['bound_by']}) library={lib_ms:.3f} ms "
              f"{rows[name]['tflops_per_s']:.2f} TFLOP/s")
    print(json.dumps({"flash_variants": rows, "shape": m,
                      "visible_pairs": pairs,
                      "f32_flops_per_s": F32_FLOPS_PER_S}))
    del q, k, v, dout, out, lse, delta, qh, kh, vh, doh, qg, kg, vg, oh
    del timers, args
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------- transformer path
def tffn_cohort():
    """The transformer main path's cohort: K clients alternating glm4-9b
    at full and half FFN width (``benchmarks/unified_bench.py``'s
    ``_tffn_cohort`` at the published widths), cut to 2 layers and the
    512-token seed vocabulary; token data from ``default_rng(0)``."""
    from repro_torch.configs import get_config
    from repro_torch.core import tfamily
    from repro_torch.data import ClientSampler, iid_partition
    from repro_torch.fl import FLRunConfig

    t = TFFN
    base = dataclasses.replace(get_config("glm4-9b"), n_layers=t["n_layers"],
                               vocab_size=t["vocab"])
    cfgs = [tfamily.make_variant(base, ffn_scale=0.5) if k % 2
            else tfamily.make_variant(base) for k in range(t["K"])]
    n = t["n_per_client"] * t["K"]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, base.vocab_size,
                        size=(n, t["S"] + 1)).astype(np.int32)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    test = {"tokens": toks[:4, :-1], "labels": toks[:4, 1:]}
    parts = iid_partition(n, t["K"], seed=0)

    def samplers():
        return [ClientSampler(data, p, round_fraction=0.5,
                              batch_size=t["batch"], seed=i)
                for i, p in enumerate(parts)]

    def run_cfg(attn_backend, rounds, k_chunk=None):
        return FLRunConfig(method="fedadp", rounds=rounds, local_epochs=1,
                           lr=0.05, momentum=0.0, seed=0, eval_every=1,
                           attn_backend=attn_backend, k_chunk=k_chunk)

    return cfgs, samplers, test, run_cfg, data


def free_device():
    """Drop what the last run left: the run hooks make reference cycles
    (backend -> hook -> bound method -> backend), so collect them before
    returning the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def _synced(fn):
    """(fn(), seconds, peak bytes allocated while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def step_breakdown(engine, state, data, kernel_ms):
    """One local-training step of the whole cohort taken apart, each
    piece timed between synchronisations: the host build and upload of
    the E Eᵀ segment matrices, the round start, ``vmap(grad)`` (of which
    the flash kernels' share is launches x their kernel-phase time), the
    E Eᵀ projection, and pack + mask + SGD update, with the peak device
    memory of each."""
    from torch.func import vmap

    from repro_torch import tree as tu
    from repro_torch.core import plane
    from repro_torch.core import segments as sg
    from repro_torch.kernels.flash_attention import flash as ff

    K, b = TFFN["K"], TFFN["batch"]
    ks = list(range(K))
    seeds = [engine._round_seed(99, k) for k in ks]
    mats, t_seg_host, _ = _synced(
        lambda: [engine._client_seg(k, s) for k, s in zip(ks, seeds)])
    seg_mats, t_seg_copy, m_seg = _synced(
        lambda: sg.stack_matrices(mats, engine.device))
    del mats
    sp, t_start, m_start = _synced(
        lambda: engine._round_start_width(state, None, 99))
    masks = engine._mask_views(ks)
    bt = {key: torch.as_tensor(v[:K * b].reshape(K, b, -1),
                               device=engine.device)
          for key, v in data.items()}
    gf = engine.family.loss_and_grad(engine.global_cfg)
    grads_fn = vmap(lambda p, x: gf(p, x)[1])
    ff.reset_launch_counts()
    grads, t_grad, m_grad = _synced(
        lambda: grads_fn(plane.unpack_stacked(sp, engine.plane_spec), bt))
    launches = ff.launch_counts()
    proj, t_proj, m_proj = _synced(
        lambda: sg.project_stacked(grads, engine._seg_axes, seg_mats))
    del grads

    def pack_mask_update():
        gp = plane.pack_stacked(proj, engine.plane_spec)
        for row, m in zip(gp, masks):
            row.mul_(m)
        engine._opt.update(gp, {}, sp, 0)

    _, t_update, m_update = _synced(pack_mask_update)
    attn_s = sum(launches[k] * kernel_ms[k] for k in launches) / 1e3
    # E Eᵀ along each widened axis a of a leaf: a (U, U) matrix times
    # every fiber along a, per client
    proj_flops = 0
    for path, axes in engine._axes_map.items():
        shape = tuple(tu.get(engine._gshapes, path).shape)
        for a in axes:
            proj_flops += 2 * K * int(np.prod(shape)) * shape[a]
    # the dense stack's matmuls, forward (2) and backward (4) per weight
    # per token; attention's own products are the flash kernels'
    cfg = engine.global_cfg
    hd = cfg.resolved_head_dim
    weights = cfg.n_layers * (2 * cfg.d_model * cfg.n_heads * hd
                              + 2 * cfg.d_model * cfg.n_kv_heads * hd
                              + 3 * cfg.d_model * cfg.d_ff)
    weights += cfg.d_model * cfg.vocab_size
    matmul_flops = 6 * K * b * TFFN["S"] * weights
    info = {"seg_matrices_host_s": t_seg_host,
            "seg_matrices_upload_s": t_seg_copy,
            "seg_matrices_bytes": sum(
                int(m.numel()) * 4 for m in {id(m): m for ms in
                                             seg_mats.values()
                                             for m in ms}.values()),
            "round_start_s": t_start, "vmap_grad_s": t_grad,
            "flash_launches": launches, "flash_kernel_s": attn_s,
            "vmap_grad_other_s": t_grad - attn_s,
            "dense_matmul_flops": matmul_flops,
            "segment_projection_s": t_proj,
            "segment_projection_flops": proj_flops,
            "pack_mask_update_s": t_update,
            "peak_bytes": {"seg_upload": m_seg, "round_start": m_start,
                           "vmap_grad": m_grad, "projection": m_proj,
                           "pack_mask_update": m_update}}
    print(json.dumps({"step_breakdown": info}))
    del sp, masks, seg_mats, proj, bt
    torch.cuda.empty_cache()
    return info


def tffn_run(attn_backend, rounds, keep_round1=False, k_chunk=None):
    """One Simulator run of the transformer cohort; returns (result,
    info, launch counts, round-1 global params on the CPU or None,
    engine)."""
    from repro_torch import tree as tu
    from repro_torch.core import TransformerFamily
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk

    cfgs, samplers, test, run_cfg, data = tffn_cohort()
    rc = run_cfg(attn_backend, rounds, k_chunk)
    fed = Simulator(TransformerFamily(), cfgs, samplers(), rc, test)._build()
    engine = fed.backend.engine
    engine.timing = True
    records = []
    fed.callbacks.append(records.append)
    round1 = {}
    if keep_round1:
        after_round1(fed, lambda _, out: round1.setdefault(
            "params", tu.tree_map(lambda t: t.detach().to("cpu", copy=True),
                                  out)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    ff.reset_launch_counts()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = fed.run(torch.Generator().manual_seed(rc.seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**ff.launch_counts(), **fk.launch_counts(),
              **wk.launch_counts()}
    steps = samplers()[0].steps_per_epoch() * rc.local_epochs
    round_walls = [records[0]["wall_s"]] + [
        b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
    info = {"attn_backend": attn_backend, "rounds": rounds,
            "steps_per_round": steps, "round_wall_s": round_walls,
            "run_wall_s": wall, "phase_stats": engine.phase_stats(),
            "agg_stats": engine.agg_stats(), "history": res["history"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts, "P": engine.plane_spec.size,
            "cache_stats": engine.cache_stats()}
    print(json.dumps({"tffn_run": info}))
    gleaves = tu.leaves(res["global_params"])
    check(all(bool(torch.isfinite(t).all()) for t in gleaves),
          f"{attn_backend}: non-finite global params")
    check(len(res["history"]) == rounds
          and all(math.isfinite(a) for a in res["history"]),
          f"{attn_backend}: non-finite eval loss {res['history']}")
    return res, info, counts, round1.get("params"), engine, data


def tffn_main_path(kernel_ms):
    """The transformer cohort: 2 flash rounds (the launch counts must be
    one per layer per step for the whole cohort), a step breakdown, then
    1 blockwise round from the same init and data."""
    from repro_torch import tree as tu

    t = TFFN
    res, info, counts, round1, engine, data = tffn_run("auto", 2,
                                                       keep_round1=True)
    L, K, rounds = t["n_layers"], t["K"], info["rounds"]
    steps = info["steps_per_round"]
    train = rounds * steps * L
    evals = len(info["history"]) * K * L  # one forward per client view
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == train,
          f"backward launches {counts} != {train} (rounds x steps x layers)")
    check(counts["flash_fwd"] == train + evals,
          f"forward launches {counts['flash_fwd']} != {train} + {evals}")
    check(counts["plane_accum"] == rounds,
          f"aggregation launches {counts}")
    check(info["agg_stats"]["layout"] == "stream",
          "agg_layout='auto' did not stream at full width")
    state = res["global_params"]
    del res
    free_device()
    breakdown = step_breakdown(engine, state, data, kernel_ms)
    del engine, state
    free_device()

    # the blockwise round streams the cohort 2 clients at a time: its
    # autograd keeps every (512 x 512) score block of both layers (≈ 17 GB
    # for 4 clients), which does not fit beside the 4-client plane. Per
    # client the round is the same; only the aggregation's summation
    # order differs (the streamed == whole-plane check of the VGG path)
    res_b, info_b, _, _, engine_b, _ = tffn_run("blockwise", 1, k_chunk=2)
    check(info_b["agg_stats"]["k_chunk"] == 2, "blockwise round not chunked")
    diff = max(float((a - b.cpu()).abs().max()) for a, b in zip(
        tu.leaves(round1), tu.leaves(res_b["global_params"])))
    print(f"  flash vs blockwise round 1: max |diff| of global params = "
          f"{diff:.3e} (tol {TFFN_TOL:g})")
    check(diff <= TFFN_TOL, f"flash round != blockwise round: {diff}")
    del res_b, engine_b
    free_device()
    return counts, {"flash": info, "blockwise": info_b,
                    "breakdown": breakdown, "flash_vs_blockwise": diff}


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


# ------------------------------------------------------ serving kernels
def decode_case(dev, gen, errs, tag, *, B, KV, G, hd, S, window, q_pos,
                kind="iota", dtype=torch.float32):
    """swa_decode vs its plain version on one cache; returns the
    operands. ``kind``: "iota" slots at positions 0..S-1, "ring" a ring
    of S slots after writing ``q_pos``, "late" every slot after q_pos
    (no slot visible)."""
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models.attention import ring_positions

    q = torch.randn(B, KV, G, hd, generator=gen, device=dev)
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
    kp = torch.arange(S, dtype=torch.int32, device=dev)
    if kind == "ring":
        kp = ring_positions(q_pos, S, device=dev).to(torch.int32)
    elif kind == "late":
        kp = kp + q_pos + 1
    got = sk.swa_decode(q, k, v, kp, q_pos, window=window)
    want = sref.decode_ref(q, k, v, kp, q_pos, window=window)
    errs.hold("swa_decode", got, want, finite_scale(want), tag, FLASH_TOL)
    if kind == "late":           # the reference's answer: the mean of v
        mean_v = v.float().mean(1)[:, :, None].expand_as(got)
        errs.hold("swa_decode", got, mean_v, finite_scale(mean_v),
                  tag + " == mean of v", FLASH_TOL)
    return q, k, v, kp


def band_pairs(S, window):
    """Visible (query, key) pairs of causal attention over S positions
    with a window (0 = none)."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


def swa_kernel_phase(dev, errs: Errors):
    """swa_decode and swa_prefill vs their plain versions in every case;
    times at the serve path's shapes (and the JAX benchmark's decode
    shape), beside SDPA with the same mask and, for prefill, flash_fwd
    with the same window."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk

    gen = torch.Generator(device=dev).manual_seed(2)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    s, geo = SERVE, SERVE_GEOM
    B, KV, G, hd, W = (s["batch"], geo["KV"], geo["G"], geo["hd"],
                       geo["window"])
    L, H = s["prompt_len"] + s["gen"], KV * G
    last = L - 1
    rows = {}

    # -- decode: the corners first
    decode_case(dev, gen, errs, f"ring W={W} q_pos=37 (partly written)",
                B=B, KV=KV, G=G, hd=hd, S=W, window=W, q_pos=37, kind="ring")
    decode_case(dev, gen, errs, "bf16 k/v ring wrapped", B=B, KV=KV, G=G,
                hd=hd, S=W, window=W, q_pos=last, kind="ring",
                dtype=torch.bfloat16)
    decode_case(dev, gen, errs, "odd S=3001 window=500", B=2, KV=4, G=2,
                hd=hd, S=3001, window=500, q_pos=2999)
    decode_case(dev, gen, errs, "no visible slot", B=2, KV=4, G=2, hd=hd,
                S=777, window=0, q_pos=40, kind="late")

    def decode_row(name, q, k, v, kp, q_pos, window):
        Bq, KVq, Gq, hdq = q.shape
        Hq = KVq * Gq
        valid = (kp >= 0) & (kp <= q_pos)
        if window > 0:
            valid = valid & (q_pos - kp < window)
        n_vis = int(valid.sum())
        nbytes = (2 * Bq * n_vis * KVq * hdq * k.element_size()
                  + kp.numel() * 4 + 2 * q.numel() * 4)
        flops = 4 * Bq * Hq * hdq * n_vis
        qh, q3 = q.reshape(Bq, Hq, 1, hdq), q.reshape(Bq, Hq, hdq)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        mask = valid.view(1, 1, 1, -1)
        time_row(rows, rate, name,
                 lambda: sk.swa_decode(q, k, v, kp, q_pos, window=window),
                 lambda: sops.decode_attention(q3, k, v, kp, q_pos,
                                               window=window),
                 lambda: sref.decode_ref(q, k, v, kp, q_pos, window=window),
                 nbytes, flops,
                 lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, attn_mask=mask, enable_gqa=True))
        rows[name]["visible_slots"] = n_vis

    # -- decode at the serve shapes and the JAX benchmark's
    args = decode_case(dev, gen, errs, f"serve local: ring W={W} wrapped",
                       B=B, KV=KV, G=G, hd=hd, S=W, window=W, q_pos=last,
                       kind="ring")
    decode_row(f"swa_decode serve local W={W}", *args, last, W)
    args = decode_case(dev, gen, errs, f"serve global: S={L} window=0",
                       B=B, KV=KV, G=G, hd=hd, S=L, window=0, q_pos=last)
    decode_row(f"swa_decode serve global S={L}", *args, last, 0)
    bb = DECODE_BENCH
    args = decode_case(dev, gen, errs, f"benchmark {bb}", B=bb["B"],
                       KV=bb["KV"], G=bb["G"], hd=bb["hd"], S=bb["S"],
                       window=bb["window"], q_pos=bb["S"] - 1)
    decode_row(f"swa_decode benchmark S={bb['S']} w={bb['window']}", *args,
               bb["S"] - 1, bb["window"])
    del args
    torch.cuda.empty_cache()

    # -- prefill: the JAX tests' cases, an odd S, bf16, the refusal
    def prefill_case(tag, *, B, KV, G, S, hd, window, causal=True,
                     dtype=torch.float32):
        q = torch.randn(B, KV, G, S, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        got = sk.swa_prefill(q, k, v, window=window, causal=causal)
        want = sref.prefill_ref(q, k, v, window=window, causal=causal)
        errs.hold("swa_prefill", got, want, finite_scale(want), tag,
                  FLASH_TOL)
        return q, k, v, got

    for dims in ((1, 2, 2, 256, 32, 64), (2, 1, 4, 512, 64, 128),
                 (1, 2, 1, 256, 32, 0), (1, 1, 2, 128, 16, 16)):
        b_, kv_, g_, s_, hd_, w_ = dims
        prefill_case(f"JAX test case {dims}", B=b_, KV=kv_, G=g_, S=s_,
                     hd=hd_, window=w_)
    prefill_case("odd S=1001 window=300", B=2, KV=4, G=2, S=1001, hd=hd,
                 window=300)
    prefill_case(f"bf16 S={2 * W} window={W}", B=1, KV=KV, G=G, S=2 * W,
                 hd=hd, window=W, dtype=torch.bfloat16)
    prefill_case("bidirectional S=300", B=1, KV=2, G=2, S=300, hd=64,
                 window=0, causal=False)
    try:
        sops.swa_prefill(*[torch.zeros(1, 1, 1, 64, 16, device=dev)],
                         torch.zeros(1, 64, 1, 16, device=dev),
                         torch.zeros(1, 64, 1, 16, device=dev), window=8,
                         causal=False)
        raise AssertionError("swa_prefill(causal=False, window>0) ran")
    except ValueError as e:
        check("not defined" in str(e), f"wrong refusal: {e}")
        print("  swa_prefill  causal=False window>0 refused (ValueError)")
    torch.cuda.empty_cache()

    # -- prefill at the serve shape: kernel, plain, SDPA, and flash_fwd
    S = s["prompt_len"]
    q, k, v, out = prefill_case(f"serve B={B} KV={KV} G={G} S={S} w={W}",
                                B=B, KV=KV, G=G, S=S, hd=hd, window=W)
    torch.cuda.empty_cache()
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    f_out, _ = ff.flash_fwd(q, k, v, pos, pos, causal=True, window=W)
    errs.hold("swa_prefill", out, f_out, finite_scale(f_out),
              "serve shape == flash_fwd with the window", FLASH_TOL)
    del out, f_out
    pairs = band_pairs(S, W)
    nbytes = (3 * B * H * S * hd + 2 * B * S * KV * hd) * 4
    flops = 4 * B * H * hd * pairs
    qh = q.reshape(B, H, S, hd)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    name = f"swa_prefill serve S={S} w={W}"
    time_row(rows, rate, name,
             lambda: sk.swa_prefill(q, k, v, window=W),
             lambda: sops.swa_prefill(q, k, v, window=W),
             lambda: sref.prefill_ref(q, k, v, window=W),
             nbytes, flops,
             lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, attn_mask=band, enable_gqa=True))
    rows[name]["flash_fwd_same_window_ms"] = cuda_ms(
        lambda: ff.flash_fwd(q, k, v, pos, pos, causal=True, window=W),
        reps=5)
    rows[name]["visible_pairs"] = pairs
    print(f"  flash_fwd on the same inputs and window: "
          f"{rows[name]['flash_fwd_same_window_ms']:.4f} ms "
          f"(swa_prefill {rows[name]['ms']:.4f} ms)")
    print(json.dumps({"swa_variants": rows}))
    del q, k, v, qh, kh, vh, band
    torch.cuda.empty_cache()
    return rows


def widen_kernel_phase(dev, errs: Errors):
    """widen_2d vs its plain version and NetChange's widen_in / widen_out
    at the JAX benchmark's shape and the transformer cohort's FFN
    widening (glm4-9b's 6848 -> 13696, both units of a client stacked);
    times beside ``index_select`` where that one call is the function."""
    from repro_torch.core import netchange as nc
    from repro_torch.kernels.netchange import ops as wops
    from repro_torch.kernels.netchange import ref as wref
    from repro_torch.kernels.netchange import widen as wk

    gen = torch.Generator(device=dev).manual_seed(3)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    rows = {}
    d_model, d_half = 4096, 6848
    for tag, R, old, new in (
            ("benchmark", 4096, 14336 // 8, 21504 // 8),
            ("glm4 FFN", TFFN["n_layers"] * d_model, d_half, 2 * d_half)):
        x = torch.randn(R, old, generator=gen, device=dev)
        m = nc.dup_mapping(old, new, tag="u/b0/ffn")
        mt = torch.as_tensor(m, device=dev)
        st = torch.as_tensor(wops.split_scale(m, old), device=dev)
        sc = float(x.abs().max())
        shape = f"{R}x{old}->{new}"
        for split in (False, True):
            got = wops.widen_cols(x, m, split=split)
            want = wops.widen_cols(x, m, split=split, use_kernel=False)
            errs.hold("widen_2d", got, want, sc, f"{shape} split={split}")
            check(torch.equal(got, want), f"widen {shape} not bit-equal")
        # NetChange's To-Wider on the same weights (the JAX package's
        # test_widen_kernel_matches_core_semantics)
        errs.hold("widen_2d", wops.widen_cols(x, m), nc.widen_in(x, m, -1),
                  sc, f"{shape} == widen_in")
        xt = x.t().contiguous()                     # (old, R): rows
        errs.hold("widen_2d", wops.widen_cols(x, m, split=True),
                  nc.widen_out(xt, m, old, axis=0).t(), sc,
                  f"{shape} == widen_out")
        errs.hold("widen_2d", wops.widen(xt, m, axis=0, split=True),
                  wref.widen_ref(xt, mt, st, axis=0), sc,
                  f"rows {old}->{new} x{R} split")
        io = R * old * 4 + R * new * 4
        time_row(rows, rate, f"widen cols dup {tag} {shape}",
                 lambda: wk.widen_2d(x, mt),
                 lambda: wops.widen_cols(x, m),
                 lambda: wref.widen_ref(x, mt, None),
                 io + new * 4, 0, lambda: x.index_select(1, mt))
        time_row(rows, rate, f"widen cols split {tag} {shape}",
                 lambda: wk.widen_2d(x, mt, st),
                 lambda: wops.widen_cols(x, m, split=True),
                 lambda: wref.widen_ref(x, mt, st),
                 io + new * 8, R * new)
        x3 = xt.view(1, old, R)
        time_row(rows, rate, f"widen rows split {tag} {old}->{new} x{R}",
                 lambda: wk.widen_2d(x3, mt, st),
                 lambda: wops.widen(xt, m, axis=0, split=True),
                 lambda: wref.widen_ref(xt, mt, st, axis=0),
                 io + new * 8, R * new)
        del x, xt, x3
    print(json.dumps({"widen_variants": rows}))
    torch.cuda.empty_cache()
    return rows


def serve_path(dev):
    """gemma3-27b at its published widths, depth cut to 12 layers (10
    local + 2 global), through ``launch.serve.run``: prefill B = 4
    prompts of 4096 tokens, then 32 greedy tokens. The launch counts of
    that run must show every attention layer in the kernels; then the
    logits are held against ``forward_hidden`` and the kernel against the
    model's plain decode attention on the real caches."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    s = SERVE
    sk.reset_launch_counts()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(s["arch"], use_reduced=False, n_layers=s["n_layers"],
                    batch=s["batch"], prompt_len=s["prompt_len"],
                    gen=s["gen"], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**sk.launch_counts(), **ff.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    cfg, params = res["cfg"], res["params"]
    kinds = [cfg.layer_pattern[i % cfg.pattern_len]
             for i in range(cfg.n_layers)]
    n_local = kinds.count("local")
    n_global = len(kinds) - n_local
    print(f"  serve run: {wall:.1f} s; launches {counts}")
    check(counts["swa_prefill"] == n_local,
          f"prefill: {counts['swa_prefill']} swa_prefill launches for "
          f"{n_local} local layers")
    check(counts["flash_fwd"] == n_global,
          f"prefill: {counts['flash_fwd']} flash_fwd launches for "
          f"{n_global} global layers")
    check(counts["swa_decode"] == cfg.n_layers * s["gen"],
          f"decode: {counts['swa_decode']} swa_decode launches for "
          f"{cfg.n_layers} layers x {s['gen']} tokens")
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 0,
          "serving launched a backward kernel")

    P_L, L = s["prompt_len"], s["prompt_len"] + s["gen"]
    ref_ctx = ShardCtx(attn_backend="flash")
    w_out = params["embed"].t()                      # tied embeddings
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tu.leaves(params))
    with torch.inference_mode():
        # prefill's last logits vs the training forward (flash kernels
        # on every layer, local ones with their window)
        h = T.forward_hidden(params, cfg, res["prompts"], ctx=ref_ctx)
        want = (h[:, -1] @ w_out).float()
        del h
        err_p = float((res["prefill_logits"] - want).abs().max())
        tol_p = SERVE_PREFILL_TOL * float(want.abs().max())
        print(f"  prefill logits vs forward_hidden: max |diff| {err_p:.3e} "
              f"(tol {tol_p:.3e})")
        check(err_p <= tol_p, f"prefill logits off by {err_p} > {tol_p}")
        # the last decode step vs the forward of prompt + generated tokens
        seq = torch.cat([res["prompts"], res["tokens"]], dim=1)
        h = T.forward_hidden(params, cfg, seq, ctx=ref_ctx)
        want = (h[:, -1] @ w_out).float()
        del h
        err_d = float((res["logits"] - want).abs().max())
        tol_d = SERVE_DECODE_TOL * float(want.abs().max())
        print(f"  last decode logits vs forward_hidden of {L} tokens: "
              f"max |diff| {err_d:.3e} (tol {tol_d:.3e})")
        check(err_d <= tol_d, f"decode logits off by {err_d} > {tol_d}")
        del want, seq
        torch.cuda.empty_cache()

        # a second (warm) prefill: its time, and the caches as prefill
        # leaves them (the run's caches hold the decoded tokens too)
        prefill = make_prefill_step(cfg, ctx=ShardCtx(), cache_len=L)
        (logits, cache), warm_s, _ = _synced(
            lambda: prefill(params, {"tokens": res["prompts"]}))
        errs_c = []
        gen = torch.Generator(device=dev).manual_seed(4)
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        local_b = cfg.layer_pattern.index("local")
        global_b = cfg.layer_pattern.index("global")
        for when, c, q_pos in (("after prefill", cache, P_L - 1),
                               ("after the last step", res["cache"],
                                L - 1)):
            for kind, b in (("local", local_b), ("global", global_b)):
                ck = c["units"][f"b{b}"]["k"][0]
                cv = c["units"][f"b{b}"]["v"][0]
                Sc = ck.shape[1]
                window = cfg.window if kind == "local" else 0
                kp = (A.ring_positions(q_pos, Sc, device=dev)
                      if kind == "local" else torch.arange(Sc, device=dev))
                q = torch.randn(s["batch"], H, hd, generator=gen, device=dev)
                got = sops.decode_attention(q, ck, cv, kp, q_pos,
                                            window=window)
                want = A.decode_attention(q, ck, cv, kp, q_pos,
                                          window=window)
                err = float((got - want).abs().max())
                errs_c.append(err)
                print(f"  swa_decode vs decode_attention, {kind} layer "
                      f"cache {tuple(ck.shape)} {when}: max |diff| "
                      f"{err:.3e} (tol {SERVE_KERNEL_TOL:g})")
                check(err <= SERVE_KERNEL_TOL,
                      f"swa_decode on the {kind} cache {when}: {err}")
        err_w = float((logits - res["prefill_logits"]).abs().max())
        check(err_w <= tol_p, f"second prefill differs by {err_w}")
        del cache, logits
        breakdown = decode_breakdown(params, cfg, res, L - 1,
                                     (local_b, global_b), n_local, n_global)
    info = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "batch": s["batch"], "prompt_len": P_L, "gen": s["gen"],
            "param_bytes": param_bytes,
            "run_wall_s": wall, "prefill_s": res["prefill_s"],
            "prefill_warm_s": warm_s,
            "decode_first_s": res["decode_first_s"],
            "decode_ms_per_token": res["decode_ms_per_token"],
            "decode_bound_ms": param_bytes / hbm_rate(
                torch.cuda.get_device_name(0)) * 1e3,
            "max_memory_allocated": peak, "launches": counts,
            "prefill_logits_err": err_p, "decode_logits_err": err_d,
            "kernel_vs_plain_on_caches": max(errs_c),
            "decode_breakdown": breakdown}
    print(json.dumps({"serve_path": info}))
    del res, params
    free_device()
    return counts, info


def decode_breakdown(params, cfg, res, pos, blocks, n_local, n_global):
    """Where one decode step's time goes (CUDA events, 10 calls each, on
    the serve run's final cache at its last position): the whole step,
    one local and one global block, and the vocabulary projection; the
    rest (embedding, final norm, launches between) is the difference.
    Each part beside its weight-read bound."""
    from repro_torch import tree as tu
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    rate = hbm_rate(torch.cuda.get_device_name(0))
    tok = res["tokens"][:, -1:]
    h = T._embed(params, cfg, tok)
    w_out = params["embed"].t()

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tu.leaves(tree))

    def block(b):
        p = tu.tree_map(lambda t: t[0], params["units"][f"b{b}"])
        c = res["cache"]["units"][f"b{b}"]
        cache = {"k": c["k"][0], "v": c["v"][0]}
        kind = cfg.layer_pattern[b]
        return (lambda: T.block_apply_decode(p, cfg, kind, h, pos, cache,
                                             ctx=ShardCtx())), nbytes(p)

    def step():
        return T.decode_step(params, cfg, tok, res["cache"], pos)

    step_ms = cuda_ms(step, reps=10)
    # the host's time to enqueue one step (~500 launches, fewer than the
    # launch queue holds, so the host does not wait on the card): about
    # the step's time when the host, not the card, sets the pace
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    (local_fn, local_bytes), (global_fn, global_bytes) = map(block, blocks)
    local_ms = cuda_ms(local_fn, reps=10)
    global_ms = cuda_ms(global_fn, reps=10)
    vocab_ms = cuda_ms(lambda: (h @ w_out).float(), reps=10)
    out = {"step_ms": step_ms, "host_enqueue_ms": min(enqueue),
           "local_block_ms": local_ms,
           "global_block_ms": global_ms, "vocab_projection_ms": vocab_ms,
           "rest_ms": step_ms - n_local * local_ms - n_global * global_ms
           - vocab_ms,
           "local_block_bound_ms": local_bytes / rate * 1e3,
           "global_block_bound_ms": global_bytes / rate * 1e3,
           "vocab_projection_bound_ms": nbytes(params["embed"]) / rate * 1e3}
    print(f"  decode step {step_ms:.3f} ms = {n_local} x local block "
          f"{local_ms:.3f} + {n_global} x global block {global_ms:.3f} + "
          f"vocabulary projection {vocab_ms:.3f} + rest {out['rest_ms']:.3f}"
          f" (bounds {out['local_block_bound_ms']:.3f}, "
          f"{out['global_block_bound_ms']:.3f}, "
          f"{out['vocab_projection_bound_ms']:.3f})")
    print(f"  host enqueue of one decode step: {out['host_enqueue_ms']:.3f} "
          f"ms (min of 5)")
    return out



def build_kernels():
    """Every CUDA source of the port, one nvcc each, started together."""
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.kernels.swa_attention import swa as sk

    t0 = time.perf_counter()
    builders = (fk.build, ff.build, sk.build, wk.build)
    with ThreadPoolExecutor(max_workers=len(builders)) as pool:
        futures = [pool.submit(b) for b in builders]
        paths = [f.result() for f in futures]
    print(f"built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")


def kernel_entry(name, route_source, replaces, launches, err, r):
    return {"name": name, "route": "cuda", "source": route_source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm VGG round per layout instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs.vgg_family import paper_client_archs, vgg
    from repro_torch.core import PlaneSpec, VGGFamily
    from repro_torch.device import strict_f32
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import swa as sk

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    strict_f32(dev)
    build_kernels()
    if args.profile:
        profile_rounds()
        print(card)
        return 0

    t_start = time.perf_counter()
    family = VGGFamily()
    union = family.union([vgg(a) for a in paper_client_archs()])
    P = PlaneSpec.from_tree(family.shapes(union)).size
    errs = Errors()
    print("fedavg kernel phase")
    rows = kernel_phase(dev, P, errs)
    rows.update(wire_kernel_phase(dev, P, errs))
    print(f"VGG main-path phase ({time.perf_counter() - t_start:.0f} s)")
    launches, g_f32 = main_path()
    print(f"wire phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in wire_path(g_f32).items():
        launches[k] += v
    del g_f32
    print(f"fedavg_stacked phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in stacked_path(dev).items():
        launches[k] += v
    print(f"flash kernel phase ({time.perf_counter() - t_start:.0f} s)")
    frows = flash_kernel_phase(dev, errs)
    print(f"transformer main-path phase "
          f"({time.perf_counter() - t_start:.0f} s)")
    flaunches, tinfo = tffn_main_path({k: r["ms"] for k, r in frows.items()})
    print(json.dumps({"transformer_main_path": {
        "round_wall_s": tinfo["flash"]["round_wall_s"],
        "train_s": tinfo["flash"]["phase_stats"]["train"],
        "max_memory_allocated": tinfo["flash"]["max_memory_allocated"],
        "blockwise_round_wall_s": tinfo["blockwise"]["round_wall_s"],
        "blockwise_max_memory_allocated":
            tinfo["blockwise"]["max_memory_allocated"],
        "flash_vs_blockwise": tinfo["flash_vs_blockwise"]}}))
    print(f"serving kernel phase ({time.perf_counter() - t_start:.0f} s)")
    srows = swa_kernel_phase(dev, errs)
    wrows = widen_kernel_phase(dev, errs)
    print(f"serve path phase ({time.perf_counter() - t_start:.0f} s)")
    slaunches, sinfo = serve_path(dev)
    print(f"phases done in {time.perf_counter() - t_start:.0f} s")

    main_row = {"weighted_sum": ("weighted_sum K=20", 425),
                "plane_agg": ("plane_agg K=20 m,mu,fb", 403),
                "plane_accum": ("plane_accum filler kc=16", 265),
                "plane_finish": ("plane_finish renorm+fb", 363),
                "plane_accum_q": ("plane_accum_q filler kc=16", 330),
                "weighted_sum_masked": ("weighted_sum_masked K=20", 459),
                "weighted_sum_masked_mult":
                    ("weighted_sum_masked_mult K=20", 494)}
    kernels = []
    for name in fk.KERNELS:
        variant, line = main_row[name]
        check(launches[name] > 0, f"{name} never launched on the main path")
        kernels.append(kernel_entry(name, SOURCE, f"{TPU_KERNELS}:{line}",
                                    launches[name], errs.max[name],
                                    rows[variant]))
    for name in ff.KERNELS:
        check(flaunches[name] > 0,
              f"{name} never launched on the transformer main path")
        kernels.append(kernel_entry(name, FLASH_SOURCE, FLASH_TPU[name],
                                    flaunches[name], errs.max[name],
                                    frows[name]))
    # the serving kernels: launches of the serve path's run; widen_2d:
    # NetChange's To-Wider at every round start of the VGG, wire and
    # transformer paths
    W = SERVE_GEOM["window"]
    swa_main = {"swa_decode": f"swa_decode serve local W={W}",
                "swa_prefill": (f"swa_prefill serve S={SERVE['prompt_len']}"
                                f" w={W}")}
    for name in sk.KERNELS:
        check(slaunches[name] > 0, f"{name} never launched on the serve path")
        kernels.append(kernel_entry(name, SWA_SOURCE, SWA_TPU[name],
                                    slaunches[name], errs.max[name],
                                    srows[swa_main[name]]))
    n_widen = launches["widen_2d"] + flaunches["widen_2d"]
    check(n_widen > 0, "widen_2d never launched on the main paths")
    widen_main = (f"widen cols dup glm4 FFN {TFFN['n_layers'] * 4096}x6848"
                  f"->13696")
    kernels.append(kernel_entry("widen_2d", WIDEN_SOURCE, WIDEN_TPU, n_widen,
                                errs.max["widen_2d"], wrows[widen_main]))
    # 12 TPU kernels; flash_bwd is two CUDA kernels (dq, dk/dv)
    check(len(kernels) == 13, f"{len(kernels)} kernels in the line, not 13")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
