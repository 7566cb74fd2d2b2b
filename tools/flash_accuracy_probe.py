#!/usr/bin/env python3
"""How far the flash kernels lie from the exact function, on the card.

    python3 tools/flash_accuracy_probe.py                  # hd 192
    python3 tools/flash_accuracy_probe.py --hd 256 --B 8 --KV 16
    python3 tools/flash_accuracy_probe.py --hd 128 --B 8 --KV 2 --G 16
    python3 tools/flash_accuracy_probe.py --hd 128 --B 4 --KV 8 --G 4 \
        --window 4096
    python3 tools/flash_accuracy_probe.py --hd 128 --B 4 --KV 16 --G 2 \
        --S 4096 --forward-only

Causal attention (``--window`` > 0: sliding) on (B, KV, G, S, hd) random
inputs. The exact function is computed in float64, one sequence at a
time (out, lse and dq, dk, dv of ``(out . dout).sum()``;
``--forward-only``: out and lse, as a prefill runs it). Each error is printed as the largest share of
``tests/test_flash.py``'s elementwise bound (|x - exact| <= 1e-5 + 1e-5
|exact|) it uses, and as the largest |x - exact|: the forward's out and
lse, the kernel's (``flash.flash_fwd``) and the plain f32 version's
(``ref.flash_fwd_ref``); dq, dk, dv from the kernel pair fed the
kernel's forward, from the kernel pair fed the exact out and lse
(rounded to f32), and from the plain backward fed the kernel's forward.
The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.device import strict_f32  # noqa: E402
from repro_torch.kernels.flash_attention import flash as ff  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402


def used(x, exact):
    d = (x.double() - exact).abs()
    return (f"{float((d / (1e-5 + 1e-5 * exact.abs())).max()):.3f} of the "
            f"bound, max |diff| {float(d.max()):.3e}")


def exact_attention(q, k, v, dout, window=0, grads=True):
    """float64 out, lse and (dq, dk, dv) of (out . dout).sum() (None
    without ``grads``), causal (sliding over ``window`` > 0), on the
    kernel layout (q (B, KV, G, S, hd), k, v (B, S, KV, hd)), one
    sequence at a time."""
    hd, S = q.shape[-1], q.shape[3]
    pos = torch.arange(S, device=q.device)
    hide = pos[None, :] > pos[:, None]
    if window:
        hide = hide | (pos[:, None] - pos[None, :] >= window)
    outs, lses, dgrads = [], [], []
    for b in range(q.shape[0]):
        leaves = [t[b:b + 1].double().requires_grad_(grads)
                  for t in (q, k, v)]
        qd, kd, vd = leaves
        with torch.set_grad_enabled(grads):
            s = torch.einsum("bkgqd,bskd->bkgqs", qd, kd) * hd ** -0.5
            s = s.masked_fill(hide, float("-inf"))
            lse = torch.logsumexp(s, -1)
            out = torch.einsum("bkgqs,bskd->bkgqd",
                               torch.exp(s - lse[..., None]), vd)
            if grads:
                dgrads.append(torch.autograd.grad(
                    (out * dout[b:b + 1].double()).sum(), leaves))
        outs.append(out.detach())
        lses.append(lse.detach())
        del s, out, lse
    cat = torch.cat
    return (cat(outs), cat(lses),
            tuple(cat(g) for g in zip(*dgrads)) if grads else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hd", type=int, default=192)
    ap.add_argument("--B", type=int, default=1)
    ap.add_argument("--KV", type=int, default=128)
    ap.add_argument("--S", type=int, default=2048)
    ap.add_argument("--G", type=int, default=1)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--forward-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_accuracy_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    strict_f32(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    B, KV, G, S, hd, W = args.B, args.KV, args.G, args.S, args.hd, args.window
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, KV, G, S, hd, generator=g, device=dev)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev)
    dout = torch.randn(B, KV, G, S, hd, generator=g, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    print(f"{card}: B={B} KV={KV} G={G} S={S} hd={hd}, causal, window {W}")
    exact = exact_attention(q, k, v, dout, W, grads=not args.forward_only)
    out_x, lse_x, grads_x = exact
    out_k, lse_k = ff.flash_fwd(q, k, v, pos, pos, window=W)
    out_p, lse_p = fref.flash_fwd_ref(q, k, v, pos, pos, window=W)
    print(f"  out  kernel {used(out_k, out_x)}; plain {used(out_p, out_x)}")
    print(f"  lse  kernel {used(lse_k, lse_x)}; plain {used(lse_p, lse_x)}")
    del out_p, lse_p
    if args.forward_only:
        return 0
    fed = {"kernel pair, kernel forward": (out_k, lse_k, True),
           "kernel pair, exact forward": (out_x.float(), lse_x.float(), True),
           "plain backward, kernel forward": (out_k, lse_k, False)}
    for tag, (out, lse, kernel) in fed.items():
        if kernel:
            delta = (dout * out).sum(-1)
            grads = ff.flash_bwd(q, k, v, pos, pos, lse, delta, dout,
                                 window=W)
        else:
            grads = fref.flash_bwd_ref(q, k, v, pos, pos, out, lse, dout,
                                       window=W)
        for name, x, ex in zip(("dq", "dk", "dv"), grads, grads_x):
            print(f"  {name}  {tag:32s} {used(x, ex)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
