"""widen_2d of two or more source trees, side by side on the card.

    python3 tools/widen_ab.py OLD_TREE . . OLD_TREE

Each argument is a checkout's root (e.g. a parent commit unpacked with
``git archive <commit> src/repro_torch | tar -x -C build/parent``); each
runs in a process of its own, in the order given (parent, change,
change, parent compares two versions on one card). A process builds
that tree's ``csrc/netchange.cu`` (into its own ``build/``), prints
ptxas's registers and spills of every ``widen_*`` kernel, checks each
shape bit-equal to the plain version, and times ``widen_2d`` at
``SHAPES`` (``chip_smoke.card_times``: 20 launches in a CUDA graph,
operands cycled past the L2): the row gathers (``widen_rows_kernel``)
of ``chip_smoke.py``'s ``widen_2d`` rows and, for comparison, its
column gather. ~30 s a tree on an H100.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (outer, old, inner, new, split); inner 1 is a (R, old) matrix
SHAPES = {
    "rows split glm4 FFN 6848->13696 x8192": (1, 6848, 8192, 13696, True),
    "rows dup glm4 FFN 6848->13696 x8192": (1, 6848, 8192, 13696, False),
    "rows split benchmark 1792->2688 x4096": (1, 1792, 4096, 2688, True),
    "cols dup glm4 FFN 8192x6848->13696": (8192, 6848, 1, 13696, False),
}


def one(tree: str) -> None:
    # the tree's package before chip_smoke, which puts this checkout's
    # src/ ahead on the path
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from repro_torch.core import netchange as nc
    from repro_torch.kernels.netchange import ops as wops
    from repro_torch.kernels.netchange import ref as wref
    from repro_torch.kernels.netchange import widen as wk
    sys.path.append(ROOT)
    import chip_smoke as cs

    wk.build()
    print(f"{tree}: {wk.__file__}")
    for line in cs.ptxas_lines("netchange", "widen_"):
        print(f"{tree}: ptxas {line}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (outer, old, inner, new, split) in SHAPES.items():
        shape = (outer, old) if inner == 1 else (outer, old, inner)
        x = torch.randn(shape, generator=g, device=dev)
        m = nc.dup_mapping(old, new, tag="u/b0/ffn")
        mt = torch.as_tensor(m, device=dev)
        st = (torch.as_tensor(wops.split_scale(m, old), device=dev)
              if split else None)
        want = (wref.widen_ref(x, mt, st) if inner == 1 else
                wref.widen_ref(x[0], mt, st, axis=0)[None])
        if not torch.equal(wk.widen_2d(x, mt, st), want):
            raise SystemExit(f"{tree}: {name}: not bit-equal")
        t = cs.card_times(cs.with_copies(
            lambda xx: wk.widen_2d(xx, mt, st), x),
            4 * (outer * (old + new) * inner))
        print(f"{tree}: {name} device_ms={t['device_ms']:.4f}"
              f" copies={t['copies']}")
        del x, want
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for tree in sys.argv[1:]:
        rc = subprocess.call([sys.executable, __file__, "--one", tree])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
