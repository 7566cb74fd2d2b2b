"""swa_decode of two or more source trees, side by side on the card.

    python3 tools/swa_decode_ab.py OLD_TREE . . OLD_TREE

Each argument is a checkout's root (e.g. a parent commit unpacked with
``git archive <commit> src/repro_torch | tar -x -C build/parent``); each
runs in a process of its own, in the order given (parent, change,
change, parent compares two versions on one card). A process builds
that tree's ``csrc/swa_attention.cu`` (into its own ``build/``), prints
ptxas's registers and spills of every ``swa_decode_kernel`` instance,
and times ``swa_decode`` at ``SHAPES``: the card's time per launch
(``chip_smoke.card_times``: 20 launches in a CUDA graph, operands
cycled past the L2), without and, where the tree has it, with the
log-sum-exp (``return_lse``). ~1 min a tree on an H100.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (B, KV, G, hd, S, window, q_pos, ring)
SHAPES = {
    "long_500k": (1, 16, 2, 128, 524288, 0, 524287, False),
    "serve local W=1024": (4, 16, 2, 128, 1024, 1024, 4127, True),
    "KV 8 x G 1 S=4128": (4, 8, 1, 128, 4128, 0, 4127, False),
    "hd 256, KV 16 x G 1 S=4128": (4, 16, 1, 256, 4128, 0, 4127, False),
    "hd 16, KV 2 x G 8 S=4128": (4, 2, 8, 16, 4128, 0, 4127, False),
    "hd 8, KV 2 x G 4 S=4128": (4, 2, 4, 8, 4128, 0, 4127, False),
}


def one(tree: str) -> None:
    # the tree's package before chip_smoke, which puts this checkout's
    # src/ ahead on the path
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from repro_torch.kernels.swa_attention import swa
    from repro_torch.models.attention import ring_positions
    sys.path.append(ROOT)
    import chip_smoke as cs

    swa.build()
    print(f"{tree}: {swa.__file__}")
    for line in cs.ptxas_lines("swa_attention", "swa_decode"):
        print(f"{tree}: ptxas {line}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    has_lse = "return_lse" in swa.swa_decode.__code__.co_varnames
    for name, (B, KV, G, hd, S, window, q_pos, ring) in SHAPES.items():
        q = torch.randn(B, KV, G, hd, generator=g, device=dev)
        k = torch.randn(B, S, KV, hd, generator=g, device=dev)
        v = torch.randn(B, S, KV, hd, generator=g, device=dev)
        kp = (ring_positions(q_pos, S, device=dev) if ring
              else torch.arange(S, device=dev)).to(torch.int32)
        for lse in (False, True) if has_lse else (False,):
            kw = {"return_lse": True} if lse else {}
            t = cs.card_times(cs.with_copies(
                lambda kk, vv: swa.swa_decode(q, kk, vv, kp, q_pos,
                                              window=window, **kw), k, v),
                2 * k.numel() * k.element_size())
            print(f"{tree}: {name} lse={lse} device_ms={t['device_ms']:.4f}"
                  f" copies={t['copies']}")
        del q, k, v, kp
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
