"""CLI: ``python -m repro_torch.analysis`` — run the analysis passes,
exit 0 when there is no finding, 1 with findings, 2 when a pass cannot
run (the kernels pass without a card)."""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.analysis import PASSES, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="Contract verifier, torch-aware lint (fedlint) and "
                    "CUDA kernel validator for the PyTorch port. Exit "
                    "code 0 = no findings.")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES, metavar="PASS",
                    help="run only this pass (repeatable); default: all "
                         f"of {', '.join(PASSES)} (kernels needs the card)")
    ap.add_argument("--lint-root", dest="lint_roots", action="append",
                    metavar="PATH",
                    help="file, directory or glob for the lint pass "
                         "(repeatable); default: src/repro_torch, "
                         "chip_smoke.py, tests/test_torch_*.py, tools/")
    ap.add_argument("--quick", action="store_true",
                    help="contracts: check the VGG cohort + two "
                         "transformer architectures instead of the full "
                         "registry matrix")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    try:
        report = run(args.passes, lint_roots=args.lint_roots,
                     quick=args.quick)
    except RuntimeError as e:       # the kernels pass without a card
        print(f"repro_torch.analysis: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0

    for f in report.findings:
        print(f.format())
    for line in report.summary_lines():
        print(line)
    total = sum(report.checked.values())
    status = "clean" if report.ok else f"{len(report.findings)} finding(s)"
    print(f"repro_torch.analysis: {total} case(s), {status}, {dt:.1f}s")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
