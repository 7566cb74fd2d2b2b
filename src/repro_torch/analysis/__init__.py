"""repro_torch.analysis — static contract verification, a torch-aware
lint (fedlint), a validator of the CUDA kernels, and a detector of work
built at run time (the JAX package's ``repro.analysis``).

FedADP's correctness rests on algebraic invariants (up/down round-trips,
E·Eᵀ idempotence, coverage/multiplicity consistency, PlaneSpec layout
identity) that the test suite only exercises dynamically, minutes at a
time. This package checks the static half of those contracts in seconds
— tensors on the ``meta`` device (shapes and dtypes, no storage), AST
inspection, the kernels' own compiler reports — with no training step
run. Four passes:

  * ``contracts``  — the architecture-matrix contract checker
                     (``analysis.contracts``): every registry
                     architecture × both families, on ``meta`` tensors
                     (values only where a check needs them, on small
                     CPU tensors).
  * ``lint``       — fedlint (``analysis.lint``): AST rules for torch
                     hazards that ruff cannot express (FDT001-004),
                     with inline ``# fedlint: ignore[RULE]``
                     suppressions.
  * ``kernels``    — the CUDA kernel validator
                     (``analysis.kernels_check``): every instantiation's
                     registers, spills and shared memory from ptxas's
                     report against the H100's per-block limits, and
                     every op wrapper's launch surface (each case
                     launches its own kernel and returns the caller's
                     shape). Needs the card: without one it raises.
  * ``retrace``    — the build detector (``analysis.retrace``): a
                     context manager counting nvcc builds, first library
                     loads and new entries of the engine's caches, used
                     by tests to show ``Federation.run`` builds nothing
                     after round 1. Not part of the default CLI run (it
                     runs a real federation).

Entry point: ``python -m repro_torch.analysis`` (``--pass``,
``--lint-root``, ``--quick``). Exit code 0 = no findings.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Finding:
    """One verified defect or contract violation.

    ``where`` is a file path for lint findings and a logical location
    (``family/cohort/client`` or ``kernel/case``) for the other passes;
    ``line`` is 0 when there is no source position.
    """
    pass_name: str           # "contracts" | "lint" | "kernels" | "retrace"
    rule: str                # e.g. "FDT001", "updown-shape", "smem-budget"
    where: str
    line: int
    msg: str

    def format(self) -> str:
        loc = f"{self.where}:{self.line}" if self.line else self.where
        return f"{loc}: [{self.rule}] {self.msg}"


@dataclass
class Report:
    """Aggregate of one analysis run: findings + per-pass case counts."""
    findings: List[Finding] = field(default_factory=list)
    checked: Dict[str, int] = field(default_factory=dict)   # pass -> cases

    def extend(self, pass_name: str, findings: List[Finding],
               n_cases: int) -> None:
        self.findings.extend(findings)
        self.checked[pass_name] = self.checked.get(pass_name, 0) + n_cases

    @property
    def ok(self) -> bool:
        return not self.findings

    def summary_lines(self) -> List[str]:
        out = []
        for name, n in sorted(self.checked.items()):
            bad = sum(1 for f in self.findings if f.pass_name == name)
            status = "ok" if bad == 0 else f"{bad} finding(s)"
            out.append(f"{name}: {n} case(s) checked — {status}")
        return out


PASSES: Tuple[str, ...] = ("contracts", "lint", "kernels")


def run(passes: Optional[List[str]] = None, *, lint_roots=None,
        quick: bool = False) -> Report:
    """Run the requested passes (default: all of ``PASSES``) and return
    the aggregate :class:`Report`. Each pass is imported when it runs, so
    the lint pass needs nothing but the standard library."""
    report = Report()
    for name in passes or list(PASSES):
        if name == "contracts":
            from repro_torch.analysis import contracts
            findings, n = contracts.check_all(quick=quick)
        elif name == "lint":
            from repro_torch.analysis import lint
            findings, n = lint.lint_roots(lint_roots)
        elif name == "kernels":
            from repro_torch.analysis import kernels_check
            findings, n = kernels_check.check_all()
        else:
            raise ValueError(f"unknown analysis pass {name!r}; known: "
                             f"{PASSES}")
        report.extend(name, findings, n)
    return report
