"""fedlint — AST rules for torch hazards that ruff cannot express (the
torch counterparts of the JAX package's FDL001-004, each guarding a
ground rule of the port).

Rules (suppress inline with ``# fedlint: ignore[RULE]`` on the flagged
line, a reason after the bracket):

  FDT001  Shared randomness in library code (``src/repro_torch/``): a
          random draw (``torch.rand*``, ``normal``, ``bernoulli``,
          ``multinomial``, ``randperm``, an in-place ``.normal_()`` /
          ``.uniform_()`` / ..., ``torch.nn.init.*``) without an explicit
          ``generator=``, or ``torch.manual_seed`` / ``torch.cuda.
          manual_seed*`` called at all. Either draws from, or reseeds,
          the process-wide stream every caller shares, so two
          "independent" draws correlate with whatever else ran — the
          torch form of the reference's PRNG key reuse (FDL001).
  FDT002  Mutable default argument: a list, dict or set literal (or
          comprehension) as a parameter's default. The one object is
          shared by every call (FDL002's torch form: no jit, the hazard
          is every function's).
  FDT003  Device work at import: at module scope, a tensor made on
          ``cuda`` (``device="cuda..."`` / ``torch.device("cuda")``),
          ``.cuda()``, ``.to("cuda")``, a ``torch.cuda.*`` call (but
          ``torch.cuda.is_available()``, a query that makes no
          context), or ``kernels.build``'s ``build`` / ``load``. Importing
          a module must not touch the card (the tests import every
          module on a machine with none) nor compile a kernel. A CPU
          tensor at import is no device work in torch (unlike ``jnp``)
          and is not flagged. ``if`` blocks at module scope (``__main__``
          and ``TYPE_CHECKING`` guards) are not import work.
  FDT004  A host read of a tensor's value inside a step or an op wrapper
          (files under ``models/``, ``launch/steps.py``,
          ``kernels/*/ops.py``): ``.item()``, ``.tolist()``,
          ``int(t)`` / ``float(t)`` / ``bool(t)``, or ``if`` / ``while``
          / a conditional expression / ``assert`` on a tensor. Each
          stalls the host on the card and fails on ``meta`` tensors (the
          dry run's), FDL004's torch form. It fires only where the
          name is provably a tensor in that function: bound from a
          ``torch.*`` call, an annotated ``torch.Tensor`` parameter, or
          arithmetic, indexing or a method call on such a name.

The checker is first-order, as the reference's: one file at a time,
literal spellings and import aliases only, and false negatives before
noisy false positives.
"""
from __future__ import annotations

import ast
import glob
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import Finding

RULES = ("FDT001", "FDT002", "FDT003", "FDT004")

_IGNORE_RE = re.compile(r"#\s*fedlint:\s*ignore\[([A-Z0-9,\s]+)\]")

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py",
                 "tools")


# --------------------------------------------------------------- utilities
def _suppressions(source: str) -> Dict[int, Set[str]]:
    """line number -> set of rule ids suppressed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for an Attribute/Name chain, '' else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> what it names, from the module's imports:
    ``import torch.nn.functional as F`` -> {"F": "torch.nn.functional"},
    ``from repro_torch.kernels import build as kbuild`` -> {"kbuild":
    "repro_torch.kernels.build"}."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _resolved(node: ast.AST, aliases: Dict[str, str]) -> str:
    """``_dotted`` with its first name resolved through the imports."""
    name = _dotted(node)
    if not name:
        return ""
    head, _, rest = name.partition(".")
    full = aliases.get(head, head)
    return f"{full}.{rest}" if rest else full


def _is_library(filename: str) -> bool:
    p = filename.replace("\\", "/")
    return "repro_torch/" in p and "/tests/" not in p \
        and not Path(p).name.startswith("test_")


def _is_step_code(filename: str) -> bool:
    p = filename.replace("\\", "/")
    return "repro_torch/" in p and (
        "/models/" in p or p.endswith("launch/steps.py")
        or bool(re.search(r"/kernels/[^/]+/ops\.py$", p)))


# ------------------------------------------------------------------ FDT001
_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
          "torch.normal", "torch.bernoulli", "torch.multinomial",
          "torch.poisson", "torch.rand_like", "torch.randn_like",
          "torch.randint_like"}
_INPLACE_DRAWS = {"normal_", "uniform_", "random_", "bernoulli_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}
_INIT_DRAWS = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
               "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
               "orthogonal_", "sparse_"}
_RESEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
            "torch.cuda.manual_seed_all", "torch.cuda.seed",
            "torch.cuda.seed_all", "torch.random.manual_seed"}


def _check_shared_randomness(tree: ast.Module, aliases: Dict[str, str]
                             ) -> List[Tuple[int, str, str]]:
    out: List[Tuple[int, str, str]] = []
    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
        name = _resolved(call.func, aliases)
        if name in _RESEEDS:
            out.append((call.lineno, "FDT001",
                        f"'{name}' reseeds the process-wide generator every "
                        "caller shares — draw from a torch.Generator "
                        "passed in instead"))
            continue
        draw = name in _DRAWS or (
            name.startswith("torch.nn.init.")
            and name.rsplit(".", 1)[-1] in _INIT_DRAWS) or (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _INPLACE_DRAWS
            and not name.startswith("torch.nn.init."))
        if draw and not any(k.arg == "generator" for k in call.keywords):
            what = name or f".{call.func.attr}()"
            out.append((call.lineno, "FDT001",
                        f"random draw '{what}' without generator= — it "
                        "reads the process-wide stream, so 'independent' "
                        "draws correlate with whatever else ran"))
    return out


# ------------------------------------------------------------------ FDT002
_MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
            ast.SetComp)


def _check_mutable_defaults(fn) -> List[Tuple[int, str, str]]:
    out: List[Tuple[int, str, str]] = []
    pos = fn.args.posonlyargs + fn.args.args
    padded = [None] * (len(pos) - len(fn.args.defaults)) + \
        list(fn.args.defaults)
    pairs = list(zip(pos, padded)) + list(zip(fn.args.kwonlyargs,
                                              fn.args.kw_defaults))
    for a, d in pairs:
        if d is not None and isinstance(d, _MUTABLE):
            out.append((fn.lineno, "FDT002",
                        f"'{fn.name}' has a mutable default for '{a.arg}' "
                        "— one object shared by every call"))
    return out


# ------------------------------------------------------------------ FDT003
def _cuda_const(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """A literal "cuda..." device, or ``torch.device("cuda"...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and \
            _resolved(node.func, aliases) == "torch.device" and node.args:
        return _cuda_const(node.args[0], aliases)
    return False


_BUILD_FNS = {"repro_torch.kernels.build.build",
              "repro_torch.kernels.build.load"}


def _check_import_time_device(tree: ast.Module, aliases: Dict[str, str]
                              ) -> List[Tuple[int, str, str]]:
    out: List[Tuple[int, str, str]] = []
    for st in tree.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.Import, ast.ImportFrom,
                           ast.If)):
            continue
        for call in (n for n in ast.walk(st) if isinstance(n, ast.Call)):
            name = _resolved(call.func, aliases)
            attr = call.func.attr if isinstance(call.func, ast.Attribute) \
                else ""
            why = None
            if name.startswith("torch.cuda.") and \
                    name != "torch.cuda.is_available":
                why = f"'{name}' touches the card"
            elif name in _BUILD_FNS or (
                    name.startswith("repro_torch.")
                    and name.rsplit(".", 1)[-1] in ("build", "load")
                    and ".kernels." in name):
                why = f"'{name}' compiles or loads a kernel library"
            elif attr == "cuda" and not name.startswith("torch."):
                why = "'.cuda()' moves a tensor to the card"
            elif attr == "to" and call.args and \
                    _cuda_const(call.args[0], aliases):
                why = "'.to(\"cuda\")' moves a tensor to the card"
            elif any(k.arg == "device" and _cuda_const(k.value, aliases)
                     for k in call.keywords):
                why = f"'{name or attr}' makes a tensor on the card"
            if why:
                out.append((call.lineno, "FDT003",
                            f"{why} at import time — importing a module "
                            "must not touch the device"))
    return out


# ------------------------------------------------------------------ FDT004
# ``torch.<fn>`` calls that return no tensor
_NON_TENSOR = {"is_tensor", "is_floating_point", "is_complex", "numel",
               "device", "Size", "finfo", "iinfo", "dtype", "Generator",
               "no_grad", "enable_grad", "inference_mode", "manual_seed",
               "compile", "jit", "broadcast_shapes", "result_type",
               "promote_types", "can_cast", "typename", "empty_cache"}
_NON_TENSOR_MODULES = {"cuda", "distributed", "backends", "utils",
                       "autograd", "func", "profiler", "testing", "library",
                       "serialization", "multiprocessing", "random"}
_NON_TENSOR_METHODS = {"item", "tolist", "size", "dim", "numel",
                       "data_ptr", "element_size", "is_contiguous",
                       "stride", "storage_offset", "get_device",
                       "is_floating_point", "nelement", "ndimension",
                       "unbind", "split", "chunk", "tensor_split", "sort",
                       "topk", "kthvalue", "mode", "unique", "aminmax",
                       "numpy", "untyped_storage"}
# a tensor without arguments, a (values, indices) pair with a dim
_PAIR_METHODS = {"max", "min", "median"}
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data", "grad"}


def _tensor_call(name: str) -> bool:
    parts = name.split(".")
    if parts[:3] == ["torch", "nn", "functional"]:
        return len(parts) == 4
    if parts[0] != "torch" or len(parts) != 2:
        return False
    fn = parts[1]
    return (fn[:1].islower() and fn not in _NON_TENSOR
            and fn not in _NON_TENSOR_MODULES
            and not fn.startswith(("is_", "get_", "set_", "use_")))


class _Tensors:
    """Which expressions of one function are provably tensors."""

    def __init__(self, aliases: Dict[str, str], names: Set[str]):
        self.aliases = aliases
        self.names = names

    def __call__(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            if isinstance(e.func, ast.Attribute) and \
                    self(e.func.value):
                attr = e.func.attr
                if attr in _PAIR_METHODS:
                    return not (e.args or e.keywords)
                return attr not in _NON_TENSOR_METHODS
            return _tensor_call(_resolved(e.func, self.aliases))
        if isinstance(e, ast.BinOp):
            return self(e.left) or self(e.right)
        if isinstance(e, ast.UnaryOp) and not isinstance(e.op, ast.Not):
            return self(e.operand)
        if isinstance(e, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return any(self(x) for x in [e.left] + list(e.comparators))
        if isinstance(e, ast.Subscript):
            return self(e.value)
        if isinstance(e, ast.Attribute):
            return e.attr in _TENSOR_ATTRS and self(e.value)
        return False


def _annotated_tensor(a: ast.arg, aliases: Dict[str, str]) -> bool:
    return a.annotation is not None and \
        _resolved(a.annotation, aliases) in ("torch.Tensor", "Tensor")


def _check_host_reads(fn, aliases: Dict[str, str]
                      ) -> List[Tuple[int, str, str]]:
    """Host reads of provable tensors in ``fn``'s own body (nested defs
    are checked on their own, with the names they see bound here)."""
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    names = {a.arg for a in args if _annotated_tensor(a, aliases)}
    is_t = _Tensors(aliases, names)
    out: List[Tuple[int, str, str]] = []

    def own_nodes(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            yield child
            yield from own_nodes(child)

    # bindings first (in source order: a name is a tensor once any
    # single-name assignment in the body binds it from a tensor)
    stmts = sorted((n for n in own_nodes(fn)
                    if isinstance(n, (ast.Assign, ast.AnnAssign,
                                      ast.AugAssign))),
                   key=lambda n: (n.lineno, n.col_offset))
    for st in stmts:
        targets = st.targets if isinstance(st, ast.Assign) else [st.target]
        for t in targets:
            if isinstance(t, ast.Name) and st.value is not None \
                    and is_t(st.value):
                names.add(t.id)

    def read(node, what):
        out.append((node.lineno, "FDT004",
                    f"{what} in '{fn.name}' reads a tensor's value on the "
                    "host — it waits for the card and fails on meta "
                    "tensors"))

    def tested(test) -> bool:
        if isinstance(test, ast.BoolOp):
            return any(tested(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return tested(test.operand)
        return is_t(test)

    for node in own_nodes(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in ("item", "tolist") and is_t(f.value):
                read(node, f"'.{f.attr}()'")
            elif isinstance(f, ast.Name) and \
                    f.id in ("int", "float", "bool") and \
                    len(node.args) == 1 and is_t(node.args[0]):
                read(node, f"'{f.id}(...)' of a tensor")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if tested(node.test):
                read(node, f"'{type(node).__name__.lower()}' on a tensor")
    return out


# ----------------------------------------------------------- entry points
def lint_source(source: str, filename: str) -> List[Finding]:
    """The findings of one file's source; ``filename`` also decides the
    scope of FDT001 (library code: a path under ``repro_torch/``) and
    FDT004 (step code: ``models/``, ``launch/steps.py``,
    ``kernels/*/ops.py`` under ``repro_torch/``)."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Finding("lint", "parse", filename, e.lineno or 0,
                        f"syntax error: {e.msg}")]
    sup = _suppressions(source)
    aliases = _aliases(tree)
    raw: List[Tuple[int, str, str]] = []
    raw += _check_import_time_device(tree, aliases)
    if _is_library(filename):
        raw += _check_shared_randomness(tree, aliases)
    step = _is_step_code(filename)
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            raw += _check_mutable_defaults(fn)
            if step:
                raw += _check_host_reads(fn, aliases)
    out = []
    for line, rule, msg in sorted(set(raw)):
        if rule in sup.get(line, ()):
            continue
        out.append(Finding("lint", rule, filename, line, msg))
    return out


def lint_file(path: Path) -> List[Finding]:
    return lint_source(Path(path).read_text(), str(path))


def iter_py_files(roots: Sequence[str]) -> List[Path]:
    """Every ``*.py`` under each root: a file, a directory (recursively)
    or a glob pattern."""
    files: List[Path] = []
    for root in roots:
        matches = sorted(glob.glob(str(root))) if glob.has_magic(str(root)) \
            else [str(root)]
        for m in matches:
            p = Path(m)
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py" and p.exists():
                files.append(p)
    return files


def lint_roots(roots: Optional[Sequence[str]] = None
               ) -> Tuple[List[Finding], int]:
    """Lint every ``*.py`` under the roots (default: ``DEFAULT_ROOTS``
    under the repository's root); returns (findings, files checked)."""
    if roots is None:
        roots = [str(ROOT / r) for r in DEFAULT_ROOTS]
    files = iter_py_files(roots)
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_file(f))
    return findings, len(files)

