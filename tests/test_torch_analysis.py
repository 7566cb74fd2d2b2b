"""The port's analysis layer (``repro_torch.analysis``), the counterpart
of ``tests/test_analysis.py``.

Lint rules are exercised on inline source snippets (the hazard fires,
the idiomatic form is silent, a ``fedlint: ignore`` suppresses) and the
port's own files lint clean; the contract checker runs clean in quick
mode and over the whole registry matrix, each contract fires on an
injected defect, and the coverage, multiplicity and ``PlaneSpec``
layouts it checks are bit-equal to the JAX package's; the kernel
validator's ptxas parser and limits fire on report text (a spill,
shared memory over a block's 232,448 B, a register blow-up) and its
launch checks on a missing kernel and a padded output, and the pass
refuses to report without a card; the CLI exits 0/1 accordingly.
"""
import dataclasses
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.vgg_family import PAPER_COHORT as JCOHORT  # noqa: E402
from repro.configs.vgg_family import scaled as jscaled  # noqa: E402
from repro.configs.vgg_family import vgg as jvgg  # noqa: E402
from repro.core import plane as jplane  # noqa: E402
from repro.core import tfamily as jtfamily  # noqa: E402
from repro.core.aggregation import (coverage_and_filler as jcov,  # noqa: E402
                                    global_shapes as jshapes,
                                    multiplicity as jmult)
from repro.core.family import TransformerFamily as JTFamily  # noqa: E402
from repro.core.family import VGGFamily as JVGGFamily  # noqa: E402
from repro.core.segments import path_keys  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.analysis import Finding, Report, run  # noqa: E402
from repro_torch.analysis import contracts, kernels_check, lint  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402
from repro_torch.core import plane  # noqa: E402
from repro_torch.core.aggregation import (coverage_and_filler,  # noqa: E402
                                          multiplicity)
from repro_torch.core.family import TransformerFamily  # noqa: E402

LIB = "src/repro_torch/core/snippet.py"          # library code (FDT001)
STEP = "src/repro_torch/models/snippet.py"       # step code (FDT004)


def _lint(src, filename=LIB):
    return lint.lint_source(textwrap.dedent(src), filename)


def _rules(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------------- FDT001
def test_fdt001_draw_without_generator_fires():
    fs = _lint("""
        import torch
        def f(n):
            return torch.randn(n) + torch.rand(n, generator=None)
    """)
    # an explicit generator= (even None, the caller's choice) is silent
    assert _rules(fs) == ["FDT001"]
    assert "randn" in fs[0].msg


def test_fdt001_explicit_generator_is_silent():
    assert _lint("""
        import torch
        def f(n, g: torch.Generator):
            a = torch.randn(n, generator=g)
            b = torch.empty(n).normal_(generator=g)
            c = torch.randint(0, 9, (n,), generator=g)
            return a + b + c
    """) == []


def test_fdt001_reseed_and_inplace_draws():
    fs = _lint("""
        import torch
        def f(x):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            x.uniform_()
            return torch.nn.init.normal_(x)
    """)
    assert _rules(fs) == ["FDT001"] * 4


def test_fdt001_only_in_library_code():
    # a test or a script may draw from the global stream it seeds
    src = """
        import torch
        torch.manual_seed(0)
        X = torch.randn(4)
    """
    assert _lint(src, "tests/test_torch_x.py") == []
    assert _lint(src, "chip_smoke.py") == []
    assert _rules(_lint(src)) == ["FDT001", "FDT001"]


def test_fdt001_aliases_resolve():
    fs = _lint("""
        import torch as T
        from torch import randn
        def f(n):
            return T.rand(n) + randn(n)
    """)
    assert _rules(fs) == ["FDT001", "FDT001"]


def test_fdt001_non_random_names_exempt():
    assert _lint("""
        import numpy as np
        import torch
        def f(n, rng: np.random.Generator):
            key_pos = torch.arange(n)
            return key_pos + torch.as_tensor(rng.normal(size=n))
    """) == []


def test_fdt001_suppression_comment():
    assert _lint("""
        import torch
        def f(n):
            return torch.randn(n)  # fedlint: ignore[FDT001] global stream on purpose
    """) == []


# ------------------------------------------------------------- FDT002
def test_fdt002_mutable_default():
    fs = _lint("""
        def f(x, opts={}, *, keys=[]):
            return x
    """)
    assert _rules(fs) == ["FDT002", "FDT002"]
    assert _lint("""
        def f(x, n=3, opts=None, keys=()):
            return x
    """) == []


# ------------------------------------------------------------- FDT003
def test_fdt003_device_work_at_import():
    fs = _lint("""
        import torch
        from repro_torch.kernels import build as kbuild
        TABLE = torch.arange(1024, device="cuda")
        DEV = torch.zeros(3, device=torch.device("cuda", 0))
        MOVED = torch.ones(2).cuda()
        TO = torch.ones(2).to("cuda:0")
        torch.cuda.synchronize()
        LIB = kbuild.build("fedavg")
    """)
    assert _rules(fs) == ["FDT003"] * 6
    # CPU tensors at import, the availability query, device work inside
    # functions and under an ``if`` guard are not import work
    assert _lint("""
        import torch
        TABLE = torch.arange(1024)
        HAS_CARD = torch.cuda.is_available()
        def f():
            return torch.zeros(3, device="cuda")
        if __name__ == "__main__":
            torch.cuda.synchronize()
    """) == []


# ------------------------------------------------------------- FDT004
def test_fdt004_host_reads_in_step_code_fire():
    fs = _lint("""
        import torch
        def f(x, y: torch.Tensor):
            t = torch.arange(4) * 2
            n = int(t.sum())
            m = t.max().item()
            if y > 0:
                pass
            rows = y.tolist()
            return bool(t[0]), float(y.mean())
    """, STEP)
    assert _rules(fs) == ["FDT004"] * 6


def test_fdt004_static_reads_and_other_files_exempt():
    src = """
        import torch
        def f(x, y: torch.Tensor, cfg, pos):
            if y.shape[0] > 2 and y.dim() == 3:
                pass
            if y is None or cfg.n > 2:
                pass
            n = int(pos)
            vals, idx = y.max(-1)
            return n + x.item()
    """
    # shape reads, None tests, names not provably tensors: silent
    assert _lint(src, STEP) == []
    hot = """
        import torch
        def f(y: torch.Tensor):
            return y.item()
    """
    assert _rules(_lint(hot, STEP)) == ["FDT004"]
    assert _rules(_lint(hot, "src/repro_torch/launch/steps.py")) == \
        ["FDT004"]
    assert _rules(_lint(
        hot, "src/repro_torch/kernels/fedavg/ops.py")) == ["FDT004"]
    # outside steps and op wrappers a host read is allowed
    assert _lint(hot, "src/repro_torch/fl/engine.py") == []


def test_findings_carry_location():
    fs = _lint("""
        def f(x, opts={}):
            return x
    """)
    (f,) = fs
    assert f.where == LIB and f.line > 0
    assert "FDT002" in f.format()


def test_the_port_lints_clean():
    findings, n = lint.lint_roots()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert n > 100


# ----------------------------------------------------------- contracts
def test_contracts_quick_mode_clean():
    report = run(["contracts"], quick=True)
    assert report.ok, "\n".join(f.format() for f in report.findings)
    assert report.checked["contracts"] == 3   # vgg + 2 transformer archs


def test_contracts_full_matrix_clean():
    from repro_torch.models.registry import arch_ids
    findings, n = contracts.check_all()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert n == 1 + len(arch_ids())


def _rules_of(fn, case):
    return {f.rule for f in fn(case)}


@dataclasses.dataclass(frozen=True)
class _DropsLeaf(TransformerFamily):
    """up() loses the output projection; down() returns a wrong dtype."""

    def up(self, params, from_cfg, to_cfg, *, seed=0):
        out = dict(super().up(params, from_cfg, to_cfg, seed=seed))
        out.pop("lm_head", None)
        return out

    def down(self, params, from_cfg, to_cfg, *, seed=0, mode="paper"):
        out = super().down(params, from_cfg, to_cfg, seed=seed, mode=mode)
        return tu.tree_map(lambda t: t.double(), out)


@dataclasses.dataclass(frozen=True)
class _BadSpec(TransformerFamily):
    """segment_spec forgets every widened axis."""

    def segment_spec(self, client_cfg, global_cfg, *, seed=0):
        return {}


@dataclasses.dataclass(frozen=True)
class _LeakyFiller(TransformerFamily):
    """up() puts a constant on every coordinate (nonzero filler where
    the client lands)."""

    def up(self, params, from_cfg, to_cfg, *, seed=0):
        out = super().up(params, from_cfg, to_cfg, seed=seed)
        return tu.tree_map(lambda t: t + 0.5, out)


def _case(family, arch="glm4-9b"):
    c = contracts.transformer_cohort(arch)
    return dataclasses.replace(c, family=family)


def test_each_contract_fires_on_an_injected_defect(monkeypatch):
    assert {"up-shape", "down-shape[paper]"} <= _rules_of(
        contracts.check_updown, _case(_DropsLeaf()))
    assert "segment-coverage" in _rules_of(contracts.check_segment_spec,
                                           _case(_BadSpec()))
    assert {"coverage-loosen", "coverage-disjoint"} & _rules_of(
        contracts.check_coverage, _case(_LeakyFiller()))
    case = contracts.transformer_cohort("glm4-9b")
    # a multiplicity one too high everywhere
    real_mult = contracts.multiplicity
    monkeypatch.setattr(contracts, "multiplicity", lambda *a, **k: tu.tree_map(
        lambda t: t + 1.0, real_mult(*a, **k)))
    assert "multiplicity" in _rules_of(contracts.check_multiplicity, case)
    monkeypatch.setattr(contracts, "multiplicity", real_mult)
    # a cohort outside the engine's domain (two different architectures)
    mixed = contracts.Case("transformer/mixed", TransformerFamily(), (
        contracts.transformer_cohort("glm4-9b").client_cfgs[1],
        contracts.transformer_cohort("gemma-7b").client_cfgs[1]))
    assert _rules_of(contracts.check_representable, mixed) == \
        {"representable"}
    # unpack that reverses the plane
    real_unpack = plane.unpack
    monkeypatch.setattr(plane, "unpack",
                        lambda x, spec: real_unpack(x.flip(0), spec))
    assert "plane-roundtrip" in _rules_of(contracts.check_plane, case)
    monkeypatch.setattr(plane, "unpack", real_unpack)
    # an int8 dequantize off by half a step
    from repro_torch.core import quant
    real_deq = quant.dequantize
    monkeypatch.setattr(quant, "dequantize",
                        lambda v, s=None, *, tile=256: real_deq(
                            v, s, tile=tile) * 1.01)
    assert {"quant-bf16", "quant-ef"} <= _rules_of(contracts.check_quant,
                                                   case)
    monkeypatch.setattr(quant, "dequantize", real_deq)
    # a flash path that drops the last query row
    from repro_torch.kernels import flash_attention as fa
    real_flash = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: real_flash(*a, **k)[:, :-1])
    assert "flash-parity" in _rules_of(contracts.check_flash, case)
    # a crashing check is itself a finding
    monkeypatch.setattr(contracts, "CHECKS", (lambda c: 1 / 0,))
    assert _rules(contracts.check_case(case)) == ["check-crash"]


def _ref_case(arch):
    """The reference's cohort of ``contracts.transformer_cohort(arch)``
    (``arch`` None: the VGG cohort)."""
    if arch is None:
        return JVGGFamily(), [jscaled(jvgg(a), 0.125, 32) for a in JCOHORT]
    fam = JTFamily()
    base = jreduced(jget_config(arch), n_units=2, d_model=64)
    for kw in (dict(n_units=1, ffn_scale=0.5), dict(n_units=1), dict()):
        variant = jtfamily.make_variant(base, **kw)
        if fam.segment_representable([variant, base]):
            break
    return fam, [variant, base]


def _jflat(tree):
    return {path_keys(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {p: t.float().numpy() for p, t in tu.flatten(tree)}


@pytest.mark.parametrize("arch", [None, "glm4-9b", "whisper-small"])
def test_checked_arrays_bit_equal_the_reference(arch):
    """The coverage masks, filler, multiplicity and PlaneSpec layout the
    contracts check are the JAX package's, bit for bit."""
    case = contracts.vgg_cohort() if arch is None else \
        contracts.transformer_cohort(arch)
    jfam, jcfgs = _ref_case(arch)
    fam = case.family
    union, junion = fam.union(list(case.client_cfgs)), jfam.union(jcfgs)
    spec = plane.PlaneSpec.from_tree(contracts.global_shapes(fam, union))
    jspec = jplane.PlaneSpec.from_tree(jshapes(jfam, junion))
    assert spec.to_manifest() == jspec.to_manifest()
    assert (spec.offsets, spec.size) == (tuple(jspec.offsets), jspec.size)
    for cfg, jcfg in zip(case.client_cfgs, jcfgs):
        strict, filler = coverage_and_filler(fam, cfg, union,
                                             seed=contracts.SEED)
        jstrict, jfiller = jcov(jfam, jcfg, junion, seed=contracts.SEED)
        mult = multiplicity(fam, cfg, union, seed=contracts.SEED)
        jm = jmult(jfam, jcfg, junion, seed=contracts.SEED)
        for mine, ref in ((strict, jstrict), (filler, jfiller), (mult, jm)):
            a, b = _tflat(mine), _jflat(ref)
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------- kernels
REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi128EEEvPKfS2_S2_PKiS4_PfS5_iiiiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi128EEEvPKfS2_S2_PKiS4_PfS5_iiiiiifii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 252 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compile time = 300.1 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117swa_decode_kernelILi256ELi1EfEEvPKviPKT1_S5_PKiPfS8_iiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117swa_decode_kernelILi256ELi1EfEEvPKviPKT1_S5_PKiPfS8_iiiiif
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 16 bytes cumulative stack size, 6192 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116plane_agg_kernelILb1ELb0ELb1EEEvPKfS2_S2_S2_S2_Pfix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116plane_agg_kernelILb1ELb0ELb1EEEvPKfS2_S2_S2_S2_Pfix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 380 bytes cmem[0]
"""


def _dyn(inst):
    return {"flash_fwd_kernel": 220_128, "plane_agg_kernel": 49_152}.get(
        inst.stem, 0)


def test_ptxas_parser_reads_every_instantiation():
    insts = kernels_check.parse_ptxas(REPORT, "x")
    assert [(i.name, i.registers, i.smem, i.spill) for i in insts] == [
        ("flash_fwd_kernel<128>", 252, 0, 0),
        ("swa_decode_kernel<256, 1, f32>", 96, 6192, 12),
        ("plane_agg_kernel<true, false, true>", 40, 0, 0)]
    # the allowed spill (PERF.md section 6) and the limits: clean
    assert kernels_check.check_resources(insts, _dyn) == []


def _rewritten(old, new):
    """The report with the first ``old`` (the first kernel's, where it
    recurs) replaced by ``new``."""
    return kernels_check.parse_ptxas(REPORT.replace(old, new, 1), "x")


def test_validator_detects_a_spill():
    insts = _rewritten("0 bytes stack frame, 0 bytes spill stores",
                       "8 bytes stack frame, 8 bytes spill stores")
    fs = kernels_check.check_resources(insts, _dyn)
    assert [(f.rule, f.where) for f in fs] == [("spill",
                                                "x/flash_fwd_kernel<128>")]
    # more than the allowed bytes of a known spill is a finding too
    insts = _rewritten("12 bytes spill stores", "16 bytes spill stores")
    assert "spill" in _rules(kernels_check.check_resources(insts, _dyn))
    # and so is a spill of another instance of the same template
    insts = kernels_check.parse_ptxas(
        REPORT.replace("ILi256ELi1EfEE", "ILi128ELi1EfEE"), "x")
    assert [(f.rule, f.where) for f in kernels_check.check_resources(
        insts, _dyn)] == [("spill", "x/swa_decode_kernel<128, 1, f32>")]


def test_validator_detects_smem_blowout():
    """Static plus dynamic shared memory over 232,448 B a block."""
    insts = _rewritten("6192 bytes smem", "6192 bytes smem")
    fs = kernels_check.check_resources(
        insts, lambda i: 230_000 if i.stem == "swa_decode_kernel" else 0)
    assert _rules(fs) == ["smem-budget"]
    assert "236192" in fs[0].msg


def test_validator_detects_register_blowup():
    insts = _rewritten("Used 40 registers", "Used 128 registers")
    fs = kernels_check.check_resources(
        insts, _dyn, threads={**kernels_check.THREADS,
                              "plane_agg_kernel": 1024})
    # 128 × 1024 threads > 65,536: the block cannot launch
    assert _rules(fs) == ["register-file"]
    insts = _rewritten("Used 252 registers", "Used 300 registers")
    assert {"registers", "register-file"} <= set(
        _rules(kernels_check.check_resources(insts, _dyn)))
    unknown = _rewritten("plane_agg_kernel", "mystery_kernel")
    assert "unknown-kernel" in _rules(
        kernels_check.check_resources(unknown, _dyn))


def test_launch_checks_detect_missing_kernel_and_pad_leak():
    seen = ["void (anonymous namespace)::plane_agg_kernel<true, false, "
            "true>(float const*, float*, int, long)"]
    assert kernels_check.case_findings("ok", seen, (100,), (100,),
                                       ("plane_agg_kernel",)) == []
    fs = kernels_check.case_findings("fake", ["at::native::reduce_kernel"],
                                     (100,), (100,), ("plane_agg_kernel",))
    assert _rules(fs) == ["no-kernel"]
    fs = kernels_check.case_findings("padleak", seen, (1024,), (1000,),
                                     ("plane_agg_kernel",))
    assert _rules(fs) == ["pad-slice"]


@pytest.mark.parametrize("empty,want", [
    (1, []),                                   # one miss: profiled again
    (kernels_check.PROFILE_TRIES, ["no-kernel"]),   # never seen: a finding
])
def test_run_case_profiles_again_after_an_empty_trace(monkeypatch, empty,
                                                       want):
    """A profile with no CUDA event at all is run again, at most
    ``PROFILE_TRIES`` times; a trace of other kernels is not. (The
    profiler and the card are stood in for: the case runs on the CPU.)"""
    import types

    import torch.profiler as tp
    traces = iter([[]] * empty + [["plane_agg_kernel<true>(float*)"]])
    runs = []

    class FakeProfile:
        def __init__(self, activities):
            self.names = next(traces, [])

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

        def events(self):
            cuda = types.SimpleNamespace(name="CUDA")
            return [types.SimpleNamespace(name=n, device_type=cuda)
                    for n in self.names]

    monkeypatch.setattr(tp, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    case = kernels_check.LaunchCase(
        "fake", lambda x: runs.append(1) or x, lambda dev: (torch.ones(4),),
        (4,), ("plane_agg_kernel",))
    fs, names = kernels_check.run_case(case, "cpu")
    assert _rules(fs) == want
    assert len(runs) == min(empty + 1, kernels_check.PROFILE_TRIES)
    # a trace of another kernel is the wrapper's fault: no second run
    traces = iter([["at::native::reduce_kernel"], []])
    runs.clear()
    fs, _ = kernels_check.run_case(case, "cpu")
    assert _rules(fs) == ["no-kernel"] and len(runs) == 1


def test_launch_surface_covers_every_kernel_family():
    names = [c.name for c in kernels_check.cases()]
    assert len(names) == len(set(names)) >= 45
    launched = {k for c in kernels_check.cases() for k in c.kernels}
    assert set(kernels_check.THREADS) >= {
        k for k in launched if k.endswith("_kernel")}
    assert any(c.raises is ValueError for c in kernels_check.cases())


@pytest.mark.skipif(torch.cuda.is_available(), reason="asserts the refusal "
                    "of the kernels pass where there is no card")
def test_kernels_pass_refuses_without_a_card(capsys):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        kernels_check.check_all()
    assert cli_main(["--pass", "kernels"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err


# ----------------------------------------------------------------- CLI
def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("import torch\nX = torch.ones(3)\n")
    assert cli_main(["--pass", "lint", "--lint-root", str(clean)]) == 0
    out = capsys.readouterr().out
    assert "clean" in out

    dirty = tmp_path / "dirty.py"
    dirty.write_text("import torch\nX = torch.ones(3, device='cuda')\n")
    assert cli_main(["--pass", "lint", "--lint-root", str(dirty)]) == 1
    out = capsys.readouterr().out
    assert "FDT003" in out


def test_report_api():
    f = Finding("lint", "FDT001", "x.py", 3, "msg")
    assert "x.py:3" in f.format() and "FDT001" in f.format()
    report = run(["lint"], lint_roots=["src/repro_torch/analysis"])
    assert report.ok and report.checked["lint"] > 0
    r = Report()
    r.extend("kernels", [dataclasses.replace(f, pass_name="kernels")], 2)
    assert not r.ok and r.summary_lines() == [
        "kernels: 2 case(s) checked — 1 finding(s)"]
