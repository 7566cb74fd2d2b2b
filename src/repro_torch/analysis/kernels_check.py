"""CUDA kernel validator — the port's counterpart of the JAX package's
Pallas validator (``analysis/kernels_check.py``), which reads the grid
mappings of traced ``pallas_call``s. A CUDA kernel has no traced grid
mapping; what the card holds it to is each block's resources and each
wrapper's launch. Two halves:

  * *Resources* (the counterpart of the VMEM budget). ptxas's ``-v``
    report of each of the four sources (``kernels/build.py``
    ``ptxas_report``: ``fedavg``, ``flash_attention``, ``swa_attention``,
    ``netchange``), every template instantiation:

      - registers ≤ 255 a thread, and registers × the block's threads
        ≤ 65,536 (an SM's register file: a block that needs more cannot
        launch);
      - no spill stores or loads, except the known spills of
        ``SPILL_ALLOWED``, each named with where ``PERF.md`` records it;
      - static shared memory plus the largest dynamic shared memory a
        launch requests ≤ 232,448 B (227 KB, Hopper's per-block
        opt-in limit). The dynamic bytes come from the libraries' own C
        entries where they depend on the head dim (``flash_smem_bytes``
        through ``flash.smem_bytes``, ``swa_prefill_smem_bytes`` through
        ``swa.prefill_smem_bytes``) and from the wrappers' caps
        elsewhere (the fedavg kernels stage ``K ≤ MAX_K`` weights;
        NetChange's column kernel at most ``12288`` columns).

  * *Launch surface* (the reference's ``cases()``, its shapes): every op
    wrapper on CUDA tensors at lane-odd, even and multi-MiB planes,
    flash attention forward and backward (causal GQA, a window band,
    a short sequence), the leaf-shaped wrappers, and — beyond the
    reference — the serving kernels and NetChange's To-Wider. Each case
    must launch its own kernel (the CUDA kernel names the profiler sees:
    "no-kernel" otherwise) and return the caller's shape ("pad-slice").
    The reference's lane-odd head dim (hd 72) is a case of its own here:
    the port's attention kernels are built for ``HEAD_DIMS`` (no hd 72),
    so the wrapper must raise its documented error.

Both halves need the card (the reports exist once the sources are
built, the cases launch): ``check_all`` raises without one and never
reports clean without having read the reports. The parser and the
limits (``parse_ptxas``, ``check_resources``) are plain functions of
report text, tested on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import Finding

SOURCES = ("fedavg", "flash_attention", "swa_attention", "netchange")
MAX_REGISTERS = 255                 # a thread (sm_90)
REGISTER_FILE = 65_536              # 32-bit registers an SM
SMEM_LIMIT = 232_448                # B a block, with the opt-in (227 KB)
# the block size of every kernel template of the four sources (their
# launches in csrc/*.cu: kThreads, kTileThreads, kBwdThreads,
# kDecThreads, kRowThreads)
THREADS = {"weighted_sum_kernel": 256, "plane_agg_kernel": 256,
           "plane_accum_kernel": 256, "plane_accum_q_kernel": 256,
           "plane_finish_kernel": 256, "flash_fwd_kernel": 256,
           "flash_bwd_dq_kernel": 256, "flash_bwd_dkv_kernel": 256,
           "swa_decode_kernel": 128, "swa_prefill_kernel": 256,
           "widen_cols_smem_kernel": 512, "widen_cols_kernel": 256,
           "widen_rows_kernel": 256}
# known spills: (instantiation pattern, most bytes) -> where PERF.md
# records what the spill costs
SPILL_ALLOWED = {
    (r"swa_decode_kernel<256, 1, f32>", 12):
        "PERF.md §6, the ptxas table: hd 256 decode, 5.8% faster than "
        "its build without the spill",
}
FEDAVG_MAX_K = 48 * 1024 // 4       # kernels/fedavg/fedavg.py MAX_K
WIDEN_MAX_SMEM_COLS = 12288         # csrc/netchange.cu kMaxSmemCols


@dataclasses.dataclass(frozen=True)
class Instance:
    """One kernel instantiation of ptxas's report."""
    source: str
    mangled: str
    stem: str                  # e.g. "flash_fwd_kernel"
    name: str                  # e.g. "flash_fwd_kernel<128>"
    args: Tuple[str, ...]      # template arguments, e.g. ("128",)
    registers: int
    smem: int                  # static shared bytes
    spill_stores: int
    spill_loads: int

    @property
    def spill(self) -> int:
        return max(self.spill_stores, self.spill_loads)


# -------------------------------------------------------------- the parser
_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS_FOR = re.compile(r"Function properties for (\w+)")
_PROPS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_WORDS = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "i8", "i": "i32"}


def _demangle(mangled: str) -> Tuple[str, Tuple[str, ...]]:
    """(the kernel's own name, its template arguments) from an Itanium
    mangled name: the last identifier of its (possibly nested, e.g. an
    anonymous namespace's) name, and the ``I ... E`` arguments read as
    ints (``Li128E``), bools (``Lb1E``) and types (``f``, ``a``,
    ``13__nv_bfloat16``)."""
    s, i = mangled, 2                     # past "_Z"
    if s[i:i + 1] == "N":
        i += 1
    stem = ""
    while i < len(s) and s[i].isdigit():
        m = re.match(r"\d+", s[i:])
        n = int(m.group(0))
        i += len(m.group(0))
        stem, i = s[i:i + n], i + n
    args: List[str] = []
    m = re.match(r"I((?:L[ib]\d+E|13__nv_bfloat16|[fai])+)E", s[i:])
    if m:
        for kind, num, typ in re.findall(
                r"L([ib])(\d+)E|(13__nv_bfloat16|[fai])", m.group(1)):
            if typ:
                args.append(_WORDS[typ])
            elif kind == "i":
                args.append(num)
            else:
                args.append(("false", "true")[int(num)])
    return stem, tuple(args)


def parse_ptxas(text: str, source: str = "") -> List[Instance]:
    """Every kernel instantiation of a ptxas ``-v`` report: its
    registers, static shared bytes and spill bytes."""
    out: List[Instance] = []
    cur: Optional[dict] = None

    def close():
        if cur is not None and "registers" in cur:
            stem, args = _demangle(cur["mangled"])
            name = f"{stem}<{', '.join(args)}>" if args else stem
            out.append(Instance(source, cur["mangled"], stem, name, args,
                                cur["registers"], cur.get("smem", 0),
                                cur.get("stores", 0), cur.get("loads", 0)))

    props_for = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            close()
            cur = {"mangled": m.group(1)}
            continue
        if cur is None:
            continue
        m = _PROPS_FOR.search(line)
        if m:
            # a called device function's properties are not the entry's
            props_for = m.group(1)
            continue
        m = _PROPS.search(line)
        if m and props_for == cur["mangled"]:
            cur["stores"], cur["loads"] = map(int, m.groups())
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    close()
    return out


# -------------------------------------------------------------- the limits
def _allowed_spill(inst: Instance) -> Optional[Tuple[int, str]]:
    for (pattern, most), why in SPILL_ALLOWED.items():
        if re.fullmatch(pattern, inst.name):
            return most, why
    return None


def check_resources(instances: Sequence[Instance],
                    dynamic: Callable[[Instance], int],
                    threads: Optional[Dict[str, int]] = None
                    ) -> List[Finding]:
    """The per-block limits on every instantiation; ``dynamic(inst)`` is
    the most dynamic shared memory a launch of it requests."""
    threads = THREADS if threads is None else threads
    out: List[Finding] = []
    for inst in instances:
        where = f"{inst.source}/{inst.name}"
        n = threads.get(inst.stem)
        if n is None:
            out.append(Finding("kernels", "unknown-kernel", where, 0,
                               f"no block size known for {inst.stem} — "
                               "add it to THREADS"))
            continue
        if inst.registers > MAX_REGISTERS:
            out.append(Finding(
                "kernels", "registers", where, 0,
                f"{inst.registers} registers a thread > {MAX_REGISTERS}"))
        if inst.registers * n > REGISTER_FILE:
            out.append(Finding(
                "kernels", "register-file", where, 0,
                f"{inst.registers} registers × {n} threads = "
                f"{inst.registers * n} > {REGISTER_FILE}: the block "
                "cannot launch"))
        if inst.spill:
            allowed = _allowed_spill(inst)
            if allowed is None or inst.spill > allowed[0]:
                out.append(Finding(
                    "kernels", "spill", where, 0,
                    f"{inst.spill_stores} B spill stores, "
                    f"{inst.spill_loads} B spill loads"
                    + (f" (allowed {allowed[0]} B: {allowed[1]})"
                       if allowed else "")))
        dyn = dynamic(inst)
        if inst.smem + dyn > SMEM_LIMIT:
            out.append(Finding(
                "kernels", "smem-budget", where, 0,
                f"{inst.smem} B static + {dyn} B dynamic shared memory = "
                f"{inst.smem + dyn} B > {SMEM_LIMIT} B a block"))
    return out


def dynamic_smem(inst: Instance) -> int:
    """The most dynamic shared memory a launch of ``inst`` requests: the
    attention kernels' from their libraries' C entries at the
    instantiation's head dim (built: needs the card's toolchain), the
    others from their wrappers' caps."""
    if inst.stem.startswith("flash_"):
        from repro_torch.kernels.flash_attention import flash as ff
        kernel = inst.stem[:-len("_kernel")]
        return ff.smem_bytes(int(inst.args[0]))[kernel]
    if inst.stem == "swa_prefill_kernel":
        from repro_torch.kernels.swa_attention import swa as sk
        return sk.prefill_smem_bytes(int(inst.args[0]))[
            {"f32": "float32", "bf16": "bfloat16"}[inst.args[1]]]
    if inst.source == "fedavg":
        return FEDAVG_MAX_K * 4
    if inst.stem == "widen_cols_smem_kernel":
        return WIDEN_MAX_SMEM_COLS * 4
    return 0


def resources() -> List[Instance]:
    """Every instantiation of the four built sources (built first)."""
    from repro_torch.kernels import build as kbuild
    out: List[Instance] = []
    for name in SOURCES:
        kbuild.build(name)
        found = parse_ptxas(kbuild.ptxas_report(name), name)
        if not found:
            raise RuntimeError(f"ptxas's report of {name}.cu names no "
                               "kernel: was it built with -Xptxas -v?")
        out.extend(found)
    return out


# ---------------------------------------------------------- launch surface
@dataclasses.dataclass(frozen=True)
class LaunchCase:
    """``fn(*make(dev))`` must launch a kernel named ``kernels`` (each a
    substring of a CUDA kernel name the profiler records) and return
    ``expect`` (a shape, or a tuple of shapes for a tuple result); with
    ``raises`` it must raise that error instead, its message holding
    ``expect``."""
    name: str
    fn: Callable
    make: Callable
    expect: object
    kernels: Tuple[str, ...] = ()
    raises: Optional[type] = None


def cases() -> List[LaunchCase]:
    """The launch surface at the reference's shapes, plus the serving
    and NetChange kernels."""
    import torch

    from repro_torch.kernels.fedavg import ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.netchange import ops as wops
    from repro_torch.kernels.swa_attention import ops as sops

    def rand(dev, *shape, dtype=torch.float32, lo=None, hi=None):
        g = torch.Generator(device=dev).manual_seed(math.prod(shape) % 9973)
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.rand(shape, generator=g, device=dev) + 0.5

    def mask(dev, *shape):
        g = torch.Generator(device=dev).manual_seed(3)
        return (torch.rand(shape, generator=g, device=dev) > 0.3).float()

    out: List[LaunchCase] = []
    K = 8
    n_odd = 4096 * 3 + 517        # 12,805: lane-odd
    n_even = 4096 * 4             # 16,384
    n_big = 1 << 22               # 4,194,304: 128 MiB of stacked rows
    for n in (n_odd, n_even, n_big):
        out.append(LaunchCase(
            f"plane_agg/N={n}", lambda p, w: ops.plane_agg(p, w),
            lambda d, n=n: (rand(d, K, n), rand(d, K)), (n,),
            ("weighted_sum_kernel",)))
        out.append(LaunchCase(
            f"plane_agg_masked/N={n}",
            lambda p, w, m: ops.plane_agg(p, w, masks=m),
            lambda d, n=n: (rand(d, K, n), rand(d, K), mask(d, K, n)), (n,),
            ("plane_agg_kernel",)))
        out.append(LaunchCase(
            f"plane_agg_mult_fb/N={n}",
            lambda p, w, m, mu, fb: ops.plane_agg(p, w, masks=m, mult=mu,
                                                  fallback=fb),
            lambda d, n=n: (rand(d, K, n), rand(d, K), mask(d, K, n),
                            rand(d, K, n), rand(d, n)), (n,),
            ("plane_agg_kernel",)))
    # the streamed pair behind fedavg_stacked(layout="stream"): a chunk
    # of Kc client rows into (n,) accumulators
    Kc = 4
    tile = 256

    def acc(d, n):
        return (torch.zeros(n, device=d), torch.zeros(n, device=d),
                torch.zeros(n, device=d))

    def first(res):
        return res[0]
    for n in (n_odd, n_even, n_big):
        nt = -(-n // tile)
        out.append(LaunchCase(
            f"plane_accum/N={n}",
            lambda nm, dn, cv, c, w: first(ops.plane_accum(nm, dn, cv, c, w)),
            lambda d, n=n: acc(d, n) + (rand(d, Kc, n), rand(d, Kc)), (n,),
            ("plane_accum_kernel",)))
        out.append(LaunchCase(
            f"plane_accum_masked_mult/N={n}",
            lambda nm, dn, cv, c, w, m, mu: first(ops.plane_accum(
                nm, dn, cv, c, w, masks=m, mult=mu)),
            lambda d, n=n: acc(d, n) + (rand(d, Kc, n), rand(d, Kc),
                                        mask(d, Kc, n), rand(d, Kc, n)),
            (n,), ("plane_accum_kernel",)))
        out.append(LaunchCase(
            f"plane_finish/N={n}",
            lambda nm, dn, cv, fb: ops.plane_finish(nm, dn, cv, fallback=fb),
            lambda d, n=n: (rand(d, n), rand(d, n), mask(d, n), rand(d, n)),
            (n,), ("plane_finish_kernel",)))
        out.append(LaunchCase(
            f"plane_accum_q/N={n}",
            lambda nm, dn, cv, c, s, w: first(ops.plane_accum_q(
                nm, dn, cv, c, s, w, tile=tile)),
            lambda d, n=n, nt=nt: acc(d, n) + (
                rand(d, Kc, n, dtype=torch.int8), rand(d, Kc, nt),
                rand(d, Kc)), (n,), ("plane_accum_q_kernel",)))
        out.append(LaunchCase(
            f"plane_accum_q_masked_mult/N={n}",
            lambda nm, dn, cv, c, s, w, m, mu: first(ops.plane_accum_q(
                nm, dn, cv, c, s, w, masks=m, mult=mu, tile=tile)),
            lambda d, n=n, nt=nt: acc(d, n) + (
                rand(d, Kc, n, dtype=torch.int8), rand(d, Kc, nt),
                rand(d, Kc), mask(d, Kc, n), rand(d, Kc, n)), (n,),
            ("plane_accum_q_kernel",)))
        out.append(LaunchCase(
            f"plane_accum_q_fold/N={n}",
            lambda nm, dn, cv, c, s, w, m, b: first(ops.plane_accum_q(
                nm, dn, cv, c, s, w, masks=m, base=b, tile=tile)),
            lambda d, n=n, nt=nt: acc(d, n) + (
                rand(d, Kc, n, dtype=torch.int8), rand(d, Kc, nt),
                rand(d, Kc), mask(d, Kc, n), rand(d, n)), (n,),
            ("plane_accum_q_kernel",)))
    # flash attention: forward, and the backward through autograd (dq and
    # dk/dv kernels); q (B, Sq, KV, G, hd), k, v (B, Sk, KV, hd)

    def flash_in(d, B, Sq, Sk, KV, G, hd, grad=False):
        q = rand(d, B, Sq, KV, G, hd) - 1.0
        k = rand(d, B, Sk, KV, hd) - 1.0
        v = rand(d, B, Sk, KV, hd)
        if grad:
            q, k, v = (t.requires_grad_() for t in (q, k, v))
        return (q, k, v, torch.arange(Sq, device=d, dtype=torch.int32),
                torch.arange(Sk, device=d, dtype=torch.int32))

    flash_shapes = (
        ("causal_gqa", (2, 256, 256, 2, 4, 128), True, 0),
        ("window", (1, 256, 256, 1, 8, 64), True, 64),
        ("sublane", (1, 8, 8, 2, 2, 64), True, 0),
    )
    for tag, (B, Sq, Sk, KV, G, hd), causal, window in flash_shapes:
        def fwd(q, k, v, qp, kp, c=causal, w=window):
            return fops.flash_attention(q, k, v, qp, kp, causal=c, window=w)

        def bwd(q, k, v, qp, kp, c=causal, w=window):
            o = fops.flash_attention(q, k, v, qp, kp, causal=c, window=w)
            return torch.autograd.grad(o.sum(), (q, k, v))

        shp = (B, Sq, Sk, KV, G, hd)
        out.append(LaunchCase(
            f"flash_fwd/{tag}", fwd, lambda d, s=shp: flash_in(d, *s),
            (B, Sq, KV * G, hd), ("flash_fwd_kernel",)))
        out.append(LaunchCase(
            f"flash_bwd/{tag}", bwd,
            lambda d, s=shp: flash_in(d, *s, grad=True),
            ((B, Sq, KV, G, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)),
            ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")))
    # the reference's lane-odd head dim: not a head dim the kernels are
    # built for, so the wrapper raises its documented error
    out.append(LaunchCase(
        "flash_fwd/cross_laneodd", lambda q, k, v, qp, kp:
        fops.flash_attention(q, k, v, qp, kp, causal=False),
        lambda d: flash_in(d, 2, 128, 192, 2, 1, 72), "head dim 72",
        raises=ValueError))
    # leaf-shaped wrappers: lane-odd, sub-lane and wide leaves
    for shape in ((33, 7), (5,), (256, 130)):
        out.append(LaunchCase(
            f"weighted_sum/{shape}", lambda s, w: ops.weighted_sum(s, w),
            lambda d, shape=shape: (rand(d, K, *shape), rand(d, K)), shape,
            ("weighted_sum_kernel",)))
        out.append(LaunchCase(
            f"weighted_sum_masked/{shape}",
            lambda s, w, m: ops.weighted_sum_masked(s, w, m),
            lambda d, shape=shape: (rand(d, K, *shape), rand(d, K),
                                    mask(d, K, *shape)), shape,
            ("plane_agg_kernel",)))
        out.append(LaunchCase(
            f"weighted_sum_masked_mult/{shape}",
            lambda s, w, m, mu: ops.weighted_sum_masked(s, w, m, mult=mu,
                                                        renorm=False),
            lambda d, shape=shape: (rand(d, K, *shape), rand(d, K),
                                    mask(d, K, *shape), rand(d, K, *shape)),
            shape, ("plane_agg_kernel",)))
    # the serving kernels and NetChange's To-Wider (no reference case:
    # rows 10-12 of PERF.md §6)
    B, KV, G, S, hd, W = 2, 2, 4, 300, 128, 64
    out.append(LaunchCase(
        "swa_decode/ring", lambda q, k, v, kp: sops.decode_attention(
            q, k, v, kp, S - 1, window=W),
        lambda d: (rand(d, B, KV * G, hd), rand(d, B, W, KV, hd),
                   rand(d, B, W, KV, hd),
                   torch.arange(S - W, S, device=d, dtype=torch.int32)),
        (B, KV * G, hd), ("swa_decode_kernel",)))
    out.append(LaunchCase(
        "swa_prefill/band", lambda q, k, v: sops.swa_prefill(q, k, v,
                                                             window=W),
        lambda d: (rand(d, 1, KV, G, S, 64), rand(d, 1, S, KV, 64),
                   rand(d, 1, S, KV, 64)),
        (1, KV, G, S, 64), ("swa_prefill_kernel",)))
    for name, axis, shape, new in (("cols", 1, (96, 130), 200),
                                   ("rows", 0, (130, 96), 200)):
        out.append(LaunchCase(
            f"widen_2d/{name}", lambda x, m, a=axis: wops.widen(
                x, m, axis=a, split=True),
            lambda d, shape=shape, new=new, a=axis: (
                rand(d, *shape), _mapping(shape[a], new)),
            tuple(new if i == axis else s for i, s in enumerate(shape)),
            ("widen_",)))
    return out


def _mapping(old: int, new: int):
    from repro_torch.core.netchange import dup_mapping
    return dup_mapping(old, new, tag="kernels_check", seed=0)


def _shapes(res):
    if isinstance(res, (tuple, list)):
        return tuple(tuple(r.shape) for r in res)
    return tuple(res.shape)


PROFILE_TRIES = 3


def run_case(case: LaunchCase, dev) -> Tuple[List[Finding], List[str]]:
    """Launch one case under the profiler; returns its findings and the
    CUDA kernel names it launched. A profile that recorded no CUDA event
    at all, of a call that returned tensors on the card, is the
    profiler's miss (it read nothing in 2 of 47 cases of one card run),
    so the case runs again under a new profiler, ``PROFILE_TRIES`` times
    at most; the last profile's names are checked."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = case.make(dev)
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize(dev)
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = case.fn(*args)
                torch.cuda.synchronize(dev)
        except Exception as e:
            if case.raises is not None and isinstance(e, case.raises) and \
                    str(case.expect) in str(e):
                return [], []
            return [Finding("kernels", "launch-crash", case.name, 0,
                            f"raised {type(e).__name__}: {e}")], []
        if case.raises is not None:
            return [Finding("kernels", "no-refusal", case.name, 0,
                            f"expected {case.raises.__name__} "
                            f"'{case.expect}', the wrapper ran")], []
        names = sorted({e.name for e in prof.events()
                        if e.device_type.name == "CUDA"})
        if names:
            break
    return case_findings(case.name, names, _shapes(res), case.expect,
                         case.kernels), names


def case_findings(name: str, launched: Sequence[str], got, expect,
                  kernels: Sequence[str]) -> List[Finding]:
    """The two launch checks on what a case did: each expected kernel
    among the CUDA kernel names launched ("no-kernel"), the result's
    shape the caller's ("pad-slice")."""
    out: List[Finding] = []
    for k in kernels:
        if not any(k in n for n in launched):
            out.append(Finding(
                "kernels", "no-kernel", name, 0,
                f"no CUDA kernel named '{k}' launched (saw "
                f"{sorted(launched)}) — the wrapper fell off its kernel"))
    if tuple(got) != tuple(expect):
        out.append(Finding(
            "kernels", "pad-slice", name, 0,
            f"wrapper output {got} != caller shape {expect} — padded "
            "columns leak out of the kernel"))
    return out


def _short(kernel: str) -> str:
    """A profiler's kernel name without its namespace and parameters
    (``plane_agg_kernel<true, false, true>``); other events as they
    are."""
    m = re.search(r"(\w+_kernel)(<[^()]*>)?\(", kernel)
    return m.group(1) + (m.group(2) or "") if m else kernel.split("<")[0]


def check_all(*, verbose: bool = False) -> Tuple[List[Finding], int]:
    """Both halves on the card: every instantiation of the four built
    sources, then every launch case. Returns (findings, number of
    instantiations + cases). Raises without a card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the kernels pass reads the built libraries' "
                           "ptxas reports and launches their kernels: it "
                           "needs a CUDA device, and there is none")
    dev = torch.device("cuda", torch.cuda.current_device())
    insts = resources()
    findings = check_resources(insts, dynamic_smem)
    if verbose:
        for i in insts:
            print(f"  ptxas {i.source} {i.name}: {i.registers} registers × "
                  f"{THREADS.get(i.stem)} threads, {i.smem} B static + "
                  f"{dynamic_smem(i)} B dynamic shared, {i.spill_stores} / "
                  f"{i.spill_loads} B spilled")
    all_cases = cases()
    for case in all_cases:
        fs, names = run_case(case, dev)
        findings.extend(fs)
        if verbose:
            print(f"  case {case.name}: "
                  + (", ".join(sorted({_short(n) for n in names}))
                     if names else f"raised as documented ({case.expect})")
                  + (f" — {len(fs)} finding(s)" if fs else ""))
    torch.cuda.empty_cache()
    return findings, len(insts) + len(all_cases)
