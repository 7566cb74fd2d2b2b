"""Static contract checker: the FedADP algebra, checked per architecture
on ``meta`` tensors (the JAX package's ``analysis/contracts.py``, where
``jax.eval_shape`` does what ``meta`` does here: shapes and dtypes, no
storage, no arithmetic).

For every architecture in ``models/registry.py`` (reduced to smoke
dimensions, as a heterogeneous variant cohort under
``TransformerFamily``) and for the paper's VGG cohort (scaled, under
``VGGFamily``), verify:

  * ``up``/``down``/``up(down(·))`` preserve tree structure, shapes and
    dtypes — on ``meta`` tensors, both narrow modes, no FLOPs;
  * ``segment_spec`` covers EXACTLY the width-differing axes of every
    client-owned union leaf (no missing axis, no spurious one), and each
    ``AxisSeg``'s ids/counts are consistent with the client extent;
  * ``coverage_mask`` invariants: masks are 0/1, loose ⊇ strict, the
    loose reading equals ``loosen(strict, filler)`` (parameter landing
    sites and filler constants are disjoint), computed on constant
    pushes of the tiny reduced configs (CPU tensors) — no model
    evaluation;
  * ``multiplicity`` matches the segment metadata: counts are integers
    ≥ 1, equal to the per-leaf product of segment sizes, 1 off the
    spec's leaves, and > 1 only on strictly-covered coordinates;
  * ``PlaneSpec`` pack → unpack → pack is the identity layout (on
    ``meta`` for shapes/dtypes, exact at value level on all-f32
    cohorts) and the ``to_manifest``/``from_manifest`` serialization
    round-trips;
  * the wire format (``core.quant``) on one ``(1, P)`` row;
  * the two attention backends (``kernels/flash_attention/ops.py``
    ``flash_attention`` and ``models/attention.py``
    ``blockwise_attention``) agree in shape and dtype on ``meta``, and
    the flash backward's cotangents have the primal shapes. Off the card
    ``flash_attention`` runs its plain version (``use_kernel=True``
    raises there, by the port's rule).

Nothing here runs a training step or a forward pass on values; the
whole registry matrix completes in seconds (acceptance: < 60 s).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.analysis import Finding
from repro_torch.configs import get_config, reduced
from repro_torch.configs.vgg_family import PAPER_COHORT, scaled, vgg
from repro_torch.core import plane, tfamily
from repro_torch.core.aggregation import (coverage_and_filler, coverage_mask,
                                          global_shapes, loosen,
                                          multiplicity)
from repro_torch.core.family import TransformerFamily, VGGFamily
from repro_torch.models.registry import arch_ids

SEED = 7           # one fixed NetChange seed for the whole matrix
NARROW_MODES = ("paper", "fold")
META = torch.device("meta")
CPU = torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Case:
    """One (family, cohort) cell of the contract matrix."""
    name: str                 # e.g. "transformer/glm4-9b", "vgg/paper"
    family: Any
    client_cfgs: Tuple[Any, ...]


# ------------------------------------------------------------ enumeration
def transformer_cohort(arch: str) -> Case:
    """A depth + width heterogeneous variant cohort of one registry
    architecture, at smoke dimensions (``configs.reduced``). Prefers the
    widest heterogeneity the family declares representable (depth+FFN),
    falling back to depth-only for cohorts whose width knob lives
    outside the unified domain (MoE expert width, d_rnn)."""
    fam = TransformerFamily()
    base = reduced(get_config(arch), n_units=2, d_model=64)
    variant = base
    for kw in (dict(n_units=1, ffn_scale=0.5), dict(n_units=1), dict()):
        variant = tfamily.make_variant(base, **kw)
        if fam.segment_representable([variant, base]):
            break
    return Case(f"transformer/{arch}", fam, (variant, base))


def vgg_cohort() -> Case:
    """The paper's 8-architecture cohort at reduced scale (depth AND
    width heterogeneity — the '-wider' variants widen a stage-4 conv)."""
    cfgs = tuple(scaled(vgg(a), 0.125, 32) for a in PAPER_COHORT)
    return Case("vgg/paper-x0.125", VGGFamily(), cfgs)


def all_cases(*, quick: bool = False) -> List[Case]:
    archs = arch_ids()[:2] if quick else arch_ids()
    return [vgg_cohort()] + [transformer_cohort(a) for a in archs]


# ------------------------------------------------------------- primitives
def _flat_shapes(tree) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    return [(p, tuple(t.shape), str(t.dtype)) for p, t in tu.flatten(tree)]


def _diff_trees(what: str, got, want, *, case: str) -> List[Finding]:
    """Structural + shape + dtype comparison of two (meta) trees;
    findings name the offending leaves."""
    out: List[Finding] = []
    a, b = _flat_shapes(got), _flat_shapes(want)
    paths_a = {p for p, _, _ in a}
    paths_b = {p for p, _, _ in b}
    for p in sorted(paths_b - paths_a):
        out.append(Finding("contracts", what, case, 0,
                           f"leaf '{'/'.join(p)}' missing from result"))
    for p in sorted(paths_a - paths_b):
        out.append(Finding("contracts", what, case, 0,
                           f"unexpected leaf '{'/'.join(p)}' in result"))
    want_by_path = {p: (s, d) for p, s, d in b}
    for p, s, d in a:
        if p not in want_by_path:
            continue
        ws, wd = want_by_path[p]
        if s != ws:
            out.append(Finding("contracts", what, case, 0,
                               f"leaf '{'/'.join(p)}': shape {s}, "
                               f"expected {ws}"))
        elif d != wd:
            out.append(Finding("contracts", what, case, 0,
                               f"leaf '{'/'.join(p)}': dtype {d}, "
                               f"expected {wd}"))
    return out


def _client_shapes(family, cfg):
    return family.shapes(cfg)


def _meta(tree):
    """Every leaf of ``tree`` on ``meta`` (what a result's shapes are
    compared on): a meta leaf stays, any other is re-made there."""
    return tu.tree_map(lambda t: t if t.device == META else torch.empty(
        t.shape, dtype=t.dtype, device=META), tree)


# ----------------------------------------------------------------- checks
def check_updown(case: Case) -> List[Finding]:
    """up, down, and up(down(·)) preserve structure/shapes/dtypes — on
    ``meta`` tensors only."""
    out: List[Finding] = []
    fam = case.family
    union = fam.union(list(case.client_cfgs))
    gshapes = global_shapes(fam, union)
    for ci, cfg in enumerate(case.client_cfgs):
        where = f"{case.name}/client{ci}"
        cshapes = _client_shapes(fam, cfg)
        up_shapes = fam.up(cshapes, cfg, union, seed=SEED)
        out += _diff_trees("up-shape", _meta(up_shapes), gshapes, case=where)
        for mode in NARROW_MODES:
            down_shapes = fam.down(gshapes, union, cfg, seed=SEED, mode=mode)
            out += _diff_trees(f"down-shape[{mode}]", _meta(down_shapes),
                               cshapes, case=where)
            rt = fam.up(down_shapes, cfg, union, seed=SEED)
            out += _diff_trees(f"updown-shape[{mode}]", _meta(rt), gshapes,
                               case=where)
    return out


def _depth_axes(path: Tuple[str, ...]) -> Tuple[int, ...]:
    """Axes that encode DEPTH, not width, for a union leaf: the stacked
    unit axis of transformer ``units/*`` leaves (depth embeds there as
    extra rows, handled by zero-block padding, never by segments)."""
    return (0,) if path and path[0] == "units" else ()


def check_segment_spec(case: Case) -> List[Finding]:
    """``segment_spec`` covers exactly the width-differing axes of every
    client-owned leaf, and every AxisSeg is internally consistent."""
    out: List[Finding] = []
    fam = case.family
    union = fam.union(list(case.client_cfgs))
    gshapes = global_shapes(fam, union)
    gflat = {p: s for p, s, _ in _flat_shapes(gshapes)}
    for ci, cfg in enumerate(case.client_cfgs):
        where = f"{case.name}/client{ci}"
        spec = fam.segment_spec(cfg, union, seed=SEED)
        cflat = {p: s for p, s, _ in _flat_shapes(_client_shapes(fam, cfg))}
        # expected = width-differing axes of leaves the client owns
        expected = set()
        for p, cs in cflat.items():
            gs = gflat.get(p)
            if gs is None:
                out.append(Finding(
                    "contracts", "segment-spec", where, 0,
                    f"client leaf '{'/'.join(p)}' has no union "
                    "counterpart"))
                continue
            if len(cs) != len(gs):
                out.append(Finding(
                    "contracts", "segment-spec", where, 0,
                    f"leaf '{'/'.join(p)}': client rank {len(cs)} != "
                    f"union rank {len(gs)}"))
                continue
            for ax, (c, g) in enumerate(zip(cs, gs)):
                if c != g and ax not in _depth_axes(p):
                    expected.add((p, ax))
        got = set()
        for p, segs in spec.items():
            p = tuple(p)
            gs = gflat.get(p)
            if gs is None:
                out.append(Finding(
                    "contracts", "segment-spec", where, 0,
                    f"spec names unknown leaf '{'/'.join(p)}'"))
                continue
            cs = cflat.get(p)
            for seg in segs:
                ax = seg.axis % len(gs)
                got.add((p, ax))
                ids = np.asarray(seg.ids)
                if len(ids) != gs[ax]:
                    out.append(Finding(
                        "contracts", "segment-ids", where, 0,
                        f"leaf '{'/'.join(p)}' axis {ax}: {len(ids)} ids "
                        f"for union extent {gs[ax]}"))
                    continue
                n_segments = len(np.unique(ids))
                if cs is not None and n_segments != cs[ax]:
                    out.append(Finding(
                        "contracts", "segment-ids", where, 0,
                        f"leaf '{'/'.join(p)}' axis {ax}: {n_segments} "
                        f"distinct segments for client extent {cs[ax]}"))
                counts = seg.counts
                if counts.min() < 1:
                    out.append(Finding(
                        "contracts", "segment-counts", where, 0,
                        f"leaf '{'/'.join(p)}' axis {ax}: non-positive "
                        "segment size"))
                # each segment contributes exactly one client coordinate:
                # sum over union positions of 1/c_j == #segments
                total = float(np.sum(1.0 / counts))
                if abs(total - n_segments) > 1e-6:
                    out.append(Finding(
                        "contracts", "segment-counts", where, 0,
                        f"leaf '{'/'.join(p)}' axis {ax}: Σ 1/c_j = "
                        f"{total:.4f} != {n_segments} segments — counts "
                        "inconsistent with ids"))
        for p, ax in sorted(expected - got):
            out.append(Finding(
                "contracts", "segment-coverage", where, 0,
                f"width-differing axis {ax} of leaf '{'/'.join(p)}' is "
                "not covered by segment_spec"))
        for p, ax in sorted(got - expected):
            out.append(Finding(
                "contracts", "segment-coverage", where, 0,
                f"segment_spec emits axis {ax} of leaf '{'/'.join(p)}' "
                "where client and union extents agree"))
    return out


def _np(t) -> np.ndarray:
    return t.detach().to(CPU, torch.float32).numpy()


def check_coverage(case: Case) -> List[Finding]:
    """Mask algebra on constant pushes (CPU tensors, no model
    evaluation): masks are 0/1, loose ⊇ strict, loose ==
    loosen(strict, filler), and landing sites are disjoint from nonzero
    filler."""
    out: List[Finding] = []
    fam = case.family
    union = fam.union(list(case.client_cfgs))
    for ci, cfg in enumerate(case.client_cfgs):
        where = f"{case.name}/client{ci}"
        strict, filler = coverage_and_filler(fam, cfg, union, seed=SEED,
                                             device=CPU)
        loose = coverage_mask(fam, cfg, union, policy="loose", seed=SEED,
                              device=CPU)
        derived = loosen(strict, filler)
        for (path, s), (_, lo), (_, d), (_, f) in zip(
                *(tu.flatten(t) for t in (strict, loose, derived, filler))):
            name = "/".join(path)
            s, lo, d, f = (_np(x) for x in (s, lo, d, f))
            if not np.isin(s, (0.0, 1.0)).all():
                out.append(Finding("contracts", "mask-01", where, 0,
                                   f"strict mask of '{name}' is not 0/1"))
            if not np.isin(lo, (0.0, 1.0)).all():
                out.append(Finding("contracts", "mask-01", where, 0,
                                   f"loose mask of '{name}' is not 0/1"))
            if (lo < s).any():
                out.append(Finding(
                    "contracts", "coverage-superset", where, 0,
                    f"loose mask of '{name}' drops strictly-covered "
                    "coordinates (loose ⊉ strict)"))
            if (lo != d).any():
                out.append(Finding(
                    "contracts", "coverage-loosen", where, 0,
                    f"loose mask of '{name}' != loosen(strict, filler) — "
                    "up(ones) landing sites overlap nonzero filler"))
            if (s * f != 0.0).any():
                out.append(Finding(
                    "contracts", "coverage-disjoint", where, 0,
                    f"'{name}': nonzero filler on a strictly-covered "
                    "coordinate — up() is not linear + constant there"))
    return out


def check_multiplicity(case: Case) -> List[Finding]:
    """``multiplicity`` agrees with the segment metadata leaf-by-leaf."""
    out: List[Finding] = []
    fam = case.family
    union = fam.union(list(case.client_cfgs))
    gflat = {p: s for p, s, _ in _flat_shapes(global_shapes(fam, union))}
    for ci, cfg in enumerate(case.client_cfgs):
        where = f"{case.name}/client{ci}"
        spec = {tuple(p): v for p, v in
                fam.segment_spec(cfg, union, seed=SEED).items()}
        mult = multiplicity(fam, cfg, union, seed=SEED, device=CPU)
        strict, _ = coverage_and_filler(fam, cfg, union, seed=SEED,
                                        device=CPU)
        for (keys, m), (_, s) in zip(tu.flatten(mult), tu.flatten(strict)):
            name = "/".join(keys)
            m, s = _np(m), _np(s)
            if (m < 1).any() or not np.array_equal(m, np.round(m)):
                out.append(Finding(
                    "contracts", "multiplicity", where, 0,
                    f"'{name}': multiplicity not an integer ≥ 1"))
            segs = spec.get(keys, [])
            expect = np.ones(gflat[keys], np.float32)
            for seg in segs:
                shape = [1] * len(gflat[keys])
                shape[seg.axis % len(shape)] = -1
                expect = expect * seg.counts.astype(np.float32).reshape(shape)
            if not np.array_equal(m, expect):
                out.append(Finding(
                    "contracts", "multiplicity", where, 0,
                    f"'{name}': multiplicity != product of segment "
                    "sizes from segment_spec"))
            if not segs and (m != 1).any():
                out.append(Finding(
                    "contracts", "multiplicity", where, 0,
                    f"'{name}': multiplicity > 1 on a leaf with no "
                    "segment metadata"))
            # m > 1 off the strict mask is fine where segment counts
            # broadcast along the depth axis (multiplicity is only read
            # under the mask); on a depth-free leaf it is a duplicated
            # coordinate the client does not own
            if not _depth_axes(keys) and segs and \
                    ((m > 1) & (s != 1)).any():
                out.append(Finding(
                    "contracts", "multiplicity", where, 0,
                    f"'{name}': duplicated coordinate (m > 1) that the "
                    "strict mask does not cover on a depth-free leaf"))
    return out


def check_plane(case: Case) -> List[Finding]:
    """PlaneSpec layout identity + manifest round-trip for the cohort's
    union tree."""
    out: List[Finding] = []
    fam = case.family
    union = fam.union(list(case.client_cfgs))
    gshapes = global_shapes(fam, union)
    where = f"{case.name}/plane"
    spec = plane.PlaneSpec.from_tree(gshapes)
    sizes = spec.leaf_sizes()
    total = sum(sizes)
    if spec.size != total:
        out.append(Finding("contracts", "plane-size", where, 0,
                           f"spec.size {spec.size} != Σ leaf sizes {total}"))
    off = 0
    for o, n in zip(spec.offsets, sizes):
        if o != off:
            out.append(Finding("contracts", "plane-offsets", where, 0,
                               f"offset {o} != running total {off} — "
                               "leaves overlap or leave gaps"))
            break
        off += n
    # on meta: pack -> (P,) f32; unpack -> the global tree; pack again
    packed = plane.pack(gshapes, spec)
    if tuple(packed.shape) != (spec.size,) or packed.dtype != torch.float32:
        out.append(Finding("contracts", "plane-pack", where, 0,
                           f"pack: {tuple(packed.shape)}/{packed.dtype}, "
                           f"expected ({spec.size},)/float32"))
    x_meta = torch.empty((spec.size,), dtype=torch.float32, device=META)
    unpacked = plane.unpack(x_meta, spec)
    out += _diff_trees("plane-unpack", unpacked, gshapes, case=where)
    repacked = plane.pack(unpacked, spec)
    if tuple(repacked.shape) != (spec.size,):
        out.append(Finding("contracts", "plane-roundtrip", where, 0,
                           f"pack∘unpack: {tuple(repacked.shape)} != "
                           f"({spec.size},)"))
    # exact identity at value level on all-f32 layouts (a handful of
    # views and one concat on a small CPU vector — no model math)
    if spec.all_f32:
        x = torch.arange(spec.size, dtype=torch.float32)
        y = plane.pack(plane.unpack(x, spec), spec)
        if not torch.equal(x, y):
            out.append(Finding(
                "contracts", "plane-roundtrip", where, 0,
                "pack(unpack(x)) != x on an all-f32 layout"))
    # manifest serialization round-trips the layout exactly
    spec2 = plane.PlaneSpec.from_manifest(spec.to_manifest())
    for fld in ("paths", "shapes", "dtypes", "offsets", "size"):
        if getattr(spec, fld) != getattr(spec2, fld):
            out.append(Finding(
                "contracts", "plane-manifest", where, 0,
                f"from_manifest(to_manifest()) changed '{fld}'"))
    # stacked spec strips K and matches the unstacked layout
    stacked = tu.tree_map(
        lambda s: torch.empty((3,) + tuple(s.shape), dtype=s.dtype,
                              device=META), gshapes)
    sspec, k = plane.PlaneSpec.from_stacked(stacked)
    if k != 3 or sspec.shapes != spec.shapes or sspec.offsets != spec.offsets:
        out.append(Finding("contracts", "plane-stacked", where, 0,
                           "from_stacked does not strip K to the "
                           "unstacked layout"))
    return out


def check_quant(case: Case) -> List[Finding]:
    """Wire-format algebra (core.quant) on the cohort's own plane size:
    bf16 encode→decode is exactly the bf16 cast, int8 error is bounded by
    half a quantization step per tile, the error-feedback identity
    ``deq(q) + e' == x + e`` holds exactly, masked encoding zeroes
    off-mask coordinates, and the payload byte accounting is consistent.
    A few vector ops on one (1, P) CPU row — no model math."""
    from repro_torch.core import quant
    out: List[Finding] = []
    fam = case.family
    union = fam.union(list(case.client_cfgs))
    spec = plane.PlaneSpec.from_tree(global_shapes(fam, union))
    where = f"{case.name}/quant"
    n, tile = spec.size, quant.DEFAULT_TILE
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal((1, n)), dtype=torch.float32)
    # bf16: the wire IS the cast
    vb, sb = quant.quantize(x, "bf16", tile=tile)
    if sb is not None or vb.dtype != torch.bfloat16:
        out.append(Finding("contracts", "quant-bf16", where, 0,
                           "bf16 wire must be a scale-free bfloat16 cast"))
    db = quant.dequantize(vb, sb, tile=tile)
    if not torch.equal(db, x.to(torch.bfloat16).float()):
        out.append(Finding("contracts", "quant-bf16", where, 0,
                           "dequantize(quantize(x, bf16)) != bf16 cast"))
    # int8: symmetric per-tile, error ≤ scale/2
    vq, sq = quant.quantize(x, "int8", tile=tile)
    if vq.dtype != torch.int8 or tuple(sq.shape) != (1, quant.n_tiles(
            n, tile)):
        out.append(Finding(
            "contracts", "quant-int8", where, 0,
            f"int8 wire: values {vq.dtype}, scales {tuple(sq.shape)} — "
            f"expected int8 values + (1, {quant.n_tiles(n, tile)}) scales"))
    dq = _np(quant.dequantize(vq, sq, tile=tile))
    step = np.repeat(_np(sq), tile, axis=1)[:, :n]
    if (np.abs(dq - _np(x)) > step / 2 + 1e-7).any():
        out.append(Finding(
            "contracts", "quant-int8", where, 0,
            "int8 round-trip error exceeds half a quantization step"))
    # error feedback: deq(q) + e' == x + e exactly
    e = torch.as_tensor(rng.standard_normal((1, n)) * 0.01,
                        dtype=torch.float32)
    vals, scales, e2 = quant.encode(x, e, "int8", tile=tile)
    lhs = quant.dequantize(vals, scales, tile=tile) + e2
    if not torch.equal(lhs, x + e):
        out.append(Finding(
            "contracts", "quant-ef", where, 0,
            "error-feedback identity deq(q) + e' != x + e"))
    # masked encoding zeroes off-mask coordinates (values AND residual)
    mask = torch.as_tensor(rng.integers(0, 2, (1, n)), dtype=torch.float32)
    vm, _, em = quant.encode(x, e, "int8", tile=tile, mask=mask)
    off = mask == 0.0
    if vm[off].any() or em[off].any():
        out.append(Finding(
            "contracts", "quant-mask", where, 0,
            "masked encode leaks nonzero values or residual off-mask"))
    # payload accounting: dense = values + scales; sparse = covered count
    nt = quant.n_tiles(n, tile)
    if quant.payload_nbytes("int8", n, tile=tile) != n + 4 * nt:
        out.append(Finding("contracts", "quant-bytes", where, 0,
                           "dense int8 payload != n·1 + n_tiles·4 bytes"))
    cov = int(mask.sum())
    if quant.payload_nbytes("int8", n, tile=tile, covered=cov) \
            != cov + 4 * nt:
        out.append(Finding("contracts", "quant-bytes", where, 0,
                           "sparse int8 payload != covered·1 + n_tiles·4"))
    if quant.payload_nbytes("f32", n, tile=tile) != 4 * n:
        out.append(Finding("contracts", "quant-bytes", where, 0,
                           "f32 payload != n·4 bytes"))
    return out


def check_flash(case: Case) -> List[Finding]:
    """The two attention backends behind ``models/attention.py``
    ``attend`` agree on ``meta`` tensors for every client config's
    attention geometry: ``flash_attention`` and ``blockwise_attention``
    give the same output shape/dtype for causal, sliding-window and
    cross calls, and the flash backward's q/k/v cotangents match the
    primal shapes. VGG cohorts have no attention — skipped."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import blockwise_attention
    out: List[Finding] = []
    if not isinstance(case.family, TransformerFamily):
        return out

    def meta(*shape, dtype=torch.float32, grad=False):
        return torch.empty(shape, dtype=dtype, device=META,
                           requires_grad=grad)
    for ci, cfg in enumerate(case.client_cfgs):
        where = f"{case.name}/client{ci}"
        kv = cfg.n_kv_heads if cfg.n_kv_heads and \
            cfg.n_heads % cfg.n_kv_heads == 0 else 1
        g = cfg.n_heads // kv
        hd = cfg.resolved_head_dim
        B, Sq, Sk = 1, 48, 48
        q, k, v = meta(B, Sq, kv, g, hd), meta(B, Sk, kv, hd), \
            meta(B, Sk, kv, hd)
        qp, kp = meta(Sq, dtype=torch.int32), meta(Sk, dtype=torch.int32)
        for tag, causal, window in (("causal", True, 0),
                                    ("window", True, min(cfg.window, Sq)),
                                    ("cross", False, 0)):
            fo = flash_attention(q, k, v, qp, kp, causal=causal,
                                 window=window)
            bo = blockwise_attention(q, k, v, qp, kp, causal=causal,
                                     window=window)
            if tuple(fo.shape) != tuple(bo.shape) or fo.dtype != bo.dtype:
                out.append(Finding(
                    "contracts", "flash-parity", where, 0,
                    f"attention[{tag}]: flash {tuple(fo.shape)}/{fo.dtype}"
                    f" != blockwise {tuple(bo.shape)}/{bo.dtype}"))
        qg, kg, vg = meta(B, Sq, kv, g, hd, grad=True), \
            meta(B, Sk, kv, hd, grad=True), meta(B, Sk, kv, hd, grad=True)
        pos = torch.arange(Sq, dtype=torch.int32, device=META)
        loss = flash_attention(qg, kg, vg, pos, pos, causal=True).float().sum()
        grads = torch.autograd.grad(loss, (qg, kg, vg))
        for name, got, want in zip("qkv", grads, (qg, kg, vg)):
            if tuple(got.shape) != tuple(want.shape) or \
                    got.dtype != want.dtype:
                out.append(Finding(
                    "contracts", "flash-vjp", where, 0,
                    f"flash d{name}: {tuple(got.shape)}/{got.dtype} != "
                    f"primal {tuple(want.shape)}/{want.dtype}"))
    return out


def check_representable(case: Case) -> List[Finding]:
    """The enumerated cohorts are the unified engine's domain — each
    must be segment-representable (the eligibility gate)."""
    if case.family.segment_representable(list(case.client_cfgs)):
        return []
    return [Finding("contracts", "representable", case.name, 0,
                    "cohort is not segment-representable — the contract "
                    "matrix no longer matches the engine's domain")]


CHECKS = (check_representable, check_updown, check_segment_spec,
          check_coverage, check_multiplicity, check_plane, check_quant,
          check_flash)


def check_case(case: Case) -> List[Finding]:
    out: List[Finding] = []
    for fn in CHECKS:
        try:
            out.extend(fn(case))
        except Exception as e:  # a crash in a check is itself a finding
            out.append(Finding("contracts", "check-crash", case.name, 0,
                               f"{fn.__name__} raised {type(e).__name__}: "
                               f"{e}"))
    return out


def check_all(*, quick: bool = False) -> Tuple[List[Finding], int]:
    """Run the whole matrix; returns (findings, number of cases)."""
    findings: List[Finding] = []
    cases = all_cases(quick=quick)
    for case in cases:
        findings.extend(check_case(case))
    return findings, len(cases)
