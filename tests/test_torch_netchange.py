"""The port's NetChange for VGG vs the JAX package's.

``dup_mapping`` draws from the same sha256-seeded numpy stream, so the
To-Wider mappings are identical; ``up``/``down`` (modes paper and fold),
``segment_spec`` (and the matrices and multiplicities built from it) and
the coverage/filler pair agree on the scaled paper cohort and on a
4-stage config whose last pool leaves 2x2 spatial positions — the
shape where a wrong (NCHW) conv->fc flatten would permute fc0's rows
(the paper's 5 stages at 32x32 leave 1x1, where it cannot show).
Tolerance 1e-6: the ops are gathers, scalings and short segment sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.configs.vgg_family import paper_client_archs  # noqa: E402
from repro.configs.vgg_family import scaled as jscaled  # noqa: E402
from repro.configs.vgg_family import vgg as jvgg  # noqa: E402
from repro.core import VGGFamily as JFamily  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import netchange as jnc  # noqa: E402
from repro.core import segments as jsg  # noqa: E402
from repro.models import vgg as jmodel  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import vgg_family as tcfg  # noqa: E402
from repro_torch.core import VGGFamily as TFamily  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import netchange as tnc  # noqa: E402
from repro_torch.core import segments as tsg  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

ATOL = 1e-6


def _tcfg(c):
    """The port's copy of a JAX-package VGGConfig (same fields)."""
    return tcfg.VGGConfig(**{f: getattr(c, f) for f in
                             ("name", "stages", "classifier", "n_classes",
                              "in_channels", "image_size")})


def _np_tree(cfg, seed):
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _jit(fn, *args):
    """Run a JAX-package function as one compiled program (eager dispatch
    compiles op by op, which is slower here)."""
    return jax.jit(fn)(*args)


def _same_trees(a_jax, b_torch, atol=ATOL):
    fa = jax.tree_util.tree_flatten_with_path(a_jax)[0]
    fb = tu.flatten(b_torch)
    assert len(fa) == len(fb)
    for (pa, xa), (pb, xb) in zip(fa, fb):
        assert tuple(str(k.key) for k in pa) == pb
        np.testing.assert_allclose(np.asarray(xb), np.asarray(xa),
                                   atol=atol, rtol=0, err_msg="/".join(pb))


PAPER = sorted(set(paper_client_archs()))
COHORTS = {
    "paper-scaled": [jscaled(jvgg(a), 0.125, 64) for a in PAPER],
    "4stage-2x2": [
        JVGGConfig(name=n, stages=st, classifier=(16,), n_classes=4,
                   image_size=32)
        for n, st in (("a", ((8,), (8,), (8, 8), (8,))),
                      ("b", ((8,), (8,), (8,), (12,))),
                      ("c", ((8,), (12,), (8,), (8,))))],
}


def test_cohorts_are_width_and_depth_heterogeneous():
    for cfgs in COHORTS.values():
        assert JFamily().segment_representable(cfgs)
        assert not JFamily().depth_only(cfgs)
        tc = [_tcfg(c) for c in cfgs]
        assert TFamily().segment_representable(tc)
        assert not TFamily().depth_only(tc)
    g = TFamily().union([_tcfg(c) for c in COHORTS["4stage-2x2"]])
    assert g.image_size // 2 ** len(g.stages) == 2


def test_config_copy_and_union_match():
    for a in PAPER:
        j = jvgg(a)
        assert _tcfg(j) == tcfg.vgg(a)
        assert _tcfg(jscaled(j, 0.125, 64)) == tcfg.scaled(tcfg.vgg(a),
                                                           0.125, 64)
    assert tcfg.paper_client_archs() == paper_client_archs()
    cfgs = COHORTS["paper-scaled"]
    assert _tcfg(JFamily().union(cfgs)) == TFamily().union(
        [_tcfg(c) for c in cfgs])


def test_dup_mapping_and_round_seed_equal():
    for old, new in ((4, 4), (3, 8), (512, 768), (64, 96)):
        for tag in ("conv/3/0", "fc/0", ""):
            for seed in (0, 7, 123456):
                assert np.array_equal(
                    tnc.dup_mapping(old, new, tag=tag, seed=seed),
                    jnc.dup_mapping(old, new, tag=tag, seed=seed))
    for args in ((0, 0, 0), (3, 5, 19), (2 ** 20, 999, 7)):
        assert tnc.round_embed_seed(*args) == jnc.round_embed_seed(*args)


@pytest.mark.parametrize("cohort", sorted(COHORTS))
@pytest.mark.parametrize("mode", ["paper", "fold"])
def test_up_down_match_jax(cohort, mode):
    cfgs = COHORTS[cohort]
    gcfg = JFamily().union(cfgs)
    tg = _tcfg(gcfg)
    gp = _np_tree(gcfg, 0)
    jf, tf = JFamily(), TFamily()
    for i, c in enumerate(cfgs):
        seed = jnc.round_embed_seed(3, 1, i)
        jd = _jit(lambda p: jf.down(p, gcfg, c, seed=seed, mode=mode), gp)
        td = tf.down(params_from_numpy(gp), tg, _tcfg(c), seed=seed,
                     mode=mode)
        _same_trees(jd, td)
        cp = _np_tree(c, i + 1)
        _same_trees(_jit(lambda p: jf.up(p, c, gcfg, seed=seed), cp),
                    tf.up(params_from_numpy(cp), _tcfg(c), tg, seed=seed))


@pytest.mark.parametrize("cohort", sorted(COHORTS))
def test_segment_spec_matrices_and_multiplicity_match(cohort):
    cfgs = COHORTS[cohort]
    gcfg = JFamily().union(cfgs)
    tg = _tcfg(gcfg)
    jshapes = jagg.global_shapes(JFamily(), gcfg)
    tshapes = tagg.global_shapes(TFamily(), tg)
    jspecs = [JFamily().segment_spec(c, gcfg, seed=5) for c in cfgs]
    tspecs = [TFamily().segment_spec(_tcfg(c), tg, seed=5) for c in cfgs]
    for js, ts in zip(jspecs, tspecs):
        assert sorted(js) == sorted(ts)
        for path in js:
            for a, b in zip(js[path], ts[path]):
                assert (a.axis, a.out_role) == (b.axis, b.out_role)
                assert np.array_equal(a.ids, b.ids)
    jaxes = jsg.union_axes(jspecs, jshapes)
    taxes = tsg.union_axes(tspecs, tshapes)
    assert jaxes == taxes
    for js, ts in zip(jspecs, tspecs):
        jm = jsg.client_matrices(js, jaxes, jshapes, kind="grad")
        tm = tsg.client_matrices(ts, taxes, tshapes, kind="grad")
        for path in jm:
            for a, b in zip(jm[path], tm[path]):
                assert np.array_equal(a, b)
        _same_trees(jsg.multiplicity_tree(js, jshapes),
                    tsg.multiplicity_tree(ts, tshapes, device="cpu"))


@pytest.mark.parametrize("cohort", sorted(COHORTS))
def test_coverage_and_filler_match(cohort):
    cfgs = COHORTS[cohort]
    gcfg = JFamily().union(cfgs)
    # paper cohort: vgg13 (depth + width) and vgg16-wider (depth only)
    for c in (cfgs if cohort == "4stage-2x2" else (cfgs[0], cfgs[3])):
        jm, jfill = _jit(lambda: jagg.coverage_and_filler(JFamily(), c,
                                                          gcfg, seed=2))
        tm, tfill = tagg.coverage_and_filler(TFamily(), _tcfg(c),
                                             _tcfg(gcfg), seed=2,
                                             device="cpu")
        _same_trees(jm, tm, atol=0)
        _same_trees(jfill, tfill, atol=0)
        _same_trees(jagg.loosen(jm, jfill), tagg.loosen(tm, tfill), atol=0)


def test_coverage_mask_and_multiplicity_match():
    cfgs = COHORTS["4stage-2x2"]
    gcfg = JFamily().union(cfgs)
    for c in cfgs:
        for policy in ("loose", "strict"):
            _same_trees(
                _jit(lambda: jagg.coverage_mask(JFamily(), c, gcfg,
                                                policy=policy, seed=4)),
                tagg.coverage_mask(TFamily(), _tcfg(c), _tcfg(gcfg),
                                   policy=policy, seed=4, device="cpu"),
                atol=0)
        _same_trees(jagg.multiplicity(JFamily(), c, gcfg, seed=4),
                    tagg.multiplicity(TFamily(), _tcfg(c), _tcfg(gcfg),
                                      seed=4, device="cpu"), atol=0)


def test_apply_leaf_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 5, 6)).astype(np.float32)
    mats = [rng.standard_normal((3, 5, 5)).astype(np.float32),
            rng.standard_normal((3, 6, 6)).astype(np.float32)]
    want = jsg.apply_leaf(x, (1, 2), mats, stacked=True)
    got = tsg.apply_leaf(torch.from_numpy(x), (1, 2),
                         [torch.from_numpy(m) for m in mats], stacked=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
