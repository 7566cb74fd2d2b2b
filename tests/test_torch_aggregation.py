"""The port's tree-facing aggregation (``repro_torch.core.aggregation``:
``fedavg_stacked`` on the plane / stream / leaf layouts, ``fedavg``,
``fedavg_masked``, ``last_agg_stats``) vs the JAX package's.

The cohort is a reduced width-heterogeneous VGG cohort embedded in its
union (the JAX package's NetChange builds the embedded client models,
their coverage masks, multiplicities and the global fallback; both
packages get the same numpy trees). Every layout of the port is held
against the JAX package's result at 1e-6 — ``tests/test_streaming.py``'s
tolerance: the layouts sum the same <= 3 f32 products per coordinate in
different association orders.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.core import VGGFamily as JFamily  # noqa: E402
from repro.core import aggregation as ja  # noqa: E402
from repro.models import vgg as jmodel  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import aggregation as ta  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.fedavg import fedavg as tfk  # noqa: E402

ATOL = 1e-6


def _tiny(name, stages):
    return JVGGConfig(name=name, stages=stages, classifier=(16,),
                      n_classes=4, image_size=8)


CFGS = [_tiny("w1", ((8,), (8,))), _tiny("w2", ((8,), (12, 8))),
        _tiny("w3", ((12, 8), (12, 8))), _tiny("w4", ((8, 8), (8,)))]
W = np.asarray([0.1, 0.4, 0.3, 0.2], np.float32)


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _init(cfg, seed):
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
        shapes)


@functools.lru_cache(maxsize=None)
def _cohort():
    """Per-client embedded models, loose coverage masks and
    multiplicities in the union (lists of numpy trees), and a global
    model as the fallback."""
    fam = JFamily()
    gcfg = fam.union(CFGS)
    models, masks, mults = [], [], []
    for k, c in enumerate(CFGS):
        models.append(_numpy(fam.up(_init(c, k), c, gcfg, seed=5)))
        masks.append(_numpy(ja.coverage_mask(fam, c, gcfg, policy="loose",
                                             seed=5)))
        mults.append(_numpy(ja.multiplicity(fam, c, gcfg, seed=5)))
    return models, masks, mults, _init(gcfg, 99)


def _jstack(trees):
    return ja.stack_trees([jax.tree.map(jnp.asarray, t) for t in trees])


def _tstack(trees):
    return ta.stack_trees([params_from_numpy(t) for t in trees])


def _assert_close(jtree, ttree, atol=ATOL):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=atol,
                                   rtol=0, err_msg="/".join(path))


CASES = [  # masks, mult, fallback, renorm
    (False, False, False, True),
    (True, False, False, True),
    (True, False, False, False),
    (True, True, False, True),
    (True, True, True, True),
    (True, False, True, True),
]


@pytest.mark.parametrize("masks,mult,fallback,renorm", CASES)
def test_fedavg_stacked_layouts_match_jax(masks, mult, fallback, renorm):
    models, mks, mus, gp = _cohort()
    jkw = dict(renorm=renorm)
    tkw = dict(renorm=renorm)
    if masks:
        jkw["masks"], tkw["masks"] = _jstack(mks), _tstack(mks)
    if mult:
        jkw["mult"], tkw["mult"] = _jstack(mus), _tstack(mus)
    if fallback:
        jkw["fallback"] = jax.tree.map(jnp.asarray, gp)
        tkw["fallback"] = params_from_numpy(gp)
    want = ja.fedavg_stacked(_jstack(models), W, layout="plane", **jkw)
    stacked = _tstack(models)
    outs = {}
    for layout, k_chunk in (("plane", None), ("leaf", None), ("stream", 1),
                            ("stream", 2), ("stream", len(CFGS))):
        got = ta.fedavg_stacked(stacked, W, layout=layout, k_chunk=k_chunk,
                                **tkw)
        _assert_close(want, got)
        outs[(layout, k_chunk)] = got
        st = ta.last_agg_stats()
        assert st["layout"] == layout and st["rows"] == len(CFGS)
        assert st["k_chunk"] == k_chunk
        jwant = ja.fedavg_stacked(_jstack(models), W, layout=layout,
                                  k_chunk=k_chunk, **jkw)
        _assert_close(jwant, got)
    # the JAX package's leaf layout through its Pallas kernels
    # (interpret mode) is the same function
    _assert_close(ja.fedavg_stacked(_jstack(models), W, layout="leaf",
                                    use_kernel=True, **jkw),
                  outs[("leaf", None)])


def test_auto_layout_and_stats_match_jax():
    models = _cohort()[0]
    ta.fedavg_stacked(_tstack(models), W)
    ja.fedavg_stacked(_jstack(models), W)
    t, j = ta.last_agg_stats(), ja.last_agg_stats()
    assert t == j and t["layout"] == "plane"
    assert t["peak_bytes"] == 4 * len(CFGS) * t["n"]
    ta.fedavg_stacked(_tstack(models), W, k_chunk=3)
    ja.fedavg_stacked(_jstack(models), W, k_chunk=3)
    t, j = ta.last_agg_stats(), ja.last_agg_stats()
    for key in ("layout", "k_chunk", "rows", "chunks", "peak_chunk_rows"):
        assert t[key] == j[key], key
    # no lane padding in the port: exactly three (P,) buffers + a chunk
    assert t["buffer_bytes"] == 3 * 4 * t["n"]
    assert t["peak_bytes"] == t["buffer_bytes"] + 3 * 4 * t["n"]


def test_fedavg_and_fedavg_masked_match_jax():
    models, mks, mus, gp = _cohort()
    jtrees = [jax.tree.map(jnp.asarray, t) for t in models]
    ttrees = [params_from_numpy(t) for t in models]
    for layout in ("plane", "stream", "leaf"):
        _assert_close(ja.fedavg(jtrees, W, layout=layout),
                      ta.fedavg(ttrees, W, layout=layout))
        _assert_close(
            ja.fedavg_masked(jtrees, W, [jax.tree.map(jnp.asarray, m)
                                         for m in mks],
                             mult=[jax.tree.map(jnp.asarray, m)
                                   for m in mus],
                             fallback=jax.tree.map(jnp.asarray, gp),
                             layout=layout),
            ta.fedavg_masked(ttrees, W, [params_from_numpy(m) for m in mks],
                             mult=[params_from_numpy(m) for m in mus],
                             fallback=params_from_numpy(gp), layout=layout))


def test_leaf_dtype_restored():
    """A bf16 leaf aggregates in f32 and comes back bf16, on every
    layout, as the JAX package's does."""
    rng = np.random.default_rng(3)
    trees = [{"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
             for _ in range(3)]
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    jst = ja.stack_trees([{"a": jnp.asarray(t["a"]).astype(jnp.bfloat16),
                           "b": jnp.asarray(t["b"])} for t in trees])
    tst = ta.stack_trees([{"a": torch.from_numpy(t["a"]).to(torch.bfloat16),
                           "b": torch.from_numpy(t["b"])} for t in trees])
    for layout in ("plane", "stream", "leaf"):
        got = ta.fedavg_stacked(tst, w, layout=layout)
        assert got["a"].dtype == torch.bfloat16
        assert got["b"].dtype == torch.float32
        _assert_close(ja.fedavg_stacked(jst, w, layout=layout), got)


def test_leaf_layout_launches_no_kernel_on_cpu():
    models, mks, mus, gp = _cohort()
    tfk.reset_launch_counts()
    ta.fedavg_stacked(_tstack(models), W, masks=_tstack(mks),
                      mult=_tstack(mus), layout="leaf")
    assert sum(tfk.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        ta.fedavg_stacked(_tstack(models), W, layout="leaf",
                          use_kernel=True)


def test_structure_errors_name_the_tree_and_leaf():
    models, mks, _, gp = _cohort()
    stacked = _tstack(models)
    bad = _tstack(mks)
    bad["extra"] = bad.pop(sorted(bad)[0])      # a renamed leaf
    jbad = _jstack(mks)
    jbad["extra"] = jbad.pop(sorted(jbad)[0])
    with pytest.raises((ValueError, AssertionError),
                       match="masks tree structure"):
        ja.fedavg_stacked(_jstack(models), W, masks=jbad, layout="leaf")
    with pytest.raises(ValueError, match="masks tree structure"):
        ta.fedavg_stacked(stacked, W, masks=bad, layout="leaf")
    # the packed layouts name the offending leaf path, as the JAX
    # package's do
    for layout in ("plane", "stream"):
        with pytest.raises(ValueError, match="structure") as terr:
            ta.fedavg_stacked(stacked, W, masks=bad, layout=layout)
        with pytest.raises(ValueError, match="structure") as jerr:
            ja.fedavg_stacked(_jstack(models), W, masks=jbad, layout=layout)
        assert str(terr.value) == str(jerr.value)
    # a ragged mask leaf names the leaf and both shapes
    path = tu.flatten(stacked)[0][0]
    short = _tstack(mks)
    leaf = tu.get(short, path)
    tu.get(short, path[:-1])[path[-1]] = leaf[..., :1]
    for layout in ("plane", "leaf"):
        with pytest.raises(ValueError, match="/".join(path)):
            ta.fedavg_stacked(stacked, W, masks=short, layout=layout)
    fb = params_from_numpy(gp)
    fb.pop(sorted(fb)[-1])
    with pytest.raises(ValueError, match="fallback"):
        ta.fedavg_stacked(stacked, W, masks=_tstack(mks), fallback=fb,
                          layout="leaf")
