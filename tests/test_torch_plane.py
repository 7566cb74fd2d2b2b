"""The port's packed parameter plane vs the JAX package's.

A JAX-initialised VGG tree, carried across through ``repro_torch.interop``,
must pack to the SAME plane bit for bit: same leaf order (dict keys
sorted), same offsets, same f32 values. Unpack returns views of the plane.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.configs.vgg_family import scaled as jscaled  # noqa: E402
from repro.configs.vgg_family import vgg as jvgg  # noqa: E402
from repro.core import plane as jplane  # noqa: E402
from repro.core import stack_trees as jstack  # noqa: E402
from repro.models import vgg as jmodel  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import plane as tplane  # noqa: E402
from repro_torch.core import stack_trees as tstack  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402

CFGS = [jscaled(jvgg("vgg19-wider"), 0.125, 64),
        JVGGConfig(name="s4", stages=((8,), (8,), (8,), (12,)),
                   classifier=(16,), n_classes=4, image_size=32)]


def _jax_tree(cfg, seed=0):
    """A tree in the JAX model's layout with numpy-seeded values (shapes
    from tracing its init; compiling jax.random per shape is slow)."""
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_pack_bit_equal_on_jax_initialised_tree():
    cfg = JVGGConfig(name="tiny", stages=((4,), (4,)), classifier=(4,),
                     n_classes=4, image_size=4)
    jt = jmodel.init_params(jax.random.PRNGKey(3), cfg)
    js = jplane.PlaneSpec.from_tree(jt)
    tt = params_from_numpy(jax.tree.map(np.asarray, jt))
    ts = tplane.PlaneSpec.from_tree(tt)
    assert ts.offsets == js.offsets
    assert np.array_equal(tplane.pack(tt, ts).numpy(),
                          np.asarray(jplane.pack(jt, js)))


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_spec_offsets_and_pack_bit_equal(cfg):
    jt = _jax_tree(cfg)
    tt = params_from_numpy(jt)
    js = jplane.PlaneSpec.from_tree(jt)
    ts = tplane.PlaneSpec.from_tree(tt)
    assert ts.paths == js.paths
    assert ts.shapes == js.shapes
    assert ts.offsets == js.offsets and ts.size == js.size
    assert ts.dtypes == js.dtypes
    assert ts.to_manifest() == js.to_manifest()
    assert tplane.PlaneSpec.from_manifest(js.to_manifest()) == ts
    jp = np.asarray(jplane.pack(jt, js))
    tp = tplane.pack(tt, ts).numpy()
    assert tp.dtype == np.float32 and np.array_equal(tp, jp)
    back = params_to_numpy(tplane.unpack(torch.from_numpy(jp.copy()), ts))
    for (pa, a), (pb, b) in zip(tu.flatten(back), tu.flatten(jt)):
        assert pa == pb and np.array_equal(a, b)


def test_pack_stacked_and_views():
    cfg = CFGS[1]
    jts = [_jax_tree(cfg, s) for s in range(3)]
    js = jplane.PlaneSpec.from_tree(jts[0])
    ts = tplane.PlaneSpec.from_tree(params_from_numpy(jts[0]))
    jsp = np.asarray(jplane.pack_stacked(jstack(jts), js))
    tst = tstack([params_from_numpy(t) for t in jts])
    tsp = tplane.pack_stacked(tst, ts)
    assert np.array_equal(tsp.numpy(), jsp)
    assert np.array_equal(tplane.pack_trees(
        [params_from_numpy(t) for t in jts], ts).numpy(), jsp)
    # unpack_stacked returns views: an in-place write shows through
    views = tplane.unpack_stacked(tsp, ts)
    tsp.mul_(2.0)
    for (_, v), (_, leaf) in zip(tu.flatten(views), tu.flatten(tst)):
        assert v.data_ptr() != leaf.data_ptr()
        np.testing.assert_array_equal(v.numpy(), 2.0 * leaf.numpy())
    row = tplane.unpack(tsp[1], ts)
    assert tu.leaves(row)[0]._base is not None
    np.testing.assert_array_equal(tplane.pack(row, ts).numpy(),
                                  2.0 * jsp[1])


def test_ragged_and_mismatch_errors():
    ts = tplane.PlaneSpec.from_tree(params_from_numpy(_jax_tree(CFGS[1])))
    bad = params_from_numpy(_jax_tree(CFGS[1]))
    bad["out"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="out/w"):
        tplane.pack(bad, ts)
    with pytest.raises(ValueError, match="leaves"):
        tplane.pack({"a": torch.zeros(2)}, ts)


def test_chunk_bounds_match_jax():
    for k, kc in ((20, 16), (7, 2), (5, 5), (3, 8)):
        assert tplane.chunk_bounds(k, kc) == jplane.chunk_bounds(k, kc)
