"""The port's ``launch/specs.py`` vs the JAX package's, in one process:
for every architecture of ``models/registry.py`` and every entry of
``INPUT_SHAPES``, ``batch_specs`` and ``param_sds`` give the reference's
shapes and dtypes (``meta`` tensors against ``ShapeDtypeStruct``s), and
``data_shardings`` / ``param_shardings`` the specs of the reference's
``NamedSharding``s, entry for entry, on ``AbstractMesh``es at (data,
model) = (16, 16) and (2, 2) (a batch of 1 splits the cache's sequence
instead); ``opt_sds`` gives AdamW's state shapes.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.registry import arch_ids  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

MESHES = ((16, 16), (2, 2))


def abstract_mesh(data, model):
    # jax>=0.4.36 takes ((name, size), ...); older takes (sizes, names)
    try:
        return AbstractMesh((("data", data), ("model", model)))
    except TypeError:
        return AbstractMesh((data, model), ("data", "model"))


def jax_leaves(tree, leaf_type):
    return {"/".join(str(k.key) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]}


def port_leaves(tree):
    return {"/".join(p): v for p, v in tu.flatten(tree)}


def same_shapes(got, want):
    """Port meta tensors vs reference ``ShapeDtypeStruct``s, path for
    path."""
    want = jax_leaves(want, jax.ShapeDtypeStruct)
    got = port_leaves(got)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert tuple(got[k].shape) == tuple(s.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(s.dtype), k


@functools.lru_cache(maxsize=None)
def jparams(arch):
    return jspecs.param_sds(jget_config(arch))


def test_input_shapes_equal_the_reference():
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in INPUT_SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", arch_ids())
def test_param_sds_and_shardings_equal_the_reference(arch):
    jp = jparams(arch)
    tp = specs.param_sds(get_config(arch))
    same_shapes(tp, jp)
    for data, model in MESHES:
        mesh = abstract_mesh(data, model)
        for embed_tp in (False, True):
            want = {k: tuple(v.spec) for k, v in jax_leaves(
                jspecs.param_shardings(jget_config(arch), mesh, jp,
                                       embed_tp=embed_tp),
                jax.sharding.NamedSharding).items()}
            got = port_leaves(specs.param_shardings(
                get_config(arch), {"data": data, "model": model}, tp,
                embed_tp=embed_tp))
            assert got == want, (data, model, embed_tp)


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", arch_ids())
def test_batch_specs_and_data_shardings_equal_the_reference(arch,
                                                             shape_name):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jb = jspecs.batch_specs(jcfg, shape_name)
    tb = specs.batch_specs(tcfg, shape_name)
    assert sorted(tb) == sorted(jb)
    same_shapes(tb, jb)
    for data, model in MESHES:
        mesh = abstract_mesh(data, model)
        want = {k: tuple(v.spec) for k, v in jax_leaves(
            jspecs.data_shardings(jcfg, shape_name, mesh, jb),
            jax.sharding.NamedSharding).items()}
        got = port_leaves(specs.data_shardings(
            tcfg, shape_name, {"data": data, "model": model}, tb))
        assert got == want, (data, model)


@pytest.mark.parametrize("arch", ("glm4-9b", "whisper-small",
                                  "deepseek-v2-236b"))
def test_opt_sds_is_adamw_state(arch):
    jp = jparams(arch)
    tp = specs.param_sds(get_config(arch))
    want = jspecs.opt_sds(jget_config(arch), jadamw(1e-3), jp)
    got = specs.opt_sds(get_config(arch), adamw(1e-3), tp)
    same_shapes(got, want)
    n = sum(int(np.prod(t.shape)) for t in tu.leaves(tp))
    assert sum(t.numel() for t in tu.leaves(got)) == 3 * n
