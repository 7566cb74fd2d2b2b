"""The port's transformer NetChange (``core/tfamily.py``) vs the JAX
package's, on the tffn cohort's configs (reduced glm4-9b at full and
half FFN width) and a shallower variant.

``up`` (To-Wider + To-Deeper), ``down`` in modes paper and fold, and
``segment_spec`` agree with JAX. The ops are gathers, scalings and
segment sums of the same numbers, so the tolerance is 1e-6; the mappings
and segment ids are equal exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import TransformerFamily as JFamily  # noqa: E402
from repro.core import segments as jsg  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import (EncoderConfig, ModelConfig,  # noqa: E402
                                 SSMConfig)
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.core import segments as tsg  # noqa: E402
from repro_torch.core import tfamily as ttf  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

BASE = jreduced(jget_config("glm4-9b"), n_units=2, d_model=64)
VARIANTS = {
    "full": jtf.make_variant(BASE),
    "half": jtf.make_variant(BASE, ffn_scale=0.5),
    "half_shallow": jtf.make_variant(BASE, n_units=1, ffn_scale=0.5),
}
GLOBAL = jtf.union(list(VARIANTS.values()))


def to_torch_cfg(c) -> ModelConfig:
    """The port's twin of a JAX ``ModelConfig`` (dense configs)."""
    return ModelConfig(**{f.name: getattr(c, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _np_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        jT.init_params(jax.random.PRNGKey(seed), cfg))


def _close_trees(jtree, ttree, tol=1e-6):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        assert tuple(b.shape) == tuple(np.shape(a)), path
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol, err_msg="/".join(path))


def test_variants_and_union_match():
    tbase = to_torch_cfg(BASE)
    assert ttf.make_variant(tbase) == to_torch_cfg(VARIANTS["full"])
    assert ttf.make_variant(tbase, ffn_scale=0.5) == \
        to_torch_cfg(VARIANTS["half"])
    assert ttf.make_variant(tbase, n_units=1, ffn_scale=0.5) == \
        to_torch_cfg(VARIANTS["half_shallow"])
    tcfgs = [to_torch_cfg(c) for c in VARIANTS.values()]
    assert ttf.union(tcfgs) == to_torch_cfg(GLOBAL)
    jfam, tfam = JFamily(), TFamily()
    for cohort in (["full", "half"], ["half", "half_shallow"],
                   ["full", "half", "half_shallow"]):
        jc = [VARIANTS[n] for n in cohort]
        tc = [to_torch_cfg(c) for c in jc]
        assert tfam.depth_only(tc) == jfam.depth_only(jc)
        assert tfam.segment_representable(tc) == \
            jfam.segment_representable(jc)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_up_matches_jax(name):
    cfg = VARIANTS[name]
    p = _np_params(cfg, seed=1)
    for seed in (0, 7):
        jup = jtf.up(jax.tree.map(np.array, p), cfg, GLOBAL, seed=seed)
        tup = ttf.up(params_from_numpy(p), to_torch_cfg(cfg),
                     to_torch_cfg(GLOBAL), seed=seed)
        _close_trees(jup, tup)


@pytest.mark.parametrize("mode", ["paper", "fold"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_down_matches_jax(name, mode):
    cfg = VARIANTS[name]
    g = _np_params(GLOBAL, seed=2)
    jdown = jtf.down(jax.tree.map(np.array, g), GLOBAL, cfg, seed=3,
                     mode=mode)
    tdown = ttf.down(params_from_numpy(g), to_torch_cfg(GLOBAL),
                     to_torch_cfg(cfg), seed=3, mode=mode)
    _close_trees(jdown, tdown)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_segment_spec_matches_jax(name):
    cfg = VARIANTS[name]
    for seed in (0, 5):
        jspec = jtf.segment_spec(cfg, GLOBAL, seed=seed)
        tspec = ttf.segment_spec(to_torch_cfg(cfg), to_torch_cfg(GLOBAL),
                                 seed=seed)
        assert sorted(jspec) == sorted(tspec)
        for path, segs in jspec.items():
            assert len(segs) == len(tspec[path])
            for a, b in zip(segs, tspec[path]):
                assert (a.axis, a.out_role) == (b.axis, b.out_role)
                np.testing.assert_array_equal(np.asarray(a.ids),
                                              np.asarray(b.ids))
    assert (ttf.segment_spec(to_torch_cfg(VARIANTS["full"]),
                             to_torch_cfg(GLOBAL)) == {}) == \
        (VARIANTS["full"].d_ff == GLOBAL.d_ff)


def test_segment_matrices_match_jax_and_are_shared():
    """The cohort's E Eᵀ matrices equal JAX's exactly; the gate and up
    leaves (same d_ff segments, same role) share one array per client and
    one stacked tensor, the down leaf (the split side) has its own."""
    names = ["full", "half", "half_shallow"]
    tg = to_torch_cfg(GLOBAL)
    jshapes = jax.eval_shape(
        lambda: jT.init_params(jax.random.PRNGKey(0), GLOBAL))
    tshapes = TFamily().shapes(tg)
    jspecs = [jtf.segment_spec(VARIANTS[n], GLOBAL, seed=4) for n in names]
    tspecs = [ttf.segment_spec(to_torch_cfg(VARIANTS[n]), tg, seed=4)
              for n in names]
    axes = tsg.union_axes(tspecs, tshapes)
    jm = [jsg.client_matrices(s, axes, jshapes, kind="grad")
          for s in jspecs]
    tm = [tsg.client_matrices(s, axes, tshapes, kind="grad")
          for s in tspecs]
    key = {p[-1]: p for p in axes}
    assert sorted(key) == ["wd", "wg", "wu"]
    for j, t, spec in zip(jm, tm, tspecs):
        for path in axes:
            for a, b in zip(j[path], t[path]):
                np.testing.assert_array_equal(a, b)
        wg, wu, wd = (t[key[n]][0] for n in ("wg", "wu", "wd"))
        # a client at the union's width has one identity for all three
        assert wg is wu and (wd is not wg) == bool(spec)
    stacked = tsg.stack_matrices(tm, "cpu")
    key = {n: "/".join(p) for n, p in key.items()}
    assert stacked[key["wg"]][0] is stacked[key["wu"]][0]
    assert stacked[key["wd"]][0] is not stacked[key["wg"]][0]
    for path in axes:
        want = np.stack([m[path][0] for m in tm])
        np.testing.assert_array_equal(stacked["/".join(path)][0].numpy(),
                                      want)


def test_not_ported_variants_raise():
    """Every variant kind is ported: d_rnn (tests/test_torch_ssm_configs.py),
    MoE (tests/test_torch_moe_configs.py) and the whisper encoder's, whose
    FFN follows d_ff (tests/test_torch_frontend_configs.py holds them
    against the reference)."""
    rnn = dataclasses.replace(to_torch_cfg(BASE),
                              layer_pattern=("rglru", "global"),
                              ssm=SSMConfig(d_rnn=64))
    var = ttf.make_variant(rnn, d_rnn=32)
    assert var.d_rnn == 32 and ttf.union([var, rnn]).d_rnn == 64
    enc = dataclasses.replace(to_torch_cfg(BASE),
                              encoder=EncoderConfig(2, 16, 64))
    var = ttf.make_variant(enc, n_units=1, ffn_scale=0.5)
    uni = ttf.union([var, enc])
    assert uni.encoder == enc.encoder and uni.d_ff == enc.d_ff
    assert ttf.segment_spec(enc, enc) == {}
    spec = ttf.segment_spec(var, uni)
    # the encoder's FFN (SwiGLU here) follows d_ff
    assert {p[-1] for p in spec if p[0] == "encoder"} == {"wg", "wu", "wd"}
