"""The port's baselines, FedADP on client trees and the unified engine's
per-client methods vs the JAX package's.

  * ``PlaneSpec.col_mask`` and ``VGGFamily.chain_paths`` equal JAX's;
  * ``ClusteredFL`` / ``FlexiFed`` / ``Standalone`` aggregation on the
    same numpy-seeded client trees, full and partial participation:
    clusters, the FlexiFed prefix extent, the prefix averaged across all
    participants and written into their trees, the remainder within
    clusters, non-participants untouched — at 1e-6 (f32 summation
    order only);
  * ``FedADP.aggregate`` on the plane, stream and leaf layouts, filler
    and coverage, depth and width cohorts, at 1e-6;
  * one round of the engine's per-client methods (``clustered``,
    ``flexifed``, ``standalone``) from the same embedded state and
    batches, at 1e-5 (depth cohort) and 1e-4 (width cohort) — the JAX
    package's own loop-vs-unified tolerances (``tests/test_unified.py``);
  * the engine's tree-facing pieces (``client_embedding``,
    ``train_round``, ``aggregate_global``, ``step_stats``) and the
    ``UnifiedFedADP`` facade with a caller's loss, at the same bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.configs.vgg_family import scaled as jscaled  # noqa: E402
from repro.configs.vgg_family import vgg as jvgg  # noqa: E402
from repro.core import ClusteredFL as JClustered  # noqa: E402
from repro.core import FedADP as JFedADP  # noqa: E402
from repro.core import FlexiFed as JFlexiFed  # noqa: E402
from repro.core import PlaneSpec as JPlaneSpec  # noqa: E402
from repro.core import Standalone as JStandalone  # noqa: E402
from repro.core import VGGFamily as JFamily  # noqa: E402
from repro.core import vgg_chain as jvgg_chain  # noqa: E402
from repro.fl import UnifiedFedADP as JUnifiedFedADP  # noqa: E402
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.fl.engine import client_embedding as jclient_embedding  # noqa: E402
from repro.models import vgg as jmodel  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs import vgg_family as tcfg  # noqa: E402
from repro_torch.core import (ClusteredFL, FedADP, FlexiFed,  # noqa: E402
                              PlaneSpec, Standalone, TransformerFamily,
                              VGGFamily, vgg_chain)
from repro_torch.fl import (UnifiedEngine, UnifiedFedADP,  # noqa: E402
                            client_embedding)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import vgg as tmodel  # noqa: E402


def _tiny(name, stages):
    return JVGGConfig(name=name, stages=stages, classifier=(16,),
                      n_classes=4, image_size=8)


COHORTS = {   # clusters of equal architecture, depth and width variants
    "depth": [_tiny("d1", ((8,), (8,))), _tiny("d2", ((8,), (8, 8))),
              _tiny("d1", ((8,), (8,))), _tiny("d3", ((8, 8), (8, 8)))],
    "width": [_tiny("w1", ((8,), (8,))), _tiny("w2", ((8,), (12, 8))),
              _tiny("w2", ((8,), (12, 8))), _tiny("w3", ((12, 8), (12, 8)))],
}
TOL = {"depth": 1e-5, "width": 1e-4}
N_SAMPLES = [40, 60, 50, 30]
AGG_TOL = 1e-6


def _tcfg(c):
    return tcfg.VGGConfig(**{f: getattr(c, f) for f in
                             ("name", "stages", "classifier", "n_classes",
                              "in_channels", "image_size")})


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
        shapes)


def _clients(cfgs, seed=0):
    return [_np_params(c, seed + 10 * i) for i, c in enumerate(cfgs)]


def _close(jtree, ttree, atol):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in p) for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=atol, rtol=0, err_msg="/".join(path))


# --------------------------------------------------------- plane + chain
def test_col_mask_matches_jax():
    gcfg = JFamily().union(COHORTS["width"])
    jspec = JPlaneSpec.from_tree(_np_params(gcfg, 0))
    tspec = PlaneSpec.from_tree(VGGFamily().shapes(_tcfg(gcfg)))
    preds = (lambda p: p[0] == "stages",
             lambda p: p[:3] == ("stages", "s1", "c0"),
             lambda p: p[-1] == "b", lambda p: False)
    for pred in preds:
        want = jspec.col_mask(pred)
        got = tspec.col_mask(pred)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["vgg13", "vgg16-wider", "vgg19", "vgg17"])
def test_chain_paths_match_jax(arch):
    jc = jscaled(jvgg(arch), 0.125, 32)
    assert VGGFamily().chain_paths(_tcfg(jc)) == JFamily().chain_paths(jc)
    with pytest.raises(NotImplementedError, match="VGG chain"):
        TransformerFamily().chain_paths(
            reduced(get_config("glm4-9b"), n_units=1, d_model=32))


# ------------------------------------------------------------ baselines
SELECTIONS = [None, [0, 2, 3], [1, 3]]


@pytest.mark.parametrize("cohort", ["depth", "width"])
@pytest.mark.parametrize("selected", SELECTIONS)
def test_clustered_matches_jax(cohort, selected):
    cfgs = COHORTS[cohort]
    ps = _clients(cfgs)
    jout = JClustered(cfgs, N_SAMPLES).aggregate(list(ps), selected)
    tout = ClusteredFL([_tcfg(c) for c in cfgs], N_SAMPLES).aggregate(
        params_from_numpy(ps), selected)
    _close(jout, tout, AGG_TOL)
    for k in set(range(len(cfgs))) - set(selected or range(len(cfgs))):
        _close(ps[k], tout[k], 0.0)          # non-participants untouched
    assert Standalone(cfgs, N_SAMPLES).aggregate(tout, selected) == tout
    assert len(JStandalone(cfgs, N_SAMPLES).aggregate(jout)) == len(cfgs)


def test_flexifed_common_prefix_extent():
    jcfgs = [jscaled(jvgg(a), 0.125, 32)
             for a in ("vgg13", "vgg16-wider", "vgg19")]
    ps = _clients(jcfgs)
    want = JFlexiFed(jcfgs, [1, 1, 1], jvgg_chain)._common_prefix(ps)
    tps = params_from_numpy(ps)
    algo = FlexiFed([_tcfg(c) for c in jcfgs], [1, 1, 1], vgg_chain)
    got = algo._common_prefix(tps)
    assert got == want and len(got) >= 4
    for pos in got:
        ids = {vgg_chain(_tcfg(c), p)[pos][0] for c, p in zip(jcfgs, tps)}
        assert len(ids) == 1


def test_flexifed_aggregates_prefix_across_all():
    """The JAX package's own case, against JAX: the prefix's first conv
    ends identical in both clients and equal to their average, written
    into the clients' own trees (the chain views, not copies)."""
    jcfgs = [jscaled(jvgg(a), 0.125, 32) for a in ("vgg13", "vgg19")]
    ps = _clients(jcfgs)
    jnew = JFlexiFed(jcfgs, [1, 1], jvgg_chain).round(
        [jax.tree.map(np.array, p) for p in ps], lambda k, p: p, 0)
    tps = params_from_numpy(ps)
    tnew = FlexiFed([_tcfg(c) for c in jcfgs], [1, 1], vgg_chain).round(
        tps, lambda k, p: p, 0)
    w0 = tnew[0]["stages"]["s0"]["c0"]["w"]
    assert torch.equal(w0, tnew[1]["stages"]["s0"]["c0"]["w"])
    want = (ps[0]["stages"]["s0"]["c0"]["w"]
            + ps[1]["stages"]["s0"]["c0"]["w"]) / 2
    np.testing.assert_allclose(w0.numpy(), want, rtol=1e-5)
    assert tnew[0] is tps[0]                 # written in place
    _close(jnew, tnew, AGG_TOL)


@pytest.mark.parametrize("cohort", ["depth", "width"])
@pytest.mark.parametrize("selected", SELECTIONS)
def test_flexifed_matches_jax(cohort, selected):
    """Prefix across the participants, remainder within (cluster ∩
    participants), non-participants untouched."""
    cfgs = COHORTS[cohort]
    ps = _clients(cfgs, seed=3)
    jout = JFlexiFed(cfgs, N_SAMPLES, jvgg_chain).aggregate(
        [jax.tree.map(np.array, p) for p in ps], selected)
    tout = FlexiFed([_tcfg(c) for c in cfgs], N_SAMPLES, vgg_chain
                    ).aggregate(params_from_numpy(ps), selected)
    _close(jout, tout, AGG_TOL)
    for k in set(range(len(cfgs))) - set(selected or range(len(cfgs))):
        _close(ps[k], tout[k], 0.0)


# --------------------------------------------------- FedADP on trees
@pytest.mark.parametrize("cohort", ["depth", "width"])
@pytest.mark.parametrize("agg_mode", ["filler", "coverage"])
@pytest.mark.parametrize("layout,k_chunk", [("plane", None), ("stream", 2),
                                            ("leaf", None)])
def test_fedadp_aggregate_matches_jax(cohort, agg_mode, layout, k_chunk):
    cfgs = COHORTS[cohort]
    kw = dict(agg_mode=agg_mode, agg_layout=layout, k_chunk=k_chunk,
              base_seed=5)
    jalgo = JFedADP(JFamily(), cfgs, N_SAMPLES, **kw)
    talgo = FedADP(VGGFamily(), [_tcfg(c) for c in cfgs], N_SAMPLES,
                   device="cpu", **kw)
    gp = _np_params(jalgo.global_cfg, 7)
    selected = [0, 1, 3]
    # each participant's update: its distributed model, perturbed, then
    # expanded back (NetChange both ways, at the round's seeds)
    exp_np = []
    for k in selected:
        down = jalgo.distribute(gp, 2, k)
        rng = np.random.default_rng(k)
        down = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape).astype(np.float32), down)
        exp_np.append(jax.tree.map(np.asarray, jalgo.collect(down, 2, k)))
    jout = jalgo.aggregate(exp_np, selected, round_idx=2, global_params=gp)
    tout = talgo.aggregate(params_from_numpy(exp_np), selected, round_idx=2,
                           global_params=params_from_numpy(gp))
    _close(jout, tout, AGG_TOL)
    # and the NetChange steps agree too
    _close(jalgo.distribute(gp, 2, 1),
           talgo.distribute(params_from_numpy(gp), 2, 1), AGG_TOL)
    if agg_mode == "coverage":
        with pytest.raises(ValueError, match="global_params"):
            talgo.aggregate(params_from_numpy(exp_np), selected, round_idx=2)


# ------------------------------------------- the engine's per-client methods
def _batches(k, steps=2, b=8, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((k, b, 8, 8, 3)).astype(np.float32),
             "y": rng.integers(0, 4, (k, b)).astype(np.int32)}
            for _ in range(steps)]


ENGINE_CASES = [  # method, cohort, selected, k_chunk
    ("clustered", "depth", None, None),
    ("clustered", "width", [0, 2, 3], None),
    ("clustered", "width", None, 3),
    ("flexifed", "depth", None, None),
    ("flexifed", "depth", [1, 3], None),
    ("flexifed", "width", None, None),
    ("flexifed", "width", [0, 1, 2], 2),
    ("standalone", "depth", [0, 3], None),
    ("standalone", "width", None, None),
]


@pytest.mark.parametrize("method,cohort,selected,k_chunk", ENGINE_CASES)
def test_engine_per_client_round_matches_jax(method, cohort, selected,
                                             k_chunk):
    cfgs = COHORTS[cohort]
    kw = dict(method=method, lr=0.05, momentum=0.9, embed_seed=3,
              k_chunk=k_chunk)
    jeng = JEngine(JFamily(), cfgs, N_SAMPLES, use_kernel=False, **kw)
    teng = UnifiedEngine(VGGFamily(), [_tcfg(c) for c in cfgs], N_SAMPLES,
                         device="cpu", **kw)
    ps = _clients(cfgs, seed=1)
    jstate = jeng.embed(ps)
    tstate = teng.embed(params_from_numpy(ps))
    _close(jstate, tstate, AGG_TOL)
    if method == "flexifed":
        assert teng._prefix_paths == jeng._prefix_paths
        if selected is not None:
            assert teng._prefix_for(selected) == jeng._prefix_for(selected)
    batches = _batches(len(selected) if selected else len(cfgs))
    jout = jeng.run_round(jstate, batches, selected=selected)
    tout = teng.run_round(tstate, batches, selected=selected)
    _close(jout, tout, TOL[cohort])
    if selected is not None:      # non-participants keep their rows
        for k in set(range(len(cfgs))) - set(selected):
            _close(jax.tree.map(lambda x: x[k], jstate),
                   teng.client_view(tout, k), 0.0)


# ------------------------------------------- the engine's tree-facing pieces
@pytest.mark.parametrize("cohort", ["depth", "width"])
def test_engine_tree_facing_matches_jax(cohort):
    """``client_embedding``, ``train_round``, ``aggregate_global`` and
    ``step_stats`` of the engine, and the ``UnifiedFedADP`` facade with a
    caller's union-space loss, against JAX's from the same inputs."""
    cfgs = COHORTS[cohort]
    tcfgs = [_tcfg(c) for c in cfgs]
    kw = dict(lr=0.05, momentum=0.9, embed_seed=3, agg_mode="coverage")
    jeng = JEngine(JFamily(), cfgs, N_SAMPLES, use_kernel=False, **kw)
    teng = UnifiedEngine(VGGFamily(), tcfgs, N_SAMPLES, device="cpu", **kw)
    jm, jf = jclient_embedding(JFamily(), cfgs, jeng.global_cfg, seed=3)
    tm, tf = client_embedding(VGGFamily(), tcfgs, teng.global_cfg, seed=3,
                              device="cpu")
    _close(jm, tm, 0.0)
    _close(jf, tf, 0.0)
    ps = _clients(cfgs, seed=4)
    jstacked, tstacked = jeng.embed(ps), teng.embed(params_from_numpy(ps))
    batches = _batches(len(cfgs))
    jtrained = jeng.train_round(jstacked, batches)
    ttrained = teng.train_round(tstacked, batches)
    _close(jtrained, ttrained, TOL[cohort])
    assert teng.step_stats()["subset_sizes"] == [len(cfgs)]
    gp = _np_params(jeng.global_cfg, 8)
    _close(jeng.aggregate_global(jtrained, gp),
           teng.aggregate_global(ttrained, params_from_numpy(gp)),
           TOL[cohort])

    gcfg = jeng.global_cfg
    juni = JUnifiedFedADP(JFamily(), cfgs, N_SAMPLES,
                          lambda p, b: jmodel.loss_fn(p, gcfg, b)[0],
                          use_kernel=False)
    tuni = UnifiedFedADP(VGGFamily(), tcfgs, N_SAMPLES,
                         lambda p, b: tmodel.loss_fn(p, _tcfg(gcfg), b)[0],
                         device="cpu")
    _close(juni.masks, tuni.masks, 0.0)
    _close(juni.round(gp, batches, round_idx=1),
           tuni.round(params_from_numpy(gp), batches, round_idx=1),
           TOL[cohort])
