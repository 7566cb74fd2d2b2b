"""The port's unified engine and Simulator vs the JAX package's.

  * one fedadp round of ``repro_torch``'s ``UnifiedEngine`` vs
    ``repro``'s on small depth and width+depth VGG cohorts, from the same
    numpy-seeded global model and batches: whole-plane and streamed
    layouts, filler "zero"/"global" and coverage aggregation, full and
    partial participation. Tolerance: 1e-5 on depth-only cohorts, 1e-4
    on width cohorts — the JAX package's own loop-vs-unified tolerances
    (tests/test_unified.py, tests/test_streaming.py);
  * a 2-round ``Simulator`` run from the same initial model whose
    accuracy history tracks the JAX run's to 0.005 (float drift can flip
    a few argmax predictions, as between the JAX package's own loop and
    unified engines);
  * the copied data modules give byte-identical arrays and batches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.core import VGGFamily as JFamily  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.fl import FLRunConfig as JRunConfig  # noqa: E402
from repro.fl import Simulator as JSimulator  # noqa: E402
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.fl.federation import Participation as JParticipation  # noqa: E402
from repro.models import vgg as jmodel  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import vgg_family as tcfg  # noqa: E402
from repro_torch.core import VGGFamily as TFamily  # noqa: E402
from repro_torch.fl import FLRunConfig as TRunConfig  # noqa: E402
from repro_torch.fl import Participation as TParticipation  # noqa: E402
from repro_torch.fl import Simulator as TSimulator  # noqa: E402
from repro_torch.fl import UnifiedEngine as TEngine  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402


def _tiny(name, stages):
    return JVGGConfig(name=name, stages=stages, classifier=(16,),
                      n_classes=4, image_size=8)


COHORTS = {
    "depth": [_tiny("d1", ((8,), (8,))), _tiny("d2", ((8,), (8, 8))),
              _tiny("d3", ((8, 8), (8, 8)))],
    "width": [_tiny("w1", ((8,), (8,))), _tiny("w2", ((8,), (12, 8))),
              _tiny("w3", ((12, 8), (12, 8)))],
}
TOL = {"depth": 1e-5, "width": 1e-4}
N_SAMPLES = [40, 60, 50]


def _tcfg(c):
    return tcfg.VGGConfig(**{f: getattr(c, f) for f in
                             ("name", "stages", "classifier", "n_classes",
                              "in_channels", "image_size")})


def _global_params(gcfg, seed=0):
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, gcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   * (np.sqrt(2.0 / np.prod(s.shape[:-1]))
                      if len(s.shape) > 1 else 0.1)).astype(np.float32),
        shapes)


def _batches(k, steps=2, b=8, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((k, b, 8, 8, 3)).astype(np.float32),
             "y": rng.integers(0, 4, (k, b)).astype(np.int32)}
            for _ in range(steps)]


def _assert_trees_close(jtree, ttree, atol):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=atol, rtol=0, err_msg="/".join(path))


ROUND_CASES = [  # cohort, layout, k_chunk, filler, agg_mode, selected
    ("depth", "plane", None, "zero", "filler", None),
    ("depth", "stream", 2, "global", "filler", [0, 2]),
    ("depth", "plane", None, "zero", "coverage", [0, 2]),
    ("width", "plane", None, "zero", "filler", None),
    ("width", "plane", None, "global", "filler", None),
    ("width", "plane", None, "zero", "coverage", None),
    ("width", "stream", 2, "zero", "filler", None),
    ("width", "stream", 2, "zero", "coverage", [0, 2]),
    ("width", "stream", 1, "global", "filler", [1, 2]),
]


@pytest.mark.parametrize("cohort,layout,k_chunk,filler,agg_mode,selected",
                         ROUND_CASES)
def test_engine_round_matches_jax(cohort, layout, k_chunk, filler, agg_mode,
                                  selected):
    cfgs = COHORTS[cohort]
    kw = dict(lr=0.05, momentum=0.9, filler_mode=filler, agg_mode=agg_mode,
              agg_layout=layout, k_chunk=k_chunk, embed_seed=3)
    jeng = JEngine(JFamily(), cfgs, N_SAMPLES, use_kernel=False, **kw)
    teng = TEngine(TFamily(), [_tcfg(c) for c in cfgs], N_SAMPLES,
                   device="cpu", **kw)
    assert teng.plane_spec.offsets == jeng.plane_spec.offsets
    gp = _global_params(jeng.global_cfg)
    batches = _batches(len(selected) if selected else len(cfgs))
    jout = jeng.run_round(gp, batches, selected=selected, round_idx=1)
    tout = teng.run_round(params_from_numpy(gp), batches, selected=selected,
                          round_idx=1)
    _assert_trees_close(jout, tout, TOL[cohort])
    assert teng.agg_stats()["layout"] == layout
    assert teng.agg_stats()["rows"] == len(selected or cfgs)
    # the round start (distribute) agrees too
    _assert_trees_close(
        jeng.round_start(jout, selected=selected, round_idx=2),
        teng.round_start(tout, selected=selected, round_idx=2),
        TOL[cohort])


@pytest.mark.parametrize("coverage", ["loose", "strict"])
def test_depth_round_start_and_coverage_planes(coverage):
    """The depth-only round start, read row by row from the (U, P)
    planes, is bit for bit ``g·m + f·(1−m)`` on the gathered rows; the
    coverage plane, built on first use, is the packed ``loosen`` of each
    unique config's trees (strict: the mask plane itself)."""
    from repro_torch.core import coverage_and_filler, loosen, pack
    from repro_torch.fl.engine import _fused_round_start

    cfgs = [_tcfg(c) for c in COHORTS["depth"]] + [_tcfg(
        COHORTS["depth"][0])]
    teng = TEngine(TFamily(), cfgs, N_SAMPLES + [30], device="cpu",
                   coverage=coverage, embed_seed=3)
    spec = teng.plane_spec
    gp = pack(params_from_numpy(_global_params(
        JFamily().union(COHORTS["depth"]), seed=2)), spec)
    ks = [3, 1, 0]
    uid = torch.as_tensor(teng._uid_np[ks])
    m, f = teng._umask_p[uid], teng._ufill_p[uid]
    want = gp[None, :] * m + f * (1.0 - m)
    got = _fused_round_start(gp, teng._mask_views(ks),
                             teng._filler_views(ks))
    assert torch.equal(got, want)
    assert "_ucov_p" not in teng.__dict__           # not built until read
    for u, cfg in enumerate(teng._uniq_cfgs):
        mask, filler = coverage_and_filler(TFamily(), cfg, teng.global_cfg,
                                           seed=3, device="cpu")
        cov = mask if coverage == "strict" else loosen(mask, filler)
        assert torch.equal(teng._ucov_p[u], pack(cov, spec))
    assert (teng._ucov_p is teng._umask_p) == (coverage == "strict")
    assert coverage == "strict" or not torch.equal(teng._ucov_p,
                                                   teng._umask_p)


def _fixed_init(base, cfg, params):
    """A family whose init returns ``params`` for ``cfg`` — both runs
    start from the same global model."""
    class Fixed(base):
        def init(self, key, c, **kw):
            if c == cfg:
                return params
            return super().init(key, c, **kw)
    return Fixed()


@pytest.mark.parametrize("agg_mode", ["filler", "coverage"])
def test_simulator_history_tracks_jax(agg_mode):
    cfgs = COHORTS["width"]
    gcfg = JFamily().union(cfgs)
    gp = _global_params(gcfg, seed=4)
    task = jdata.ImageTaskSpec("t8", n_classes=4, image_size=8, seed=5)
    data = jdata.image_classification(task, 150, seed=0)
    test = jdata.image_classification(task, 200, seed=9)
    parts = jdata.iid_partition(150, len(cfgs), seed=0)

    def samplers(mod):
        return [mod.ClientSampler(data, p, round_fraction=0.5,
                                  batch_size=16, seed=i)
                for i, p in enumerate(parts)]

    common = dict(rounds=2, local_epochs=1, lr=0.05, momentum=0.9,
                  eval_every=1, agg_mode=agg_mode)
    jres = JSimulator(_fixed_init(JFamily, gcfg, gp), cfgs, samplers(jdata),
                      JRunConfig(engine="unified", **common), test).run()
    tg = _tcfg(gcfg)
    tres = TSimulator(_fixed_init(TFamily, tg, params_from_numpy(gp)),
                      [_tcfg(c) for c in cfgs], samplers(tdata),
                      TRunConfig(engine="unified", device="cpu", **common),
                      {k: v.copy() for k, v in test.items()}).run()
    assert len(tres["history"]) == len(jres["history"]) == 2
    assert max(abs(a - b) for a, b in zip(tres["history"],
                                          jres["history"])) <= 0.005
    _assert_trees_close(jres["global_params"], tres["global_params"], 1e-3)


def test_data_modules_byte_identical():
    for jt, tt in zip(jdata.TABLE1_TASKS, tdata.TABLE1_TASKS):
        assert jt.__dict__ == tt.__dict__
        a = jdata.image_classification(jt, 64, seed=3)
        b = tdata.image_classification(tt, 64, seed=3)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                   for k in a)
    pa = jdata.iid_partition(103, 7, seed=2)
    pb = tdata.iid_partition(103, 7, seed=2)
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    data = jdata.image_classification(jdata.EASY, 120, seed=0)
    for seed in (0, 5):
        sa = jdata.ClientSampler(data, pa[1], round_fraction=0.5,
                                 batch_size=4, seed=seed)
        sb = tdata.ClientSampler(data, pb[1], round_fraction=0.5,
                                 batch_size=4, seed=seed)
        for _ in range(2):
            ba = list(sa.round_batches(2))
            bb = list(sb.round_batches(2))
            assert len(ba) == len(bb) > 0
            for x, y in zip(ba, bb):
                assert all(np.array_equal(x[k], y[k]) for k in x)
    for frac, mode in ((1.0, "sample"), (0.5, "sample"), (0.4, "cycle")):
        jp = JParticipation(frac, seed=3, mode=mode)
        tp = TParticipation(frac, seed=3, mode=mode)
        assert all(jp.select(r, 10) == tp.select(r, 10) for r in range(4))
