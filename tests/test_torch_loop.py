"""The port's per-client loop (``engine="loop"``) vs the JAX package's,
and loop vs unified inside the port.

  * one round of ``Simulator(engine="loop")`` for each of the four
    methods, with full participation and with ``Participation.sample
    (0.5)``, from the same client (or global) models and the same data
    streams as JAX's loop: global params (fedadp) or every client's
    params (the per-client methods) at 1e-5 on the depth cohort and 1e-4
    on the width cohort — the JAX package's loop-vs-unified tolerances;
  * inside the port, loop vs unified from the same generator: fedadp's
    global params on a depth cohort at 1e-5 (``tests/test_unified.py``
    holds JAX's there), and the clients' logits for clustered / flexifed
    at 1e-5;
  * a JAX loop checkpoint of per-client (list) state resumed by the
    port's loop, and the reverse: round 2 after the resume matches the
    other package's uninterrupted round 2;
  * ``engine="auto"`` on a ragged cohort falls back to the loop and
    names the reason; a compressed wire cannot fall back and raises.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.core import VGGFamily as JFamily  # noqa: E402
from repro.fl import FLRunConfig as JRunConfig  # noqa: E402
from repro.fl import Federation as JFederation  # noqa: E402
from repro.fl import LoopBackend as JLoop  # noqa: E402
from repro.fl import Simulator as JSimulator  # noqa: E402
from repro.fl import make_strategy as jmake_strategy  # noqa: E402
from repro.models import vgg as jmodel  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import vgg_family as tcfg  # noqa: E402
from repro_torch.core import VGGFamily  # noqa: E402
from repro_torch.fl import (FLRunConfig, Federation, LoopBackend,  # noqa: E402
                            Simulator, make_strategy, unified_eligible)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import vgg as tmodel  # noqa: E402


def _tiny(name, stages):
    return JVGGConfig(name=name, stages=stages, classifier=(16,),
                      n_classes=4, image_size=8)


COHORTS = {
    "depth": [_tiny("d1", ((8,), (8,))), _tiny("d2", ((8,), (8, 8))),
              _tiny("d1", ((8,), (8,))), _tiny("d3", ((8, 8), (8, 8)))],
    "width": [_tiny("w1", ((8,), (8,))), _tiny("w2", ((8,), (12, 8))),
              _tiny("w2", ((8,), (12, 8))), _tiny("w3", ((12, 8), (12, 8)))],
}
TOL = {"depth": 1e-5, "width": 1e-4}
N = 160
TASK = jdata.ImageTaskSpec("t8", n_classes=4, image_size=8, seed=5)
DATA = jdata.image_classification(TASK, N, seed=0)
TEST = jdata.image_classification(TASK, 64, seed=9)
PARTS = jdata.iid_partition(N, 4, seed=0)
COMMON = dict(rounds=1, local_epochs=1, lr=0.05, momentum=0.9, eval_every=1,
              embed_seed=3)


def _tcfg(c):
    return tcfg.VGGConfig(**{f: getattr(c, f) for f in
                             ("name", "stages", "classifier", "n_classes",
                              "in_channels", "image_size")})


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   * (np.sqrt(2.0 / np.prod(s.shape[:-1]))
                      if len(s.shape) > 1 else 0.1)).astype(np.float32),
        shapes)


def _init_np(method, cfgs, seed=0):
    """The run's initial state in numpy: the global model for fedadp,
    one model per client otherwise."""
    if method == "fedadp":
        return _np_params(JFamily().union(cfgs), seed)
    return [_np_params(c, seed + 10 * k) for k, c in enumerate(cfgs)]


def _samplers(mod, parts=PARTS):
    return [mod.ClientSampler(DATA, p, round_fraction=0.5, batch_size=8,
                              seed=i) for i, p in enumerate(parts)]


_JSIMS = {}


def _jax_run(cohort, method, init, **kw):
    """JAX's loop from ``init``; one Simulator per cohort, so its jitted
    grad fns are compiled once for every case."""
    cfgs = COHORTS[cohort]
    if cohort not in _JSIMS:
        _JSIMS[cohort] = JSimulator(JFamily(), cfgs, _samplers(jdata),
                                    JRunConfig(engine="loop", **COMMON), TEST)
    sim = _JSIMS[cohort]
    sim.cfg = JRunConfig(method=method, engine="loop", **COMMON, **kw)
    sim.samplers = _samplers(jdata)
    fed = sim._build()
    fed.strategy.init_state = lambda key: jax.tree.map(np.array, init)
    return fed.run(jax.random.PRNGKey(0))


def _torch_run(cohort, method, init, *, engine="loop", **kw):
    cfgs = [_tcfg(c) for c in COHORTS[cohort]]
    sim = Simulator(VGGFamily(), cfgs, _samplers(tdata),
                    FLRunConfig(method=method, engine=engine, device="cpu",
                                **COMMON, **kw), TEST)
    fed = sim._build()
    if init is not None:
        fed.strategy.init_state = (
            lambda gen, device=None: params_from_numpy(init))
    return fed.run(torch.Generator().manual_seed(0)), fed


def _close(jtree, ttree, atol):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in p) for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=atol, rtol=0, err_msg="/".join(path))


LOOP_CASES = [  # method, cohort, participation, extra knobs
    *[(m, c, p, {}) for m in ("clustered", "flexifed", "standalone")
      for c in ("depth", "width") for p in (1.0, 0.5)],
    ("fedadp", "depth", 1.0, {}),
    ("fedadp", "depth", 0.5, dict(agg_mode="coverage")),
    ("fedadp", "width", 1.0, dict(filler="global")),
    ("fedadp", "width", 0.5, dict(agg_mode="coverage", coverage="strict")),
]


@pytest.mark.parametrize("method,cohort,participation,extra", LOOP_CASES)
def test_loop_round_matches_jax(method, cohort, participation, extra):
    init = _init_np(method, COHORTS[cohort])
    kw = dict(participation=participation, participation_seed=2, **extra)
    jres = _jax_run(cohort, method, init, **kw)
    tres, fed = _torch_run(cohort, method, init, **kw)
    assert fed.backend.name == "loop"
    if method == "fedadp":
        _close(jres["global_params"], tres["global_params"], TOL[cohort])
    else:
        assert jres["global_params"] is None and tres["global_params"] is None
        _close(jres["client_params"], tres["client_params"], TOL[cohort])
    assert len(tres["history"]) == 1
    assert abs(tres["history"][0] - jres["history"][0]) <= 0.02


# ------------------------------------------------- loop vs unified (port)
def test_fedadp_loop_matches_unified():
    """Depth cohort: the unified engine's round reproduces the loop's
    global params at 1e-5, as the JAX package's engine does its loop."""
    res = {eng: _torch_run("depth", "fedadp", None, engine=eng)[0]
           for eng in ("loop", "unified")}
    assert res["loop"]["history"] == res["unified"]["history"]
    for (p, a), (_, b) in zip(tu.flatten(res["loop"]["global_params"]),
                              tu.flatten(res["unified"]["global_params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg="/".join(p))


@pytest.mark.parametrize("method", ["clustered", "flexifed", "standalone"])
def test_per_client_loop_matches_unified(method):
    """Client functions agree: the loop's client-space params against the
    engine's union-space views, logits on 16 test images at 1e-5."""
    cfgs = [_tcfg(c) for c in COHORTS["depth"]]
    res = {}
    for eng in ("loop", "unified"):
        res[eng], fed = _torch_run("depth", method, None, engine=eng)
        assert fed.backend.name == eng
    assert res["loop"]["history"] == res["unified"]["history"]
    gcfg = VGGFamily().union(cfgs)
    x = torch.as_tensor(TEST["x"][:16])
    for k, cfg in enumerate(cfgs):
        la = tmodel.apply(res["loop"]["client_params"][k], cfg, x)
        lb = tmodel.apply(res["unified"]["client_params"][k], gcfg, x)
        np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=1e-5)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("method", ["clustered", "flexifed"])
def test_loop_checkpoint_crosses_packages(tmp_path, method):
    """Per-client state is a list of client trees, keyed ``<k>/<path>``
    in both packages: a JAX round-1 checkpoint resumed by the port's loop
    gives JAX's round 2, and the reverse."""
    cohort = "depth"
    jcfgs = COHORTS[cohort]
    cfgs = [_tcfg(c) for c in jcfgs]
    init = _init_np(method, jcfgs)
    kw = dict(local_epochs=1, lr=0.05, momentum=0.9)

    jstrat = jmake_strategy(method, JFamily(), jcfgs, [40] * 4)
    jstrat.init_state = lambda key: jax.tree.map(np.array, init)
    jdir = tmp_path / "jax"
    jfed = JFederation(jstrat, JLoop(JFamily(), jcfgs, _samplers(jdata), **kw),
                       rounds=2, checkpoint_dir=str(jdir), checkpoint_every=1)
    jfed.run(jax.random.PRNGKey(0))
    jfinal = jfed.state

    tstrat = make_strategy(method, VGGFamily(), cfgs, [40] * 4, device="cpu")
    tfed = Federation(tstrat, LoopBackend(VGGFamily(), cfgs,
                                          _samplers(tdata), device="cpu",
                                          **kw), rounds=2)
    tfed.run(torch.Generator().manual_seed(1),
             resume_from=str(jdir / "round_0001.npz"))
    assert isinstance(tfed.state, list) and len(tfed.state) == 4
    _close(jfinal, tfed.state, TOL[cohort])

    tstrat.init_state = lambda gen, device=None: params_from_numpy(init)
    tdir = tmp_path / "torch"
    tfed = Federation(tstrat, LoopBackend(VGGFamily(), cfgs,
                                          _samplers(tdata), device="cpu",
                                          **kw), rounds=2,
                      checkpoint_dir=str(tdir), checkpoint_every=1)
    tfed.run(torch.Generator())
    jfed = JFederation(jstrat, JLoop(JFamily(), jcfgs, _samplers(jdata), **kw),
                       rounds=2)
    jfed.run(jax.random.PRNGKey(0), resume_from=str(tdir / "round_0001.npz"))
    _close(jfed.state, tfed.state, TOL[cohort])


# --------------------------------------------------------------- fallback
def test_auto_falls_back_to_loop_on_ragged_cohort(caplog):
    cfgs = [_tcfg(c) for c in COHORTS["width"]]
    parts = [PARTS[0][:30], PARTS[1], PARTS[2][:36], PARTS[3]]
    samplers = _samplers(tdata, parts)
    rc = FLRunConfig(method="flexifed", device="cpu", **COMMON)
    sim = Simulator(VGGFamily(), cfgs, samplers, rc, TEST)
    assert not unified_eligible(sim._strategy(), VGGFamily(), cfgs, samplers)
    with caplog.at_level(logging.INFO, logger="repro_torch.fl"):
        fed = sim._build()
        sim._build()
    assert fed.backend.name == "loop"
    msgs = [r.getMessage() for r in caplog.records
            if "falls back to the loop" in r.getMessage()]
    assert len(msgs) == 1 and "ragged client datasets" in msgs[0]
    res = sim.run()
    assert len(res["client_params"]) == 4 and res["global_params"] is None
    # a compressed wire has no loop to fall back to
    wire = Simulator(VGGFamily(), cfgs, samplers,
                     FLRunConfig(wire="int8", device="cpu", **COMMON), TEST)
    with pytest.raises(ValueError, match="needs the unified engine"):
        wire._build()
