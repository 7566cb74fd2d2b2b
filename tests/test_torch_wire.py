"""The compressed wire (``wire="int8" | "bf16"``, error feedback, the
sparse coverage wire) of the port's unified engine vs the JAX package's.

  * ``FLRunConfig``'s wire validation raises what the JAX package's
    does (``tests/test_quant.py``'s matches);
  * two or three engine rounds of each package from the same
    numpy-seeded global model and batches, on the reduced width VGG
    cohort and the reduced tffn cohort of ``tests/test_quant.py``, with
    partial participation after (or from) round 0, so error feedback
    and the residual gather/scatter by client index run: each chunk's
    local training is held to JAX's at 1e-4 (the width-cohort tolerance
    of ``tests/test_torch_engine.py``), then both engines encode JAX's
    trained rows, so ``wire_stats()`` are equal and the residual planes
    and global models agree within 1e-6 after every round;
  * 3-round compressed runs of the port track its own f32 run's final
    accuracy within 1e-2 (the JAX package's bound).
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
from repro.configs.vgg_family import scaled as jscaled  # noqa: E402
from repro.configs.vgg_family import vgg as jvgg  # noqa: E402
from repro.core import TransformerFamily as JTFamily  # noqa: E402
from repro.core import VGGFamily as JVFamily  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import vgg as jvggm  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs.vgg_family import scaled, vgg  # noqa: E402
from repro_torch.core import TransformerFamily, VGGFamily  # noqa: E402
from repro_torch.data import (EASY, ClientSampler,  # noqa: E402
                              image_classification, iid_partition)
from repro_torch.fl import FLRunConfig, Simulator, UnifiedEngine  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

TOL = 1e-4
ARCHS = ("vgg13", "vgg16", "vgg16-wider")


# ------------------------------------------------------------ validation
def test_run_config_validates_wire_combinations():
    def cfg(**kw):
        return FLRunConfig(device="cpu", **kw)
    with pytest.raises(ValueError, match="wire="):
        cfg(wire="fp4")
    with pytest.raises(ValueError, match="tile"):
        cfg(wire="int8", wire_tile=100)
    with pytest.raises(ValueError, match="loop"):
        cfg(wire="int8", engine="loop")
    with pytest.raises(ValueError, match="plane"):
        cfg(wire="int8", agg_layout="plane")
    with pytest.raises(ValueError, match="wire layer"):
        cfg(wire="int8", method="clustered")
    with pytest.raises(ValueError, match="wire_sparse"):
        cfg(wire_sparse=True)                   # needs a wire
    with pytest.raises(ValueError, match="coverage"):
        cfg(wire="int8", wire_sparse=True)      # needs agg_mode
    # the valid combinations construct
    cfg(wire="bf16")
    cfg(wire="int8", wire_tile=512, agg_layout="stream")
    cfg(wire="int8", wire_sparse=True, agg_mode="coverage")


def test_engine_validates_wire_combinations():
    cfgs = [scaled(vgg(a), 0.125, 16) for a in ARCHS[:2]]
    mk = dict(family=VGGFamily(), client_cfgs=cfgs, n_samples=[1, 1],
              device="cpu")
    with pytest.raises(ValueError, match="plane"):
        UnifiedEngine(wire="int8", agg_layout="plane", **mk)
    with pytest.raises(ValueError, match="wire_sparse"):
        UnifiedEngine(wire_sparse=True, **mk)
    with pytest.raises(ValueError, match="coverage"):
        UnifiedEngine(wire="bf16", wire_sparse=True, **mk)
    with pytest.raises(ValueError, match="tile"):
        UnifiedEngine(wire="int8", wire_tile=200, **mk)


# ------------------------------------------------------- engine rounds
def _share_training(monkeypatch, jeng, teng):
    """Hand each port chunk the JAX engine's trained rows for the same
    chunk, after holding the port's own training of it to them at TOL.
    The wire then encodes identical inputs in both engines, so payloads
    are equal and residuals and the aggregate are compared at 1e-6;
    a two-framework training difference (~1e-6) can no longer flip a
    rounding and hide behind a one-quantum tolerance. Returns the queue
    of recorded chunks (empty once the port's round consumed them)."""
    queue = []
    jtrain, ttrain = jeng._train_packed, teng._train_packed

    def record(*args):
        out = jtrain(*args)
        queue.append(np.array(out))
        return out

    def substitute(*args):
        own = ttrain(*args).detach().numpy()
        want = queue.pop(0)
        np.testing.assert_allclose(own, want, atol=TOL, rtol=0)
        return torch.from_numpy(want.copy())
    monkeypatch.setattr(jeng, "_train_packed", record)
    monkeypatch.setattr(teng, "_train_packed", substitute)
    return queue


def _assert_close(jtree, ttree, atol):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=atol, rtol=0, err_msg="/".join(path))


def _run_rounds(monkeypatch, jeng, teng, gp, batches_for, sels):
    """Run both engines through the rounds of ``sels`` (the participating
    clients of each round, None = all), each on its own previous global
    as a Federation does, and compare after every round: wire_stats
    equal, global models and residual planes at 1e-6. From round
    1 on, participants carry earlier rounds' residuals (error feedback),
    and the residual rows of clients that sit a round out stay as they
    were."""
    queue = _share_training(monkeypatch, jeng, teng)
    jstate, tstate = gp, params_from_numpy(gp)
    prev = None
    for r, sel in enumerate(sels):
        batches = batches_for(r, len(teng.client_cfgs) if sel is None
                              else len(sel))
        jstate = jeng.run_round(jstate, batches, selected=sel, round_idx=r)
        tstate = teng.run_round(tstate, batches, selected=sel, round_idx=r)
        assert not queue
        assert teng.wire_stats() == jeng.wire_stats()
        assert teng.agg_stats()["layout"] == "stream"
        _assert_close(jstate, tstate, 1e-6)
        res = teng.wire_residuals().numpy().copy()
        assert res.shape == (len(teng.client_cfgs), teng.plane_spec.size)
        if prev is not None:
            ks = range(len(res)) if sel is None else sel
            assert np.abs(prev[list(ks)]).max() > 0   # e != 0 consumed
            out = [k for k in range(len(res)) if k not in ks]
            np.testing.assert_array_equal(res[out], prev[out])
        # the payloads are equal; the residual (x + e) - q*s may differ
        # in its last bit where XLA contracts it into an FMA, and x + e
        # next round could then round the other way: the port goes on
        # from JAX's residual plane, so every round's payloads are equal
        prev = np.array(jeng.wire_residuals())
        np.testing.assert_allclose(res, prev, atol=1e-6, rtol=0)
        teng.load_wire_residuals(torch.from_numpy(prev.copy()))


def _vgg_round_inputs(r, k):
    rng = np.random.default_rng(1 + r)
    return [{"x": rng.standard_normal((k, 16, 32, 32, 3)).astype(np.float32),
             "y": rng.integers(0, 10, (k, 16)).astype(np.int32)}
            for _ in range(2)]


def _vgg_global(gcfg, seed=0):
    shapes = jax.eval_shape(lambda key: jvggm.init_params(key, gcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   * (np.sqrt(2.0 / np.prod(s.shape[:-1]))
                      if len(s.shape) > 1 else 0.1)).astype(np.float32),
        shapes)


def _vgg_engines(wire, agg_mode, filler, sparse, k_chunk, tile):
    jcfgs = [jscaled(jvgg(a), 0.125, 64) for a in ARCHS]
    tcfgs = [scaled(vgg(a), 0.125, 64) for a in ARCHS]
    kw = dict(lr=0.05, momentum=0.9, agg_mode=agg_mode, filler_mode=filler,
              k_chunk=k_chunk, embed_seed=2, wire=wire, wire_tile=tile,
              wire_sparse=sparse)
    n = [40, 60, 50]
    jeng = JEngine(JVFamily(), jcfgs, n, use_kernel=False, **kw)
    teng = UnifiedEngine(VGGFamily(), tcfgs, n, device="cpu", **kw)
    return jeng, teng


WIRE_CASES = [  # wire, agg_mode, filler, sparse, k_chunk, tile
    ("int8", "filler", "zero", False, None, 256),
    ("int8", "filler", "global", False, 2, 128),
    ("int8", "coverage", "zero", True, 2, 512),
    ("bf16", "filler", "zero", False, 1, 256),
    ("bf16", "coverage", "zero", False, None, 256),
]


@pytest.mark.parametrize("wire,agg_mode,filler,sparse,k_chunk,tile",
                         WIRE_CASES)
def test_vgg_width_round_matches_jax(monkeypatch, wire, agg_mode, filler,
                                     sparse, k_chunk, tile):
    """A full round, then a partial one (clients 0 and 2) that consumes
    round 0's residuals through the gather by client index."""
    jeng, teng = _vgg_engines(wire, agg_mode, filler, sparse, k_chunk, tile)
    _run_rounds(monkeypatch, jeng, teng, _vgg_global(jeng.global_cfg),
                _vgg_round_inputs, [None, [0, 2]])


def test_vgg_width_partial_rounds_match_jax(monkeypatch):
    """Partial participation from round 0 on, one client per chunk: a
    client's first round (zero residual) and later rounds share chunks
    with others, and client 1's residual row sits round 1 out."""
    jeng, teng = _vgg_engines("int8", "filler", "global", False, 1, 256)
    _run_rounds(monkeypatch, jeng, teng, _vgg_global(jeng.global_cfg),
                _vgg_round_inputs, [[1, 2], [0, 2], None])


def _tffn():
    base = jreduced(jget_config("glm4-9b"), n_units=2, d_model=32)
    jcfgs = [jtf.make_variant(base, n_units=2, ffn_scale=0.5),
             jtf.make_variant(base, n_units=1, ffn_scale=1.0)]
    tcfgs = [ModelConfig(**{f.name: getattr(c, f.name)
                            for f in dataclasses.fields(ModelConfig)})
             for c in jcfgs]
    return base, jcfgs, tcfgs


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_tffn_width_round_matches_jax(monkeypatch, wire):
    """A full round, then client 1 alone on round 0's residual."""
    base, jcfgs, tcfgs = _tffn()
    kw = dict(lr=0.05, momentum=0.9, embed_seed=3, wire=wire,
              attn_backend="blockwise")
    jeng = JEngine(JTFamily(), jcfgs, [16, 16], use_kernel=False, **kw)
    teng = UnifiedEngine(TransformerFamily(), tcfgs, [16, 16], device="cpu",
                         **kw)
    gp = jax.tree.map(np.asarray, jT.init_params(
        jax.random.PRNGKey(0), JTFamily().union(jcfgs)))

    def batches_for(r, k):
        rng = np.random.default_rng(1 + r)
        toks = rng.integers(0, base.vocab_size, (2, k, 4, 17))
        return [{"tokens": t[..., :-1].astype(np.int32),
                 "labels": t[..., 1:].astype(np.int32)} for t in toks]
    _run_rounds(monkeypatch, jeng, teng, gp, batches_for, [None, [1]])


# ------------------------------------------------------- 3-round accuracy
def _vgg_width_setup(n=240, n_eval=360):
    """``tests/test_quant.py``'s width cohort and data."""
    cfgs = [scaled(vgg(a), 0.125, 64) for a in ARCHS]
    data = image_classification(EASY, n, seed=0)
    test = image_classification(EASY, n_eval, seed=99)
    parts = iid_partition(n, len(cfgs), seed=0)

    def samplers():
        return [ClientSampler(data, p, round_fraction=0.5, batch_size=32,
                              seed=i) for i, p in enumerate(parts)]
    return cfgs, samplers, test


def _run(cfgs, samplers, test, *, wire, rounds=3, **kw):
    rc = FLRunConfig(method="fedadp", rounds=rounds, local_epochs=1,
                     lr=0.05, momentum=0.9, eval_every=rounds,
                     engine="unified", wire=wire, device="cpu", **kw)
    sim = Simulator(VGGFamily(), cfgs, samplers(), rc, test)
    return sim.run(), next(iter(sim._backends.values()))


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_wire_accuracy_tracks_f32(wire):
    cfgs, samplers, test = _vgg_width_setup()
    f32, _ = _run(cfgs, samplers, test, wire="f32")
    q, backend = _run(cfgs, samplers, test, wire=wire)
    assert abs(f32["final_acc"] - q["final_acc"]) <= 1e-2
    ws = backend.wire_stats()
    assert ws["wire"] == wire
    assert ws["reduction"] == 2.0 if wire == "bf16" else ws["reduction"] > 3.9
    assert backend.wire_residuals() is not None
    assert backend.plane_spec.size == ws["f32_bytes"] // (4 * len(cfgs))


def test_sparse_wire_beats_4x_and_tracks_f32():
    """One coverage round on the sparse int8 wire: >= 4x fewer bytes,
    accuracy within 1e-2 and the global model within 1e-2 of the f32
    wire's (tests/test_quant.py's bounds)."""
    cfgs, samplers, test = _vgg_width_setup()
    f32, _ = _run(cfgs, samplers, test, wire="f32", agg_mode="coverage",
                  rounds=1)
    qs, bs = _run(cfgs, samplers, test, wire="int8", wire_sparse=True,
                  agg_mode="coverage", rounds=1)
    assert abs(f32["final_acc"] - qs["final_acc"]) <= 1e-2
    for a, b in zip(tu.leaves(f32["global_params"]),
                    tu.leaves(qs["global_params"])):
        assert float((a - b).abs().max()) <= 1e-2
    assert bs.wire_stats()["reduction"] >= 4.0
