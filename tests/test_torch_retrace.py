"""The build detector (``repro_torch.analysis.retrace``), the
counterpart of ``tests/test_retrace.py``: ``Federation.run`` on the
unified backend builds everything it builds in round 1 and NOTHING after
— no nvcc build, no first library load, no new entry of the engine's
embedding-artifact cache (``KeyedCache``) — under full participation,
with the streamed layout, and with the int8 wire; and the engine's step
serves every round's subset size (``step_stats()`` unchanged after round
1). The port traces nothing per subset size (no ``torch.compile``), so
these are the run-time builds that could multiply.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

from repro_torch.analysis import retrace  # noqa: E402
from repro_torch.analysis.retrace import RetraceDetector  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.vgg_family import scaled, vgg  # noqa: E402
from repro_torch.core import TransformerFamily, VGGFamily, tfamily  # noqa: E402
from repro_torch.core.netchange import KeyedCache  # noqa: E402
from repro_torch.data import (EASY, ClientSampler, image_classification,  # noqa: E402
                              iid_partition)
from repro_torch.fl import (Federation, FedADPStrategy, Participation,  # noqa: E402
                            UnifiedBackend)

FAMILY = VGGFamily()


def test_detector_counts_builds_loads_and_cache_misses():
    """Sanity: a KeyedCache miss is one event, a hit none; a recorded
    build or load is one event each; a checkpoint restarts the count;
    nothing is counted once the detector has exited."""
    cache = KeyedCache(bound=4)
    with RetraceDetector() as det:
        cache.get(("mask", 0), lambda: 1)
        assert det.compiles == 1 and det.counts["cache_miss"] == 1
        det.checkpoint()
        cache.get(("mask", 0), lambda: 2)                  # a hit
        assert det.since_checkpoint == 0
        cache.get(("mask", 1), lambda: 3)                  # a new key
        retrace.record("build", "fedavg")
        retrace.record("load", "fedavg")
        assert det.since_checkpoint == 3
        assert det.counts == {"build": 1, "load": 1, "cache_miss": 2}
    assert det.events[0] == ("cache_miss", "mask")
    cache.get(("mask", 2), lambda: 4)                      # inactive
    assert det.compiles == 4
    with pytest.raises(RuntimeError):
        with det:
            with det:
                pass


def test_detector_watches_build_and_load_from_outside(monkeypatch,
                                                      tmp_path):
    """The detector wraps ``kernels.build``'s ``build`` and ``load`` while
    it is active: a library file made by the call is one build, a first
    load one load, a built or loaded library nothing; the functions are
    the originals again once it exits. (The compiler is replaced by a
    file write: there is no nvcc here.)"""
    from repro_torch.kernels import build as kbuild
    lib = tmp_path / "libfake.so"
    monkeypatch.setattr(kbuild, "library_path", lambda name: lib)

    def fake_build(name):
        lib.touch()
        return lib
    monkeypatch.setattr(kbuild, "build", fake_build)
    monkeypatch.setattr(kbuild, "_libs", {})
    monkeypatch.setattr(kbuild.ctypes, "CDLL", lambda path: object())
    load0, get0 = kbuild.load, KeyedCache.get
    declared = []
    with RetraceDetector() as det:
        kbuild.load("fake", declared.append)       # built, then loaded
        kbuild.load("fake", declared.append)       # loaded already
        kbuild.build("fake")                       # built already
    assert det.events == [("build", "fake"), ("load", "fake")]
    assert len(declared) == 1
    assert (kbuild.build, kbuild.load) == (fake_build, load0)
    assert KeyedCache.get is get0


def test_detector_counts_its_own_thread_only():
    """A build on another thread (``chip_smoke.py`` builds the attention
    sources beside its first phases) is not the region's."""
    import threading
    with RetraceDetector() as det:
        t = threading.Thread(target=retrace.record, args=("build", "swa"))
        t.start()
        t.join()
        retrace.record("load", "fedavg")
    assert det.events == [("load", "fedavg")]


def _setup():
    cfgs = [scaled(vgg(a), 0.125, 32) for a in ("vgg13", "vgg16")]
    n = 160
    data = image_classification(EASY, n, seed=0)
    test = image_classification(EASY, 80, seed=9)
    parts = iid_partition(n, len(cfgs), seed=0)
    samplers = [ClientSampler(data, p, round_fraction=0.5, batch_size=16,
                              seed=i) for i, p in enumerate(parts)]
    return cfgs, samplers, test


def _run(family, cfgs, samplers, test, participation=None, **backend_kw):
    """Three rounds; returns (detector, backend, step_stats after round
    1, the run's history)."""
    backend = UnifiedBackend(family, cfgs, samplers, local_epochs=1,
                             lr=0.05, momentum=0.9, device="cpu",
                             **backend_kw)
    strategy = FedADPStrategy(family, cfgs, [s.n_samples for s in samplers])
    det = RetraceDetector()
    after_r1 = {}

    def after_round(rec):
        if not after_r1:
            det.checkpoint()              # everything up to here may build
            after_r1.update(backend.engine.step_stats())

    with det:
        # the engine is made (and its artifacts built) where the
        # federation binds the backend: inside the region
        fed = Federation(strategy, backend, rounds=3, eval_batch=test,
                         eval_every=1, participation=participation,
                         callbacks=[after_round])
        res = fed.run(torch.Generator().manual_seed(0))
    return det, backend, after_r1, res["history"]


@pytest.mark.parametrize("pname,participation", [
    ("full", Participation()),
    ("sample", Participation.sample(0.5, seed=2)),
])
def test_federation_builds_nothing_after_round_one(pname, participation):
    """Rounds >= 2 reuse round 1's cache entries and step: no new
    KeyedCache miss, no build or load, ``step_stats()`` unchanged.
    Sampled participation keeps the subset size constant."""
    cfgs, samplers, test = _setup()
    det, backend, after_r1, hist = _run(FAMILY, cfgs, samplers, test,
                                        participation)
    assert len(hist) == 3
    # the detector sees every miss of the engine's cache
    assert det.counts["cache_miss"] == backend.engine.cache_stats()["misses"]
    assert det.since_checkpoint == 0, (
        f"{pname}: {det.since_checkpoint} build(s) AFTER round 1: "
        f"{det.events[det._mark:]}")
    stats = backend.engine.step_stats()
    assert stats == after_r1, stats
    assert set(stats["subset_sizes"]) == ({2} if pname == "full" else {1})


def test_streamed_rounds_build_nothing_after_round_one():
    """The streamed layout (``agg_layout="stream"``, ``k_chunk=1``): every
    chunk after round 1 reuses the same artifacts and step."""
    cfgs, samplers, test = _setup()
    det, backend, after_r1, hist = _run(FAMILY, cfgs, samplers, test,
                                        agg_layout="stream", k_chunk=1)
    assert len(hist) == 3
    assert backend.engine.agg_stats()["layout"] == "stream"
    assert backend.engine.agg_stats()["k_chunk"] == 1
    assert det.since_checkpoint == 0, det.events[det._mark:]
    assert backend.engine.step_stats() == after_r1
    assert set(backend.engine.step_stats()["subset_sizes"]) == {1}


def test_compressed_wire_rounds_build_nothing_after_round_one():
    """The int8 wire (encode, residual rows, the dequantize-accumulate
    pass) builds nothing after round 1 and moves bytes every round."""
    cfgs, samplers, test = _setup()
    det, backend, after_r1, hist = _run(FAMILY, cfgs, samplers, test,
                                        k_chunk=1, wire="int8")
    assert len(hist) == 3
    assert backend.wire_stats()["wire"] == "int8"
    assert backend.wire_stats()["bytes_per_round"] > 0
    assert det.since_checkpoint == 0, det.events[det._mark:]
    assert backend.engine.step_stats() == after_r1


def _transformer_cohort(ffn_scale):
    base = reduced(get_config("glm4-9b"), n_units=2, d_model=64)
    cfgs = [tfamily.make_variant(base, n_units=1, ffn_scale=ffn_scale),
            tfamily.make_variant(base)]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, base.vocab_size, size=(32, 17)).astype(np.int32)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    samplers = [ClientSampler(data, p, round_fraction=0.5, batch_size=8,
                              seed=i)
                for i, p in enumerate((np.arange(0, 16),
                                       np.arange(16, 32)))]
    test = {"tokens": toks[:8, :-1], "labels": toks[:8, 1:]}
    return cfgs, samplers, test


def test_transformer_rounds_build_nothing_after_round_one():
    """A depth cohort of glm4-9b (reduced) in bf16: the bf16 casts and
    the embedding artifacts are built in round 1 only."""
    cfgs, samplers, test = _transformer_cohort(1.0)
    det, backend, after_r1, hist = _run(TransformerFamily(), cfgs, samplers,
                                        test, compute_dtype="bf16")
    assert len(hist) == 3
    assert det.since_checkpoint == 0, det.events[det._mark:]
    assert backend.engine.step_stats() == after_r1


def test_width_rounds_build_only_their_round_seeds_segments():
    """A width cohort draws its NetChange mappings from a per-round seed
    (``round_embed_seed``, the reference's semantics), so each later
    round builds each participant's E·Eᵀ segment matrices anew (one
    ``("seg", k, seed)`` miss a client a round) — and nothing else: no
    build, no load, no other artifact, the same step."""
    cfgs, samplers, test = _transformer_cohort(0.5)
    det, backend, after_r1, hist = _run(TransformerFamily(), cfgs, samplers,
                                        test)
    assert len(hist) == 3
    later = det.events[det._mark:]
    assert later == [("cache_miss", "seg")] * (2 * len(cfgs)), later
    assert backend.engine.step_stats() == after_r1
