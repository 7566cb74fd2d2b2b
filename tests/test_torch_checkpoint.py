"""The port's checkpoints (``repro_torch.checkpoint``) and the
Federation's checkpoint/resume.

  * ``save/load_pytree`` and ``save/load_plane`` round-trip bit for bit,
    bf16 included;
  * a file the JAX package's ``repro.checkpoint`` writes loads in the
    port bit for bit, and the reverse (the same npz layout);
  * an int8-wire run interrupted at round 3 and resumed from
    ``round_0003.npz`` + ``round_0003.wire.npz`` matches the
    uninterrupted 6-round run (history and global params at 1e-6, as
    ``tests/test_federation.py`` holds the JAX package), and the sampler
    rngs continue their streams after a resume.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.core import plane as jplane  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.vgg_family import scaled, vgg  # noqa: E402
from repro_torch.core import VGGFamily, plane  # noqa: E402
from repro_torch.data import (EASY, ClientSampler,  # noqa: E402
                              image_classification, iid_partition)
from repro_torch.fl import (Federation, FedADPStrategy,  # noqa: E402
                            UnifiedBackend, checkpoint_path,
                            load_round_checkpoint, restore_sampler_rngs,
                            save_round_checkpoint, wire_checkpoint_path)


def _tree():
    rng = np.random.default_rng(0)
    return {"conv": {"w": torch.from_numpy(
                         rng.standard_normal((3, 3, 2, 4)).astype(np.float32)),
                     "b": (torch.arange(6, dtype=torch.bfloat16) / 3)},
            "fc": {"w": torch.from_numpy(
                       rng.standard_normal((5, 2)).astype(np.float32)),
                   "step": torch.arange(3, dtype=torch.int32)}}


def _equal(a, b):
    assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a,
                       b.view(torch.int16) if b.dtype == torch.bfloat16
                       else b)


def test_pytree_roundtrip_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "t.npz")
    tck.save_pytree(path, tree, extra={"round": 4, "note": "x"})
    got, extra = tck.load_pytree(path)
    assert extra == {"round": 4, "note": "x"}
    assert [p for p, _ in tu.flatten(got)] == [p for p, _ in tu.flatten(tree)]
    for (_, a), (_, b) in zip(tu.flatten(tree), tu.flatten(got)):
        _equal(a, b)
    like = tu.tree_map(torch.zeros_like, tree)
    got2, _ = tck.load_pytree(path, like=like)
    for (_, a), (_, b) in zip(tu.flatten(tree), tu.flatten(got2)):
        _equal(a, b)
    assert not any(f.endswith(".npz") and f != "t.npz"
                   for f in os.listdir(tmp_path))   # no temp left behind


def test_plane_roundtrip_bit_exact(tmp_path):
    tree = _tree()
    spec = plane.PlaneSpec.from_tree(tree)
    rng = np.random.default_rng(1)
    for arr in (torch.from_numpy(rng.standard_normal(
                    (3, spec.size)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal(spec.size).astype(
                    np.float32)).to(torch.bfloat16)):
        path = str(tmp_path / "p.npz")
        tck.save_plane(path, arr, spec, extra={"kind": "wire_residuals"})
        got, spec2, extra = tck.load_plane(path)
        _equal(arr, got)
        assert spec2 == spec and extra == {"kind": "wire_residuals"}


def test_files_cross_between_packages(tmp_path):
    """A JAX checkpoint loads in the port bit for bit, and the reverse —
    trees (bf16 included) and planes with their specs."""
    tree = _tree()
    jtree = tu.tree_map(
        lambda t: (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                   if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())),
        tree)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_pytree(jpath, jtree, extra={"round": 2})
    tck.save_pytree(tpath, tree, extra={"round": 2})
    got, extra = tck.load_pytree(jpath)
    assert extra == {"round": 2}
    for (_, a), (_, b) in zip(tu.flatten(tree), tu.flatten(got)):
        _equal(a, b)
    jgot, jextra = jck.load_pytree(tpath)
    assert jextra == {"round": 2}
    for (p, a) in tu.flatten(tree):
        b = tu.get(jgot, p)
        assert str(b.dtype) == str(a.dtype).split(".")[-1]
        np.testing.assert_array_equal(np.asarray(b, np.float32),
                                      a.float().numpy())
    # the same npz keys and manifest, whichever package wrote the file
    jz, tz = np.load(jpath), np.load(tpath)
    assert sorted(jz.files) == sorted(tz.files)
    assert str(jz["__manifest__"]) == str(tz["__manifest__"])
    # planes
    spec = plane.PlaneSpec.from_tree(tree)
    jspec = jplane.PlaneSpec.from_tree(jtree)
    arr = np.random.default_rng(3).standard_normal((2, spec.size)).astype(
        np.float32)
    jck.save_plane(jpath, jnp.asarray(arr), jspec, extra={"k": 1})
    got, spec2, _ = tck.load_plane(jpath)
    np.testing.assert_array_equal(got.numpy(), arr)
    assert spec2 == spec
    tck.save_plane(tpath, torch.from_numpy(arr), spec)
    jarr, jspec2, _ = jck.load_plane(tpath)
    np.testing.assert_array_equal(np.asarray(jarr), arr)
    assert jspec2.paths == jspec.paths and jspec2.dtypes == jspec.dtypes


class _FakeSampler:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)


def test_round_checkpoint_and_rng_roundtrip(tmp_path):
    """The round checkpoint carries round, history and the sampler rng
    streams; a restored sampler continues exactly where it was cut."""
    state = _tree()
    s = _FakeSampler(5)
    s.rng.integers(0, 10, size=7)                    # advance the stream
    path = str(tmp_path / "ck.npz")
    save_round_checkpoint(path, state, round_idx=2, history=[0.1, 0.2],
                          samplers=[s])
    expected_next = s.rng.integers(0, 1000, size=8)
    state2, extra = load_round_checkpoint(
        path, like=tu.tree_map(torch.zeros_like, state))
    assert extra["round"] == 2 and extra["history"] == [0.1, 0.2]
    for (_, a), (_, b) in zip(tu.flatten(state), tu.flatten(state2)):
        _equal(a, b)
    s2 = _FakeSampler(0)                             # wrong seed on purpose
    restore_sampler_rngs([s2], extra)
    np.testing.assert_array_equal(s2.rng.integers(0, 1000, size=8),
                                  expected_next)
    with pytest.raises(ValueError, match="sampler"):
        restore_sampler_rngs([s2, s2], extra)


FAMILY = VGGFamily()


def _setup(archs=("vgg13", "vgg16"), n=160, width=32):
    cfgs = [scaled(vgg(a), 0.125, width) for a in archs]
    data = image_classification(EASY, n, seed=0)
    test = image_classification(EASY, 80, seed=9)
    parts = iid_partition(n, len(cfgs), seed=0)

    def samplers():
        return [ClientSampler(data, p, round_fraction=0.5, batch_size=16,
                              seed=i) for i, p in enumerate(parts)]

    return cfgs, samplers, test


@pytest.mark.parametrize("wire", ["int8", "f32"])
def test_resume_reproduces_run(tmp_path, wire):
    """Interrupt a 6-round fedadp run at round 3, restore, and the
    resumed history + final global params match the uninterrupted run.
    On the int8 wire the residual plane rides ``round_0003.wire.npz``."""
    cfgs, mk, test = _setup()
    backend = UnifiedBackend(FAMILY, cfgs, mk(), local_epochs=1, lr=0.05,
                             momentum=0.9, wire=wire, device="cpu")
    records = []

    def fed(rounds, **kw):
        strategy = FedADPStrategy(FAMILY, cfgs,
                                  [s.n_samples for s in backend.samplers])
        return Federation(strategy, backend, rounds=rounds, eval_batch=test,
                          eval_every=1, callbacks=[records.append], **kw)

    gen = torch.Generator().manual_seed(0)
    full = fed(6).run(gen)
    if wire == "int8":
        assert all(r["wire_bytes"] == backend.wire_stats()["bytes_per_round"]
                   for r in records)
    else:
        assert not any("wire_bytes" in r for r in records)

    ckdir = str(tmp_path / wire)
    backend.samplers = mk()                  # a fresh 6-round job
    fed(3, checkpoint_dir=ckdir, checkpoint_every=3).run(
        torch.Generator().manual_seed(0))    # "interrupted" after round 3
    ck = checkpoint_path(ckdir, 3)
    wp = wire_checkpoint_path(ck)
    assert wp.endswith("round_0003.wire.npz")
    assert os.path.exists(ck)
    assert os.path.exists(wp) == (wire == "int8")
    if wire == "int8":
        # nonzero residuals: dropping them on resume would not match
        assert float(backend.wire_residuals().abs().max()) > 0.0
        res, spec, extra = tck.load_plane(wp)
        assert extra == {"round": 3, "kind": "wire_residuals"}
        assert torch.equal(res, backend.wire_residuals())
        assert spec == backend.plane_spec

    backend.engine = None                    # the resumed process starts
    backend._engine_key = None               # cold
    backend.samplers = mk()
    resumed = fed(6).run(torch.Generator().manual_seed(1),
                         resume_from=ck)
    np.testing.assert_allclose(resumed["history"], full["history"],
                               atol=1e-6)
    assert len(resumed["history"]) == 6
    for a, b in zip(tu.leaves(full["global_params"]),
                    tu.leaves(resumed["global_params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)
