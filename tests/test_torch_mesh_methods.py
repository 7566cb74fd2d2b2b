"""What the client mesh and the model axis used to refuse, on two gloo
ranks of the CPU, vs the port's flat run and the JAX package's.

One spawn (``repro_torch.launch.mesh.run_ranks``, the rank body
``test_torch_mesh_methods_ranks.mesh_methods``; one thread a rank) runs:

  * clustered, flexifed and standalone, 2 rounds on the 4-client tiny VGG
    depth cohort and a width cohort (``test_torch_mesh_ranks``), at full
    participation and at 0.5 (seed 10: client 2 trains on rank 1, then on
    rank 0);
  * fedadp on the int8 wire at participation 0.5 (a residual row moves
    between the ranks), the bf16 wire, and the sparse int8 wire under
    coverage, 2 rounds each;
  * an int8 run at 0.5 that checkpoints every round, and a run resumed
    from its round-1 file, on the mesh;
  * on a (data=1, model=2) mesh: ``launch.train.run`` on reduced glm4
    writing a checkpoint, and one step's gradients under remat "dots",
    "full" and none.

Held: the ranks' end states (every client's row, or the globals, and the
residual plane) equal each other bit for bit, and are within 1e-4 of the
port's flat run and of the JAX package's from the same model and data
(``tests/test_streaming.py``'s mesh-vs-flat tolerance); the wire's
``bytes_per_round`` equals the flat count exactly; the resumed run equals
the uninterrupted one bit for bit, rank 0 alone wrote one file a round
(and its residual sibling), and the mesh's file resumes in one process;
the model-axis file has the one-process run's tree and shapes and
``tp_slice`` of it gives each rank its params bit for bit; "dots"
gradients equal "full"'s and are within 2e-5 of the plain ones.
"""
import dataclasses
import functools
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_torch_mesh_methods_ranks as R  # noqa: E402
import test_torch_mesh_ranks as MR  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.core import VGGFamily as JFamily  # noqa: E402
from repro.fl import FLRunConfig as JRunConfig  # noqa: E402
from repro.fl import Simulator as JSimulator  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.core import VGGFamily as TFamily  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding.rules import tp_slice_rank  # noqa: E402

WORLD = 2
TOL = 1e-4           # tests/test_streaming.py's mesh-vs-flat tolerance
GRAD_TOL = 2e-5      # tests/test_torch_remat.py's


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ck"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ckdir):
    """The ranks' results. The spawn runs in a thread while this process
    computes every flat reference (the port's and the JAX package's
    runs, cached for the tests), so the two overlap."""
    out = {}

    def spawn():
        try:
            out["ranks"] = run_ranks(
                R.mesh_methods, WORLD, (ckdir,),
                rdv_dir=str(tmp_path_factory.mktemp("rdv")), timeout_s=60,
                wall_s=240, threads=1)
        except BaseException as e:   # re-raised in the test process
            out["error"] = e
    t = threading.Thread(target=spawn)
    t.start()
    try:
        for v in R.PER_CLIENT:
            flat_pc(v)
            jax_run(*v)
        for v in R.WIRES:
            flat_wire(v)
            wire, part, sparse = v
            jax_run("depth4", "fedadp", part, wire=wire, sparse=sparse)
    finally:
        t.join()
    if "error" in out:
        raise out["error"]
    return out["ranks"]


def _jcfg(c):
    return JVGGConfig(**{f.name: getattr(c, f.name)
                         for f in dataclasses.fields(c)})


class JSeeded(JFamily):
    """The JAX family whose every init is the port's ``numpy_init`` of
    the config's shapes (``test_torch_mesh_ranks.SeededVGG``)."""

    def init(self, key, c, **kw):
        tc = MR.VGGConfig(**{f.name: getattr(c, f.name)
                             for f in dataclasses.fields(c)})
        leaves = MR.numpy_init(TFamily().shapes(tc))
        return jax.tree_util.tree_unflatten(_jtreedef(c), leaves)


@functools.lru_cache(maxsize=None)
def _jtreedef(c):
    """The JAX family's parameter tree structure for config ``c``."""
    return jax.tree_util.tree_structure(
        jax.eval_shape(lambda: JFamily().init(jax.random.PRNGKey(0), c)))


@functools.lru_cache(maxsize=None)
def jax_sim(cohort, method, wire, sparse):
    """One JAX ``Simulator`` a cohort, method and wire, and its samplers'
    maker: the participation levels' runs share its engine (the
    reference's ``Simulator`` keeps its backends across runs and reads
    ``cfg`` and ``samplers`` anew each run), so they compile once."""
    cfgs = [_jcfg(c) for c in MR.COHORTS[cohort]]
    spec = dataclasses.replace(jdata.EASY, image_size=8, n_classes=4)
    K = len(cfgs)
    data = jdata.image_classification(spec, 16 * K, seed=0)
    test = jdata.image_classification(spec, 32, seed=9)
    parts = jdata.iid_partition(16 * K, K, seed=0)

    def samplers():
        return [jdata.ClientSampler(data, p, round_fraction=0.5,
                                    batch_size=8, seed=i)
                for i, p in enumerate(parts)]
    t = R.run_cfg(method, 1.0, wire=wire, sparse=sparse)
    return JSimulator(JSeeded(), cfgs, samplers(), _jrun_cfg(t),
                      test), samplers


def _jrun_cfg(t):
    return JRunConfig(**{f.name: getattr(t, f.name)
                         for f in dataclasses.fields(JRunConfig)
                         if hasattr(t, f.name) and f.name != "device"})


def jax_run(cohort, method, part, *, wire="f32", sparse=False):
    """The JAX package's flat run of a scenario from the same model and
    data: history and end state (globals, or every client's row)."""
    sim, samplers = jax_sim(cohort, method, wire, sparse)
    sim.cfg = _jrun_cfg(R.run_cfg(method, part, wire=wire, sparse=sparse))
    sim.samplers = samplers()
    out = sim.run()

    def flat(tree):
        return {"/".join(str(k.key) for k in p): np.asarray(a)
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    if method == "fedadp":
        state = flat(out["global_params"])
    else:
        views = [flat(c) for c in out["client_params"]]
        state = {k: np.stack([v[k] for v in views]) for k in views[0]}
    return {"history": list(out["history"]), "state": state}


@functools.lru_cache(maxsize=None)
def flat_pc(v):
    return R.pc_run(None, *v)


@functools.lru_cache(maxsize=None)
def flat_wire(v):
    return R.wire_run(None, *v)


def _same(runs, what):
    for r in runs[1:]:
        assert r["history"] == runs[0]["history"], what
        for k, a in runs[0]["state"].items():
            assert np.array_equal(r["state"][k], a), (what, k)


def _close(got, want, what):
    assert got["state"].keys() == want["state"].keys(), what
    for k, a in want["state"].items():
        np.testing.assert_allclose(got["state"][k], a, atol=TOL, rtol=0,
                                   err_msg=f"{what}: {k}")
    np.testing.assert_allclose(got["history"], want["history"], atol=TOL,
                               err_msg=what)


def _id(v):
    return "-".join(map(str, v))


@pytest.mark.parametrize("v", R.PER_CLIENT, ids=_id)
def test_per_client_method_matches_flat_and_jax(ranks, v):
    runs = [r["per_client"][v] for r in ranks]
    _same(runs, v)
    for r in runs:
        # one stacked all_reduce of the averages (standalone: the gather)
        # a round, over the rounds whose rows split: every round here
        assert r["comm"]["all_reduces"] == R.ROUNDS, r["comm"]
    _close(runs[0], flat_pc(v), f"{v}: mesh vs the port's flat run")
    _close(runs[0], jax_run(*v), f"{v}: mesh vs the JAX package's run")


@pytest.mark.parametrize("v", R.WIRES, ids=_id)
def test_wire_matches_flat_and_jax(ranks, v):
    runs = [r["wires"][v] for r in ranks]
    _same(runs, v)
    for r in runs[1:]:
        assert np.array_equal(r["residuals"], runs[0]["residuals"])
    want = flat_wire(v)
    for r in runs:
        # the cohort's payload, summed over the ranks: the flat count
        assert r["wire_stats"] == want["wire_stats"]
        # residual rows move only when a participant changes rank
        assert (r["comm"]["moved_rows"] > 0) == (v[1] < 1.0), r["comm"]
    _close(runs[0], want, f"{v}: mesh vs the port's flat run")
    np.testing.assert_allclose(runs[0]["residuals"], want["residuals"],
                               atol=TOL, rtol=0)
    wire, part, sparse = v
    _close(runs[0], jax_run("depth4", "fedadp", part, wire=wire,
                            sparse=sparse),
           f"{v}: mesh vs the JAX package's run")


def test_mesh_checkpoint_resumes_bit_equal(ranks, ckdir):
    files = ["round_0001.npz", "round_0001.wire.npz", "round_0002.npz",
             "round_0002.wire.npz"]
    assert sorted(os.listdir(os.path.join(ckdir, "client_mesh"))) == files
    for r in ranks:
        c = r["ckpt"]
        # no rank saw a temporary or second file (rank 0 alone writes,
        # every rank reads after the barrier)
        assert c["files"] == files
        _same([c["full"], c["resumed"]], "resumed vs uninterrupted")
    _same([r["ckpt"]["full"] for r in ranks], "ranks")


def test_mesh_checkpoint_resumes_in_one_process(ranks, ckdir):
    out = R.ckpt_federation(None, R.ROUNDS).run(
        torch.Generator().manual_seed(0),
        resume_from=os.path.join(ckdir, "client_mesh", "round_0001.npz"))
    got = {"history": [float(a) for a in out["history"]],
           "state": R._state(out, "fedadp")}
    _close(got, ranks[0]["ckpt"]["full"], "one process from the mesh's file")


def test_model_axis_checkpoint_reslices_bit_equal(ranks, ckdir, tmp_path):
    from repro_torch.launch import train
    one = train.run(**R.TP_TRAIN, ckpt=str(tmp_path / "one.npz"))
    cfg = one["cfg"]
    tree, extra = load_pytree(os.path.join(ckdir, "tp.npz"))
    ref, _ = load_pytree(str(tmp_path / "one.npz"))
    assert extra["arch"] == cfg.name
    meta = T.init_params(None, cfg, device="meta")
    assert [(p, tuple(t.shape)) for p, t in tu.flatten(tree)] == \
        [(p, tuple(t.shape)) for p, t in tu.flatten(ref)] == \
        [(p, tuple(t.shape)) for p, t in tu.flatten(meta)]
    for r in ranks:
        tp = r["tp"]
        assert tp["losses"] == pytest.approx(one["losses"], abs=GRAD_TOL)
        mine = tp_slice_rank(tree, cfg, WORLD, tp["model_rank"])
        for p, t in tu.flatten(mine):
            assert np.array_equal(t.numpy(), tp["params"]["/".join(p)]), p
    for (p, a), (_, b) in zip(tu.flatten(tree), tu.flatten(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg="/".join(p))


def test_remat_dots_under_a_model_axis(ranks):
    for r in ranks:
        g = r["tp"]["grads"]
        assert g["dots"][0] == g["full"][0]
        assert abs(g["dots"][0] - g["plain"][0]) <= GRAD_TOL * abs(
            g["plain"][0])
        for k, a in g["plain"][1].items():
            assert np.array_equal(g["dots"][1][k], g["full"][1][k]), k
            scale = max(float(np.abs(a).max()), 1e-30)
            np.testing.assert_allclose(g["dots"][1][k], a,
                                       atol=GRAD_TOL * scale, rtol=0,
                                       err_msg=k)


def test_run_from_an_explicit_init_state():
    """``Federation.run(init_state=)`` starts from the given state: the
    backend's own init of the same generator gives the drawn run."""
    drawn = R.ckpt_federation(None, 1).run(torch.Generator().manual_seed(0))
    fed = R.ckpt_federation(None, 1)
    given = fed.run(init_state=fed.backend.init_state(
        torch.Generator().manual_seed(0)))
    _same([{"history": [float(a) for a in r["history"]],
            "state": R._state(r, "fedadp")} for r in (drawn, given)],
          "init_state vs the drawn init")
