"""The client-axis mesh of the port's unified engine, on four gloo ranks
of the CPU, vs the port's flat run and the JAX package's.

One spawn (``repro_torch.launch.mesh.run_ranks``, the rank bodies in
``test_torch_mesh_ranks.py``; 60 s collective timeout, 240 s wall) runs
every scenario:

  * the rules: ``cohort_mesh`` (the largest rank count dividing K) and
    the row placement (``edge_groups``, ``local_rows``, the divisibility
    rule ``stacked_client_spec``) for K in {3, 4, 6, 20} over meshes of
    1-4 ranks agree with the JAX package's ``cohort_mesh``,
    ``CohortCtx.edge_groups`` and ``stacked_client_spec``;
  * two fedadp rounds of the reference's 4-client tiny VGG mesh cohort
    (``tests/test_streaming.py``) under coverage, filler zero and filler
    global, on the plane (the edge reduce) and stream layouts, and a
    width cohort under coverage (multiplicity): every rank's history and
    globals equal the other ranks', and are within 1e-4 of the port's
    flat (whole-plane) run and of the JAX package's from the same model
    and data (the reference's own mesh-vs-flat tolerance; its stream
    round equals its plane round to 1e-6, tests/test_streaming.py);
    ``agg_stats`` reports 4 edges;
  * six clients over four ranks take the flat round on every rank, and
    ``cohort_mesh(6)``'s three-rank mesh leaves rank 3 outside (None):
    it runs the round alone and ends with the same globals;
  * the per-client methods, the compressed wires and checkpoints, which
    a mesh refused before they were ported, build and run there: every
    rank ends with the same history, the wire's payload is the cohort's,
    and one checkpoint file (and its residual sibling) is written
    (``test_torch_mesh_methods.py`` holds them against the flat runs);
  * ``launch.mesh.make_host_mesh`` puts every rank on a (data, model) =
    (4, 1) mesh, and ``data_axes`` reads ("data",) of it.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import test_torch_mesh_ranks as R  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.core import VGGFamily as JFamily  # noqa: E402
from repro.fl import FLRunConfig as JRunConfig  # noqa: E402
from repro.fl import Simulator as JSimulator  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import VGGFamily as TFamily  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

WORLD = 4
TOL = 1e-4           # tests/test_streaming.py's mesh-vs-flat tolerance


class FakeMesh:
    """What the JAX package's rules read of a mesh: its axis sizes."""

    def __init__(self, n):
        self.shape = {"clients": n}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(R.mesh_rounds, WORLD,
                     (str(tmp_path_factory.mktemp("ck")),),
                     rdv_dir=str(tmp_path_factory.mktemp("rdv")),
                     timeout_s=60, wall_s=240, threads=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes are small, and the spawned ranks
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def flat(cohort, mode, filler):
    """The port's flat (single-process, whole-plane) run."""
    return R.vgg_round(None, cohort, mode, filler, "plane")


def _jcfg(c):
    return JVGGConfig(**{f.name: getattr(c, f.name)
                         for f in dataclasses.fields(c)})


@functools.lru_cache(maxsize=None)
def jax_round(cohort, mode, filler):
    """The JAX package's flat (whole-plane) run from the same model and
    data."""
    cfgs = [_jcfg(c) for c in R.COHORTS[cohort]]
    gcfg = JFamily().union(cfgs)
    shapes = TFamily().shapes(TFamily().union(list(R.COHORTS[cohort])))
    leaves = R.numpy_init(shapes)
    jshapes = jax.eval_shape(lambda: JFamily().init(jax.random.PRNGKey(0),
                                                    gcfg))
    gp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jshapes), leaves)

    class Fixed(JFamily):
        def init(self, key, c, **kw):
            return gp if c == gcfg else super().init(key, c, **kw)

    spec = dataclasses.replace(jdata.EASY, image_size=8, n_classes=4)
    K = len(cfgs)
    data = jdata.image_classification(spec, 16 * K, seed=0)
    test = jdata.image_classification(spec, 32, seed=9)
    parts = jdata.iid_partition(16 * K, K, seed=0)
    samplers = [jdata.ClientSampler(data, p, round_fraction=0.5,
                                    batch_size=8, seed=i)
                for i, p in enumerate(parts)]
    t = R.run_cfg(mode, filler, "plane")
    cfg = JRunConfig(**{f.name: getattr(t, f.name)
                        for f in dataclasses.fields(JRunConfig)
                        if hasattr(t, f.name) and f.name != "device"})
    out = JSimulator(Fixed(), cfgs, samplers, cfg, test).run()
    paths = [p for p, _ in tu.flatten(shapes)]
    return {"history": list(out["history"]),
            "globals": {"/".join(p): np.asarray(a) for p, a in zip(
                paths, jax.tree.leaves(out["global_params"]))}}


def _close(got, want, what):
    assert got["globals"].keys() == want["globals"].keys(), what
    for k, a in want["globals"].items():
        np.testing.assert_allclose(got["globals"][k], a, atol=TOL, rtol=0,
                                   err_msg=f"{what}: {k}")
    np.testing.assert_allclose(got["history"], want["history"], atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("K", R.K_RULES)
def test_cohort_mesh_and_placement_follow_the_reference(ranks, K,
                                                        monkeypatch):
    monkeypatch.setattr(jrules.jax, "devices",
                        lambda: list(range(WORLD)))
    monkeypatch.setattr(jrules, "Mesh",
                        lambda devs, axes: FakeMesh(len(devs)))
    jm = jrules.cohort_mesh(K)
    want = None if jm is None else list(range(jm.shape["clients"]))
    for r in ranks:
        # a rank past the mesh's ranks is outside it and gets None
        inside = want is not None and r["rank"] < len(want)
        assert r["cohort_mesh"][K] == (want if inside else None), \
            (r["rank"], K)
    for n in range(1, WORLD + 1):
        jc = jctx.CohortCtx(mesh=FakeMesh(n))
        groups = jc.edge_groups(range(K))
        splits = jrules.stacked_client_spec(FakeMesh(n), ("clients",),
                                            K) != JP()
        for r in ranks[:n]:
            got = r["placement"][(n, K)]
            assert got["extent"] == jc.edge_extent
            assert got["groups"] == groups
            assert bool(got["spec"]) == splits
            mine = groups[r["rank"]] if splits else None
            assert got["rows"] == (None if mine is None
                                   else (mine[0], mine[-1] + 1))


@pytest.mark.parametrize("variant", R.VARIANTS, ids="-".join)
def test_mesh_round_matches_flat_and_jax(ranks, variant):
    runs = [r["runs"][variant] for r in ranks]
    for r in runs[1:]:
        assert r["history"] == runs[0]["history"]
        for k, a in runs[0]["globals"].items():
            assert np.array_equal(r["globals"][k], a), k
    for r in runs:
        assert r["stats"]["edges"] == WORLD
        assert r["stats"]["layout"] == ("edge" if variant[3] == "plane"
                                        else "stream")
    want = flat(*variant[:3])
    assert want["stats"]["layout"] == "plane"
    _close(runs[0], want, "mesh vs the port's flat run")
    _close(runs[0], jax_round(*variant[:3]), "mesh vs the JAX package's run")


def test_rows_that_do_not_split_take_the_flat_round(ranks):
    want = R.vgg_round(None, *R.K6)
    for r in ranks:
        assert r["k6_mesh4"]["stats"]["layout"] == "plane"
        _close(r["k6_mesh4"], want, "6 rows over 4 ranks")
        # cohort_mesh(6): ranks 0-2 reduce over 3 edges, rank 3 is outside
        # the mesh and runs the flat round on its own
        got = r["k6_cohort"]
        inside = r["rank"] < 3
        assert got["mesh"] == ([0, 1, 2] if inside else None)
        assert got["stats"]["layout"] == ("edge" if inside else "plane")
        _close(got, want, f"cohort_mesh(6), rank {r['rank']}")


def test_host_mesh_holds_every_rank(ranks):
    for r in ranks:
        assert r["host_mesh"] == ((WORLD, 1), ("data", "model"), ("data",))


@pytest.mark.parametrize("what", ["clustered", "wire", "checkpoint"])
def test_once_refused_under_a_mesh_builds_and_runs(ranks, what):
    got = [r["once_refused"][what] for r in ranks]
    assert all(g == got[0] for g in got), got
    if what == "clustered":
        assert len(got[0]) == 1
    elif what == "wire":
        # four clients' int8 payloads: P values and a scale a 256-tile
        n = sum(int(np.prod(a.shape))
                for a in flat("depth4", "coverage", "zero")["globals"]
                .values())
        assert got[0][1] == 4 * (n + 4 * -(-n // 256))
    else:
        assert got[0] == ["round_0001.npz"]
