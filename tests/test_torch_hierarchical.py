"""Two-level hierarchical aggregation of the port
(``core.aggregation.plane_partials`` / ``finish_partials`` /
``fedavg_hierarchical``) vs the JAX package's, on the CPU.

On the reference's width+depth VGG coverage fixture (6 clients,
family-built loose masks and multiplicities, a fallback; the JAX
package's ``tests/test_streaming.py``), as numpy for both packages:

  * ``fedavg_hierarchical`` equals the JAX function and the port's flat
    ``fedavg_stacked`` within 1e-6 for every split of
    ``tests/test_streaming.py``: whole, even, uneven, reordered and
    singletons — with masks + mult + fallback, and unmasked;
  * partial triples of the edge groups summed and finished once equal
    the JAX package's ``plane_partials`` / ``finish_partials``;
  * groups that do not partition ``range(K)`` raise ``ValueError``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import plane as jplane  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.vgg_family import VGGConfig  # noqa: E402
from repro_torch.core import VGGFamily, coverage_mask, multiplicity  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.netchange import round_embed_seed  # noqa: E402
from repro_torch.core import plane as tplane  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

TOL = 1e-6
SPLITS = [
    [[0, 1, 2, 3, 4, 5]],                       # whole cohort
    [[0, 1], [2, 3], [4, 5]],                   # even edges
    [[0], [1, 2, 3, 4, 5]],                     # uneven
    [[5, 3, 1], [0, 2, 4]],                     # reordered rows
    [[0], [1], [2], [3], [4], [5]],             # one client per edge
]


def _tiny(name, stages):
    return VGGConfig(name=name, stages=stages, classifier=(16,),
                     n_classes=4, image_size=8)


@pytest.fixture(scope="module")
def fixture():
    """The reference's ``_coverage_fixture`` on its 6-client width
    cohort, as numpy trees: rows and the fallback drawn from a numpy
    seed, the masks (loose) and multiplicities built by the port's family
    at each client's round seed (equal to the JAX package's,
    tests/test_torch_aggregation.py)."""
    family = VGGFamily()
    base = [_tiny("w1", ((8,), (8,))), _tiny("w2", ((8,), (12, 8))),
            _tiny("w3", ((12, 8), (12, 8)))]
    cfgs = [base[k % 3] for k in range(6)]
    gcfg = family.union(cfgs)
    shapes = family.shapes(gcfg)
    rng = np.random.default_rng(11)
    draw = lambda lead: tu.tree_map(  # noqa: E731
        lambda s: rng.standard_normal(lead + tuple(s.shape)).astype(
            np.float32), shapes)
    masks, mults = [], []
    for k, c in enumerate(cfgs):
        s = round_embed_seed(0, 0, k)
        masks.append(coverage_mask(family, c, gcfg, policy="loose", seed=s,
                                   device="cpu"))
        mults.append(multiplicity(family, c, gcfg, seed=s, device="cpu"))
    as_np = lambda t: tu.tree_map(lambda a: a.numpy(), t)  # noqa: E731
    return {"stacked": draw((6,)), "fb": draw(()),
            "w": tagg.subset_weights([k + 1 for k in range(6)]),
            "masks": as_np(tagg.stack_trees(masks)),
            "mult": as_np(tagg.stack_trees(mults))}


def _close(jtree, ttree, what):
    jl = jax.tree.leaves(jtree)
    tl = [v for _, v in tu.flatten(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL,
                                   rtol=0, err_msg=what)


@pytest.mark.parametrize("masked", [True, False], ids=["coverage", "eq1"])
@pytest.mark.parametrize("groups", SPLITS, ids=lambda g: str(g))
def test_hierarchical_matches_jax_and_flat(fixture, groups, masked):
    f = fixture
    kw = (dict(masks=f["masks"], mult=f["mult"], fallback=f["fb"])
          if masked else {})
    tkw = {k: params_from_numpy(v) for k, v in kw.items()}
    want = jagg.fedavg_hierarchical(f["stacked"], f["w"], groups=groups,
                                    k_chunk=2, use_kernel=False, **kw)
    got = tagg.fedavg_hierarchical(params_from_numpy(f["stacked"]), f["w"],
                                   groups=groups, k_chunk=2, **tkw)
    _close(want, got, f"groups={groups}")
    flat = tagg.fedavg_stacked(params_from_numpy(f["stacked"]), f["w"],
                               layout="plane", **tkw)
    for a, b in zip(tu.leaves(flat), tu.leaves(got)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL, rtol=0)


def test_partials_sum_and_finish_like_jax(fixture):
    f = fixture
    spec, _ = jplane.PlaneSpec.from_stacked(f["stacked"])
    x = np.array(jplane.pack_stacked(f["stacked"], spec))
    m = np.array(jplane.pack_stacked(f["masks"], spec))
    mu = np.array(jplane.pack_stacked(f["mult"], spec))
    fb = np.array(jplane.pack(f["fb"], spec))
    jt = tt = None
    for g in SPLITS[1]:
        a = jagg.plane_partials(jnp.asarray(x[g]), jnp.asarray(f["w"][g]),
                                jnp.asarray(m[g]), jnp.asarray(mu[g]))
        b = tagg.plane_partials(torch.from_numpy(x[g]),
                                torch.from_numpy(f["w"][g]),
                                torch.from_numpy(m[g]),
                                torch.from_numpy(mu[g]))
        jt = a if jt is None else tuple(p + q for p, q in zip(jt, a))
        tt = b if tt is None else tuple(p + q for p, q in zip(tt, b))
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL,
                                   rtol=0)
    want = jagg.finish_partials(*jt, renorm=True, fallback=jnp.asarray(fb))
    got = tagg.finish_partials(*tt, renorm=True,
                               fallback=torch.from_numpy(fb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert tplane.PlaneSpec.from_tree(params_from_numpy(f["fb"])).size \
        == spec.size


@pytest.mark.parametrize("bad", [[[0, 1], [2]], [[0, 1], [1, 2, 3]],
                                 [[0, 1, 2, 3, 4, 5, 6]]])
def test_bad_groups_raise(fixture, bad):
    stacked = params_from_numpy(fixture["stacked"])
    with pytest.raises(ValueError, match="partition"):
        tagg.fedavg_hierarchical(stacked, fixture["w"], groups=bad)
