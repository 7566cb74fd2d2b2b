"""The port's MoE FFN (``repro_torch.models.moe``) vs the JAX package's
(``repro.models.moe``), on the CPU.

  * ``moe_apply`` value at 1e-5 and its gradients (parameters and input)
    at 2e-5 on the reduced mixtral at ``tests/test_moe.py``'s (top_k,
    n_experts) cases: the same sums in another order (the port adds a
    token's top_k contributions over an axis, the reference scatters
    them);
  * capacity drops (capacity_factor 0.01): the same tokens dropped, the
    outputs equal at 1e-5;
  * shared experts, on the reduced deepseek-v2;
  * ties: a router with duplicated columns (what NetChange's expert
    duplication makes) gives ``jax.lax.top_k``'s ids element for
    element, also on a client widened from 2 to 4 experts;
  * ``torch.func.vmap`` over 3 clients equals 3 separate calls (value
    and gradient), and two calls are bit-equal.

Parameters are JAX-initialised and carried across through ``interop``;
inputs come from numpy seeds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro.models import moe as jM  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import tfamily as ttf  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.sharding.ctx import ShardCtx  # noqa: E402

VAL_TOL = 1e-5
GRAD_TOL = 2e-5
KEY = jax.random.PRNGKey(0)  # fedlint: ignore[FDL003] CPU-only parity test


def to_torch_cfg(c) -> ModelConfig:
    """The port's twin of a JAX ``ModelConfig``, sub-configs (``moe``,
    ``mla``, ...) included."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return ModelConfig(**{f.name: conv(getattr(c, f.name))
                          for f in dataclasses.fields(ModelConfig)})


def _cfg(capacity=8.0, top_k=2, n_experts=4, arch="mixtral-8x7b"):
    cfg = jreduced(jget_config(arch), d_model=64)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity))


def _params(cfg, seed=0):
    p = jM.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed + 50)
    p = jax.tree.map(np.asarray, p)
    # a nonzero router bias, so the bias path is exercised
    p["router_b"] = (0.3 * rng.standard_normal(p["router_b"].shape)
                     ).astype(np.float32)
    return p


def _x(cfg, B=2, S=9, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _close_trees(jtree, ttree, tol):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(np.asarray(b.detach()), np.asarray(a),
                                   atol=tol, rtol=tol,
                                   err_msg="/".join(path))


def _value_and_grads(jcfg, p, x, ct):
    """(value, grads wrt params, grad wrt x) in both packages, for the
    loss sum(moe_apply(p, x) * ct)."""
    tcfg = to_torch_cfg(jcfg)

    def jloss(p, x):
        return (jM.moe_apply(p, jcfg, x) * ct).sum()
    jval = jM.moe_apply(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = tu.tree_map(lambda t: t.requires_grad_(), params_from_numpy(p))
    tx = torch.from_numpy(x).requires_grad_()
    tval = tM.moe_apply(tp, tcfg, tx)
    (tval * torch.from_numpy(ct)).sum().backward()
    return (np.asarray(jval), jgp, np.asarray(jgx)), \
        (tval.detach().numpy(), tu.tree_map(lambda t: t.grad, tp),
         tx.grad.numpy())


@pytest.mark.parametrize("top_k,n_experts", [(1, 4), (2, 4), (3, 3)])
def test_moe_apply_matches_jax(top_k, n_experts):
    jcfg = _cfg(top_k=top_k, n_experts=n_experts)
    p, x = _params(jcfg), _x(jcfg)
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    (jv, jgp, jgx), (tv, tgp, tgx) = _value_and_grads(jcfg, p, x, ct)
    np.testing.assert_allclose(tv, jv, atol=VAL_TOL, rtol=VAL_TOL)
    np.testing.assert_allclose(tgx, jgx, atol=GRAD_TOL, rtol=GRAD_TOL)
    _close_trees(jgp, tgp, GRAD_TOL)


def test_capacity_drops_the_same_tokens():
    jcfg = _cfg(capacity=0.01)
    p, x = _params(jcfg), _x(jcfg, B=1, S=16)
    tcfg = to_torch_cfg(jcfg)
    assert tM._capacity(16, 2, 4, 0.01) == jM._capacity(16, 2, 4, 0.01) == 1
    jv = np.asarray(jM.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                                 jnp.asarray(x)))
    tv = tM.moe_apply(params_from_numpy(p), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tv.numpy(), jv, atol=VAL_TOL, rtol=VAL_TOL)
    # one slot an expert: at most 4 of the 16 tokens keep any expert
    kept = (np.abs(jv).max(-1) > 0).sum()
    assert 1 <= kept <= 4
    assert np.array_equal(np.abs(tv.numpy()).max(-1) > 0,
                          np.abs(jv).max(-1) > 0)


def test_shared_experts_match_jax():
    jcfg = _cfg(arch="deepseek-v2-236b", top_k=2, n_experts=4)
    assert jcfg.moe.n_shared == 1
    p, x = _params(jcfg), _x(jcfg, S=7)
    assert "shared" in p
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    (jv, jgp, jgx), (tv, tgp, tgx) = _value_and_grads(jcfg, p, x, ct)
    np.testing.assert_allclose(tv, jv, atol=VAL_TOL, rtol=VAL_TOL)
    np.testing.assert_allclose(tgx, jgx, atol=GRAD_TOL, rtol=GRAD_TOL)
    _close_trees(jgp, tgp, GRAD_TOL)


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.default_rng(4)
    probs = rng.random((1000, 6)).astype(np.float32)
    probs[:, 2] = probs[:, 4] = probs[:, 5] = probs.max(-1) + 0.1
    probs[0] = [0.1, 0.3, 0.3, 0.3, 0.0, 0.0]
    for k in (1, 2, 3):
        jw, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tw, ti = tM.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tM.top_k(torch.from_numpy(probs[:1]), 2)[1].tolist() == [[1, 2]]


def test_route_ties_on_a_widened_client():
    """A client of 2 experts widened to 4 (duplicated experts, equal
    router columns and biases): the union's routing of every token
    matches the reference's, ids and weights."""
    base = _cfg(top_k=2, n_experts=4)
    var = jtf.make_variant(base, n_experts=2)
    uni = jtf.union([var, base])
    from repro.models import transformer as jT
    pj = jax.tree.map(np.asarray, jT.init_params(jax.random.PRNGKey(5), var))
    gj = jtf.up(jax.tree.map(np.array, pj), var, uni, seed=1)
    gt = ttf.up(params_from_numpy(pj), to_torch_cfg(var), to_torch_cfg(uni),
                seed=1)
    moe_j = jax.tree.map(lambda a: np.asarray(a)[0], gj["units"]["b0"]["moe"])
    moe_t = tu.tree_map(lambda t: t[0], gt["units"]["b0"]["moe"])
    router = moe_j["router"]
    # the widened router duplicates its two columns: exact ties
    assert {tuple(router[:, j]) for j in range(4)} == \
        {tuple(router[:, j]) for j in range(2)}
    x = _x(base, B=1, S=64, seed=6).reshape(64, -1)
    jw, ji, _ = jM._route(jnp.asarray(router), jnp.asarray(x), 2,
                          jnp.asarray(moe_j["router_b"]))
    tw, ti, _ = tM._route(moe_t["router"], torch.from_numpy(x), 2,
                          moe_t["router_b"])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=VAL_TOL)


def test_vmap_over_clients_equals_separate_calls():
    jcfg = _cfg(top_k=2, n_experts=4)
    tcfg = to_torch_cfg(jcfg)
    ps = [params_from_numpy(_params(jcfg, seed=s)) for s in range(3)]
    xs = torch.stack([torch.from_numpy(_x(jcfg, seed=10 + s))
                      for s in range(3)])
    stacked = tu.tree_map(lambda *t: torch.stack(t), *ps)

    def f(p, x):
        return tM.moe_apply(p, tcfg, x)

    def loss(p, x):
        return (f(p, x) ** 2).sum()
    got = torch.func.vmap(f)(stacked, xs)
    ggot = torch.func.vmap(torch.func.grad(loss))(stacked, xs)
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(), f(ps[c], xs[c]).numpy(),
                                   atol=1e-6, rtol=1e-6)
        want = torch.func.grad(loss)(ps[c], xs[c])
        for (path, a), (_, b) in zip(tu.flatten(ggot), tu.flatten(want)):
            np.testing.assert_allclose(a[c].numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg="/".join(path))


def test_two_calls_are_bit_equal_and_mesh_raises():
    """Two calls are bit-equal, and ``moe_all_to_all`` (a knob that
    changes no computation in the reference) gives the same output."""
    jcfg = _cfg(top_k=2, n_experts=4)
    tcfg = to_torch_cfg(jcfg)
    p, x = params_from_numpy(_params(jcfg)), torch.from_numpy(_x(jcfg))
    assert torch.equal(tM.moe_apply(p, tcfg, x), tM.moe_apply(p, tcfg, x))
    assert torch.equal(tM.moe_apply(p, tcfg, x),
                       tM.moe_apply(p, tcfg, x, ShardCtx(moe_all_to_all=True)))
