"""The port's multi-head latent attention (``repro_torch.models.attention``
``mla_*``) vs the JAX package's, on the CPU, on the reduced deepseek-v2
(qk head dim 24, v head dim 16, KV = H = 4).

  * ``mla_apply_seq`` output at 2e-5, with and without ``return_cache``
    (the latent ``{"ckv", "krope"}`` cache at 2e-5), and its gradients;
  * ``mla_apply_decode`` after a prefill, plain and absorbed
    (``ShardCtx.mla_absorb``), output and cache at 2e-5 against JAX's
    same form, and the two forms against each other;
  * ``init_mla_cache`` shapes.

f32 throughout: the same products summed in another order. Parameters
are JAX-initialised (norm scales drawn nonzero) and carried across
through ``interop``; inputs come from numpy seeds.
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
from repro.models import attention as jA  # noqa: E402
from repro.sharding.ctx import ShardCtx as JCtx  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.sharding.ctx import ShardCtx as TCtx  # noqa: E402

TOL = 2e-5
JCFG = jreduced(jget_config("deepseek-v2-236b"))


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


TCFG = to_torch_cfg(JCFG)


def _params(seed=0):
    p = jax.tree.map(np.asarray, jA.mla_init(jax.random.PRNGKey(seed), JCFG,
                                             jnp.float32))
    rng = np.random.default_rng(seed + 7)
    for k in ("qln", "kvln"):
        p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def _x(B=2, S=11, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, JCFG.d_model)).astype(np.float32)


def _close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a), np.asarray(b), atol=TOL,
                               rtol=TOL, err_msg=what)


def test_config_dims():
    m = TCFG.mla
    assert m.qk_nope_dim + m.qk_rope_dim == 24 and m.v_head_dim == 16
    assert TCFG.n_heads == TCFG.n_kv_heads
    full = to_torch_cfg(jget_config("deepseek-v2-236b")).mla
    assert full.qk_nope_dim + full.qk_rope_dim == 192


@pytest.mark.parametrize("return_cache", [False, True])
def test_mla_apply_seq_matches_jax(return_cache):
    p, x = _params(), _x()
    S = x.shape[1]
    pos = np.arange(S, dtype=np.int32)
    jy, jc = jA.mla_apply_seq(jax.tree.map(jnp.asarray, p), JCFG,
                              jnp.asarray(x), jnp.asarray(pos),
                              return_cache=return_cache, cache_len=S + 3)
    ty, tc = tA.mla_apply_seq(params_from_numpy(p), TCFG, torch.from_numpy(x),
                              torch.from_numpy(pos).long(),
                              return_cache=return_cache, cache_len=S + 3)
    _close(ty, jy, "y")
    assert (tc is None) == (jc is None) == (not return_cache)
    if return_cache:
        assert sorted(tc) == sorted(jc) == ["ckv", "krope"]
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape
            _close(tc[k], jc[k], k)


def test_mla_apply_seq_grads_match_jax():
    p, x = _params(seed=3), _x(S=9, seed=4)
    pos = np.arange(x.shape[1], dtype=np.int32)
    ct = np.random.default_rng(5).standard_normal(
        (2, 9, JCFG.d_model)).astype(np.float32)

    def jloss(p, x):
        return (jA.mla_apply_seq(p, JCFG, x, jnp.asarray(pos))[0] * ct).sum()
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                               jnp.asarray(x))
    tp = tu.tree_map(lambda t: t.requires_grad_(), params_from_numpy(p))
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = tA.mla_apply_seq(tp, TCFG, tx, torch.from_numpy(pos).long())
    (ty * torch.from_numpy(ct)).sum().backward()
    _close(tx.grad, jgx, "dx")
    for k in jgp:
        _close(tp[k].grad, jgp[k], k)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_apply_decode_matches_jax(absorb):
    p = _params(seed=2)
    prompt, gen, B = 8, 3, 2
    x = _x(B=B, S=prompt + gen, seed=8)
    L = prompt + gen
    pos = np.arange(prompt, dtype=np.int32)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p)
    _, jc = jA.mla_apply_seq(jp, JCFG, jnp.asarray(x[:, :prompt]),
                             jnp.asarray(pos), return_cache=True,
                             cache_len=L)
    with torch.no_grad():
        _, tc = tA.mla_apply_seq(tp, TCFG, torch.from_numpy(x[:, :prompt]),
                                 torch.from_numpy(pos).long(),
                                 return_cache=True, cache_len=L)
    jctx, tctx = JCtx(mla_absorb=absorb), TCtx(mla_absorb=absorb)
    for i in range(gen):
        t = prompt + i
        xi = x[:, t:t + 1]
        jy, jc = jA.mla_apply_decode(jp, JCFG, jnp.asarray(xi), t, jc,
                                     ctx=jctx)
        with torch.no_grad():
            ty, tc = tA.mla_apply_decode(tp, TCFG, torch.from_numpy(xi), t,
                                         tc, ctx=tctx)
        _close(ty, jy, f"decode {i}")
        for k in jc:
            _close(tc[k], jc[k], f"{k} after step {i}")
    # the other form gives the same output on the same cache
    with torch.no_grad():
        ty2, _ = tA.mla_apply_decode(
            tp, TCFG, torch.from_numpy(x[:, -1:]), L - 1,
            {k: v.clone() for k, v in tc.items()},
            ctx=TCtx(mla_absorb=not absorb))
    _close(ty2, jy, "the other form")


def test_init_mla_cache_shapes():
    c = tA.init_mla_cache(TCFG, 3, 17)
    jc = jA.init_mla_cache(JCFG, 3, 17, jnp.float32)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: v.shape for k, v in jc.items()} == \
        {"ckv": (3, 17, 32), "krope": (3, 17, 8)}
    assert all(v.dtype == torch.float32 and not v.any() for v in c.values())
