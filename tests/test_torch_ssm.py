"""The recurrent blocks of ``repro_torch.models.ssm`` (RG-LRU, mLSTM,
sLSTM) and ``models.layers.causal_conv1d`` against the JAX package's, on
the CPU, module by module:

  * ``causal_conv1d`` with and without a carried state, its new state
    the last W-1 inputs;
  * each block's full-sequence path from a zero state and from a
    carried one, its decode step, and a prefill's state fed to a few
    decode steps (outputs and states at 2e-5: the same f32 products;
    the RG-LRU's doubling scan adds in another order than
    ``associative_scan``);
  * ``linear_scan`` against the sequential recurrence at lengths that
    are and are not powers of two;
  * ``_gn`` (the population variance, as ``jnp.var``);
  * the gradients of each block through ``torch.func.vmap(grad)`` over a
    stack of two parameter sets against ``jax.vmap(jax.grad)`` (2e-5 x
    the leaf's largest magnitude where that passes 1: the cotangent is
    a unit normal, so the gradients reach ~10), finite from the -1e30
    stabiliser start.

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
from repro.models import layers as jL  # noqa: E402
from repro.models import ssm as jS  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tS  # noqa: E402

TOL = 2e-5          # ROADMAP.md: f32 outputs, states and gradients
B, S = 2, 11

# rglru reads d_rnn and the conv width; mlstm / slstm the ssm heads
RG = jreduced(jget_config("recurrentgemma-9b"), d_model=32)
XL = dataclasses.replace(jreduced(jget_config("xlstm-125m"), d_model=32),
                         ssm=dataclasses.replace(
                             jget_config("xlstm-125m").ssm, n_heads=2))

BLOCKS = {
    "rglru": (RG, jS.rglru_init,
              lambda p, c, x, st, rs: jS.rglru_seq(p, x, st, return_state=rs),
              lambda p, c, x, st, rs: tS.rglru_seq(p, x, st, return_state=rs),
              lambda p, c, x, st: jS.rglru_decode(p, x, st),
              lambda p, c, x, st: tS.rglru_decode(p, x, st),
              jS.init_rglru_state),
    "mlstm": (XL, jS.mlstm_init,
              lambda p, c, x, st, rs: jS.mlstm_seq(p, c, x, st,
                                                   return_state=rs),
              lambda p, c, x, st, rs: tS.mlstm_seq(p, c, x, st,
                                                   return_state=rs),
              jS.mlstm_decode, tS.mlstm_decode, jS.init_mlstm_state),
    "slstm": (XL, jS.slstm_init,
              lambda p, c, x, st, rs: jS.slstm_seq(p, c, x, st,
                                                   return_state=rs),
              lambda p, c, x, st, rs: tS.slstm_seq(p, c, x, st,
                                                   return_state=rs),
              jS.slstm_decode, tS.slstm_decode, jS.init_slstm_state),
}


def _to_torch_cfg(c):
    """The port's twin of a JAX ``ModelConfig`` (its ``ssm`` included)."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return tbase.ModelConfig(**{f.name: conv(getattr(c, f.name))
                                for f in dataclasses.fields(tbase.ModelConfig)})


def _params(kind, seed=0):
    cfg, init = BLOCKS[kind][:2]
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg,
                                      jnp.float32))
    # nonzero biases and norm scales, so each one carries a real value
    rng = np.random.default_rng(seed + 50)
    return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            if k in ("ba", "bx", "bi", "gn", "bz", "bo") else np.array(v)
            for k, v in p.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(a, b, tol=TOL, what=""):
    ja = jax.tree.leaves(a)
    tb = tu.leaves(b) if isinstance(b, dict) else jax.tree.leaves(b)
    assert len(ja) == len(tb), what
    for x, y in zip(ja, tb):
        y = y.detach().numpy() if isinstance(y, torch.Tensor) else y
        np.testing.assert_allclose(y, np.asarray(x), atol=tol, rtol=tol,
                                   err_msg=what)


def _tstate(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


# ------------------------------------------------------------- the conv
@pytest.mark.parametrize("W", [1, 4])
def test_causal_conv1d_matches_jax(W):
    x = _x((B, S, 6), 0)
    k = _x((W, 6), 1)
    st = _x((B, W - 1, 6), 2)
    for state in (None, st):
        jo, js = jL.causal_conv1d(jnp.asarray(x), jnp.asarray(k),
                                  None if state is None
                                  else jnp.asarray(state))
        to, ts = tL.causal_conv1d(torch.from_numpy(x), torch.from_numpy(k),
                                  None if state is None
                                  else torch.from_numpy(state))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if W > 1:   # the new state is the last W-1 inputs
        np.testing.assert_array_equal(ts.numpy(), x[:, -(W - 1):])


# ------------------------------------------------------------ the scan
@pytest.mark.parametrize("length", [1, 2, 7, 8, 33])
def test_linear_scan_is_the_recurrence(length):
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.0, (2, length, 3)).astype(np.float64)
    b = rng.standard_normal((2, length, 3))
    want = np.zeros_like(b)
    h = np.zeros((2, 3))
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = tS.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=1e-12)


def test_gn_is_the_population_variance():
    h = _x((B, S, 2, 8), 3)
    scale = _x((16,), 4)
    np.testing.assert_allclose(
        tS._gn(torch.from_numpy(h), torch.from_numpy(scale)).numpy(),
        np.asarray(jS._gn(jnp.asarray(h), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- the blocks
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_seq_and_decode_match_jax(kind):
    """Full sequence from a zero state and from a carried one; then the
    prefill's state through 3 decode steps."""
    cfg, _, jseq, tseq, jdec, tdec, _ = BLOCKS[kind]
    tcfg = _to_torch_cfg(cfg)
    p = _params(kind)
    tp = params_from_numpy(p)
    x = _x((B, S, cfg.d_model), 5)
    jseq = jax.jit(jseq, static_argnums=(1, 4))
    jdec = jax.jit(jdec, static_argnums=(1,))
    jy, jst = jseq(p, cfg, jnp.asarray(x), None, True)
    ty, tst = tseq(tp, tcfg, torch.from_numpy(x), None, True)
    _close(jy, ty, what=f"{kind} seq")
    assert sorted(jst) == sorted(tst)
    _close({k: jst[k] for k in sorted(jst)},
           {k: tst[k] for k in sorted(tst)}, what=f"{kind} state")
    # a second chunk from the carried state
    x2 = _x((B, 5, cfg.d_model), 6)
    jy2, jst2 = jseq(p, cfg, jnp.asarray(x2), jst, True)
    ty2, tst2 = tseq(tp, tcfg, torch.from_numpy(x2), _tstate(jst), True)
    _close(jy2, ty2, what=f"{kind} seq from a state")
    _close({k: jst2[k] for k in sorted(jst2)},
           {k: tst2[k] for k in sorted(tst2)}, what=f"{kind} state 2")
    # decode steps from the prefill's state, each port step fed its own
    jcur, tcur = jst, tst
    for i in range(3):
        xt = _x((B, 1, cfg.d_model), 10 + i)
        jy, jcur = jdec(p, cfg, jnp.asarray(xt), jcur)
        ty, tcur = tdec(tp, tcfg, torch.from_numpy(xt), tcur)
        _close(jy, ty, what=f"{kind} decode {i}")
        _close({k: jcur[k] for k in sorted(jcur)},
               {k: tcur[k] for k in sorted(tcur)},
               what=f"{kind} decode state {i}")


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_init_state_matches_jax(kind):
    cfg, *_, jinit = BLOCKS[kind]
    tinit = getattr(tS, jinit.__name__)
    js = jinit(cfg, 3, jnp.float32)
    ts = tinit(_to_torch_cfg(cfg), 3, torch.float32)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
        assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype)
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_vmapped_grads_match_jax(kind):
    """``vmap(grad)`` over two stacked parameter sets and two inputs, as
    the unified engine differentiates a cohort."""
    cfg, _, jseq, tseq, *_ = BLOCKS[kind]
    tcfg = _to_torch_cfg(cfg)
    ps = [_params(kind, seed=s) for s in (0, 1)]
    stacked = {k: np.stack([p[k] for p in ps]) for k in ps[0]}
    xs = _x((2, B, 7, cfg.d_model), 7)
    cot = _x((2, B, 7, cfg.d_model), 8)

    def jloss(p, x, c):
        return jnp.sum(jseq(p, cfg, x, None, False)[0] * c)

    def tloss(p, x, c):
        return (tseq(p, tcfg, x, None, False)[0] * c).sum()

    jg = jax.jit(jax.vmap(jax.grad(jloss)))(stacked, jnp.asarray(xs),
                                            jnp.asarray(cot))
    tg = torch.func.vmap(torch.func.grad(tloss))(
        params_from_numpy(stacked), torch.from_numpy(xs),
        torch.from_numpy(cot))
    assert sorted(jg) == sorted(tg)
    for k in sorted(jg):
        assert bool(torch.isfinite(tg[k]).all()), k
        # an f32 gradient's rounding scales with the leaf's magnitude
        scale = max(1.0, float(np.abs(np.asarray(jg[k])).max()))
        _close(jg[k], tg[k], tol=TOL * scale, what=f"{kind} grad {k}")
