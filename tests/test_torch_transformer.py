"""The port's transformer path vs the JAX package's, on the CPU, on the
reduced glm4-9b config (``reduced(get_config("glm4-9b"), n_units=2,
d_model=64)``: GQA 4q/2kv, RoPE, QKV bias, SwiGLU, untied head).

Parameters are initialised by the JAX package, given random norm scales
and QKV biases (so both enter the comparison), and carried across through
``interop``; tokens come from a numpy seed. ``forward`` logits and the
``lm_loss`` value and gradients agree to 2e-5 (f32, the same matmuls
summed in another order), under each attention backend — blockwise, and
flash (on the CPU: the plain versions through the port's autograd
Functions, the jnp reference in JAX).
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
from repro.core import TransformerFamily as JFamily  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.sharding.ctx import ShardCtx as JCtx  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, reduced  # noqa: E402
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.sharding.ctx import ShardCtx as TCtx  # noqa: E402

TOL = 2e-5
JCFG = jreduced(jget_config("glm4-9b"), n_units=2, d_model=64)


def to_torch_cfg(c) -> ModelConfig:
    """The port's twin of a JAX ``ModelConfig`` (dense configs)."""
    return ModelConfig(**{f.name: getattr(c, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def jax_params(cfg, seed=0):
    """JAX-initialised params as numpy, with norm scales and biases drawn
    nonzero so they matter."""
    p = jax.tree.map(np.asarray, jT.init_params(jax.random.PRNGKey(seed),
                                                cfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("ln1", "ln2", "final_ln", "bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(perturb, p)


def _batch(cfg, B=2, S=24, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close_trees(jtree, ttree, tol=TOL):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(np.asarray(b.detach()), np.asarray(a),
                                   atol=tol, rtol=tol,
                                   err_msg="/".join(path))


def test_config_copy_and_shapes_match():
    tcfg = reduced(get_config("glm4-9b"), n_units=2, d_model=64)
    assert tcfg == to_torch_cfg(JCFG)
    assert get_config("glm4-9b") == to_torch_cfg(jget_config("glm4-9b"))
    jshapes = jax.eval_shape(lambda k: jT.init_params(k, JCFG),
                             jax.random.PRNGKey(0))
    tshapes = tT.init_params(None, tcfg, device="meta")
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tflat = tu.flatten(tshapes)
    assert [(tuple(str(k.key) for k in p), tuple(s.shape))
            for p, s in jflat] == [(p, tuple(t.shape)) for p, t in tflat]
    # the port's own init matches in distribution (std of the big leaves)
    tp = tT.init_params(torch.Generator().manual_seed(0), tcfg)
    jp = jT.init_params(jax.random.PRNGKey(0), JCFG)
    for path in (("embed",), ("units", "b0", "mlp", "wg"),
                 ("units", "b0", "attn", "wq")):
        a = float(np.asarray(tu.get(jp, path)).std())
        b = float(tu.get(tp, path).std())
        assert abs(a - b) < 0.1 * a, (path, a, b)


def test_interop_round_trip():
    p = jax_params(JCFG)
    back = params_to_numpy(params_from_numpy(p))
    jflat = jax.tree_util.tree_flatten_with_path(p)[0]
    assert len(jflat) == len(tu.flatten(back))
    for (path, a), (_, b) in zip(jflat, tu.flatten(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize("backend", ["blockwise", "flash"])
def test_forward_logits_match_jax(backend):
    p = jax_params(JCFG)
    batch = _batch(JCFG)
    jl = jT.forward(p, JCFG, batch["tokens"],
                    ctx=JCtx(attn_backend=backend, block_q=8, block_kv=8))
    tl = tT.forward(params_from_numpy(p), to_torch_cfg(JCFG),
                    torch.from_numpy(batch["tokens"]),
                    ctx=TCtx(attn_backend=backend, block_q=8, block_kv=8))
    assert tl.dtype == torch.float32 and tl.shape == (2, 24, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("backend", ["auto", "flash"])
def test_lm_loss_grads_match_jax(backend):
    p = jax_params(JCFG, seed=2)
    batch = _batch(JCFG, seed=3)
    jfam, tfam = JFamily(), TFamily()
    tcfg = to_torch_cfg(JCFG)
    jctx = None if backend == "auto" else JCtx(attn_backend=backend)
    tctx = None if backend == "auto" else TCtx(attn_backend=backend)
    jgf = (jfam.loss_and_grad(JCFG) if jctx is None
           else jfam.loss_and_grad(JCFG, ctx=jctx))
    (jloss, _), jg = jgf(jax.tree.map(jnp.asarray, p),
                         jax.tree.map(jnp.asarray, batch))
    (tloss, _), tg = tfam.loss_and_grad(tcfg, ctx=tctx)(
        params_from_numpy(p), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL,
                               rtol=TOL)
    _close_trees(jg, tg)
    # the family's eval loss is the same loss without gradients
    assert abs(tfam.evaluate(params_from_numpy(p), tcfg, batch)
               - float(jloss)) <= TOL


def test_chunked_xent_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 13, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 13)).astype(np.int32)
    for chunk in (0, 4):
        jl, ja = jsteps.chunked_softmax_xent(h, w, labels, chunk=chunk)
        tl, ta = tsteps.chunked_softmax_xent(
            torch.from_numpy(h), torch.from_numpy(w),
            torch.from_numpy(labels), chunk=chunk)
        np.testing.assert_allclose(float(tl), float(jl), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))
