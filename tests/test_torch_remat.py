"""Layer rematerialisation of the port (``ShardCtx(remat=True)``,
``models/transformer.py``'s ``_Remat``) vs the plain traversal and vs the
JAX package's ``jax.checkpoint``, on the CPU.

On reduced dense (glm4-9b), MoE (mixtral-8x7b), recurrent
(recurrentgemma-9b: RG-LRU; xlstm-125m: mLSTM / sLSTM) and "crossdec"
(whisper-small, its encoder output an input of every unit) configs:

  * the ``lm_loss`` gradients under remat "full" equal the plain ones
    within 2e-5, under ``torch.func.grad`` and under ``vmap(grad)`` over
    two parameter sets, and equal the JAX package's remat gradients
    (``jax.checkpoint`` over its scan body) within the parity tolerance
    2e-5 from the same numpy-drawn parameters;
  * ``make_train_step`` with a remat ctx takes the plain step's update;
  * prefill (a cache-building pass) with a remat ctx equals prefill
    without one.

The "dots" policy is held in tests/test_torch_remat_dots.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.sharding.ctx import ShardCtx as JShardCtx  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.sharding import ShardCtx  # noqa: E402

TOL = 2e-5
ARCHS = ("glm4-9b", "mixtral-8x7b", "recurrentgemma-9b", "xlstm-125m",
         "whisper-small")
B, S = 2, 20         # the parity tests' batch (test_torch_ssm_configs.py)
REMAT = ShardCtx(remat=True)


def to_torch_cfg(c) -> ModelConfig:
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return ModelConfig(**{f.name: conv(getattr(c, f.name))
                          for f in dataclasses.fields(ModelConfig)})


_AT_INIT = {"lam": lambda s: np.full(s, -4.0),
            "bf": lambda s: np.broadcast_to(np.linspace(3.0, 6.0, s[-1]), s),
            "bf_init": lambda s: np.broadcast_to(np.linspace(3.0, 6.0, s[-1]),
                                                 s)}


def _draw(rng, name, s):
    """As the JAX init draws (tests/test_torch_ssm_configs.py): matrices
    N(0, 1/fan_in), the embedding N(0, 0.02²), the RG-LRU's ``lam`` and
    the xLSTM forget biases at their init, other biases 0, norm scales
    N(0, 0.1²)."""
    if name in _AT_INIT:
        a = _AT_INIT[name](s.shape)
    elif name == "embed":
        a = 0.02 * rng.standard_normal(s.shape)
    elif name in ("ln1", "ln2", "lnx", "final_ln", "gn"):
        a = 0.1 * rng.standard_normal(s.shape)
    elif len(s.shape) >= 2:
        a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
    else:
        a = np.zeros(s.shape)
    return np.array(a, dtype=s.dtype)


@functools.lru_cache(maxsize=None)
def _setup(arch, seed=0):
    """JAX and port configs, numpy-drawn parameters (JAX tree) and a
    batch (tokens, labels, the encoder's frames where it has one)."""
    jcfg = jreduced(jget_config(arch), d_model=64)
    rng = np.random.default_rng(seed + 100)
    shapes = jax.eval_shape(lambda k: jT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: _draw(rng, str(getattr(path[-1], "key", "")), s),
        shapes)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.encoder is not None:
        batch["aux"] = rng.standard_normal(
            (B, jcfg.encoder.n_ctx, jcfg.d_model)).astype(np.float32)
    return jcfg, to_torch_cfg(jcfg), params, batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad(cfg, ctx):
    return torch.func.grad(
        lambda p, b: tsteps.lm_loss(p, cfg, b, ctx=ctx)[0])


def _close(got, want, what):
    for (path, a), (_, b) in zip(tu.flatten(got), tu.flatten(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=f"{what} "
                                   + "/".join(path))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_plain_and_jax(arch):
    jcfg, tcfg, jp, batch = _setup(arch)
    tp, tb = params_from_numpy(jp), _tbatch(batch)
    plain = _grad(tcfg, ShardCtx())(tp, tb)
    remat = _grad(tcfg, REMAT)(tp, tb)
    _close(remat, plain, "remat vs plain")
    jg = jax.jit(jax.grad(lambda p, b: jsteps.lm_loss(
        p, jcfg, b, ctx=JShardCtx(remat=True))[0]))(jp, batch)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tu.flatten(remat)]
    _close(remat, tu.unflatten([p for p, _ in tu.flatten(remat)],
                               [np.asarray(a) for _, a in jflat]),
           "remat vs the JAX package's jax.checkpoint")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_under_vmap_grad(arch):
    _, tcfg, jp, batch = _setup(arch)
    tp = params_from_numpy(jp)
    stacked = tu.tree_map(lambda t: torch.stack([t, 0.9 * t]), tp)
    sb = {k: torch.stack([v, v]) for k, v in _tbatch(batch).items()}
    plain = torch.func.vmap(_grad(tcfg, ShardCtx()))(stacked, sb)
    remat = torch.func.vmap(_grad(tcfg, REMAT))(stacked, sb)
    _close(remat, plain, "vmap(grad): remat vs plain")


@pytest.mark.parametrize("arch", ("glm4-9b", "whisper-small"))
def test_train_step_and_prefill_with_remat(arch):
    _, tcfg, jp, batch = _setup(arch)
    tb = _tbatch(batch)
    out = {}
    for tag, ctx in (("plain", ShardCtx()), ("remat", REMAT)):
        p = params_from_numpy(jp)
        step = tsteps.make_train_step(tcfg, sgd(0.1), ctx=ctx)
        p, _, m = step(p, sgd(0.1).init(p), 0, tb)
        with torch.no_grad():
            logits, cache = tsteps.make_prefill_step(tcfg, ctx=ctx)(p, tb)
        out[tag] = (p, float(m["loss"]), logits, cache)
    assert abs(out["remat"][1] - out["plain"][1]) <= TOL * abs(
        out["plain"][1])
    _close(out["remat"][0], out["plain"][0], "step")
    # prefill computes what the plain traversal computes
    p = out["plain"][0]
    with torch.no_grad():
        a = tsteps.make_prefill_step(tcfg, ctx=REMAT)(p, tb)
        b = tsteps.make_prefill_step(tcfg)(p, tb)
    assert torch.equal(a[0], b[0])
    for x, y in zip(tu.leaves(a[1]), tu.leaves(b[1])):
        assert torch.equal(x, y)
