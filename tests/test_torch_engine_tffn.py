"""The port's unified engine and Simulator vs the JAX package's on the
transformer tffn cohort — K = 4 clients alternating reduced glm4-9b at
full and half FFN width (``benchmarks/unified_bench.py:_tffn_cohort``,
S = 64), fedadp.

  * one round of ``repro_torch``'s ``UnifiedEngine`` vs ``repro``'s from
    the same numpy-seeded global model and batches, with
    ``attn_backend`` "flash" (on the CPU: the plain versions through the
    port's autograd Functions; the jnp reference in JAX) and
    "blockwise", whole-plane and streamed. Tolerance 1e-4, the JAX
    package's width-cohort tolerance (tests/test_unified.py);
  * a 2-round ``Simulator`` run from the same initial model whose
    eval-loss history tracks the JAX run's to 0.005.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import TransformerFamily as JFamily  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.fl import FLRunConfig as JRunConfig  # noqa: E402
from repro.fl import Simulator as JSimulator  # noqa: E402
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.fl import FLRunConfig as TRunConfig  # noqa: E402
from repro_torch.fl import Simulator as TSimulator  # noqa: E402
from repro_torch.fl import UnifiedEngine as TEngine  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

K, S = 4, 64
BASE = jreduced(jget_config("glm4-9b"), n_units=2, d_model=64)
JCFGS = [jtf.make_variant(BASE, ffn_scale=0.5) if k % 2
         else jtf.make_variant(BASE) for k in range(K)]
N_SAMPLES = [16] * K
TOL = 1e-4


def to_torch_cfg(c) -> ModelConfig:
    """The port's twin of a JAX ``ModelConfig`` (dense configs)."""
    return ModelConfig(**{f.name: getattr(c, f.name)
                          for f in dataclasses.fields(ModelConfig)})


TCFGS = [to_torch_cfg(c) for c in JCFGS]


def _global_params(seed=0):
    gcfg = JFamily().union(JCFGS)
    return jax.tree.map(np.asarray,
                        jT.init_params(jax.random.PRNGKey(seed), gcfg))


def _batches(steps=2, b=4, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, BASE.vocab_size,
                            (K, b, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _assert_trees_close(jtree, ttree, atol):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=atol, rtol=0, err_msg="/".join(path))


@pytest.mark.parametrize("attn,layout,k_chunk", [
    ("flash", "plane", None), ("blockwise", "stream", 2)])
def test_engine_round_matches_jax(attn, layout, k_chunk):
    kw = dict(lr=0.05, momentum=0.9, agg_layout=layout, k_chunk=k_chunk,
              embed_seed=3, attn_backend=attn)
    jeng = JEngine(JFamily(), JCFGS, N_SAMPLES, use_kernel=False, **kw)
    teng = TEngine(TFamily(), TCFGS, N_SAMPLES, device="cpu", **kw)
    assert teng.plane_spec.offsets == jeng.plane_spec.offsets
    gp = _global_params()
    batches = _batches()
    jout = jeng.run_round(gp, batches, round_idx=1)
    tout = teng.run_round(params_from_numpy(gp), batches, round_idx=1)
    _assert_trees_close(jout, tout, TOL)
    assert teng.agg_stats()["layout"] == layout


def _fixed_init(base, cfg, params):
    """A family whose init returns ``params`` for ``cfg`` — both runs
    start from the same global model."""
    class Fixed(base):
        def init(self, key, c, **kw):
            if c == cfg:
                return params
            return super().init(key, c, **kw)
    return Fixed()


def test_simulator_history_tracks_jax():
    gp = _global_params(seed=4)
    n = 16 * K
    rng = np.random.default_rng(0)
    toks = rng.integers(0, BASE.vocab_size, size=(n, S + 1)).astype(np.int32)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    test = {"tokens": toks[:16, :-1], "labels": toks[:16, 1:]}
    parts = jdata.iid_partition(n, K, seed=0)

    def samplers(mod):
        return [mod.ClientSampler(data, p, round_fraction=0.5, batch_size=8,
                                  seed=i) for i, p in enumerate(parts)]

    common = dict(rounds=2, local_epochs=1, lr=0.05, momentum=0.9,
                  eval_every=1, attn_backend="flash")
    jres = JSimulator(_fixed_init(JFamily, JFamily().union(JCFGS), gp),
                      JCFGS, samplers(jdata),
                      JRunConfig(engine="unified", **common), test).run()
    tres = TSimulator(
        _fixed_init(TFamily, TFamily().union(TCFGS), params_from_numpy(gp)),
        TCFGS, samplers(tdata),
        TRunConfig(engine="unified", device="cpu", **common),
        {k: v.copy() for k, v in test.items()}).run()
    assert len(tres["history"]) == len(jres["history"]) == 2
    assert max(abs(a - b) for a, b in zip(tres["history"],
                                          jres["history"])) <= 0.005
    _assert_trees_close(jres["global_params"], tres["global_params"], 1e-3)
