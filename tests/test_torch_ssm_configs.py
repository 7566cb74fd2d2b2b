"""The recurrent configs of this slice, recurrentgemma-9b (RG-LRU and
local MQA, pattern (rglru, rglru, local)) and xlstm-125m (3 mLSTM : 1
sLSTM), in the port vs the JAX package, on the CPU.

  * the config files are the JAX package's, byte for byte but for the
    package name in their import; ``param_count`` equals the
    reference's on the reduced and the published configs;
  * ``forward`` logits and ``lm_loss`` value and gradients at 2e-5 on
    the reduced configs;
  * prefill then greedy decode against JAX's (logits and caches at
    2e-5, the same tokens): the recurrent states carried across, the
    local layers' ring caches wrapping;
  * ``make_variant(d_rnn=...)``, ``union``, ``up``, ``down`` (paper and
    fold) and ``segment_spec`` with a ``d_rnn`` pair at 1e-6, and the
    coverage multiplicity the loop reads from it, exactly;
  * ``up`` preserving the function at the reference's 5e-4
    (``tests/test_tfamily.py``);
  * ``segment_representable`` and ``engine="auto"`` as the reference's:
    depth and d_ff cohorts unified, d_rnn cohorts on the loop;
  * one round at 1e-4: the unified engine on a recurrentgemma depth and
    FFN pair and an xlstm depth pair, the loop on a d_rnn pair.

Parameters are JAX-initialised for the model tests, drawn with numpy
in the JAX tree's shapes for NetChange and the rounds (norm scales
nonzero in both), and carried across through ``interop``; tokens come
from numpy seeds.
"""
import dataclasses
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import TransformerFamily as JFamily  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro.fl import FLRunConfig as JRunConfig  # noqa: E402
from repro.fl import Simulator as JSimulator  # noqa: E402
from repro.fl.backends import unified_ineligible_reason as jreason  # noqa: E402,E501
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import tfamily as ttf  # noqa: E402
from repro_torch.fl import FLRunConfig as TRunConfig  # noqa: E402
from repro_torch.fl import Simulator as TSimulator  # noqa: E402
from repro_torch.fl import UnifiedEngine as TEngine  # noqa: E402
from repro_torch.fl.backends import unified_ineligible_reason as treason  # noqa: E402,E501
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

TOL = 2e-5          # logits, losses, gradients, caches (f32)
NC_TOL = 1e-6       # NetChange: gathers and scalings
FN_TOL = 5e-4       # up() preserving the function, tests/test_tfamily.py
ROUND_TOL = 1e-4    # a round (the reference's width-cohort tolerance)
NEW = ("recurrentgemma-9b", "xlstm-125m")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def to_torch_cfg(c) -> ModelConfig:
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return ModelConfig(**{f.name: conv(getattr(c, f.name))
                          for f in dataclasses.fields(ModelConfig)})


def _shapes(cfg):
    return jax.eval_shape(lambda k: jT.init_params(k, cfg),
                          jax.random.PRNGKey(0))


_JINIT = jax.jit(jT.init_params, static_argnums=1)


def jax_params(cfg, seed=0):
    """JAX-initialised parameters, norm scales drawn nonzero."""
    p = jax.tree.map(np.asarray, _JINIT(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("ln1", "ln2", "final_ln", "gn"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(perturb, p)


def drawn_params(cfg, seed=0):
    """Parameters in the JAX tree's shapes (traced, not compiled: a
    compiled init costs seconds a config), drawn with numpy as the JAX
    init draws them: matrices N(0, 1/fan_in), the embedding N(0, 0.02²),
    the RG-LRU's ``lam`` and the xLSTM forget biases at their init, the
    other biases 0; norm scales N(0, 0.1²), so each carries a real
    value."""
    rng = np.random.default_rng(seed + 100)
    init = {"lam": lambda s: np.full(s, -4.0),
            "bf": lambda s: np.broadcast_to(np.linspace(3.0, 6.0, s[-1]),
                                            s),
            "bf_init": lambda s: np.broadcast_to(
                np.linspace(3.0, 6.0, s[-1]), s)}

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in init:
            a = init[name](s.shape)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(s.shape)
        elif name in ("ln1", "ln2", "final_ln", "gn"):
            a = 0.1 * rng.standard_normal(s.shape)
        elif len(s.shape) >= 2:
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        else:
            a = np.zeros(s.shape)
        return np.array(a, dtype=s.dtype)
    return jax.tree_util.tree_map_with_path(draw, _shapes(cfg))


def _close_trees(jtree, ttree, tol, what=""):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat], what
    for (_, a), (path, b) in zip(jflat, tflat):
        assert tuple(b.shape) == tuple(np.shape(a)), path
        np.testing.assert_allclose(np.asarray(b.detach()), np.asarray(a),
                                   atol=tol, rtol=tol,
                                   err_msg=f"{what} {'/'.join(path)}")


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", NEW)
def test_config_file_is_the_reference(arch):
    name = arch.replace("-", "_") + ".py"
    with open(os.path.join(SRC, "repro", "configs", name)) as f:
        want = f.read()
    with open(os.path.join(SRC, "repro_torch", "configs", name)) as f:
        got = f.read()
    assert got == want.replace("from repro.configs.base import",
                               "from repro_torch.configs.base import")
    assert arch in tconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", NEW)
def test_param_count_equals_reference(arch):
    cfg = jget_config(arch)
    for c in (jreduced(cfg), jreduced(cfg, d_model=64, n_units=2)):
        assert tconfigs.param_count(to_torch_cfg(c)) == jbase.param_count(c)
    # the published widths, counted on the meta device: recurrentgemma-9b
    # has 9.40 B parameters, xlstm-125m 0.145 B
    assert tconfigs.param_count(to_torch_cfg(cfg)) == jbase.param_count(cfg)


# ---------------------------------------------------------------- models
MODEL_CFGS = {a: jreduced(jget_config(a), d_model=64) for a in NEW}


def _batch(cfg, B=2, S=20, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("name", NEW)
def test_logits_and_grads_match_jax(name):
    jcfg = MODEL_CFGS[name]
    tcfg = to_torch_cfg(jcfg)
    p = jax_params(jcfg, seed=2)
    batch = _batch(jcfg)
    loss_and_grad = JFamily().loss_and_grad(jcfg)

    @jax.jit              # one compile for the logits and the gradients
    def jref(p, batch):
        return jT.forward(p, jcfg, batch["tokens"]), loss_and_grad(p, batch)
    jl, ((jloss, _), jg) = jref(jax.tree.map(jnp.asarray, p),
                                jax.tree.map(jnp.asarray, batch))
    tl = tT.forward(params_from_numpy(p), tcfg,
                    torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=TOL, rtol=TOL)
    (tloss, _), tg = TFamily().loss_and_grad(tcfg)(
        params_from_numpy(p), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL,
                               rtol=TOL)
    _close_trees(jg, tg, TOL, name)


@pytest.mark.parametrize("name,prompt", [
    ("recurrentgemma-9b", 70),            # the 64-slot rings wrap
    ("xlstm-125m", 12)])
def test_prefill_then_decode_match_jax(name, prompt):
    jcfg = MODEL_CFGS[name]
    tcfg = to_torch_cfg(jcfg)
    gen, B = 3, 2
    npp = jax_params(jcfg)
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, prompt)).astype(np.int32)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg,
                                                cache_len=prompt + gen))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    tprefill = tsteps.make_prefill_step(tcfg, cache_len=prompt + gen)
    tdecode = tsteps.make_decode_step(tcfg)
    tparams = params_from_numpy(npp)
    jlogits, jcache = jprefill(npp, {"tokens": jnp.asarray(prompts)})
    with torch.inference_mode():
        tlogits, tcache = tprefill(tparams,
                                   {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    _close_trees(jcache, tcache, TOL, "prefill cache")
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    ttok = tlogits.argmax(-1)[:, None].int()
    for i in range(gen):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlogits, jcache = jdecode(npp, jtok, jcache, jnp.int32(prompt + i))
        with torch.inference_mode():
            tlogits, tcache = tdecode(tparams, ttok, tcache, prompt + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        ttok = tlogits.argmax(-1)[:, None].int()
    _close_trees(jcache, tcache, TOL, "cache after decode")
    # the init_cache layout is prefill's
    zero = tT.init_cache(tcfg, B, prompt + gen)
    assert [(p, tuple(t.shape), t.dtype) for p, t in tu.flatten(zero)] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tu.flatten(tcache)]


# ------------------------------------------------------------- NetChange
RG_BASE = jreduced(jget_config("recurrentgemma-9b"), n_units=2, d_model=32)
RG_VARIANTS = [dict(), dict(d_rnn=16), dict(n_units=1, ffn_scale=0.5,
                                            d_rnn=24)]


def test_tfamily_d_rnn_matches_jax():
    variants = [jtf.make_variant(RG_BASE, **kw) for kw in RG_VARIANTS]
    glob = jtf.union(variants)
    tb, tglob = to_torch_cfg(RG_BASE), to_torch_cfg(glob)
    for kw, v in zip(RG_VARIANTS, variants):
        assert ttf.make_variant(tb, **kw) == to_torch_cfg(v)
    assert ttf.union([to_torch_cfg(v) for v in variants]) == tglob
    g = drawn_params(glob, seed=2)
    for i, cfg in enumerate(variants[1:], 1):
        tcfg = to_torch_cfg(cfg)
        p = drawn_params(cfg, seed=i)
        _close_trees(jtf.up(jax.tree.map(np.array, p), cfg, glob, seed=3),
                     ttf.up(params_from_numpy(p), tcfg, tglob, seed=3),
                     NC_TOL, f"up {i}")
        for mode in ("paper", "fold"):
            _close_trees(
                jtf.down(jax.tree.map(np.array, g), glob, cfg, seed=3,
                         mode=mode),
                ttf.down(params_from_numpy(g), tglob, tcfg, seed=3,
                         mode=mode), NC_TOL, f"down {i} {mode}")
        jspec = jtf.segment_spec(cfg, glob, seed=3)
        tspec = ttf.segment_spec(tcfg, tglob, seed=3)
        assert sorted(jspec) == sorted(tspec)
        for path, segs in jspec.items():
            for a, b in zip(segs, tspec[path], strict=True):
                assert (a.axis, a.out_role) == (b.axis, b.out_role)
                np.testing.assert_array_equal(np.asarray(a.ids),
                                              np.asarray(b.ids))
        # the loop's coverage multiplicity reads the rnn segments
        _close_trees(jagg.multiplicity(JFamily(), cfg, glob, seed=3),
                     tagg.multiplicity(TFamily(), tcfg, tglob, seed=3,
                                       device="cpu"), 0.0, f"mult {i}")
    # the square gate matrices carry both roles
    spec = ttf.segment_spec(to_torch_cfg(variants[1]), tglob, seed=3)
    wa = spec[("units", "b0", "rg", "wa")]
    assert [(s.axis, s.out_role) for s in wa] == [(-2, True), (-1, False)]


@pytest.mark.parametrize("arch,kw", [
    ("recurrentgemma-9b", dict(n_units=1, ffn_scale=0.5, d_rnn=64)),
    ("xlstm-125m", dict(n_units=1))])
def test_up_preserves_function(arch, kw):
    cfg = to_torch_cfg(jreduced(jget_config(arch), n_units=2, d_model=128))
    var = ttf.make_variant(cfg, **kw)
    uni = ttf.union([var, cfg])
    p = params_from_numpy(drawn_params(jtf.make_variant(
        jreduced(jget_config(arch), n_units=2, d_model=128), **kw), seed=4))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, var.vocab_size, (2, 12)).astype(np.int32))
    with torch.no_grad():
        y0 = tT.forward(p, var, toks)
        y1 = tT.forward(ttf.up(p, var, uni, seed=3), uni, toks)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=FN_TOL,
                               rtol=FN_TOL)


class _Sampler:
    def __init__(self, n):
        self.n_samples, self.batch_size, self.round_fraction = n, 4, 0.5


@pytest.mark.parametrize("arch,kws,unified", [
    ("recurrentgemma-9b", [dict(n_units=1, ffn_scale=0.5), dict()], True),
    ("recurrentgemma-9b", [dict(d_rnn=16), dict()], False),
    ("xlstm-125m", [dict(n_units=1), dict()], True)])
def test_segment_representable_and_auto_match_jax(arch, kws, unified):
    base = jreduced(jget_config(arch), n_units=2, d_model=32)
    jcfgs = [jtf.make_variant(base, **kw) for kw in kws]
    tcfgs = [to_torch_cfg(c) for c in jcfgs]
    assert TFamily().segment_representable(tcfgs) == \
        JFamily().segment_representable(jcfgs) == unified
    assert TFamily().depth_only(tcfgs) == JFamily().depth_only(jcfgs)

    class Strat:
        name = "fedadp"
    samplers = [_Sampler(16), _Sampler(16)]
    got = treason(Strat(), TFamily(), tcfgs, samplers)
    assert got == jreason(Strat(), JFamily(), jcfgs, samplers)
    assert (got is None) == unified


# ---------------------------------------------------------------- rounds
N_PER, S = 8, 16


def _round_batches(vocab, K, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        toks = rng.integers(0, vocab, (K, 2, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


@pytest.mark.parametrize("arch,kws", [
    ("recurrentgemma-9b", [dict(n_units=1, ffn_scale=0.5), dict()]),
    ("xlstm-125m", [dict(n_units=1), dict()])])
def test_unified_round_matches_jax(arch, kws):
    base = jreduced(jget_config(arch), n_units=2, d_model=32)
    jcfgs = [jtf.make_variant(base, **kw) for kw in kws]
    tcfgs = [to_torch_cfg(c) for c in jcfgs]
    K = len(jcfgs)
    kw = dict(lr=0.05, momentum=0.9, embed_seed=3)
    jeng = JEngine(JFamily(), jcfgs, [16] * K, use_kernel=False, **kw)
    teng = TEngine(TFamily(), tcfgs, [16] * K, device="cpu", **kw)
    assert teng.plane_spec.offsets == jeng.plane_spec.offsets
    gp = drawn_params(JFamily().union(jcfgs), seed=6)
    batches = _round_batches(base.vocab_size, K)
    jout = jeng.run_round(gp, batches, round_idx=1)
    tout = teng.run_round(params_from_numpy(gp), batches, round_idx=1)
    _close_trees(jout, tout, ROUND_TOL, "unified round")


def test_loop_round_of_a_d_rnn_cohort_matches_jax(caplog):
    base = jreduced(jget_config("recurrentgemma-9b"), n_units=1, d_model=32)
    jcfgs = [jtf.make_variant(base, d_rnn=16), jtf.make_variant(base)]
    tcfgs = [to_torch_cfg(c) for c in jcfgs]
    K = len(jcfgs)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, base.vocab_size,
                        size=(N_PER * K, S + 1)).astype(np.int32)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    test = {"tokens": toks[:4, :-1], "labels": toks[:4, 1:]}
    parts = jdata.iid_partition(N_PER * K, K, seed=0)
    init = drawn_params(JFamily().union(jcfgs), seed=5)

    def samplers(mod):
        return [mod.ClientSampler(data, p, round_fraction=0.5, batch_size=2,
                                  seed=i) for i, p in enumerate(parts)]
    common = dict(rounds=1, local_epochs=1, lr=0.05, momentum=0.9,
                  eval_every=1, embed_seed=3, agg_mode="coverage")
    jfed = JSimulator(JFamily(), jcfgs, samplers(jdata),
                      JRunConfig(engine="loop", **common), test)._build()
    jfed.strategy.init_state = lambda key: jax.tree.map(np.array, init)
    jres = jfed.run(jax.random.PRNGKey(0))
    with caplog.at_level(logging.INFO, logger="repro_torch.fl"):
        tfed = TSimulator(TFamily(), tcfgs, samplers(tdata),
                          TRunConfig(engine="auto", device="cpu", **common),
                          test)._build()
    assert tfed.backend.name == "loop"
    assert "not segment-representable" in caplog.text
    tfed.strategy.init_state = (
        lambda gen, device=None: params_from_numpy(init))
    tres = tfed.run(torch.Generator().manual_seed(0))
    _close_trees(jres["global_params"], tres["global_params"], ROUND_TOL,
                 "loop round")
    assert abs(tres["history"][0] - jres["history"][0]) <= 1e-3
