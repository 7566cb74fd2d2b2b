"""The MoE configs of this slice, mixtral-8x7b (8 experts top-2, every
layer local) and deepseek-v2-236b (160 routed experts top-6, 2 shared,
MLA), in the port vs the JAX package, on the CPU.

  * ``get_config`` (``tests/test_torch_dense_configs.py`` holds it for
    every arch of ``ARCH_IDS``), ``param_count`` and
    ``active_param_count`` equal the reference's, on the reduced configs
    and on the published ones (counted on the ``meta`` device);
  * ``forward`` logits and ``lm_loss`` value and gradients at 2e-5 on
    the reduced configs (f32, the same matmuls summed in another order);
  * ``make_variant(n_experts=..., ffn_scale=...)``, ``union``, ``up``,
    ``down`` (``narrow_paper`` and fold, with the router-bias shift) and
    ``segment_spec`` at 1e-6 (gathers and scalings of the same numbers),
    as ``tests/test_tfamily.py`` and ``tests/test_segments.py``'s
    ``tmoe`` pair run them; the expert-count embedding exact under soft
    routing;
  * ``segment_representable`` equal to the reference's on depth,
    expert-count and expert-width cohorts, and ``engine="auto"``
    resolving as the reference's, with its reason;
  * prefill then greedy decode against JAX's (logits and caches at 2e-5,
    the same tokens): mixtral's ring caches wrap, deepseek's latent
    caches in both MLA decode forms;
  * one loop round of an expert-count cohort at 1e-4 (the reference's
    width-cohort tolerance), one unified round of a depth-only MoE cohort
    at 1e-5 (its depth tolerance, ``tests/test_unified.py``);
  * ``launch.train.run`` on the reduced deepseek-v2 against the
    reference's trainer, as ``tests/test_torch_train.py`` runs glm4.

Parameters are JAX-initialised (norm scales drawn nonzero) and carried
across through ``interop``; tokens come from numpy seeds.
"""
import dataclasses
import logging

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
from repro.core import tfamily as jtf  # noqa: E402
from repro.fl import FLRunConfig as JRunConfig  # noqa: E402
from repro.fl import Simulator as JSimulator  # noqa: E402
from repro.fl.backends import unified_ineligible_reason as jreason  # noqa: E402,E501
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.sharding.ctx import ShardCtx as JCtx  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.core import tfamily as ttf  # noqa: E402
from repro_torch.fl import FLRunConfig as TRunConfig  # noqa: E402
from repro_torch.fl import Simulator as TSimulator  # noqa: E402
from repro_torch.fl import UnifiedEngine as TEngine  # noqa: E402
from repro_torch.fl.backends import unified_ineligible_reason as treason  # noqa: E402,E501
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.sharding.ctx import ShardCtx as TCtx  # noqa: E402

TOL = 2e-5          # logits, losses, gradients, caches (f32)
NC_TOL = 1e-6       # NetChange: gathers and scalings
WIDTH_TOL = 1e-4    # a round of a width (expert-count) cohort
DEPTH_TOL = 1e-5    # a round of a depth cohort
LOSS_TOL = 1e-4     # a trained loss history
NEW = ("mixtral-8x7b", "deepseek-v2-236b")


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


def jax_params(cfg, seed=0):
    p = jax.tree.map(np.asarray, jT.init_params(jax.random.PRNGKey(seed),
                                                cfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("ln1", "ln2", "final_ln", "qln", "kvln"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(perturb, p)


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
def test_param_count_equals_reference(arch):
    cfg = jget_config(arch)
    for c in (jreduced(cfg), jreduced(cfg, d_model=64, n_units=2)):
        assert tconfigs.param_count(to_torch_cfg(c)) == jbase.param_count(c)
        assert tconfigs.active_param_count(to_torch_cfg(c)) == \
            jbase.active_param_count(c)
    # the published widths: mixtral 46.7 B parameters (12.9 B active),
    # deepseek-v2 239.4 B (every layer MoE; 21.4 B active)
    t = to_torch_cfg(cfg)
    assert tconfigs.param_count(t) == jbase.param_count(cfg)
    assert tconfigs.active_param_count(t) == jbase.active_param_count(cfg)


# ---------------------------------------------------------------- models
MODEL_CFGS = {a: jreduced(jget_config(a)) for a in NEW}


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
    jl = jT.forward(p, jcfg, batch["tokens"])
    tl = tT.forward(params_from_numpy(p), tcfg,
                    torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=TOL, rtol=TOL)
    (jloss, _), jg = JFamily().loss_and_grad(jcfg)(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch))
    (tloss, _), tg = TFamily().loss_and_grad(tcfg)(
        params_from_numpy(p), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL,
                               rtol=TOL)
    _close_trees(jg, tg, TOL, name)


# ------------------------------------------------------------- NetChange
def _moe_base(arch):
    return jreduced(jget_config(arch), n_units=2, d_model=64)


VARIANTS = {
    "mixtral-8x7b": [dict(), dict(n_experts=2), dict(ffn_scale=0.5),
                     dict(n_units=1, n_experts=2, ffn_scale=0.5)],
    "deepseek-v2-236b": [dict(), dict(n_experts=3), dict(ffn_scale=0.5),
                         dict(n_units=1, n_experts=2, ffn_scale=0.5)],
}


@pytest.mark.parametrize("arch", NEW)
def test_tfamily_up_down_segment_spec_match_jax(arch):
    base = _moe_base(arch)
    variants = [jtf.make_variant(base, **kw) for kw in VARIANTS[arch]]
    glob = jtf.union(variants)
    tbase, tglob = to_torch_cfg(base), to_torch_cfg(glob)
    for kw, v in zip(VARIANTS[arch], variants):
        assert ttf.make_variant(tbase, **kw) == to_torch_cfg(v)
    assert ttf.union([to_torch_cfg(v) for v in variants]) == tglob
    g = jax_params(glob, seed=2)
    # a nonzero router bias, so narrowing and folding carry a real one
    rng = np.random.default_rng(9)
    for part in g["units"].values():
        part["moe"]["router_b"] = rng.standard_normal(
            part["moe"]["router_b"].shape).astype(np.float32)
    for i, cfg in enumerate(variants):
        tcfg = to_torch_cfg(cfg)
        p = jax_params(cfg, seed=i)
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
    assert any("effn" in "/".join(p) or p[-2:] == ("moe", "wd")
               for p in ttf.segment_spec(to_torch_cfg(variants[2]), tglob))


def test_expert_widening_exact_under_soft_routing():
    """``tests/test_tfamily.py``'s case in the port: a 2-expert client
    embedded in the 4-expert union computes the same function when every
    expert takes every token (top_k = n_experts)."""
    cfg = jreduced(jget_config("mixtral-8x7b"), n_units=2, d_model=64)
    cfg = to_torch_cfg(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=4, top_k=4, capacity_factor=8.0)))
    var = ttf.make_variant(cfg, n_units=1, n_experts=2)
    var = dataclasses.replace(var, moe=dataclasses.replace(
        var.moe, top_k=2, capacity_factor=8.0))
    uni = ttf.union([var, cfg])
    p = params_from_numpy(jax_params(_as_jax(var), seed=4))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, var.vocab_size, (2, 10)).astype(np.int32))
    y0 = tT.forward(p, var, toks)
    y1 = tT.forward(ttf.up(p, var, uni, seed=1), uni, toks)
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(),
                               atol=1e-4, rtol=1e-4)


def _as_jax(tcfg):
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(jbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return jbase.ModelConfig(**{f.name: conv(getattr(tcfg, f.name))
                                for f in dataclasses.fields(jbase.ModelConfig)})


class _Sampler:
    def __init__(self, n):
        self.n_samples, self.batch_size, self.round_fraction = n, 4, 0.5


@pytest.mark.parametrize("kind,kws", [
    ("depth", [dict(n_units=1), dict()]),
    ("expert count", [dict(n_experts=2), dict()]),
    ("expert width", [dict(ffn_scale=0.5), dict()]),
])
def test_segment_representable_and_auto_match_jax(kind, kws):
    base = _moe_base("mixtral-8x7b")
    jcfgs = [jtf.make_variant(base, **kw) for kw in kws]
    tcfgs = [to_torch_cfg(c) for c in jcfgs]
    want = JFamily().segment_representable(jcfgs)
    assert TFamily().segment_representable(tcfgs) == want == \
        (kind == "depth")
    assert TFamily().depth_only(tcfgs) == JFamily().depth_only(jcfgs)

    class Strat:
        name = "fedadp"
    samplers = [_Sampler(16), _Sampler(16)]
    assert treason(Strat(), TFamily(), tcfgs, samplers) == \
        jreason(Strat(), JFamily(), jcfgs, samplers)


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("name,prompt,absorb", [
    ("mixtral-8x7b", 70, False),          # the 64-slot rings wrap
    ("deepseek-v2-236b", 24, False),
    ("deepseek-v2-236b", 24, True)])
def test_prefill_then_decode_match_jax(name, prompt, absorb):
    jcfg = MODEL_CFGS[name]
    tcfg = to_torch_cfg(jcfg)
    gen, B = 4, 2
    npp = jax_params(jcfg)
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, prompt)).astype(np.int32)
    jctx, tctx = JCtx(mla_absorb=absorb), TCtx(mla_absorb=absorb)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, ctx=jctx,
                                                cache_len=prompt + gen))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, ctx=jctx))
    tprefill = tsteps.make_prefill_step(tcfg, ctx=tctx,
                                        cache_len=prompt + gen)
    tdecode = tsteps.make_decode_step(tcfg, ctx=tctx)
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
    assert [(p, tuple(t.shape)) for p, t in tu.flatten(zero)] == \
        [(p, tuple(t.shape)) for p, t in tu.flatten(tcache)]


# ---------------------------------------------------------------- rounds
N_PER, S = 8, 16


def _lm_data(vocab, K, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(N_PER * K, S + 1)).astype(np.int32)
    return ({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
            {"tokens": toks[:4, :-1], "labels": toks[:4, 1:]})


def test_loop_round_of_an_expert_count_cohort_matches_jax(caplog):
    base = jreduced(jget_config("mixtral-8x7b"), n_units=1, d_model=64)
    jcfgs = [jtf.make_variant(base, n_experts=2), jtf.make_variant(base),
             jtf.make_variant(base, n_experts=3)]
    tcfgs = [to_torch_cfg(c) for c in jcfgs]
    K = len(jcfgs)
    data, test = _lm_data(base.vocab_size, K)
    parts = jdata.iid_partition(N_PER * K, K, seed=0)
    init = jax_params(JFamily().union(jcfgs), seed=5)

    def samplers(mod):
        return [mod.ClientSampler(data, p, round_fraction=0.5, batch_size=2,
                                  seed=i) for i, p in enumerate(parts)]
    common = dict(rounds=1, local_epochs=1, lr=0.05, momentum=0.9,
                  eval_every=1, embed_seed=3)
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
    _close_trees(jres["global_params"], tres["global_params"], WIDTH_TOL,
                 "loop round")
    assert abs(tres["history"][0] - jres["history"][0]) <= 1e-3


def test_unified_round_of_a_depth_cohort_matches_jax():
    base = jreduced(jget_config("mixtral-8x7b"), n_units=2, d_model=64)
    jcfgs = [jtf.make_variant(base, n_units=1), jtf.make_variant(base)]
    tcfgs = [to_torch_cfg(c) for c in jcfgs]
    K = len(jcfgs)
    kw = dict(lr=0.05, momentum=0.9, embed_seed=3)
    jeng = JEngine(JFamily(), jcfgs, [16] * K, use_kernel=False, **kw)
    teng = TEngine(TFamily(), tcfgs, [16] * K, device="cpu", **kw)
    assert teng.plane_spec.offsets == jeng.plane_spec.offsets
    gp = jax_params(JFamily().union(jcfgs), seed=6)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, base.vocab_size,
                            (K, 2, S + 1)).astype(np.int32)
        batches.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    jout = jeng.run_round(gp, batches, round_idx=1)
    tout = teng.run_round(params_from_numpy(gp), batches, round_idx=1)
    _close_trees(jout, tout, DEPTH_TOL, "unified round")


# ---------------------------------------------------------------- trainer
def test_train_run_matches_jax_on_deepseek(capsys):
    arch = "deepseek-v2-236b"
    kw = dict(steps=5, batch=2, seq=16, lr=3e-4, log_every=5, seed=0,
              d_model=64)
    jres = jtrain.run(arch, **kw)
    cfg = jreduced(jget_config(arch), d_model=64)
    p0 = jax.tree.map(np.asarray,
                      jT.init_params(jax.random.PRNGKey(0), cfg))
    tres = ttrain.run(arch, device="cpu", params=p0, **kw)
    assert len(tres["losses"]) == 5
    np.testing.assert_allclose(tres["losses"], jres["losses"], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert tres["losses"][-1] < tres["losses"][0]
    assert "params=" in capsys.readouterr().out
