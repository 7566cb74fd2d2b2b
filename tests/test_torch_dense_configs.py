"""The two dense configs of this slice, gemma-7b (GeGLU, embed scale, tied
embeddings, head dim 256) and command-r-plus-104b (SwiGLU, tied, GQA
with 12 query heads a kv head), in the port vs the JAX package, on the
CPU.

  * ``get_config`` gives field for field the reference's dataclass, for
    every arch the port runs; ``INPUT_SHAPES``, ``param_count`` and
    ``active_param_count`` (the port counts on the ``meta`` device) equal
    the reference's on the reduced configs, and on the published ones;
  * ``forward`` logits and ``lm_loss`` value and gradients at 2e-5 (f32,
    the same matmuls summed in another order: ``tests/
    test_torch_transformer.py``'s tolerance) on the reduced configs, on
    gemma-7b also at head dims 8 and 256 (the reduced config with
    ``d_model=16``, and with ``head_dim=256``);
  * ``make_variant`` / ``up`` / ``down`` / ``segment_spec`` at 1e-6
    (gathers and scalings of the same numbers; ``tests/
    test_torch_tfamily.py``'s), as ``tests/test_tfamily.py`` runs them;
  * prefill then greedy decode against JAX's (logits and caches at 2e-5,
    the same tokens), as ``tests/test_torch_serve.py`` holds gemma3.

Parameters are initialised by the JAX package, norm scales drawn
nonzero, and carried across through ``interop``; tokens come from a
numpy seed.
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

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import TransformerFamily as JFamily  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.core import tfamily as ttf  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

TOL = 2e-5          # logits, losses, gradients, caches (f32)
NC_TOL = 1e-6       # NetChange: gathers and scalings
NEW = ("gemma-7b", "command-r-plus-104b")


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
        if name in ("ln1", "ln2", "final_ln"):
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
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_get_config_equals_reference(arch):
    assert tconfigs.get_config(arch) == to_torch_cfg(jget_config(arch))
    assert tconfigs.reduced(tconfigs.get_config(arch)) == \
        to_torch_cfg(jreduced(jget_config(arch)))


def test_input_shapes_equal_reference():
    assert {k: dataclasses.asdict(v)
            for k, v in tconfigs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", NEW)
def test_param_count_equals_reference(arch):
    cfg = jget_config(arch)
    for c in (jreduced(cfg), jreduced(cfg, d_model=64, n_units=2)):
        assert tconfigs.param_count(to_torch_cfg(c)) == jbase.param_count(c)
        assert tconfigs.active_param_count(to_torch_cfg(c)) == \
            jbase.active_param_count(c)
    # the published widths, counted on the meta device: gemma-7b has
    # 8.54 B parameters, command-r-plus 103.8 B
    assert tconfigs.param_count(to_torch_cfg(cfg)) == jbase.param_count(cfg)


# ---------------------------------------------------------------- models
MODEL_CFGS = {
    "gemma-7b": jreduced(jget_config("gemma-7b")),
    "command-r-plus-104b": jreduced(jget_config("command-r-plus-104b")),
    "gemma-7b_hd8": jreduced(jget_config("gemma-7b"), d_model=16),
    "gemma-7b_hd256": dataclasses.replace(
        jreduced(jget_config("gemma-7b"), d_model=64), head_dim=256),
}


def _batch(cfg, B=2, S=20, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_logits_and_grads_match_jax(name):
    jcfg = MODEL_CFGS[name]
    tcfg = to_torch_cfg(jcfg)
    assert tcfg.resolved_head_dim == {"gemma-7b_hd8": 8,
                                      "gemma-7b_hd256": 256}.get(
        name, tcfg.resolved_head_dim)
    p = jax_params(jcfg, seed=2)
    batch = _batch(jcfg)
    jl = jT.forward(p, jcfg, batch["tokens"])
    tl = tT.forward(params_from_numpy(p), tcfg,
                    torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    (jloss, _), jg = JFamily().loss_and_grad(jcfg)(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch))
    (tloss, _), tg = TFamily().loss_and_grad(tcfg)(
        params_from_numpy(p), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL,
                               rtol=TOL)
    _close_trees(jg, tg, TOL, name)


# ------------------------------------------------------------- NetChange
@pytest.mark.parametrize("arch", NEW)
def test_tfamily_up_down_segment_spec_match_jax(arch):
    base = jreduced(jget_config(arch), n_units=2, d_model=64)
    variants = [jtf.make_variant(base),
                jtf.make_variant(base, ffn_scale=0.5),
                jtf.make_variant(base, n_units=1, ffn_scale=0.5)]
    glob = jtf.union(variants)
    tbase, tglob = to_torch_cfg(base), to_torch_cfg(glob)
    assert ttf.make_variant(tbase, n_units=1, ffn_scale=0.5) == \
        to_torch_cfg(variants[2])
    assert ttf.union([to_torch_cfg(v) for v in variants]) == tglob
    g = jax.tree.map(np.asarray, jT.init_params(jax.random.PRNGKey(2), glob))
    for i, cfg in enumerate(variants):
        tcfg = to_torch_cfg(cfg)
        p = jax.tree.map(np.asarray,
                         jT.init_params(jax.random.PRNGKey(i), cfg))
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


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("name", ["gemma-7b", "command-r-plus-104b",
                                  "gemma-7b_hd256"])
def test_prefill_then_decode_match_jax(name):
    jcfg = MODEL_CFGS[name]
    tcfg = to_torch_cfg(jcfg)
    prompt, gen, B = 24, 4, 2
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
