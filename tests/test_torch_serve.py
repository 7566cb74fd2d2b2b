"""The port's serving path vs the JAX package's, on the CPU: ``prefill``
and greedy ``decode_step`` (through ``launch.steps``) on reduced
gemma3-27b (6 layers: 5 local with a 64-token window + 1 global; GQA
4q/4kv, GeGLU, tied embeddings, embed scale) and reduced glm4-9b
(2 global layers, GQA 4q/2kv, QKV bias, SwiGLU).

Parameters are initialised by the JAX package, given random norm scales
and QKV biases, and carried across through ``interop``; prompts come
from a numpy seed. An 80-token prompt (longer than the window, so the
local layers' ring caches wrap during prefill) is prefilled, then 8
tokens are decoded greedily. Prefill logits, every cache leaf (after
prefill and after each step) and each step's logits agree to 2e-5 (f32,
the same matmuls summed in another order), and the greedy tokens are
equal; each package then decodes one more step from the other's cache
(crossed through ``interop``). ``ring_positions``, ``init_cache``
shapes and the serve launcher on the CPU are checked beside.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, reduced  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

TOL = 2e-5
PROMPT, GEN, B = 80, 8, 2
ARCHS = ("gemma3-27b", "glm4-9b")


def to_torch_cfg(c) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(c, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def jax_params(cfg, seed=0):
    """JAX-initialised params as numpy, norm scales and biases nonzero."""
    p = jax.tree.map(np.asarray, jT.init_params(jax.random.PRNGKey(seed),
                                                cfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("ln1", "ln2", "final_ln", "bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(perturb, p)


def _close_trees(jtree, ttree, what):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat], what
    for (_, a), (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=TOL,
                                   rtol=TOL,
                                   err_msg=f"{what}: {'/'.join(path)}")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jreduced(jget_config(request.param))
    tcfg = reduced(get_config(request.param))
    assert tcfg == to_torch_cfg(jcfg)
    return jcfg, tcfg, jax_params(jcfg)


def test_prefill_and_greedy_decode_match_jax(pair):
    jcfg, tcfg, npp = pair
    if tcfg.name.startswith("gemma3"):
        assert tcfg.n_layers == 6 and tcfg.window == 64 < PROMPT
    cache_len = PROMPT + GEN
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=cache_len))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    tprefill = tsteps.make_prefill_step(tcfg, cache_len=cache_len)
    tdecode = tsteps.make_decode_step(tcfg)
    tparams = params_from_numpy(npp)

    jlogits, jcache = jprefill(npp, {"tokens": jnp.asarray(prompts)})
    with torch.inference_mode():
        tlogits, tcache = tprefill(tparams,
                                   {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    _close_trees(jcache, tcache, "prefill cache")

    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    ttok = tlogits.argmax(-1)[:, None].int()
    for i in range(GEN):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = PROMPT + i
        jlogits, jcache = jdecode(npp, jtok, jcache, jnp.int32(pos))
        with torch.inference_mode():
            tlogits, tcache = tdecode(tparams, ttok, tcache, pos)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}")
        _close_trees(jcache, tcache, f"cache after step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        ttok = tlogits.argmax(-1)[:, None].int()
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))

    # the cache crosses between the packages leaf for leaf (interop), as
    # params do: each package decodes one more step from the other's cache
    pos = PROMPT + GEN
    jlogits2, _ = jdecode(npp, jtok, params_to_numpy(tcache), jnp.int32(pos))
    with torch.inference_mode():
        tlogits2, _ = tdecode(tparams, ttok, params_from_numpy(
            jax.tree.map(np.asarray, jcache)), pos)
    np.testing.assert_allclose(tlogits2.numpy(), np.asarray(jlogits2),
                               atol=TOL, rtol=TOL)


def test_init_cache_and_ring_positions(pair):
    jcfg, tcfg, _ = pair
    jc = jT.init_cache(jcfg, 3, 100)
    tc = tT.init_cache(tcfg, 3, 100)
    jshapes = [(tuple(str(k.key) for k in p), a.shape, str(a.dtype))
               for p, a in jax.tree_util.tree_flatten_with_path(jc)[0]]
    tshapes = [(p, tuple(a.shape), str(a.dtype).replace("torch.", ""))
               for p, a in tu.flatten(tc)]
    assert jshapes == tshapes
    assert all(float(a.abs().sum()) == 0 for _, a in tu.flatten(tc))
    for pos in (0, 37, 63, 64, 65, 200):
        np.testing.assert_array_equal(
            tattn.ring_positions(pos, 64).numpy(),
            np.asarray(jattn.ring_positions(jnp.int32(pos), 64)))


def test_serve_run_on_cpu(capsys):
    """The launcher end to end on the CPU, greedy, on reduced gemma3-27b:
    the prompt is longer than the window, and the tokens it returns are
    what greedy decoding from its own prefill gives."""
    res = serve.run("gemma3-27b", use_reduced=True, batch=2, prompt_len=70,
                    gen=5, seed=3, device="cpu")
    out = capsys.readouterr().out
    assert "prefill(2x70)" in out and "ms/tok" in out
    toks = res["tokens"]
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    assert res["cfg"].n_layers == 6 and res["cfg"].window == 64
    with torch.inference_mode():
        logits, cache = tT.prefill(res["params"], res["cfg"], res["prompts"],
                                   cache_len=75)
        np.testing.assert_array_equal(logits.numpy(),
                                      res["prefill_logits"].numpy())
        tok = toks[:, :1]
        np.testing.assert_array_equal(tok[:, 0].numpy(),
                                      logits.argmax(-1).numpy())
        for i in range(5):
            logits, cache = tT.decode_step(res["params"], res["cfg"],
                                           toks[:, i:i + 1], cache, 70 + i)
            if i < 4:
                np.testing.assert_array_equal(toks[:, i + 1].numpy(),
                                              logits.argmax(-1).numpy())
        np.testing.assert_array_equal(logits.numpy(), res["logits"].numpy())
    # a sampled run and a depth cut (one unit + two unstacked local
    # layers) go through the same path
    res = serve.run("gemma3-27b", use_reduced=True, batch=2, prompt_len=8,
                    gen=3, temperature=0.7, device="cpu", n_layers=8)
    assert res["tokens"].shape == (2, 3) and res["cfg"].n_layers == 8
    assert sorted(res["cache"]["rem"]) == ["b0", "b1"]
    assert res["cache"]["rem"]["b0"]["k"].shape == (2, 11, 4, 64)
