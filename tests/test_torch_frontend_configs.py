"""The front-end configs of this slice, whisper-small (a 12-layer
bidirectional encoder over 1500 frame embeddings, 12 "crossdec" decoder
layers) and internvl2-1b (256 patch embeddings ahead of a 24-layer GQA
decoder), in the port vs the JAX package, on the CPU:

  * the config files are the JAX package's, byte for byte but for the
    package name in their import; ``param_count`` equals the
    reference's on the reduced and the published configs;
  * ``forward`` logits and ``lm_loss`` value and gradients with ``aux``
    (frames, or patches whose rows the loss drops) at 2e-5 on the
    reduced configs (2 encoder layers over 16 frames, 8 patches);
  * prefill with ``aux`` then 4 greedy decode steps against JAX's
    (logits and caches leaf by leaf at 2e-5, the same tokens): whisper's
    cross kv in the cache, internvl2's positions after the prefix;
  * ``make_variant``, ``union``, ``up``, ``down`` (paper and fold) and
    ``segment_spec`` (the encoder's FFN entry among them) on whisper at
    1e-6, and ``up`` preserving the function with ``aux`` at the
    reference's 5e-4 (``tests/test_tfamily.py``) for both models;
  * ``launch.serve.run`` and ``launch.train.run`` on the CPU (the
    trainer's first loss against the reference's ``lm_loss`` on the same
    batch and zero ``aux``);
  * one unified-engine round of a text-only internvl2 cohort at 1e-4,
    and the engine's ``ValueError`` for a whisper cohort, whose token
    batches carry no frames.

Parameters are drawn with numpy in the JAX tree's shapes (norm scales
and biases nonzero) and carried across through ``interop``; tokens and
``aux`` come from numpy seeds. Each JAX reference is compiled once per
config (module-scoped).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import TransformerFamily as JFamily  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.core import tfamily as ttf  # noqa: E402
from repro_torch.data import LMPipeline  # noqa: E402
from repro_torch.fl import UnifiedEngine as TEngine  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

TOL = 2e-5          # logits, losses, gradients, caches (f32)
NC_TOL = 1e-6       # NetChange: gathers and scalings
FN_TOL = 5e-4       # up() preserving the function, tests/test_tfamily.py
ROUND_TOL = 1e-4    # a round (the reference's width-cohort tolerance)
NEW = ("whisper-small", "internvl2-1b")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
JCFGS = {a: jreduced(jget_config(a)) for a in NEW}
B, S = 2, 16        # the batch of the gradient and trainer checks


def to_torch_cfg(c) -> ModelConfig:
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return ModelConfig(**{f.name: conv(getattr(c, f.name))
                          for f in dataclasses.fields(ModelConfig)})


_NORMS_BIASES = ("ln1", "ln2", "lnx", "final_ln", "bq", "bk", "bv", "bi",
                 "bd")


def drawn_params(cfg, seed=0):
    """Parameters in the JAX tree's shapes, drawn with numpy: matrices
    N(0, 1/fan_in), the embedding N(0, 0.02²), norm scales and biases
    N(0, 0.1²), so each carries a real value."""
    rng = np.random.default_rng(seed + 100)
    shapes = jax.eval_shape(lambda k: jT.init_params(k, cfg),
                            jax.random.PRNGKey(0))

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "embed":
            a = 0.02 * rng.standard_normal(s.shape)
        elif len(s.shape) >= 2 and name not in _NORMS_BIASES:
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return np.array(a, dtype=s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def close_trees(jtree, ttree, tol, what=""):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat], what
    for (_, a), (path, b) in zip(jflat, tflat):
        assert tuple(b.shape) == tuple(np.shape(a)), path
        np.testing.assert_allclose(np.asarray(b.detach()), np.asarray(a),
                                   atol=tol, rtol=tol,
                                   err_msg=f"{what} {'/'.join(path)}")


def aux_shape(cfg, batch):
    if cfg.encoder is not None:
        return (batch, cfg.encoder.n_ctx, cfg.d_model)
    return (batch, cfg.frontend.n_prefix, cfg.d_model)


def npx(cfg) -> int:
    """Rows of a vision prefix (0 for the encoder's frames)."""
    return cfg.frontend.n_prefix if cfg.frontend.kind == "vision" else 0


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    aux = rng.standard_normal(aux_shape(cfg, B)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "aux": aux}


@functools.lru_cache(maxsize=None)
def jax_loss(arch):
    """The reference's logits and ``lm_loss`` value and gradients, one
    compile per config (shared by the gradient and trainer checks)."""
    cfg = JCFGS[arch]
    loss_and_grad = JFamily().loss_and_grad(cfg)

    @jax.jit
    def f(p, batch):
        return (jT.forward(p, cfg, batch["tokens"], aux=batch["aux"]),
                loss_and_grad(p, batch))
    return f


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small shapes: they run as
    fast, and the parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert tconfigs.get_config(arch) == to_torch_cfg(jget_config(arch))


@pytest.mark.parametrize("arch", NEW)
def test_param_count_equals_reference(arch):
    cfg = jget_config(arch)
    assert tconfigs.param_count(to_torch_cfg(JCFGS[arch])) == \
        jbase.param_count(JCFGS[arch])
    # the published widths, counted on the meta device: whisper-small has
    # 0.238 B parameters (encoder included), internvl2-1b 0.494 B
    assert tconfigs.param_count(to_torch_cfg(cfg)) == jbase.param_count(cfg)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch", NEW)
def test_logits_and_grads_match_jax(arch):
    jcfg = JCFGS[arch]
    tcfg = to_torch_cfg(jcfg)
    p = drawn_params(jcfg, seed=2)
    batch = _batch(jcfg)
    jl, ((jloss, _), jg) = jax_loss(arch)(jax.tree.map(jnp.asarray, p),
                                          jax.tree.map(jnp.asarray, batch))
    tb = tbatch(batch)
    tl = tT.forward(params_from_numpy(p), tcfg, tb["tokens"], aux=tb["aux"])
    assert tl.shape == (B, npx(tcfg) + S, tcfg.vocab_size)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=TOL, rtol=TOL)
    (tloss, _), tg = TFamily().loss_and_grad(tcfg)(params_from_numpy(p), tb)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL,
                               rtol=TOL)
    close_trees(jg, tg, TOL, arch)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_then_decode_match_jax(arch):
    jcfg = JCFGS[arch]
    tcfg = to_torch_cfg(jcfg)
    prompt, gen = 10, 4
    base = npx(jcfg) + prompt
    npp = drawn_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, tcfg.vocab_size, (B, prompt)).astype(np.int32)
    aux = rng.standard_normal(aux_shape(jcfg, B)).astype(np.float32)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=base + gen))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    tprefill = tsteps.make_prefill_step(tcfg, cache_len=base + gen)
    tdecode = tsteps.make_decode_step(tcfg)
    tparams = params_from_numpy(npp)
    jlogits, jcache = jprefill(npp, {"tokens": jnp.asarray(prompts),
                                     "aux": jnp.asarray(aux)})
    with torch.inference_mode():
        tlogits, tcache = tprefill(tparams, {
            "tokens": torch.from_numpy(prompts),
            "aux": torch.from_numpy(aux)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    close_trees(jcache, tcache, TOL, "prefill cache")
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    ttok = tlogits.argmax(-1)[:, None].int()
    for i in range(gen):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlogits, jcache = jdecode(npp, jtok, jcache, jnp.int32(base + i))
        with torch.inference_mode():
            tlogits, tcache = tdecode(tparams, ttok, tcache, base + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        ttok = tlogits.argmax(-1)[:, None].int()
    close_trees(jcache, tcache, TOL, "cache after decode")
    # the init_cache layout is prefill's
    zero = tT.init_cache(tcfg, B, base + gen)
    assert [(q, tuple(t.shape), t.dtype) for q, t in tu.flatten(zero)] == \
        [(q, tuple(t.shape), t.dtype) for q, t in tu.flatten(tcache)]


# ------------------------------------------------------------- NetChange
WH_BASE = jreduced(jget_config("whisper-small"), n_units=2, d_model=32)
WH_VARIANTS = [dict(), dict(n_units=1, ffn_scale=0.5)]


def test_tfamily_whisper_matches_jax():
    variants = [jtf.make_variant(WH_BASE, **kw) for kw in WH_VARIANTS]
    glob = jtf.union(variants)
    tb, tglob = to_torch_cfg(WH_BASE), to_torch_cfg(glob)
    for kw, v in zip(WH_VARIANTS, variants):
        assert ttf.make_variant(tb, **kw) == to_torch_cfg(v)
    assert ttf.union([to_torch_cfg(v) for v in variants]) == tglob
    g = drawn_params(glob, seed=2)
    for i, cfg in enumerate(variants[1:], 1):
        tcfg = to_torch_cfg(cfg)
        p = drawn_params(cfg, seed=i)
        close_trees(jtf.up(jax.tree.map(np.array, p), cfg, glob, seed=3),
                    ttf.up(params_from_numpy(p), tcfg, tglob, seed=3),
                    NC_TOL, f"up {i}")
        for mode in ("paper", "fold"):
            close_trees(
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
        # the encoder's FFN rides d_ff with one mapping for its layers
        enc = {path[-1]: segs for path, segs in tspec.items()
               if path[0] == "encoder"}
        assert sorted(enc) == ["bi", "wd", "wi"]
        np.testing.assert_array_equal(np.asarray(enc["wi"][0].ids),
                                      np.asarray(enc["wd"][0].ids))


@pytest.mark.parametrize("arch,kw", [
    ("whisper-small", dict(n_units=1, ffn_scale=0.5)),
    ("internvl2-1b", dict(n_units=1, ffn_scale=0.5))])
def test_up_preserves_function(arch, kw):
    jbase_cfg = jreduced(jget_config(arch), n_units=2, d_model=128)
    cfg = to_torch_cfg(jbase_cfg)
    var = ttf.make_variant(cfg, **kw)
    uni = ttf.union([var, cfg])
    p = params_from_numpy(drawn_params(jtf.make_variant(jbase_cfg, **kw),
                                       seed=4))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, var.vocab_size, (2, 12)
                                         ).astype(np.int32))
    aux = torch.from_numpy(rng.standard_normal(aux_shape(var, 2)
                                               ).astype(np.float32))
    with torch.no_grad():
        y0 = tT.forward(p, var, toks, aux=aux)
        y1 = tT.forward(ttf.up(p, var, uni, seed=3), uni, toks, aux=aux)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=FN_TOL,
                               rtol=FN_TOL)


# -------------------------------------------------------- serve and train
@pytest.mark.parametrize("arch", NEW)
def test_serve_run_on_cpu(arch, capsys):
    """The launcher end to end on the CPU, greedy: the tokens it returns
    are what greedy decoding from its own prefill (with its ``aux``)
    gives, at positions after the vision prefix."""
    prompt, gen = 12, 3
    res = serve.run(arch, use_reduced=True, batch=2, prompt_len=prompt,
                    gen=gen, seed=3, device="cpu")
    assert f"prefill(2x{prompt})" in capsys.readouterr().out
    cfg, toks, aux = res["cfg"], res["tokens"], res["aux"]
    assert toks.shape == (2, gen) and tuple(aux.shape) == aux_shape(cfg, 2)
    base = npx(cfg) + prompt
    with torch.inference_mode():
        logits, cache = tT.prefill(res["params"], cfg, res["prompts"],
                                   aux=aux, cache_len=base + gen)
        np.testing.assert_array_equal(logits.numpy(),
                                      res["prefill_logits"].numpy())
        for i in range(gen):
            np.testing.assert_array_equal(toks[:, i].numpy(),
                                          logits.argmax(-1).numpy())
            logits, cache = tT.decode_step(res["params"], cfg,
                                           toks[:, i:i + 1], cache, base + i)
        np.testing.assert_array_equal(logits.numpy(), res["logits"].numpy())


@pytest.mark.parametrize("arch,aux", [("whisper-small", "zeros"),
                                      ("internvl2-1b", "zeros"),
                                      ("internvl2-1b", "normal")])
def test_train_run_on_cpu(arch, aux, capsys):
    """``launch.train.run`` on the reduced config from drawn parameters:
    the first loss is the reference's ``lm_loss`` of the first batch with
    the trainer's ``aux`` (zeros, the reference trainer's, or N(0, 1)
    from the seed); every loss is finite and the parameters moved."""
    jcfg = JCFGS[arch]
    p0 = drawn_params(jcfg, seed=5)
    res = ttrain.run(arch, steps=4, batch=B, seq=S, lr=3e-3, log_every=4,
                     seed=0, device="cpu", params=p0, aux=aux)
    assert "params=" in capsys.readouterr().out
    first = next(iter(LMPipeline(jcfg.vocab_size, B, S, seed=0)))
    emb = ttrain.modality_aux(res["cfg"], B, aux, seed=0, device="cpu")
    assert tuple(emb.shape) == aux_shape(jcfg, B)
    assert bool((emb == 0).all()) == (aux == "zeros")
    batch = dict(first, aux=emb.numpy())
    _, ((jloss, _), _) = jax_loss(arch)(jax.tree.map(jnp.asarray, p0),
                                        jax.tree.map(jnp.asarray, batch))
    assert len(res["losses"]) == 4
    np.testing.assert_allclose(res["losses"][0], float(jloss), atol=TOL,
                               rtol=TOL)
    assert all(np.isfinite(res["losses"]))
    moved = [float((a - torch.from_numpy(np.asarray(b))).abs().max())
             for a, b in zip(tu.leaves(res["params"]), jax.tree.leaves(p0))]
    assert max(moved) > 0


# ---------------------------------------------------------------- rounds
def _round_batches(vocab, K, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        toks = rng.integers(0, vocab, (K, 2, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _cohort(arch):
    """A depth and FFN-width pair: 1 layer at half d_ff, 2 at full."""
    base = jreduced(jget_config(arch), d_model=32)
    return [jtf.make_variant(base, n_units=1, ffn_scale=0.5),
            jtf.make_variant(base)]


def test_text_only_internvl2_loss():
    """Token batches without ``aux`` have no prefix rows: the port's
    loss drops none and equals its loss of the same config without its
    front end (the same parameters, the same function; that config's
    round is held against the reference's below). The reference's own
    loss of the vision config drops ``n_prefix`` text rows all the same
    and fails on the shapes."""
    jcfg = JCFGS["internvl2-1b"]
    p = drawn_params(jcfg, seed=8)
    batch = {k: v for k, v in _batch(jcfg).items() if k != "aux"}
    with pytest.raises((ValueError, TypeError)):
        jsteps.lm_loss(p, jcfg, batch)
    tcfg = to_torch_cfg(jcfg)
    tp = params_from_numpy(p)
    got, _ = tsteps.lm_loss(tp, tcfg, tbatch(batch))
    want, _ = tsteps.lm_loss(tp, dataclasses.replace(tcfg, frontend=None),
                             tbatch(batch))
    assert float(got) == float(want)


def test_unified_round_of_a_text_only_internvl2_cohort_matches_jax():
    """internvl2's cohorts train on token batches (tokens, labels). The
    reference's engine fails on them (``test_text_only_internvl2_loss``),
    so the port's round is held against the reference's round of the
    same cohort without its front end: the same parameters, the same
    text-only function."""
    tcfgs = [to_torch_cfg(c) for c in _cohort("internvl2-1b")]
    jcfgs = [dataclasses.replace(c, frontend=None)
             for c in _cohort("internvl2-1b")]
    K = len(jcfgs)
    kw = dict(lr=0.05, momentum=0.9, embed_seed=3)
    jeng = JEngine(JFamily(), jcfgs, [16] * K, use_kernel=False, **kw)
    teng = TEngine(TFamily(), tcfgs, [16] * K, device="cpu", **kw)
    assert teng.plane_spec.offsets == jeng.plane_spec.offsets
    gp = drawn_params(JFamily().union(jcfgs), seed=6)
    batches = _round_batches(jcfgs[0].vocab_size, K)
    jout = jeng.run_round(gp, batches, round_idx=1)
    tout = teng.run_round(params_from_numpy(gp), batches, round_idx=1)
    close_trees(jout, tout, ROUND_TOL, "unified round")


def test_whisper_cohort_without_frames_raises():
    """A whisper cohort's token batches carry no frames: the engine
    raises a ``ValueError`` that names them (the reference fails inside
    its encoder), and invents none."""
    tcfgs = [to_torch_cfg(c) for c in _cohort("whisper-small")]
    teng = TEngine(TFamily(), tcfgs, [16, 16], device="cpu", lr=0.05,
                   embed_seed=3)
    gp = teng.init_global(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frames"):
        teng.run_round(gp, _round_batches(tcfgs[0].vocab_size, 2),
                       round_idx=1)
