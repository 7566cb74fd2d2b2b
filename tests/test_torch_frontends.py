"""The front-end modules in the port vs the JAX package, on the CPU: the
pieces that reach the attention kernels, each at 2e-5 (f32, the same
products summed in another order) on the reduced whisper-small (2
encoder layers over 16 frames, 2 decoder layers, 4 heads of 64, QKV and
MLP biases, tanh GELU, tied embeddings) and internvl2-1b (8 patch
embeddings ahead of the text, 4 query heads on 2 kv heads of 64):

  * ``cross_attn_apply`` over a sequence (``attend``, non-causal, every
    position 0) and for one token (``attend_decode``);
  * ``encode``, the bidirectional encoder;
  * a "crossdec" block over a sequence with its cache (self k/v and the
    cross kv), then one decode step on that cache;
  * the vision ``_embed``: the patch embeddings ahead of the tokens;
  * the registry: ``arch_ids``, ``plane_spec`` (offsets, shapes, size)
    equal to the reference's ``PlaneSpec`` for both models, reduced and
    at the published widths, and the ``Model`` handle.

Parameters are drawn with numpy in the JAX tree's shapes (norm scales
and biases nonzero) and carried across through ``interop``; inputs come
from numpy seeds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.sharding.ctx import ShardCtx  # noqa: E402

TOL = 2e-5
ARCHS = ("whisper-small", "internvl2-1b")
JW = jreduced(jget_config("whisper-small"))
JV = jreduced(jget_config("internvl2-1b"))


def to_torch_cfg(c) -> ModelConfig:
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return ModelConfig(**{f.name: conv(getattr(c, f.name))
                          for f in dataclasses.fields(ModelConfig)})


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
        elif len(s.shape) >= 2 and name not in ("ln1", "ln2", "lnx",
                                                "final_ln", "bq", "bk", "bv",
                                                "bi", "bd"):
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return np.array(a, dtype=s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=what)


def close_trees(jtree, ttree, tol=TOL, what=""):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat], what
    for (_, a), (path, b) in zip(jflat, tflat):
        close(b, a, tol, f"{what} {'/'.join(path)}")


def unit(tree, u=0):
    """Unit ``u`` of a stacked tree (numpy)."""
    return jax.tree.map(lambda a: np.array(a[u]), tree)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small shapes: they run as
    fast, and the parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whisper():
    p = drawn_params(JW, seed=1)
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((2, JW.encoder.n_ctx, JW.d_model)
                                 ).astype(np.float32)
    return p, frames


@pytest.mark.parametrize("S", [7, 1])
def test_cross_attn_matches_jax(whisper, S):
    p, frames = whisper
    xp = unit(p["units"]["b0"]["xattn"])
    x = np.random.default_rng(3).standard_normal(
        (2, S, JW.d_model)).astype(np.float32)
    jkv = jA.cross_kv(xp, JW, jnp.asarray(frames))
    want = jA.cross_attn_apply(xp, JW, jnp.asarray(x), jkv)
    tcfg = to_torch_cfg(JW)
    tp = params_from_numpy(xp)
    tkv = tA.cross_kv(tp, tcfg, torch.from_numpy(frames))
    close_trees(jkv, tkv, what="cross kv")
    got = tA.cross_attn_apply(tp, tcfg, torch.from_numpy(x), tkv)
    close(got, want, what=f"cross attention S={S}")
    # the plain route of the kernels' backend computes the same
    got_f = tA.cross_attn_apply(tp, tcfg, torch.from_numpy(x), tkv,
                                ctx=ShardCtx(attn_backend="flash"))
    close(got_f, want, what=f"cross attention S={S}, flash's plain route")


def test_encode_matches_jax(whisper):
    p, frames = whisper
    want = jT.encode(p["encoder"], JW, jnp.asarray(frames))
    got = tT.encode(params_from_numpy(p["encoder"]), to_torch_cfg(JW),
                    torch.from_numpy(frames))
    assert got.shape == (2, JW.encoder.n_ctx, JW.d_model)
    close(got, want, what="encoder output")


def test_crossdec_block_matches_jax(whisper):
    """A "crossdec" block: the sequence with its cache (self k/v of
    ``cache_len`` slots, the cross kv beside), then one decode step that
    writes the self cache in place and leaves the cross kv as they
    are."""
    p, frames = whisper
    tcfg = to_torch_cfg(JW)
    bp = unit(p["units"]["b0"])
    S, L = 9, 12
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, JW.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, JW.d_model)).astype(np.float32)

    @jax.jit                    # one compile for the sequence and the step
    def jref(bp, enc_p, x, x1, frames):
        enc = jT.encode(enc_p, JW, frames)
        jx, jc = jT.block_apply_seq(bp, JW, "crossdec", x, jnp.arange(S),
                                    ctx=jT.CPU_CTX, return_cache=True,
                                    cache_len=L, enc_out=enc)
        jy, jc2 = jT.block_apply_decode(bp, JW, "crossdec", x1,
                                        jnp.int32(S), jc, ctx=jT.CPU_CTX)
        return enc, jx, jc, jy, jc2
    enc, jx, jc, jy, jc2 = jref(bp, p["encoder"], x, x1, frames)
    tp = params_from_numpy(bp)
    tenc = torch.from_numpy(np.array(enc))
    tx, tc = tT.block_apply_seq(tp, tcfg, "crossdec", torch.from_numpy(x),
                                torch.arange(S), ctx=ShardCtx(),
                                return_cache=True, cache_len=L,
                                enc_out=tenc)
    close(tx, jx, what="crossdec block over the sequence")
    close_trees(jc, tc, what="crossdec prefill cache")
    assert sorted(tc) == ["k", "v", "xk", "xv"]
    xk = tc["xk"].clone()
    ty, tc2 = tT.block_apply_decode(tp, tcfg, "crossdec",
                                    torch.from_numpy(x1), S, tc,
                                    ctx=ShardCtx())
    close(ty, jy, what="crossdec decode step")
    close_trees(jc2, tc2, what="crossdec cache after the step")
    assert tc2["k"] is tc["k"] and torch.equal(tc2["xk"], xk)


def test_vision_embed_matches_jax():
    p = drawn_params(JV, seed=5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, JV.vocab_size, (2, 5)).astype(np.int32)
    aux = rng.standard_normal((2, JV.frontend.n_prefix, JV.d_model)
                              ).astype(np.float32)
    tcfg = to_torch_cfg(JV)
    tp = params_from_numpy(p)
    want = jT._embed(p, JV, jnp.asarray(toks), jnp.asarray(aux))
    got = tT._embed(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(aux))
    assert got.shape == (2, JV.frontend.n_prefix + 5, JV.d_model)
    close(got, want, what="vision prefix + token embeddings")
    # no aux: the text alone, as the reference's text-only batches
    close(tT._embed(tp, tcfg, torch.from_numpy(toks)),
          jT._embed(p, JV, jnp.asarray(toks), None), what="text only")


def _spec_tuple(spec):
    return (spec.size, tuple(spec.offsets), tuple(tuple(s) for s in
                                                  spec.shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_plane_spec_matches_jax(arch):
    assert treg.arch_ids() == jreg.arch_ids()
    for jcfg in (jreduced(jget_config(arch)), jget_config(arch)):
        tcfg = to_torch_cfg(jcfg)
        got, want = treg.plane_spec(tcfg), jreg.plane_spec(jcfg)
        assert _spec_tuple(got) == _spec_tuple(want)
        assert got.paths == want.paths and got.dtypes == want.dtypes
    # by id: the published config, its parameters on the meta device
    assert treg.get_model(arch).cfg == to_torch_cfg(jget_config(arch))
    shapes = treg.get_model(arch).param_shapes()
    assert all(t.device.type == "meta" for t in tu.leaves(shapes))
    assert treg.plane_spec(arch).size == sum(t.numel()
                                             for t in tu.leaves(shapes))


def test_registry_model_handle(whisper):
    """``Model``'s methods are the transformer stack's, ``aux`` passed
    through: the handle's forward, prefill and decode step equal
    ``models.transformer``'s."""
    p, frames = whisper
    m = treg.get_model(to_torch_cfg(JW))
    tp = params_from_numpy(p)
    aux = torch.from_numpy(frames)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, JW.vocab_size, (2, 6)).astype(np.int32))
    with torch.no_grad():
        assert torch.equal(m.forward(tp, toks, aux=aux),
                           tT.forward(tp, m.cfg, toks, aux=aux))
        logits, cache = m.prefill(tp, toks, aux=aux, cache_len=8)
        want, wcache = tT.prefill(tp, m.cfg, toks, aux=aux, cache_len=8)
        assert torch.equal(logits, want)
        got, _ = m.decode_step(tp, toks[:, :1], cache, 6)
        assert torch.equal(got, tT.decode_step(tp, m.cfg, toks[:, :1],
                                               wcache, 6)[0])
    zero = m.init_cache(2, 8)
    assert [(q, tuple(t.shape)) for q, t in tu.flatten(zero)] == \
        [(q, tuple(t.shape)) for q, t in tu.flatten(cache)]
    init = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert [(q, tuple(t.shape)) for q, t in tu.flatten(init)] == \
        [(q, tuple(t.shape)) for q, t in tu.flatten(tp)]
