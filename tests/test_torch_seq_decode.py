"""The sequence-split decode cache's arithmetic, in one process: a decode
attention whose cache's slots are cut into parts (each data rank's block
under ``ShardCtx.batch_whole``) and combined by the parts' log-sum-exp
(``sharding.collectives.merge_parts`` / ``combine_seq``), vs the JAX
package on the whole cache.

  * the plain ``decode_ref(..., return_lse=True)`` over d = 2 and 4
    contiguous parts (global caches, a window, ring caches wrapped past
    their window), merged, within 1e-6 x max|out| of the JAX package's
    ``ref.decode_ref`` and ``ops.decode_attention`` (its Pallas kernel in
    interpret mode) on the whole cache; ``lse`` within 1e-6 (relative)
    of the log-sum-exp of the masked scores in float64; a part with no
    visible slot returns -inf and the mean of its v; every part empty
    gives the mean of v over every slot, as the whole cache does;
  * the port's ops / model faces take the same flag;
  * the model's decode layers on threads standing in for the data ranks
    (``combine_seq``'s sum done across the threads): GQA on a global
    cache and a local ring, MLA plain and absorbed, each rank holding its
    block of slots from the prefill on, held against the whole cache in
    one process at 1e-6 x max|y|, the ranks' outputs bit-equal, their
    cache blocks put together the whole cache.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attention import ops as jops  # noqa: E402
from repro.kernels.swa_attention import ref as jref  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.swa_attention import ops as sops  # noqa: E402
from repro_torch.kernels.swa_attention import ref as sref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.sharding import CPU_CTX, ShardCtx  # noqa: E402
from repro_torch.sharding.collectives import merge_parts  # noqa: E402

TOL = 1e-6
# name, (B, KV, G, hd, S), window, q_pos, key_pos kind; S a multiple of
# the JAX kernel's block (its swa_decode asserts S % min(512, S) == 0)
CASES = [
    ("global_full", (2, 2, 2, 16, 64), 0, 63, "iota"),
    # slots past q_pos unwritten: the later parts see no slot
    ("global_partial", (1, 2, 3, 16, 64), 0, 20, "iota"),
    ("window", (2, 2, 2, 16, 64), 24, 63, "iota"),
    ("ring_wrapped", (1, 2, 2, 16, 64), 64, 150, "ring"),
    # a ring wider than the window: past it, parts partly masked
    ("ring_past_window", (1, 2, 2, 16, 64), 40, 150, "ring"),
    ("ring_partly_written", (1, 1, 4, 32, 128), 128, 80, "ring"),
    ("no_visible_slot", (2, 2, 2, 16, 64), 0, 5, "late"),
]
JAX_OPS_CASES = ("global_partial", "ring_past_window", "no_visible_slot")


def _inputs(dims, q_pos, kind, seed=0):
    B, KV, G, hd, S = dims
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    if kind == "ring":
        kp = A.ring_positions(q_pos, S).numpy().astype(np.int32)
    else:
        kp = np.arange(S, dtype=np.int32) + (q_pos + 1 if kind == "late"
                                              else 0)
    return q, k, v, kp


def _lse64(q, k, kp, q_pos, window):
    """The log-sum-exp of the visible slots' scaled scores, in float64."""
    s = np.einsum("bkgd,bskd->bkgs", q.astype(np.float64),
                  k.astype(np.float64)) * q.shape[-1] ** -0.5
    valid = (kp >= 0) & (kp <= q_pos)
    if window > 0:
        valid &= q_pos - kp < window
    s = np.where(valid[None, None, None], s, -np.inf)
    top = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        out = np.log(np.exp(s - top).sum(-1)) + top[..., 0]
    return np.where(np.isfinite(top[..., 0]), out, -np.inf)


def _parts(q, k, v, kp, q_pos, window, d):
    """decode_ref with its lse on each of d contiguous slot blocks."""
    S = k.shape[1]
    n = S // d
    t = [torch.from_numpy(a) for a in (q, k, v, kp)]
    return [sref.decode_ref(t[0], t[1][:, r * n:(r + 1) * n],
                            t[2][:, r * n:(r + 1) * n],
                            t[3][r * n:(r + 1) * n], q_pos, window=window,
                            return_lse=True) for r in range(d)]


@pytest.mark.parametrize("d", (2, 4))
@pytest.mark.parametrize("name,dims,window,q_pos,kind", CASES)
def test_parts_merged_are_the_whole_cache(name, dims, window, q_pos, kind,
                                          d):
    q, k, v, kp = _inputs(dims, q_pos, kind)
    parts = _parts(q, k, v, kp, q_pos, window, d)
    got = merge_parts(torch.stack([p[0] for p in parts]),
                      torch.stack([p[1] for p in parts])).numpy()
    want = np.asarray(jref.decode_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(kp),
                                      q_pos, window=window))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)
    if name in JAX_OPS_CASES and d == 2:
        B, KV, G, hd, _ = dims
        kern = np.asarray(jops.decode_attention(
            jnp.asarray(q.reshape(B, KV * G, hd)), jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(kp), q_pos, window=window))
        np.testing.assert_allclose(got.reshape(kern.shape), kern,
                                   atol=TOL * scale, rtol=0)
    # each part's lse is the log-sum-exp of its visible slots' scores
    n = dims[4] // d
    for r, (o, lse) in enumerate(parts):
        sl = slice(r * n, (r + 1) * n)
        want_lse = _lse64(q, k[:, sl], kp[sl], q_pos, window)
        got_lse = lse.double().numpy()
        empty = np.isneginf(want_lse)
        np.testing.assert_array_equal(np.isneginf(got_lse), empty)
        np.testing.assert_allclose(got_lse[~empty], want_lse[~empty],
                                   rtol=TOL, atol=0)
        if empty.all():
            # no visible slot: the mean of v over the part's slots
            mean_v = v[:, sl].mean(1)[:, :, None]
            np.testing.assert_allclose(o.numpy(), np.broadcast_to(
                mean_v, o.shape), atol=TOL, rtol=0)


def test_a_part_without_a_visible_slot_and_every_part_empty():
    q, k, v, kp = _inputs((1, 2, 3, 16, 64), 20, "iota")
    lses = torch.stack([p[1] for p in _parts(q, k, v, kp, 20, 0, 4)])
    # slots 0-15 and 16-31 hold 0..20; 32-63 none: -inf there only
    assert torch.isfinite(lses[:2]).all() and torch.isneginf(lses[2:]).all()
    q, k, v, kp = _inputs((2, 2, 2, 16, 64), 5, "late")
    parts = _parts(q, k, v, kp, 5, 0, 4)
    got = merge_parts(torch.stack([p[0] for p in parts]),
                      torch.stack([p[1] for p in parts])).numpy()
    mean_v = v.mean(1)[:, :, None]
    np.testing.assert_allclose(got, np.broadcast_to(mean_v, got.shape),
                               atol=TOL, rtol=0)


def test_ops_and_model_faces_return_the_lse():
    B, KV, G, hd, S = 2, 2, 3, 16, 64
    q, k, v, kp = (torch.from_numpy(a) for a in
                   _inputs((B, KV, G, hd, S), 40, "iota"))
    q3 = q.reshape(B, KV * G, hd)
    out, lse = sops.decode_attention(q3, k, v, kp, 40, window=16,
                                     return_lse=True)
    o4, l4 = sref.decode_ref(q, k, v, kp, 40, window=16, return_lse=True)
    assert torch.equal(out, o4.reshape(B, KV * G, hd))
    assert torch.equal(lse, l4.reshape(B, KV * G))
    assert torch.equal(sops.decode_attention(q3, k, v, kp, 40, window=16),
                       out)
    mo, ml = A.attend_decode(q3, k, v, kp, 40, window=16, ctx=CPU_CTX,
                             return_lse=True)
    np.testing.assert_allclose(mo.numpy(), out.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(ml.numpy(), lse.numpy(), rtol=TOL, atol=0)


# ------------------------------------ the model's layers on data "ranks"
def thread_ctxs(d, **kw):
    """d contexts of a batch whole on d data ranks, one a thread: their
    ``data_sum`` sums the threads' buffers in rank order."""
    bufs = [None] * d
    # a rank that fails before the sum breaks the barrier for the others
    gate = threading.Barrier(d, timeout=30)

    def data_sum(self, t):
        bufs[self.data_rank] = t.clone()
        gate.wait()
        total = bufs[0].clone()
        for b in bufs[1:]:
            total += b
        gate.wait()
        t.copy_(total)
        return t
    return [type("ThreadCtx", (ShardCtx,), {
        "data_size": d, "data_rank": r, "data_sum": data_sum})(
        batch_whole=True, **kw) for r in range(d)]


def on_threads(ctxs, fn):
    """``fn(ctx)`` on one thread a context; the results in rank order."""
    out = [None] * len(ctxs)
    errs = []

    def run(r):
        try:
            out[r] = fn(ctxs[r])
        except BaseException as e:            # noqa: BLE001 - re-raised
            errs.append(e)
    threads = [threading.Thread(target=run, args=(r,))
               for r in range(len(ctxs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errs:
        raise errs[0]
    assert not any(t.is_alive() for t in threads), "a rank thread hung"
    return out


def _layer(arch, init, seed=0, **kw):
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=64), **kw)
    g = torch.Generator().manual_seed(seed)
    return cfg, init(g, cfg)


def _x(cfg, S, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (1, S + 1, cfg.d_model)).astype(np.float32))


def _hold(ys, caches, y1, cache1, dims, what):
    for y in ys[1:]:
        assert torch.equal(y, ys[0]), what            # bit-equal ranks
    scale = float(y1.abs().max())
    np.testing.assert_allclose(ys[0].numpy(), y1.numpy(), atol=TOL * scale,
                               rtol=0, err_msg=what)
    for name, dim in dims.items():
        got = torch.cat([c[name] for c in caches], dim=dim)
        np.testing.assert_allclose(got.numpy(), cache1[name].numpy(),
                                   atol=TOL * float(cache1[name].abs().max()),
                                   rtol=0, err_msg=f"{what} {name}")


@pytest.mark.parametrize("d", (2, 4))
@pytest.mark.parametrize("kind,S,L", (("global", 20, 24),
                                      ("local", 20, 24)))
def test_gqa_decode_over_slot_blocks(kind, S, L, d):
    # GQA (2 query heads a kv head); a ring of 8 the prompt wraps, its
    # d blocks of slots
    cfg, p = _layer("gemma3-27b", A.attn_init, window=8, n_kv_heads=2)
    x = _x(cfg, S)
    pos = torch.arange(S)

    def serve(ctx):
        with torch.inference_mode():
            _, cache = A.attn_apply_seq(p, cfg, x[:, :S], pos, kind=kind,
                                        ctx=ctx, return_cache=True,
                                        cache_len=L)
            ys = []
            for t in range(2):                  # two steps: S, then S + 1
                y, cache = A.attn_apply_decode(
                    p, cfg, x[:, S - 1 + t:S + t], S + t, cache, kind=kind,
                    ctx=ctx, cache_len=L)
                ys.append(y)
            return torch.cat(ys, 1), cache

    y1, c1 = serve(CPU_CTX)
    res = on_threads(thread_ctxs(d), serve)
    _hold([r[0] for r in res], [r[1] for r in res], y1, c1,
          {"k": 1, "v": 1}, f"{kind} d={d}")


@pytest.mark.parametrize("absorb", (False, True))
def test_mla_decode_over_slot_blocks(absorb):
    cfg, p = _layer("deepseek-v2-236b", A.mla_init)
    S, L = 14, 16
    x = _x(cfg, S)
    pos = torch.arange(S)

    def serve(ctx):
        with torch.inference_mode():
            _, cache = A.mla_apply_seq(p, cfg, x[:, :S], pos, ctx=ctx,
                                       return_cache=True, cache_len=L)
            ys = []
            for t in range(2):           # slot 14, then 15: rank d-1's
                y, cache = A.mla_apply_decode(
                    p, cfg, x[:, S - 1 + t:S + t], S + t, cache,
                    ctx=dataclasses.replace(ctx, mla_absorb=absorb),
                    cache_len=L)
                ys.append(y)
            return torch.cat(ys, 1), cache

    y1, c1 = serve(CPU_CTX)
    for d in (2, 4):
        res = on_threads(thread_ctxs(d), serve)
        _hold([r[0] for r in res], [r[1] for r in res], y1, c1,
              {"ckv": 1, "krope": 1}, f"absorb={absorb} d={d}")


def test_a_split_decode_needs_the_cache_length():
    cfg, p = _layer("glm4-9b", A.attn_init)
    ctx = thread_ctxs(2)[0]
    cache = A.init_attn_cache(cfg, 1, 8, ctx=ctx)
    assert cache["k"].shape[1] == 4
    with pytest.raises(ValueError, match="needs cache_len"):
        A.attn_apply_decode(p, cfg, _x(cfg, 1)[:, :1], 3, cache, ctx=ctx)
