"""The plain versions of this slice's aggregation kernels vs the JAX
package's: the int8 wire's fused dequantize-accumulate
(``plane_accum_q``), the bf16 wire's chunk through ``plane_accum``, and
the per-leaf coverage average (``weighted_sum_masked[_mult]``).

Each is held, on the same numpy-seeded inputs, against the JAX
package's jnp oracle and its Pallas kernel run as its own tests run it
on the CPU (``interpret=True``), to 1e-6 — the kernel-vs-oracle
tolerance of ``tests/test_quant.py`` and ``tests/test_plane.py``: both
sides sum the same few f32 products per coordinate in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels.fedavg import fedavg as jfk  # noqa: E402
from repro.kernels.fedavg import ops as jops  # noqa: E402
from repro.kernels.fedavg import ref as jref  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels.fedavg import ops as tops  # noqa: E402
from repro_torch.kernels.fedavg import ref as tref  # noqa: E402

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a).copy())
            for a in arrays]


def _chunk(K, n, tile, seed):
    """An int8 chunk with scales (quantized by the JAX package, masked),
    weights, masks, multiplicities and a base row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, n)).astype(np.float32)
    x[:, :tile] = 0.0                         # an all-zero tile
    w = (rng.random(K) + 0.1).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    m = rng.integers(0, 2, (K, n)).astype(np.float32)
    mu = (rng.integers(1, 3, (K, n)) * m).astype(np.float32)
    base = rng.standard_normal(n).astype(np.float32)
    xq, s = jq.quantize(jnp.asarray(x), "int8", tile=tile,
                        mask=jnp.asarray(m))
    return np.asarray(xq), np.asarray(s), w, m, mu, base


VARIANTS = ["plain", "masks", "masked_mult", "fold"]


def _variant_kw(variant, m, mu, base):
    return {"plain": {}, "masks": dict(masks=m),
            "masked_mult": dict(masks=m, mult=mu),
            "fold": dict(masks=m, base=base)}[variant]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,tile", [(4096 * 2 + 517, 256), (1000, 128),
                                    (1031, 512)])
def test_accum_q_matches_jax_ref_and_pallas(variant, n, tile):
    K = 3
    xq, s, w, m, mu, base = _chunk(K, n, tile, seed=n + tile)
    kw = _variant_kw(variant, m, mu, base)
    z = np.zeros(n, np.float32)
    jz = jnp.asarray(z)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want_ref = jops.plane_accum_q(jz, jz, jz, jnp.asarray(xq),
                                  jnp.asarray(s), jnp.asarray(w), tile=tile,
                                  use_kernel=False, **jkw)
    want_pallas = jops.plane_accum_q(jz, jz, jz, jnp.asarray(xq),
                                     jnp.asarray(s), jnp.asarray(w),
                                     tile=tile, use_kernel=True,
                                     interpret=True, **jkw)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = tops.plane_accum_q(*_t(z, z, z, xq, s), torch.from_numpy(w),
                             tile=tile, **tkw)
    # the plain version itself, on (1, n) buffers
    z2 = np.zeros((1, n), np.float32)
    got2 = tref.plane_accum_q_ref(
        *_t(z2, z2, z2, xq, s, w), tkw.get("masks"), tkw.get("mult"),
        tkw.get("base"), tile=tile)
    for g, g2, a, b in zip(got, got2, want_ref, want_pallas):
        _close(g, a)
        _close(g, b)
        _close(g2[0], a)


def test_dequantize_ref_matches_jax():
    xq, s, *_ = _chunk(4, 1000, 256, seed=3)
    want = jref.dequantize_ref(jnp.asarray(xq), jnp.asarray(s), tile=256)
    got = tref.dequantize_ref(*_t(xq, s), tile=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tq.dequantize(*_t(xq, s), tile=256).numpy())


def test_accum_q_pallas_2d_matches_plain():
    """``plane_accum_q_2d`` itself (the TPU kernel, interpret mode, on
    block-aligned operands) against the port's plain version."""
    K, n, tile = 2, 1024, 256
    xq, s, w, m, mu, base = _chunk(K, n, tile, seed=5)
    z = np.zeros((1, n), np.float32)
    jz = jnp.asarray(z)
    trip = jfk.plane_accum_q_2d(jz, jz, jz, jnp.asarray(xq), jnp.asarray(s),
                                jnp.asarray(w), jnp.asarray(m),
                                jnp.asarray(mu), tile=tile, block=512,
                                interpret=True)
    mine = tref.plane_accum_q_ref(*_t(z, z, z, xq, s, w, m, mu), tile=tile)
    for g, e in zip(mine, trip):
        _close(g, e)


def test_update_q_matches_update_on_dequantized_chunks():
    """``update_q`` (int8 chunks + scales) folds the same numbers as
    ``update`` on the dequantized f32 chunks, and its peak bytes do not
    depend on K (the streaming contract survives compression)."""
    n, tile, kc = 4096 * 3 + 101, 256, 2
    rng = np.random.default_rng(0)
    w_all = torch.from_numpy((rng.random(8) + 0.1).astype(np.float32))
    x_all = torch.from_numpy(rng.standard_normal((8, n)).astype(np.float32))
    peaks = {}
    for K in (4, 8):
        acc_q = tops.PlaneAccumulator(n, device="cpu", q_tile=tile)
        acc_f = tops.PlaneAccumulator(n, device="cpu")
        for lo in range(0, K, kc):
            xq, s = tq.quantize(x_all[lo:lo + kc], "int8", tile=tile)
            acc_q.update_q(xq, s, w_all[lo:lo + kc])
            acc_f.update(tq.dequantize(xq, s, tile=tile), w_all[lo:lo + kc])
        _close(acc_q.finish(), acc_f.finish())
        peaks[K] = acc_q.stats()["peak_bytes"]
    assert peaks[4] == peaks[8], "compressed peak bytes must not scale with K"
    nt = tq.n_tiles(n, tile)
    assert peaks[4] == 3 * 4 * n + kc * (n + 4 * nt)
    f32 = tops.PlaneAccumulator(n, device="cpu").update(x_all[:kc],
                                                        w_all[:kc])
    assert peaks[4] < f32.stats()["peak_bytes"]
    # the same accounting as the JAX package's, less its lane padding
    jacc = jops.PlaneAccumulator(n, use_kernel=False, k_hint=kc,
                                 q_tile=tile)
    xq, s = jq.quantize(jnp.asarray(x_all[:kc].numpy()), "int8", tile=tile)
    jacc.update_q(xq, s, jnp.asarray(w_all[:kc].numpy()))
    js = jacc.stats()
    assert js["chunk_bytes"] == kc * (js["padded"] + 4 * js["padded"] // tile)


def test_update_q_rejects_what_it_cannot_take():
    acc = tops.PlaneAccumulator(300, device="cpu", q_tile=128)
    with pytest.raises(ValueError, match="int8"):
        acc.update_q(torch.zeros(2, 300), torch.zeros(2, 3), torch.ones(2))
    with pytest.raises(AssertionError, match="q_tile"):
        tops.PlaneAccumulator(300, device="cpu").update_q(
            torch.zeros(2, 300, dtype=torch.int8), torch.zeros(2, 3),
            torch.ones(2))
    with pytest.raises(ValueError, match="128"):
        tops.PlaneAccumulator(300, device="cpu", q_tile=100)


@pytest.mark.parametrize("masks", [False, True])
def test_bf16_chunk_update_matches_jax(masks):
    """A bf16 chunk (the bf16 wire) through ``update`` as it is, against
    the JAX package's accumulator fed the same bf16 chunk; the chunk
    counts 2 bytes a coordinate."""
    n, K = 1000, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((K, n)).astype(np.float32)
    w = (rng.random(K) + 0.1).astype(np.float32)
    m = rng.integers(0, 2, (K, n)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jxb = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(xb.float().numpy(),
                                  np.asarray(jxb.astype(jnp.float32)))
    acc = tops.PlaneAccumulator(n, device="cpu")
    jacc = jops.PlaneAccumulator(n, use_kernel=False)
    for lo in (0, 2):
        mm = m[lo:lo + 2] if masks else None
        acc.update(xb[lo:lo + 2], torch.from_numpy(w[lo:lo + 2]),
                   masks=None if mm is None else torch.from_numpy(mm))
        jacc.update(jxb[lo:lo + 2], jnp.asarray(w[lo:lo + 2]),
                    masks=None if mm is None else jnp.asarray(mm))
    _close(acc.finish(renorm=masks), jacc.finish(renorm=masks))
    assert acc.stats()["chunk_bytes"] == 2 * n * (2 + 4 * masks)


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("shape", [(5, 384), (4, 3, 7, 11)])
def test_weighted_sum_masked_matches_jax(mult, renorm, shape):
    """The per-leaf coverage average on a ``(K, *shape)`` leaf: the
    port's plain version and op vs the JAX package's oracle and its
    Pallas ``weighted_sum_masked[_mult]_2d`` (interpret mode)."""
    rng = np.random.default_rng(len(shape) + mult + 2 * renorm)
    K = shape[0]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.random(K) + 0.1).astype(np.float32)
    w[0] = 0.0
    m = (rng.random(shape) < 0.5).astype(np.float32)
    m[..., :2] = 0.0                        # uncovered: renorm gives 0
    mu = (rng.integers(1, 4, shape) * m).astype(np.float32) if mult else None
    jmu = None if mu is None else jnp.asarray(mu)
    flat = (K, -1)
    want_ref = jref.weighted_sum_masked_ref(
        jnp.asarray(x).reshape(flat), jnp.asarray(w),
        jnp.asarray(m).reshape(flat),
        mult=None if jmu is None else jmu.reshape(flat), renorm=renorm)
    want_pallas = jops.weighted_sum_masked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(m), mult=jmu,
        block=128, interpret=True, renorm=renorm)
    tx, tw, tm, tmu = _t(x, w, m, mu)
    got_ref = tref.weighted_sum_masked_ref(
        tx.reshape(flat), tw, tm.reshape(flat),
        mult=None if tmu is None else tmu.reshape(flat), renorm=renorm)
    got = tops.weighted_sum_masked(tx, tw, tm, mult=tmu, renorm=renorm)
    assert tuple(got.shape) == shape[1:]
    _close(got_ref, want_ref)
    _close(got, want_pallas)
    _close(got.reshape(-1), want_ref)


@pytest.mark.parametrize("shape", [(3, 500), (6, 2, 3, 5)])
def test_weighted_sum_leaf_matches_jax(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.random(shape[0]) + 0.1).astype(np.float32)
    want = jops.weighted_sum(jnp.asarray(x), jnp.asarray(w), block=128,
                             interpret=True)
    got = tops.weighted_sum(*_t(x, w))
    assert tuple(got.shape) == shape[1:]
    _close(got, want)
