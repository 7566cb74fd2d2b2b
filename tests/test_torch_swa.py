"""The port's sliding-window serving attention vs the JAX package's, on the
CPU: the plain versions (``kernels/swa_attention/ref.py``) and the CPU
dispatch of ``ops.decode_attention`` / ``ops.swa_prefill`` against
``repro.kernels.swa_attention.ref`` and the Pallas kernels in interpret
mode, at the shapes of the JAX package's ``tests/test_kernels.py``.

Inputs come from a numpy seed and are rounded to bf16 the same way in
both packages. Tolerances are the JAX tests': f32 1e-5 (the same f32
einsums and softmax summed in another order); bf16 2e-2 (decode) and
3e-2 (prefill), held in f32 against the f32 math of the bf16 operands
(the Pallas kernels round their probabilities to bf16 before p @ v).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attention import ops as jops  # noqa: E402
from repro.kernels.swa_attention import ref as jref  # noqa: E402
from repro.kernels.swa_attention.prefill import swa_prefill as jprefill  # noqa: E402
from repro.models.attention import decode_attention as jmodel_decode  # noqa: E402
from repro.models.attention import ring_positions as jring  # noqa: E402
from repro_torch.kernels.swa_attention import ops, ref  # noqa: E402
from repro_torch.kernels.swa_attention import swa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}


def _arrays(seed, *shapes, dtype="float32"):
    """numpy f32 normals, the same values as jnp and torch arrays of
    ``dtype`` (bf16 rounded identically in both)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    js = [jnp.asarray(x, dtype=jnp.dtype(dtype)) for x in xs]
    ts = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    return js, ts


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,KV,hd,S", [(1, 4, 1, 64, 256),
                                         (2, 8, 2, 32, 384),
                                         (3, 6, 6, 128, 128)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(B, H, KV, hd, S, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        B * S + window, (B, H, hd), (B, S, KV, hd), (B, S, KV, hd),
        dtype=dtype)
    pos = S - 10
    want_ref = jref.decode_ref(jq.reshape(B, KV, H // KV, hd), jk, jv,
                               jnp.arange(S), jnp.int32(pos), window=window)
    want_kernel = jops.decode_attention(jq, jk, jv, jnp.arange(S),
                                        jnp.int32(pos), window=window,
                                        block_s=128)
    got_ref = ref.decode_ref(tq.reshape(B, KV, H // KV, hd), tk, tv,
                             torch.arange(S), pos, window=window)
    got = ops.decode_attention(tq, tk, tv, torch.arange(S), pos,
                               window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    _close(got_ref, want_ref, 1e-5)
    _close(got, want_kernel, TOL[dtype][0])
    _close(got, got_ref.reshape(B, H, hd), 0)


def test_decode_ring_cache_positions():
    """Ring caches (slot = pos % W): unwritten slots (< 0) are masked."""
    B, H, KV, hd, W = 1, 2, 1, 32, 128
    pos = 37                                # ring only partly written
    key_pos = tattn.ring_positions(pos, W)
    np.testing.assert_array_equal(key_pos.numpy(),
                                  np.asarray(jring(jnp.int32(pos), W)))
    assert int((key_pos >= 0).sum()) == 38
    (jq, jk, jv), (tq, tk, tv) = _arrays(3, (B, H, hd), (B, W, KV, hd),
                                         (B, W, KV, hd))
    jkp = jnp.asarray(key_pos.numpy(), jnp.int32)
    want = jops.decode_attention(jq, jk, jv, jkp, jnp.int32(pos), window=W,
                                 block_s=64)
    got = ops.decode_attention(tq, tk, tv, key_pos, pos, window=W)
    _close(got, want, 1e-5)
    # and after the ring wrapped: every slot written, the oldest W-1 back
    pos = 3 * W + 5
    key_pos = tattn.ring_positions(pos, W)
    np.testing.assert_array_equal(key_pos.numpy(),
                                  np.asarray(jring(jnp.int32(pos), W)))
    assert int(key_pos.min()) == pos - W + 1 and int(key_pos[5]) == pos
    want = jref.decode_ref(jq.reshape(B, KV, H, hd), jk, jv,
                           jnp.asarray(key_pos.numpy()), jnp.int32(pos),
                           window=W)
    got = ops.decode_attention(tq, tk, tv, key_pos, pos, window=W)
    _close(got, np.asarray(want).reshape(B, H, hd), 1e-5)


def test_decode_row_with_no_visible_slot():
    """q_pos before every written slot: no slot is visible, and the
    reference's finite NEG_INF gives the mean of v over the whole cache
    (neither NaN nor 0)."""
    B, H, KV, hd, S = 2, 4, 2, 16, 96
    (jq, jk, jv), (tq, tk, tv) = _arrays(5, (B, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd))
    kp = np.arange(S, dtype=np.int32) + 50
    kp[:7] = -1
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(kp), jnp.int32(40),
                                 window=0, block_s=32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(kp), 40)
    _close(got, want, 1e-5)
    mean_v = tv.float().mean(dim=1)                       # (B, KV, hd)
    _close(got.reshape(B, KV, H // KV, hd),
           mean_v[:, :, None].expand(B, KV, H // KV, hd), 1e-5)


def test_decode_matches_model_decode_attention():
    """The ops entry == the model's plain einsum decode, in both packages
    (JAX ``tests/test_kernels.py`` ``test_swa_kernel_vs_model_...``)."""
    B, H, KV, hd, S = 2, 8, 4, 64, 256
    (jq, jk, jv), (tq, tk, tv) = _arrays(6, (B, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd))
    want = jmodel_decode(jq, jk, jv, jnp.arange(S), jnp.int32(S - 1),
                         window=128)
    got_model = tattn.decode_attention(tq, tk, tv, torch.arange(S), S - 1,
                                       window=128)
    got = ops.decode_attention(tq, tk, tv, torch.arange(S), S - 1,
                               window=128)
    _close(got_model, want, 1e-5)
    _close(got, got_model, 1e-4)


@pytest.mark.parametrize("B,KV,G,S,hd,win,bq,bk",
                         [(1, 2, 2, 256, 32, 64, 64, 64),
                          (2, 1, 4, 512, 64, 128, 128, 64),
                          (1, 2, 1, 256, 32, 0, 64, 64),   # full causal
                          (1, 1, 2, 128, 16, 16, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(B, KV, G, S, hd, win, bq, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        S + win, (B, KV, G, S, hd), (B, S, KV, hd), (B, S, KV, hd),
        dtype=dtype)
    want_ref = jref.prefill_ref(jq, jk, jv, window=win)
    want_kernel = jprefill(jq, jk, jv, window=win, block_q=bq, block_kv=bk)
    got_ref = ref.prefill_ref(tq, tk, tv, window=win)
    got = ops.swa_prefill(tq, tk, tv, window=win, block_q=bq, block_kv=bk)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _close(got_ref, want_ref, 1e-5)
    _close(got, want_kernel, TOL[dtype][1])


def test_prefill_odd_length_and_bidirectional():
    """Any S (the TPU's S % block assert is a tiling limit), and
    causal=False with window=0, full bidirectional attention as the JAX
    oracle defines it (its Pallas kernel differs there: see below)."""
    S, hd = 77, 16
    (jq, jk, jv), (tq, tk, tv) = _arrays(8, (1, 2, 2, S, hd),
                                         (1, S, 2, hd), (1, S, 2, hd))
    _close(ops.swa_prefill(tq, tk, tv, window=20),
           jref.prefill_ref(jq, jk, jv, window=20), 1e-5)
    (jq, jk, jv), (tq, tk, tv) = _arrays(9, (1, 2, 2, 128, hd),
                                         (1, 128, 2, hd), (1, 128, 2, hd))
    _close(ops.swa_prefill(tq, tk, tv, window=0, causal=False),
           jref.prefill_ref(jq, jk, jv, window=0, causal=False), 1e-5)


def test_noncausal_window_raises_and_the_reference_gap():
    """causal=False with window > 0 is refused: the JAX package's Pallas
    kernel and its oracle compute two different functions there (the
    kernel's band stops at each q block's end, and the oracle admits
    every later key). Recorded here so the reason stays visible: they
    agree with causal=True and disagree with causal=False — with
    window=0 as well, where the port follows the oracle's full
    bidirectional attention."""
    S, hd, win, blk = 128, 16, 32, 32
    (jq, jk, jv), (tq, tk, tv) = _arrays(10, (1, 1, 1, S, hd),
                                         (1, S, 1, hd), (1, S, 1, hd))
    gap = {}
    for causal in (True, False):
        for w in (win, 0):
            k_out = jprefill(jq, jk, jv, window=w, causal=causal,
                             block_q=blk, block_kv=blk)
            r_out = jref.prefill_ref(jq, jk, jv, window=w, causal=causal)
            gap[causal, w] = float(jnp.abs(k_out - r_out).max())
    assert gap[True, win] < 1e-5 and gap[True, 0] < 1e-5, gap
    assert gap[False, win] > 0.1 and gap[False, 0] > 0.1, gap
    with pytest.raises(ValueError, match="not defined"):
        ops.swa_prefill(tq, tk, tv, window=win, causal=False)
    with pytest.raises(ValueError, match="not defined"):
        ops.swa_prefill(tq, tk, tv, window=win, causal=False,
                        use_kernel=False)
    with pytest.raises(ValueError, match="window=0"):
        swa.swa_prefill(tq, tk, tv, window=win, causal=False)


def test_decode_split_covers_the_cache():
    """The kernel's cut of S: every slot in exactly one block of the
    cluster, no block without one, groups a multiple of 16 slots, at
    most 16 blocks a cluster."""
    for B, KV, G, S in [(4, 16, 2, 1024), (4, 16, 2, 4128), (1, 8, 2, 16384),
                        (1, 1, 1, 1), (3, 6, 1, 129), (2, 2, 16, 1000)]:
        n = swa.decode_split(B, KV, G, S, 132, 128)  # H100 SXM's SMs, hd 128
        assert swa.DECODE_KEYS_PER_STEP % 16 == 0
        assert 1 <= n <= swa.DECODE_CLUSTER_MAX
        blocks = swa.decode_slots(S, n)
        assert all(blocks)
        assert sorted(s for b in blocks for s in b) == list(range(S))
    assert [swa.group_chunk(g, 128) for g in (1, 2, 3, 4, 5, 16)] == \
        [1, 2, 4, 4, 8, 8]
