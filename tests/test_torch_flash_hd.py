"""The port's attention at head dims 8 and 256 vs the JAX package's, on the
CPU: the plain versions the CUDA kernels are held against on the card
(``kernels/flash_attention/ref.py``, ``kernels/swa_attention/ref.py``)
and ``flash_attention(..., use_kernel=False)``, values and gradients,
against ``repro``'s refs and its Pallas kernels in interpret mode.

hd 256 is gemma-7b's (and recurrentgemma-9b's local layers'); hd 8 is
every reduced config whose ``d_model // n_heads`` is below 8 and
``tests/test_flash.py``'s. Tolerances are ``tests/test_flash.py``'s: f32
1e-5 (the same f32 einsums summed in another order), bf16 inputs 1e-2
(both backends accumulate in f32 from the same bf16 values); the swa
plain versions against the JAX refs at 1e-5 in f32 and bf16 alike (the
same math on the same widened operands).

Inputs come from a numpy seed and go to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import bwd as jbwd  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention import fwd as jfwd  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.swa_attention import ref as jsref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.kernels.swa_attention import ops as sops  # noqa: E402
from repro_torch.kernels.swa_attention import ref as tsref  # noqa: E402

F32_TOL = 1e-5       # tests/test_flash.py, f32
BF16_TOL = 1e-2      # tests/test_flash.py, bf16 inputs

# name, (B, KV, G, Sq, Sk, hd), causal, window, positions, block_kv
KERNEL_CASES = [
    (f"{name}_hd{hd}", dims + (hd,), causal, window, pos, bk)
    for hd in (8, 256)
    for name, dims, causal, window, pos, bk in [
        ("causal", (2, 2, 2, 16, 16), True, 0, "iota", 16),
        ("gqa", (1, 2, 4, 24, 24), True, 0, "iota", 8),
        ("window", (1, 1, 2, 48, 48), True, 8, "iota", 16),
        ("cross", (1, 2, 1, 16, 24), False, 0, "iota", 8),
        ("dead_rows", (1, 1, 2, 24, 24), True, 0, "dead", 8),
    ]]


def _positions(kind, Sq, Sk):
    qp = np.arange(Sq, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    if kind == "dead":
        qp[4:12] = -1                    # rows that see no key at all
        kp[:2] = -1
    return qp, kp


def _normals(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _close(got, want, what, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["jax-ref", "pallas-interpret"])
@pytest.mark.parametrize("name,dims,causal,window,pos,bk", KERNEL_CASES)
def test_plain_flash_matches_jax(name, dims, causal, window, pos, bk,
                                 interpret):
    B, KV, G, Sq, Sk, hd = dims
    q, k, v, dout = _normals(hd + Sq, (B, KV, G, Sq, hd), (B, Sk, KV, hd),
                             (B, Sk, KV, hd), (B, KV, G, Sq, hd))
    qp, kp = _positions(pos, Sq, Sk)
    kw = dict(causal=causal, window=window, block_kv=bk)
    if interpret:
        jout, jlse = jfwd.flash_fwd(q, k, v, qp, kp, block_q=8,
                                    interpret=True, **kw)
        delta = (dout * np.asarray(jout)).sum(-1)
        jgrads = jbwd.flash_bwd(q, k, v, qp, kp, jlse, delta, dout,
                                block_q=8, interpret=True, **kw)
    else:
        jout, jlse = jref.flash_fwd_ref(q, k, v, qp, kp, **kw)
        jgrads = jref.flash_bwd_ref(q, k, v, qp, kp, jout, jlse, dout, **kw)
    tq, tk, tv, tdo, tqp, tkp = _t(q, k, v, dout, qp, kp)
    tout, tlse = tref.flash_fwd_ref(tq, tk, tv, tqp, tkp, **kw)
    tgrads = tref.flash_bwd_ref(tq, tk, tv, tqp, tkp, tout, tlse, tdo, **kw)
    _close(tout, jout, f"{name}: out")
    _close(tlse, jlse, f"{name}: lse")
    for nm, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        _close(a, b, f"{name}: {nm}")


# name, (B, Sq, Sk, KV, G, hd), causal, window, (block_q, block_kv), dtype
OP_CASES = [
    (f"{name}_hd{hd}_{dt}", dims + (hd,), causal, window, blocks, dt)
    for hd in (8, 256)
    for dt in ("float32", "bfloat16")
    for name, dims, causal, window, blocks in [
        ("causal", (2, 16, 16, 2, 2), True, 0, (16, 16)),
        ("window", (1, 40, 40, 1, 2), True, 8, (16, 16)),
        ("cross", (1, 16, 24, 2, 1), False, 0, (16, 24)),
    ]]


@pytest.mark.parametrize("name,dims,causal,window,blocks,dtype", OP_CASES)
def test_flash_attention_op_matches_jax(name, dims, causal, window, blocks,
                                        dtype):
    """``flash_attention`` with the plain versions, values and gradients,
    vs ``repro``'s (its ref, ``use_kernel=False``)."""
    B, Sq, Sk, KV, G, hd = dims
    q, k, v, cot = _normals(7, (B, Sq, KV, G, hd), (B, Sk, KV, hd),
                            (B, Sk, KV, hd), (B, Sq, KV * G, hd))
    bq, bk = blocks
    qp, kp = np.arange(Sq), np.arange(Sk)
    jdt = jnp.dtype(dtype)

    def jloss(q, k, v):
        out = jflash(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                     causal=causal, window=window, block_q=bq, block_kv=bk,
                     use_kernel=False)
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (t.to(tdt).requires_grad_() for t in _t(q, k, v))
    tout = flash_attention(tq, tk, tv, torch.from_numpy(qp),
                           torch.from_numpy(kp), causal=causal,
                           window=window, block_q=bq, block_kv=bk,
                           use_kernel=False)
    assert tout.dtype == tdt
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(tout.detach().float(), jout, f"{name}: out", tol)
    for nm, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        _close(a.float(), b, f"{name}: d{nm}", tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [8, 256])
@pytest.mark.parametrize("B,KV,G,S,win", [(1, 2, 2, 40, 16),
                                          (1, 1, 4, 33, 0)])
def test_plain_swa_matches_jax(B, KV, G, S, win, hd, dtype):
    """The swa plain versions (prefill and decode, with MQA and a ring
    cache whose slots are partly unwritten) vs the JAX refs."""
    q, k, v, qd = _normals(hd + S, (B, KV, G, S, hd), (B, S, KV, hd),
                           (B, S, KV, hd), (B, KV, G, hd))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv, jqd = (jnp.asarray(x, jdt) for x in (q, k, v, qd))
    tq, tk, tv, tqd = (t.to(tdt) for t in _t(q, k, v, qd))
    _close(tsref.prefill_ref(tq, tk, tv, window=win),
           jsref.prefill_ref(jq, jk, jv, window=win), "prefill")
    kp = np.arange(S, dtype=np.int32)
    kp[-3:] = -1
    pos = S - 5
    _close(tsref.decode_ref(tqd, tk, tv, torch.from_numpy(kp), pos,
                            window=win),
           jsref.decode_ref(jqd, jk, jv, jnp.asarray(kp), jnp.int32(pos),
                            window=win), "decode")
    # the CPU dispatch of the entry points is the plain version
    _close(sops.swa_prefill(tq, tk, tv, window=win),
           tsref.prefill_ref(tq, tk, tv, window=win), "ops.swa_prefill", 0)


def test_decode_plan_follows_the_head_dim():
    """``swa.group_chunk`` / ``decode_split`` take the head dim and plan
    as many clusters as ``swa_attention.cu`` launches: a cluster serves
    at most ``kMaxGroup<HD>`` query heads (4 at hd 256, where a lane
    holds 8 columns, else 8). The Python mirror is read against the C
    source's constant; each plan covers the cache once."""
    import re
    from pathlib import Path

    from repro_torch.kernels.swa_attention import swa

    src = (Path(swa.__file__).parents[1] / "csrc" /
           "swa_attention.cu").read_text()
    m = re.search(r"kMaxGroup = HD > (\d+) \? (\d+) : (\d+);", src)
    assert m, "kMaxGroup<HD> not found in swa_attention.cu"
    edge, wide, narrow = map(int, m.groups())
    for hd in (8, 128, 256):
        cap = wide if hd > edge else narrow
        assert [swa.group_chunk(g, hd) for g in (1, 2, 3, 4, 5, 16)] == \
            [1, 2, 4, 4, min(8, cap), cap]
    with pytest.raises(TypeError):
        swa.group_chunk(16)              # no default head dim
    # gemma-7b's serve decode (16 kv heads, G = 1) and recurrentgemma-9b's
    # local MQA (1 kv head of 16 query heads) at hd 256, on 132 SMs
    for B, KV, G, S in [(4, 16, 1, 4128), (4, 1, 16, 4128), (1, 1, 16, 300)]:
        n = swa.decode_split(B, KV, G, S, 132, 256)
        rows = B * KV * -(-G // swa.group_chunk(G, 256))
        cap = (swa.DECODE_CLUSTER_MAX if rows * swa.DECODE_CLUSTER < 132
               else swa.DECODE_CLUSTER)
        assert n == max(1, min(cap, -(-swa.DECODE_BLOCKS_PER_SM * 132
                                       // rows),
                               -(-S // swa.DECODE_KEYS_PER_STEP)))
        blocks = swa.decode_slots(S, n)
        assert all(blocks)
        assert sorted(s for b in blocks for s in b) == list(range(S))
    # MQA of 16 heads takes 4 clusters per kv head at hd 256, twice hd
    # 128's 2: at B = 8 that is 32 clusters of 8 blocks against 16 of 16
    assert swa.decode_split(8, 1, 16, 4128, 132, 256) == 8
    assert swa.decode_split(8, 1, 16, 4128, 132, 128) == 16
