"""The port's flash attention vs the JAX package's, on the CPU.

  * ``flash_fwd_ref`` / ``flash_bwd_ref`` (the plain versions the CUDA
    kernels are held against on the card) vs ``repro``'s ``ref.py`` and
    vs ``repro``'s Pallas kernels in interpret mode — causal, GQA,
    sliding window, cross (non-causal, Sq != Sk), padded keys and query
    rows that see no key. Tolerance 1e-5 (the JAX package's own f32 bar,
    tests/test_flash.py); rows that see no key carry lse = -1e30 in both;
  * ``flash_attention`` (padding, transposes and the autograd Functions)
    vs ``repro``'s ``flash_attention``, values and gradients, at 1e-5;
  * ``vmap(grad)`` through the port's autograd Functions equals
    ``vmap(grad)`` through ``blockwise_attention``, and the vmap rule
    runs the plain forward and backward ONCE for all clients (the card's
    one launch per call).

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
from torch.func import grad, vmap  # noqa: E402

from repro.kernels.flash_attention import bwd as jbwd  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention import fwd as jfwd  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402

TOL = 1e-5

# name, (B, KV, G, Sq, Sk, hd), causal, window, positions, block_kv
KERNEL_CASES = [
    ("causal", (2, 2, 2, 16, 16, 8), True, 0, "iota", 16),
    ("gqa_multiblock", (1, 2, 4, 32, 32, 16), True, 0, "iota", 8),
    ("window", (1, 1, 2, 48, 48, 16), True, 8, "iota", 16),
    ("cross", (2, 2, 1, 24, 40, 8), False, 0, "iota", 8),
    ("padded", (1, 1, 2, 32, 32, 8), True, 0, "pad", 8),
    ("dead_rows", (1, 2, 2, 32, 32, 8), True, 0, "dead", 8),
]


def _positions(kind, Sq, Sk):
    qp = np.arange(Sq, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    if kind == "pad":
        qp[Sq - 7:] = -1
        kp[Sk - 7:] = -1
    elif kind == "dead":
        qp[4:12] = -1                    # rows that see no key at all
        kp[:2] = -1
    return qp, kp


def _kernel_inputs(dims, seed=0):
    B, KV, G, Sq, Sk, hd = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, KV, G, Sq, hd), f(B, Sk, KV, hd), f(B, Sk, KV, hd),
            f(B, KV, G, Sq, hd))


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=what)


@pytest.mark.parametrize("name,dims,causal,window,pos,bk", KERNEL_CASES)
def test_plain_versions_match_jax(name, dims, causal, window, pos, bk):
    q, k, v, dout = _kernel_inputs(dims)
    qp, kp = _positions(pos, dims[3], dims[4])
    kw = dict(causal=causal, window=window, block_kv=bk)
    jout, jlse = jref.flash_fwd_ref(q, k, v, qp, kp, **kw)
    jgrads = jref.flash_bwd_ref(q, k, v, qp, kp, jout, jlse, dout, **kw)
    tq, tk, tv, tdo, tqp, tkp = _t(q, k, v, dout, qp, kp)
    tout, tlse = tref.flash_fwd_ref(tq, tk, tv, tqp, tkp, **kw)
    tgrads = tref.flash_bwd_ref(tq, tk, tv, tqp, tkp, tout, tlse, tdo, **kw)
    _close(tout, jout, f"{name}: out")
    _close(tlse, jlse, f"{name}: lse")
    for nm, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        _close(a, b, f"{name}: {nm}")
    if pos == "dead":
        # the finite NEG_INF convention: such rows average v, lse -1e30
        assert np.all(tlse.numpy()[..., 4:12] <= -1e29)
        np.testing.assert_allclose(
            tout.numpy()[..., 4:12, :],
            np.broadcast_to(v.mean(axis=1)[:, :, None, None, :],
                            tout.numpy()[..., 4:12, :].shape),
            atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,dims,causal,window,pos,bk", KERNEL_CASES)
def test_plain_versions_match_pallas_interpret(name, dims, causal, window,
                                               pos, bk):
    q, k, v, dout = _kernel_inputs(dims, seed=1)
    qp, kp = _positions(pos, dims[3], dims[4])
    bq = 8
    kw = dict(causal=causal, window=window, block_q=bq, block_kv=bk,
              interpret=True)
    jout, jlse = jfwd.flash_fwd(q, k, v, qp, kp, **kw)
    delta = (dout * np.asarray(jout)).sum(-1)
    jgrads = jbwd.flash_bwd(q, k, v, qp, kp, jlse, delta, dout, **kw)
    tq, tk, tv, tdo, tqp, tkp = _t(q, k, v, dout, qp, kp)
    rkw = dict(causal=causal, window=window, block_kv=bk)
    tout, tlse = tref.flash_fwd_ref(tq, tk, tv, tqp, tkp, **rkw)
    tgrads = tref.flash_bwd_ref(tq, tk, tv, tqp, tkp, tout, tlse, tdo, **rkw)
    _close(tout, jout, f"{name}: out")
    _close(tlse, jlse, f"{name}: lse")
    for nm, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        _close(a, b, f"{name}: {nm}")


# name, (B, Sq, Sk, KV, G, hd), causal, window, (block_q, block_kv)
OP_CASES = [
    ("causal", (2, 16, 16, 2, 2, 8), True, 0, (16, 16)),
    ("window", (1, 48, 48, 1, 2, 16), True, 8, (16, 16)),
    ("cross", (2, 24, 40, 2, 1, 8), False, 0, (24, 40)),
    ("multiblock_ragged", (1, 40, 40, 1, 1, 8), True, 12, (16, 16)),
]


def _op_inputs(dims, seed=0):
    B, Sq, Sk, KV, G, hd = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, Sq, KV, G, hd), f(B, Sk, KV, hd), f(B, Sk, KV, hd),
            f(B, Sq, KV * G, hd))


@pytest.mark.parametrize("name,dims,causal,window,blocks", OP_CASES)
def test_flash_attention_op_matches_jax(name, dims, causal, window, blocks):
    q, k, v, cot = _op_inputs(dims)
    Sq, Sk = dims[1], dims[2]
    bq, bk = blocks
    qp, kp = np.arange(Sq), np.arange(Sk)

    def jloss(q, k, v):
        out = jflash(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                     causal=causal, window=window, block_q=bq, block_kv=bk,
                     use_kernel=False)
        return (out * cot).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv, tcot = [t.requires_grad_() for t in _t(q, k, v)] + _t(cot)
    tout = flash_attention(tq, tk, tv, torch.from_numpy(qp),
                           torch.from_numpy(kp), causal=causal,
                           window=window, block_q=bq, block_kv=bk)
    (tout * tcot).sum().backward()
    _close(tout.detach(), jout, f"{name}: out")
    for nm, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        _close(a, b, f"{name}: d{nm}")


@pytest.mark.parametrize("name,dims,causal,window,blocks", OP_CASES)
def test_vmap_grad_flash_equals_blockwise(name, dims, causal, window,
                                          blocks):
    n = 3
    per = [_op_inputs(dims, seed=s) for s in range(n)]
    q, k, v, cot = (torch.from_numpy(np.stack([p[i] for p in per]))
                    for i in range(4))
    qp = torch.arange(dims[1])
    kp = torch.arange(dims[2])
    bq, bk = blocks

    def loss(fn):
        def f(q, k, v, c):
            return (fn(q, k, v, qp, kp, causal=causal, window=window,
                       block_q=bq, block_kv=bk) * c).sum()
        return f

    fg = vmap(grad(loss(flash_attention), argnums=(0, 1, 2)))(q, k, v, cot)
    bg = vmap(grad(loss(blockwise_attention), argnums=(0, 1, 2)))(q, k, v,
                                                                  cot)
    for nm, a, b in zip("qkv", fg, bg):
        _close(a, b, f"{name}: d{nm}")


def test_vmap_rule_runs_once_for_all_clients(monkeypatch):
    """The vmap rule folds the client axis into B: one forward and one
    backward call per ``vmap(grad)`` call, at batch n·B."""
    calls = []

    def counted(fn, tag):
        def wrapped(q, *a, **kw):
            calls.append((tag, tuple(q.shape)))
            return fn(q, *a, **kw)
        return wrapped

    monkeypatch.setattr(tref, "flash_fwd_ref",
                        counted(tref.flash_fwd_ref, "fwd"))
    monkeypatch.setattr(tref, "flash_bwd_ref",
                        counted(tref.flash_bwd_ref, "bwd"))
    n, B, S, KV, G, hd = 4, 2, 16, 2, 2, 8
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((n, B, S, KV, G, hd))
                         .astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((n, B, S, KV, hd))
                          .astype(np.float32))
    pos = torch.arange(S)

    def f(q, k):
        return flash_attention(q, k, k, pos, pos, block_q=8,
                               block_kv=8).square().sum()

    vmap(grad(f, argnums=(0, 1)))(q, kv)
    assert calls == [("fwd", (n * B, KV, G, S, hd)),
                     ("bwd", (n * B, KV, G, S, hd))]
