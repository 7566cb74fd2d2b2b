"""The numeric policy of the CUDA flash backward, rehearsed on the CPU.

The card's ``flash_bwd_dq`` / ``flash_bwd_dkv`` run every product on the
tensor cores at f32 accuracy by splitting each f32 operand ``x`` into
``big = tf32(x)`` and ``small = tf32(x - big)`` (``cvt.rna.tf32.f32``:
round to nearest, ties away from zero, 10 mantissa bits kept) and taking
``a b`` as ``small.big + big.small + big.big`` with f32 accumulation
("3xTF32"). This file emulates that arithmetic in PyTorch on the CPU:

  * the rounding, on the f32 bit pattern, and the split's reconstruction
    (``big + small`` within 2^-22 of ``x``, relative);
  * the plain backward (``ref.flash_bwd_ref``'s math) with every product
    replaced by the split, against the f32 plain versions of both
    packages, within the card tests' 2e-5 x the largest finite |value|:
    causal, sliding window and query rows that see no key, at hd 128,
    S 256, G 4. A product of two TF32 values is exact in f32, so the
    emulation differs from the card only in the order of its f32 sums
    (the kernels add each step's part, nine tensor-core products, in
    f32: the tensor cores' own accumulation cuts instead of rounding);
  * one TF32 product without the split misses that tolerance on the
    same inputs: the split is what makes the tensor cores usable here.

Inputs come from a numpy seed and go to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

TOL = 2e-5                       # x the largest finite |value|, card tests
NEG_INF = tref.NEG_INF


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 of the 23 mantissa bits, rounding to
    nearest with ties away from zero. Adding half a TF32 ulp to the
    magnitude bits (the sign bit is apart in the f32 pattern) and clearing
    the 13 dropped bits does exactly that."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernels take it: small.big + big.small
    + big.big, in that order, each in f32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    out = torch.einsum(eq, as_, bb)
    out = out + torch.einsum(eq, ab, bs)
    return out + torch.einsum(eq, ab, bb)


def mm1(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, no split."""
    return torch.einsum(eq, tf32(a), tf32(b))


def emulated_bwd(q, k, v, q_pos, kv_pos, lse, dout, out, *, causal, window,
                 mm=mm3):
    """``ref.flash_bwd_ref``'s math in one key block with every product
    taken through ``mm``; the element-wise steps are the kernels' f32,
    and, as in the kernels, the scale multiplies s, dq and dk after the
    products instead of q before them."""
    scale = q.shape[-1] ** -0.5
    delta = (dout * out).sum(-1)
    mask = tref._block_mask(q_pos, kv_pos, causal, window)[None, None, None]
    s = mm("bkgqd,bskd->bkgqs", q, k) * scale
    p = torch.exp(torch.where(mask, s, torch.full_like(s, NEG_INF))
                  - lse[..., None])
    dp = mm("bkgqd,bskd->bkgqs", dout, v)
    ds = p * (dp - delta[..., None])
    dq = mm("bkgqs,bskd->bkgqd", ds, k) * scale
    dk = mm("bkgqs,bkgqd->bskd", ds, q) * scale
    dv = mm("bkgqs,bkgqd->bskd", p, dout)
    return dq, dk, dv


def _scale(t: torch.Tensor) -> float:
    finite = t.abs()[t.abs() < 1e29]
    return max(1.0, float(finite.max())) if finite.numel() else 1.0


def _err(got, want) -> float:
    return float((got - want).abs().max()) / _scale(want)


# name, (B, KV, G, S, hd), causal, window, positions
CASES = [
    ("causal", (1, 2, 4, 256, 128), True, 0, "iota"),
    ("window", (1, 2, 4, 256, 128), True, 48, "iota"),
    ("dead_rows", (1, 2, 4, 256, 128), True, 0, "dead"),
]


def _inputs(dims, pos, seed):
    B, KV, G, S, hd = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, dout = (f(B, KV, G, S, hd), f(B, S, KV, hd), f(B, S, KV, hd),
                     f(B, KV, G, S, hd))
    qp = np.arange(S, dtype=np.int32)
    kp = np.arange(S, dtype=np.int32)
    if pos == "dead":
        qp[40:72] = -1                   # query rows that see no key
        kp[:3] = -1
    return q, k, v, dout, qp, kp


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                 # TF32's ulp at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + one_ulp / 2 - 2 ** -20, 1 + 3 * one_ulp / 2,
                      0.0, -0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0,
                         1 + 2 * one_ulp, 0.0, -0.0, 3.0])
    got = tf32(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert int((got.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_split_reconstructs_f32():
    rng = np.random.default_rng(0)
    mant = rng.standard_normal(200_000).astype(np.float32)
    expo = rng.integers(-60, 60, size=mant.shape).astype(np.float32)
    x = torch.from_numpy(mant * np.exp2(expo).astype(np.float32))
    big, small = split(x)
    for part in (big, small):            # both are TF32 values
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs().clamp_min(1e-300))
    assert float(rel.max()) <= 2.0 ** -22
    # the product of two TF32 values is exact in f32
    a, b = big[:1000], big[1000:2000]
    assert torch.equal((a * b).double(), a.double() * b.double())


@pytest.mark.parametrize("name,dims,causal,window,pos", CASES)
def test_split_backward_matches_f32(name, dims, causal, window, pos):
    q, k, v, dout, qp, kp = _inputs(dims, pos, seed=7)
    kw = dict(causal=causal, window=window)
    S = dims[3]
    jout, jlse = jref.flash_fwd_ref(q, k, v, qp, kp, block_kv=S, **kw)
    jgrads = jref.flash_bwd_ref(q, k, v, qp, kp, jout, jlse, dout,
                                block_kv=S, **kw)
    t = [torch.from_numpy(np.asarray(a)) for a in (q, k, v, dout, qp, kp)]
    tq, tk, tv, tdo, tqp, tkp = t
    tout, tlse = tref.flash_fwd_ref(tq, tk, tv, tqp, tkp, block_kv=S, **kw)
    plain = tref.flash_bwd_ref(tq, tk, tv, tqp, tkp, tout, tlse, tdo,
                               block_kv=S, **kw)
    got = emulated_bwd(tq, tk, tv, tqp, tkp, tlse, tdo, tout, **kw)
    for what, g, p, j in zip(("dq", "dk", "dv"), got, plain, jgrads):
        assert torch.isfinite(g).all(), f"{name} {what}"
        assert _err(g, p) <= TOL, f"{name} {what} vs port: {_err(g, p)}"
        jt = torch.from_numpy(np.array(j))
        assert _err(g, jt) <= TOL, f"{name} {what} vs JAX: {_err(g, jt)}"
    if pos == "dead":                    # p = 1 on every key of such rows
        assert bool((tlse[..., 40:72] <= -1e29).all())


def test_single_tf32_product_misses_the_tolerance():
    name, dims, causal, window, pos = CASES[0]
    q, k, v, dout, qp, kp = [torch.from_numpy(np.asarray(a))
                             for a in _inputs(dims, pos, seed=7)]
    kw = dict(causal=causal, window=window)
    out, lse = tref.flash_fwd_ref(q, k, v, qp, kp, block_kv=dims[3], **kw)
    plain = tref.flash_bwd_ref(q, k, v, qp, kp, out, lse, dout,
                               block_kv=dims[3], **kw)
    one = emulated_bwd(q, k, v, qp, kp, lse, dout, out, mm=mm1, **kw)
    assert max(_err(g, p) for g, p in zip(one, plain)) > TOL
