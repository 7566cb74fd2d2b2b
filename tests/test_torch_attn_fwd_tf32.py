"""The numeric policy of the CUDA attention forwards, rehearsed on the CPU.

The card's ``flash_fwd`` and ``swa_prefill`` (``csrc/attn_fwd.cuh``) run
every product on the tensor cores at f32 accuracy as split TF32
("3xTF32": ``small.big + big.small + big.big``, the emulation of
``tests/test_torch_flash_tf32.py``). This file emulates their forward
as the kernels take it:

  * q scaled as it lands; keys in steps of ``STEP`` (the kernels' 48), a
    ragged last step zero-filled with its missing keys scored -inf;
  * per step, the scores through the split product, the masks
    (NEG_INF = -1e30, the reference's convention), the online softmax in
    f32 (running max, correction ``exp(m_old - m_new)``, row sum; the
    kernels take exp as the card's ``__expf``, the emulation as
    ``torch.exp``, and the card tests hold that difference), and
    ``p v`` through the split product into a zeroed part that is added
    to ``o * corr`` in f32;
  * ``out = o / max(l, 1e-30)``, ``lse = m + log(max(l, 1e-30))``;
  * for the banded prefill, 128-query blocks that visit only the steps
    of their band, as ``swa_prefill_kernel`` does.

The emulated forward is held against the f32 plain versions of both
packages within the card tests' 2e-5 x the largest finite |value|:
causal, a window, query rows that see no key (whose lse must be exactly
the reference's), and Sk off the step, at hd 128, S <= 256, G 4; the
emulated prefill against both packages' ``prefill_ref``, f32 and bf16,
causal with a window. One TF32 product without the split misses that
tolerance on the same inputs. Inputs come from a numpy seed and go to
both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.swa_attention import ref as jsref  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.kernels.swa_attention import ref as tsref  # noqa: E402
from test_torch_flash_tf32 import mm1, mm3  # noqa: E402

TOL = 2e-5                       # x the largest finite |value|, card tests
NEG_INF = tref.NEG_INF
STEP = 48                        # keys a step (attn_fwd.cuh kFwdStep)
ROWS = 128                       # queries a block (kFwdRows)


def emulated_fwd(q, k, v, q_pos, kv_pos, *, causal, window, mm=mm3,
                 steps=None):
    """``flash_fwd`` as the kernel computes it; ``steps`` (the key steps
    to visit, default all) stands for a block's band. Returns (out,
    lse)."""
    B, KV, G, Sq, hd = q.shape
    Sk = k.shape[1]
    qf = q.float() * hd ** -0.5
    m = torch.full((B, KV, G, Sq), NEG_INF)
    l = torch.zeros(B, KV, G, Sq)
    o = torch.zeros(B, KV, G, Sq, hd)
    n_steps = -(-Sk // STEP)
    for j in (range(n_steps) if steps is None else steps):
        lo, hi = j * STEP, min(Sk, (j + 1) * STEP)
        kb = torch.zeros(B, STEP, KV, hd)
        vb = torch.zeros(B, STEP, KV, hd)
        kb[:, :hi - lo] = k[:, lo:hi].float()
        vb[:, :hi - lo] = v[:, lo:hi].float()
        kp = torch.full((STEP,), -1, dtype=torch.int32)
        kp[:hi - lo] = kv_pos[lo:hi]
        s = mm("bkgqd,bskd->bkgqs", qf, kb)
        mask = tref._block_mask(q_pos, kp, causal, window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        s[..., hi - lo:] = -torch.inf            # keys past Sk
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        part = mm("bkgqs,bskd->bkgqd", p, vb)
        o = o * corr[..., None] + part
        m = m_new
    ls = torch.clamp(l, min=1e-30)
    return o / ls[..., None], m + torch.log(ls)


def emulated_prefill(q, k, v, *, window, causal=True, mm=mm3):
    """``swa_prefill`` as the kernel computes it: per 128-query block,
    only the key steps of its band."""
    S = q.shape[3]
    pos = torch.arange(S, dtype=torch.int32)
    outs = []
    for q0 in range(0, S, ROWS):
        q_last = min(S - 1, q0 + ROWS - 1)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = q_last if causal else S - 1
        out, _ = emulated_fwd(q[:, :, :, q0:q_last + 1], k, v,
                              pos[q0:q_last + 1], pos, causal=causal,
                              window=window, mm=mm,
                              steps=range(lo // STEP, hi // STEP + 1))
        outs.append(out)
    return torch.cat(outs, dim=3)


def _scale(t: torch.Tensor) -> float:
    finite = t.abs()[t.abs() < 1e29]
    return max(1.0, float(finite.max())) if finite.numel() else 1.0


def _err(got, want) -> float:
    return float((got - want).abs().max()) / _scale(want)


def _np(*shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


# name, (B, KV, G, Sq, Sk, hd), causal, window, positions
CASES = [
    ("causal", (1, 2, 4, 256, 256, 128), True, 0, "iota"),
    ("window", (1, 2, 4, 256, 256, 128), True, 48, "iota"),
    ("dead_rows", (1, 2, 4, 256, 256, 128), True, 0, "dead"),
    ("ragged_steps", (1, 2, 4, 200, 227, 128), True, 0, "iota"),
    ("cross_ragged", (1, 1, 4, 70, 101, 128), False, 0, "iota"),
]


def _inputs(dims, pos, seed):
    B, KV, G, Sq, Sk, hd = dims
    rng = np.random.default_rng(seed)
    q, k, v = (_np(B, KV, G, Sq, hd, rng=rng), _np(B, Sk, KV, hd, rng=rng),
               _np(B, Sk, KV, hd, rng=rng))
    qp = np.arange(Sq, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    if pos == "dead":
        qp[40:72] = -1                   # query rows that see no key
        kp[:3] = -1
    return q, k, v, qp, kp


@pytest.mark.parametrize("name,dims,causal,window,pos", CASES)
def test_split_forward_matches_f32(name, dims, causal, window, pos):
    q, k, v, qp, kp = _inputs(dims, pos, seed=11)
    kw = dict(causal=causal, window=window)
    Sk = dims[4]
    jout, jlse = jref.flash_fwd_ref(q, k, v, qp, kp, block_kv=Sk, **kw)
    tq, tk, tv, tqp, tkp = (torch.from_numpy(a) for a in (q, k, v, qp, kp))
    pout, plse = tref.flash_fwd_ref(tq, tk, tv, tqp, tkp, block_kv=Sk, **kw)
    out, lse = emulated_fwd(tq, tk, tv, tqp, tkp, **kw)
    jout, jlse = (torch.from_numpy(np.array(a)) for a in (jout, jlse))
    for what, got, p, j in (("out", out, pout, jout),
                            ("lse", lse, plse, jlse)):
        assert torch.isfinite(got).all(), f"{name} {what}"
        assert _err(got, p) <= TOL, f"{name} {what} vs port: {_err(got, p)}"
        assert _err(got, j) <= TOL, f"{name} {what} vs JAX: {_err(got, j)}"
    dead = plse <= -1e29
    assert bool((dead == (jlse <= -1e29)).all())
    assert torch.equal(lse[dead], plse[dead])
    assert torch.equal(lse[dead], jlse[dead])
    if pos == "dead":          # rows 40..71, and rows 0..2 (keys 0..2 masked)
        assert int(dead.sum()) == 2 * 4 * 35


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(256, 48), (227, 100)])
def test_split_prefill_matches_f32(dtype, S, window):
    B, KV, G, hd = 1, 2, 4, 128
    rng = np.random.default_rng(12)
    q, k, v = (_np(B, KV, G, S, hd, rng=rng), _np(B, S, KV, hd, rng=rng),
               _np(B, S, KV, hd, rng=rng))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, dtype=getattr(jnp, dtype))
                  for a in (q, k, v))
    want_j = torch.from_numpy(np.array(jsref.prefill_ref(jq, jk, jv,
                                                         window=window)))
    want_t = tsref.prefill_ref(tq, tk, tv, window=window)
    got = emulated_prefill(tq, tk, tv, window=window)
    assert torch.isfinite(got).all()
    assert _err(got, want_t) <= TOL, _err(got, want_t)
    assert _err(got, want_j) <= TOL, _err(got, want_j)


def test_band_visits_only_what_is_needed():
    """Per 128-query block, visiting every key step gives bit for bit
    what the band's steps give: the steps outside the band add exactly
    nothing (masked keys before a row's first visible one are wiped by
    the correction exp(-1e30 - m) = 0, later ones weigh 0)."""
    rng = np.random.default_rng(13)
    B, KV, G, S, hd, window = 1, 1, 2, 384, 32, 40
    q, k, v = (torch.from_numpy(_np(B, KV, G, S, hd, rng=rng)),
               torch.from_numpy(_np(B, S, KV, hd, rng=rng)),
               torch.from_numpy(_np(B, S, KV, hd, rng=rng)))
    pos = torch.arange(S, dtype=torch.int32)
    for q0 in range(0, S, ROWS):
        rows = slice(q0, q0 + ROWS)
        lo, hi = max(0, q0 - window + 1), q0 + ROWS - 1
        kw = dict(causal=True, window=window)
        band, _ = emulated_fwd(q[:, :, :, rows], k, v, pos[rows], pos,
                               steps=range(lo // STEP, hi // STEP + 1), **kw)
        every, _ = emulated_fwd(q[:, :, :, rows], k, v, pos[rows], pos, **kw)
        assert torch.equal(band, every), q0


def test_single_tf32_product_misses_the_tolerance():
    name, dims, causal, window, pos = CASES[0]
    q, k, v, qp, kp = (torch.from_numpy(a)
                       for a in _inputs(dims, pos, seed=11))
    kw = dict(causal=causal, window=window)
    plain, _ = tref.flash_fwd_ref(q, k, v, qp, kp, block_kv=dims[4], **kw)
    one, _ = emulated_fwd(q, k, v, qp, kp, mm=mm1, **kw)
    assert _err(one, plain) > TOL
    pre_one = emulated_prefill(q[..., :128, :], k[:, :128], v[:, :128],
                               window=48, mm=mm1)
    pre_plain = tsref.prefill_ref(q[..., :128, :], k[:, :128], v[:, :128],
                                  window=48)
    assert _err(pre_one, pre_plain) > TOL
