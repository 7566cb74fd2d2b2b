"""The attention kernels at head dims 8, 192 and 256 vs their plain
PyTorch versions, and the MoE dispatch's determinism, on the card
(marked ``cuda``; they skip where there is none):

    python -m pytest -m cuda tests/test_torch_cuda_hd.py

hd 256 takes its own block shape (64 query rows or keys a block, two
warps to each 16 rows, 16-key forward steps, 8-row backward steps;
``csrc/attn_fwd.cuh`` ``FwdGeom``, ``csrc/flash_attention.cu``
``BwdGeom``), and so does hd 192 (MLA's qk head dim; the flash kernels
only: the swa kernels have no caller at 192); hd 8 the hd <= 128 shape
with one 8-column mma tile. The
cases put S at those tiles' edges, with causal and windowed masks, GQA
and MQA groups, ragged S, bf16 operands for the swa kernels and query
rows that see no key.

Tolerance: ``tests/test_torch_cuda.py``'s, 2e-5 x the largest finite
|value| of the plain version (at least 1), for the same reason (the same
f32 products summed in another order, each as three TF32 products).

``test_flash_reference_tolerance_form`` runs ``tests/test_flash.py``'s
five shapes (hd 8 and 16) through ``flash_attention`` with and without
the kernels and holds values and gradients to that test's own
elementwise form, ``atol=1e-5, rtol=1e-5`` (value ``atol=1e-4``), and
two hd 192 shapes of MLA's layout (KV = H, G = 1).

The front ends' shapes at hd 64: whisper-small's encoder (bidirectional
over 1500 frames, 1500 = 23 x 64 + 28) and cross-attention (448 text rows
onto 1500 frames, every position 0), internvl2-1b's GQA group of 7, in
the flash cases; ``swa_decode`` at G 7 and on a 1500-slot cross cache
whose positions are all 0; ``test_frontend_cross_tolerance_form`` holds
the cross shape, forward and backward, in ``tests/test_flash.py``'s
elementwise form.

``test_recurrentgemma_local_shapes`` holds ``swa_decode`` and the flash
pair at recurrentgemma-9b's local layers (KV 1, G 16, hd 256) with a
window of 2048 that cuts in.

``test_moe_dispatch_is_bit_equal`` runs ``models.moe.moe_apply`` and its
gradients twice on the card: the dispatch adds nothing through atomics,
so the two runs are bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention import flash as ff  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.swa_attention import ref as sref  # noqa: E402
from repro_torch.kernels.swa_attention import swa as sk  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++)")
    return torch.device("cuda", 0)


def _scale(t):
    finite = t.abs()[t.abs() < 1e29]
    return max(1.0, float(finite.max())) if finite.numel() else 1.0


def _close(got, want):
    tol = 2e-5 * _scale(want)
    assert float((got - want).abs().max()) <= tol


def _positions(kind, Sq, Sk, dev):
    qp = torch.arange(Sq, dtype=torch.int32, device=dev)
    kp = torch.arange(Sk, dtype=torch.int32, device=dev)
    if kind == "pad":
        qp[Sq - 30:] = -1
        kp[Sk - 30:] = -1
    elif kind == "dead":              # query rows that see no key
        qp[10:30] = -1
        kp[:5] = -1
    elif kind == "zeros":             # cross-attention: every position 0
        qp.zero_()
        kp.zero_()
    return qp, kp


# name, (B, KV, G, Sq, Sk, hd), causal, window, positions
FLASH_CASES = [
    (f"{name}_hd{hd}", dims + (hd,), causal, window, pos)
    for hd in (8, 192, 256)
    for name, dims, causal, window, pos in [
        ("causal", (2, 2, 2, 200, 200), True, 0, "iota"),
        ("gqa_ragged", (1, 2, 4, 70, 70), True, 0, "iota"),
        ("window", (1, 1, 2, 300, 300), True, 40, "iota"),
        ("cross", (1, 1, 2, 65, 90), False, 0, "iota"),
        ("padded", (1, 2, 2, 130, 130), True, 0, "pad"),
        ("dead_rows", (1, 1, 2, 96, 96), True, 0, "dead"),
        ("window_dead_rows", (1, 2, 2, 150, 150), True, 20, "dead"),
        # hd 256's tiles: 64 rows a block, 16 keys a forward step, 8 rows
        # a backward step; S at and off their edges
        ("tile_minus_1", (1, 1, 2, 63, 15), False, 0, "iota"),
        ("tile", (1, 1, 1, 64, 64), True, 0, "iota"),
        ("tile_plus_1", (1, 2, 1, 65, 17), False, 0, "iota"),
        # dk, dv sum over G x Sq = 8192 rows
        ("long_sums", (1, 1, 8, 1024, 1024), True, 0, "iota"),
    ]] + [
    # the front ends at hd 64: whisper's encoder (1500 = 23 x 64 + 28
    # keys, bidirectional) and cross-attention (448 rows onto 1500
    # frames, positions all 0), internvl2-1b's prefill group of 7
    ("whisper_encoder_hd64", (1, 12, 1, 1500, 1500, 64), False, 0, "iota"),
    ("whisper_cross_hd64", (1, 12, 1, 448, 1500, 64), False, 0, "zeros"),
    ("internvl2_g7_hd64", (1, 2, 7, 1100, 1100, 64), True, 0, "iota"),
]


@pytest.mark.parametrize("name,dims,causal,window,pos", FLASH_CASES)
def test_flash_kernels_match_plain(dev, name, dims, causal, window, pos):
    B, KV, G, Sq, Sk, hd = dims
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, KV, G, Sq, hd, generator=g, device=dev)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=dev)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=dev)
    dout = torch.randn(B, KV, G, Sq, hd, generator=g, device=dev)
    qp, kp = _positions(pos, Sq, Sk, dev)
    ff.reset_launch_counts()
    out, lse = ff.flash_fwd(q, k, v, qp, kp, causal=causal, window=window)
    delta = (dout * out).sum(-1)
    dq, dk, dv = ff.flash_bwd(q, k, v, qp, kp, lse, delta, dout,
                              causal=causal, window=window)
    torch.cuda.synchronize()
    assert ff.launch_counts() == dict.fromkeys(ff.KERNELS, 1)
    w_out, w_lse = fref.flash_fwd_ref(q, k, v, qp, kp, causal=causal,
                                      window=window, block_kv=Sk)
    grads = fref.flash_bwd_ref(q, k, v, qp, kp, w_out, w_lse, dout,
                               causal=causal, window=window, block_kv=Sk)
    _close(out, w_out)
    _close(lse, w_lse)
    for got, want in zip((dq, dk, dv), grads):
        _close(got, want)
    if pos == "dead":
        assert bool((lse[..., 10:30] == w_lse[..., 10:30]).all())


@pytest.mark.parametrize("hd", [8, 192, 256])
def test_flash_deterministic(dev, hd):
    """Two launches of each kernel on the same inputs are bit-equal."""
    B, KV, G, S = 1, 2, 4, 300
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(B, KV, G, S, hd, generator=g, device=dev)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev)
    dout = torch.randn(B, KV, G, S, hd, generator=g, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    runs = []
    for _ in range(2):
        out, lse = ff.flash_fwd(q, k, v, pos, pos, window=50)
        delta = (dout * out).sum(-1)
        runs.append((out, lse) + ff.flash_bwd(q, k, v, pos, pos, lse, delta,
                                               dout, window=50))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_refuses_192_for_mla(dev):
    """The head dims still refused: swa_prefill at 192 (MLA's, which the
    flash kernels take: no local layer has it) and 96 everywhere."""
    q = torch.randn(1, 1, 1, 16, 192, device=dev)
    k = torch.randn(1, 16, 1, 192, device=dev)
    pos = torch.arange(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="built for"):
        sk.swa_prefill(q, k, k, window=0)
    q96, k96 = q[..., :96].contiguous(), k[..., :96].contiguous()
    with pytest.raises(ValueError, match="built for"):
        ff.flash_fwd(q96, k96, k96, pos, pos)
    with pytest.raises(ValueError, match="built for"):
        sk.swa_prefill(q96, k96, k96, window=0)


# ------------------------------------------------------------ swa decode
# name, (B, KV, G, hd, S), window, q_pos, key_pos kind, kv dtype, q dtype
DECODE_CASES = [
    (f"{name}_hd{hd}", (B, KV, G, hd, S), window, q_pos, kind, kvd, qd)
    for hd in (8, 256)
    for name, (B, KV, G, S), window, q_pos, kind, kvd, qd in [
        ("window", (2, 4, 2, 1000), 256, 999, "iota", "float32", "float32"),
        ("ring_wrapped", (2, 2, 2, 256), 256, 700, "ring", "float32",
         "float32"),
        ("window0_odd_S", (3, 2, 3, 333), 0, 300, "iota", "float32",
         "float32"),
        ("bf16_kv", (2, 2, 2, 1000), 256, 999, "iota", "bfloat16",
         "float32"),
        ("bf16_all", (1, 2, 3, 517), 0, 516, "iota", "bfloat16",
         "bfloat16"),
        ("no_visible_slot", (2, 2, 2, 300), 0, 40, "late", "float32",
         "float32"),
        # MQA, 16 query heads a kv head: several clusters at hd 256
        ("mqa_g16", (1, 1, 16, 600), 128, 599, "iota", "float32",
         "float32"),
        ("mha_serve", (4, 16, 1, 4128), 0, 4127, "iota", "float32",
         "float32"),
    ]] + [
    # the front ends at hd 64: internvl2-1b's self cache (7 query heads a
    # kv head: a cluster of 8 lanes, one idle) and whisper's cross cache
    # (1500 slots, every position 0, the query at 0)
    ("internvl2_g7_hd64", (4, 2, 7, 64, 4128), 0, 4127, "iota", "float32",
     "float32"),
    ("whisper_cross_hd64", (4, 12, 1, 64, 1500), 0, 0, "zeros", "float32",
     "float32"),
]


def _key_pos(kind, S, q_pos, dev):
    if kind == "ring":
        return tattn.ring_positions(q_pos, S, device=dev).int()
    kp = torch.arange(S, dtype=torch.int32, device=dev)
    if kind == "zeros":
        return torch.zeros_like(kp)
    return kp + 50 if kind == "late" else kp


@pytest.mark.parametrize("name,dims,window,q_pos,kind,kv_dtype,q_dtype",
                         DECODE_CASES)
def test_swa_decode_matches_plain(dev, name, dims, window, q_pos, kind,
                                  kv_dtype, q_dtype):
    B, KV, G, hd, S = dims
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, KV, G, hd, generator=g, device=dev).to(
        getattr(torch, q_dtype))
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(
        getattr(torch, kv_dtype))
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(k.dtype)
    kp = _key_pos(kind, S, q_pos, dev)
    sk.reset_launch_counts()
    got = sk.swa_decode(q, k, v, kp, q_pos, window=window)
    torch.cuda.synchronize()
    assert sk.launch_counts()["swa_decode"] == 1
    want = sref.decode_ref(q, k, v, kp, q_pos, window=window)
    _close(got, want)
    if kind == "late":              # the mean of v over every slot
        _close(got, v.float().mean(1)[:, :, None].expand_as(got))


# ------------------------------------------ recurrentgemma-9b's local layers
@pytest.mark.parametrize("what", ["swa_decode", "flash_pair"])
def test_recurrentgemma_local_shapes(dev, what):
    """recurrentgemma-9b's local attention (MQA: 1 kv head of 16 query
    heads, hd 256, window 2048) where the window cuts in: ``swa_decode``
    on a wrapped ring of 2048 slots (four clusters share the kv head at
    hd 256), and ``flash_fwd`` / ``flash_bwd`` over 2600 positions."""
    B, KV, G, hd, W = 2, 1, 16, 256, 2048
    g = torch.Generator(device=dev).manual_seed(11)
    if what == "swa_decode":
        q_pos = 4127                  # a 4096-token prompt + 31 tokens
        q = torch.randn(B, KV, G, hd, generator=g, device=dev)
        k = torch.randn(B, W, KV, hd, generator=g, device=dev)
        v = torch.randn(B, W, KV, hd, generator=g, device=dev)
        kp = tattn.ring_positions(q_pos, W, device=dev).int()
        sk.reset_launch_counts()
        got = sk.swa_decode(q, k, v, kp, q_pos, window=W)
        torch.cuda.synchronize()
        assert sk.launch_counts()["swa_decode"] == 1
        _close(got, sref.decode_ref(q, k, v, kp, q_pos, window=W))
        return
    S = 2600
    q = torch.randn(1, KV, G, S, hd, generator=g, device=dev)
    k = torch.randn(1, S, KV, hd, generator=g, device=dev)
    v = torch.randn(1, S, KV, hd, generator=g, device=dev)
    dout = torch.randn(1, KV, G, S, hd, generator=g, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    ff.reset_launch_counts()
    out, lse = ff.flash_fwd(q, k, v, pos, pos, causal=True, window=W)
    delta = (dout * out).sum(-1)
    grads = ff.flash_bwd(q, k, v, pos, pos, lse, delta, dout, causal=True,
                         window=W)
    torch.cuda.synchronize()
    assert ff.launch_counts() == dict.fromkeys(ff.KERNELS, 1)
    w_out, w_lse = fref.flash_fwd_ref(q, k, v, pos, pos, causal=True,
                                      window=W, block_kv=S)
    w_grads = fref.flash_bwd_ref(q, k, v, pos, pos, w_out, w_lse, dout,
                                 causal=True, window=W, block_kv=S)
    _close(out, w_out)
    _close(lse, w_lse)
    for got, want in zip(grads, w_grads):
        _close(got, want)


# ----------------------------------------------------------- swa prefill
# name, (B, KV, G, S, hd), window, causal, dtype
PREFILL_CASES = [
    (f"{name}_hd{hd}", (B, KV, G, S, hd), window, causal, dtype)
    for hd in (8, 256)
    for name, (B, KV, G, S), window, causal, dtype in [
        ("window", (1, 2, 2, 1000), 256, True, "float32"),
        ("window_not_tile", (2, 1, 2, 300), 100, True, "float32"),
        ("causal", (1, 2, 1, 256), 0, True, "float32"),
        ("bidirectional", (1, 1, 2, 200), 0, False, "float32"),
        ("bf16", (1, 2, 2, 517), 128, True, "bfloat16"),
        ("small_window", (1, 1, 2, 130), 16, True, "float32"),
        ("tile_minus_1", (1, 1, 2, 63), 0, True, "float32"),
        ("tile_plus_1_bf16", (1, 2, 1, 65), 16, True, "bfloat16"),
        ("window_under_step", (2, 1, 2, 300), 5, True, "float32"),
        # recurrentgemma-9b's local layers: MQA, 16 heads, window 2048
        ("mqa_g16_window", (1, 1, 16, 700), 300, True, "float32"),
    ]]


@pytest.mark.parametrize("name,dims,window,causal,dtype", PREFILL_CASES)
def test_swa_prefill_matches_plain(dev, name, dims, window, causal, dtype):
    B, KV, G, S, hd = dims
    g = torch.Generator(device=dev).manual_seed(7)
    dt = getattr(torch, dtype)
    q = torch.randn(B, KV, G, S, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    sk.reset_launch_counts()
    got = sk.swa_prefill(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert sk.launch_counts()["swa_prefill"] == 1
    _close(got, sref.prefill_ref(q, k, v, window=window, causal=causal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_prefill_deterministic_hd256(dev, dtype):
    B, KV, G, S, hd = 1, 2, 2, 300, 256
    g = torch.Generator(device=dev).manual_seed(8)
    dt = getattr(torch, dtype)
    q = torch.randn(B, KV, G, S, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    first = sk.swa_prefill(q, k, v, window=100)
    second = sk.swa_prefill(q, k, v, window=100)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ------------------------------------- the reference's tolerance form
# tests/test_flash.py SHAPES: name, (B, Sq, Sk, KV, G, hd), causal,
# window, (block_q, block_kv)
REF_SHAPES = [
    ("causal", (2, 16, 16, 2, 2, 8), True, 0, (16, 16)),
    ("gqa", (1, 32, 32, 2, 4, 16), True, 0, (32, 32)),
    ("window", (1, 48, 48, 1, 2, 16), True, 8, (16, 16)),
    ("cross", (2, 24, 40, 2, 1, 8), False, 0, (24, 40)),
    ("multiblock_ragged", (1, 40, 40, 1, 1, 8), True, 12, (16, 16)),
    # MLA's layout at its qk head dim: one query head a kv head
    ("mla_causal", (1, 96, 96, 4, 1, 192), True, 0, (64, 64)),
    ("mla_ragged", (2, 70, 70, 3, 1, 192), True, 0, (32, 32)),
]


def _val_and_grads(q, k, v, cot, **kw):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(q, k, v, **kw)
    val = (out.float() * cot).sum()
    return (val,) + torch.autograd.grad(val, (q, k, v))


@pytest.mark.parametrize("name,dims,causal,window,blocks", REF_SHAPES)
def test_flash_reference_tolerance_form(dev, name, dims, causal, window,
                                        blocks):
    """The kernels (values and dq, dk, dv) against the plain version in
    ``tests/test_flash.py``'s elementwise form: value ``atol=1e-4,
    rtol=1e-5``, gradients ``atol=1e-5, rtol=1e-5``."""
    B, Sq, Sk, KV, G, hd = dims
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((B, Sq, KV, G, hd)), device=dev,
                     dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((B, Sk, KV, hd)), device=dev,
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((B, Sk, KV, hd)), device=dev,
                     dtype=torch.float32)
    cot = torch.tensor(rng.standard_normal((B, Sq, KV * G, hd)), device=dev,
                       dtype=torch.float32)
    kw = dict(q_pos=torch.arange(Sq, device=dev),
              kv_pos=torch.arange(Sk, device=dev), causal=causal,
              window=window, block_q=blocks[0], block_kv=blocks[1])
    ff.reset_launch_counts()
    got = _val_and_grads(q, k, v, cot, use_kernel=True, **kw)
    assert ff.launch_counts() == dict.fromkeys(ff.KERNELS, 1)
    want = _val_and_grads(q, k, v, cot, use_kernel=False, **kw)
    np.testing.assert_allclose(got[0].item(), want[0].item(), atol=1e-4,
                               rtol=1e-5)
    for nm, a, b in zip("qkv", got[1:], want[1:]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        used = np.abs(a - b) / (1e-5 + 1e-5 * np.abs(b))
        print(f"{name} d{nm}: max |diff| {np.abs(a - b).max():.3e}, "
              f"{used.max():.3f} of the elementwise bound")
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{name}: d{nm}")


def test_frontend_cross_tolerance_form(dev):
    """whisper-small's cross-attention (448 text rows onto 1500 frames, 12
    heads of 64, every position 0, non-causal) through ``flash_attention``
    with and without the kernels, values and dq, dk, dv in
    ``tests/test_flash.py``'s elementwise form (as
    ``test_flash_reference_tolerance_form``)."""
    B, Sq, Sk, H, hd = 1, 448, 1500, 12, 64
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((B, Sq, H, 1, hd)), device=dev,
                     dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((B, Sk, H, hd)), device=dev,
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((B, Sk, H, hd)), device=dev,
                     dtype=torch.float32)
    cot = torch.tensor(rng.standard_normal((B, Sq, H, hd)), device=dev,
                       dtype=torch.float32)
    kw = dict(q_pos=torch.zeros(Sq, dtype=torch.int32, device=dev),
              kv_pos=torch.zeros(Sk, dtype=torch.int32, device=dev),
              causal=False, window=0)
    ff.reset_launch_counts()
    got = _val_and_grads(q, k, v, cot, use_kernel=True, **kw)
    assert ff.launch_counts() == dict.fromkeys(ff.KERNELS, 1)
    want = _val_and_grads(q, k, v, cot, use_kernel=False, **kw)
    np.testing.assert_allclose(got[0].item(), want[0].item(), atol=1e-4,
                               rtol=1e-5)
    for nm, a, b in zip("qkv", got[1:], want[1:]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        used = np.abs(a - b) / (1e-5 + 1e-5 * np.abs(b))
        print(f"whisper cross d{nm}: max |diff| {np.abs(a - b).max():.3e}, "
              f"{used.max():.3f} of the elementwise bound")
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                   err_msg=f"whisper cross: d{nm}")


# ------------------------------------------------------ MoE determinism
def test_moe_dispatch_is_bit_equal(dev):
    cfg = reduced(get_config("mixtral-8x7b"), d_model=256)
    g = torch.Generator(device=dev).manual_seed(9)
    p = tmoe.moe_init(g, cfg, device=dev)
    x = torch.randn(2, 512, cfg.d_model, generator=g, device=dev)
    cot = torch.randn(2, 512, cfg.d_model, generator=g, device=dev)
    names = sorted(p)
    runs = []
    for _ in range(2):
        leaves = [p[n].detach().clone().requires_grad_() for n in names]
        xx = x.clone().requires_grad_()
        out = tmoe.moe_apply(dict(zip(names, leaves)), cfg, xx)
        grads = torch.autograd.grad((out * cot).sum(), leaves + [xx])
        runs.append([out.detach()] + list(grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
