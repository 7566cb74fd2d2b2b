"""The hand-written CUDA kernels vs their plain PyTorch versions, on the
card (marked ``cuda``; they skip where there is none):

    python -m pytest -m cuda tests/test_torch_cuda.py

fedavg: tolerance 1e-6 × max|x| (x the dequantized chunk for the int8
wire): both sum the same <= 20 f32 products per coordinate, in different
orders.

flash attention: tolerance 2e-5 × the largest finite |value| of the plain
version (at least 1): both sum the same f32 products in different orders
(the kernels per tile, the plain version per einsum); the kernels take
each product as three TF32 tensor-core products (split TF32), within
~2^-22 of the f32 one (tests/test_torch_flash_tf32.py,
tests/test_torch_attn_fwd_tf32.py). Rows that see
no key carry lse = -1e30 in both, and must match exactly there.

swa_decode / swa_prefill: the same 2e-5 × scale, for f32 and bf16
operands alike (both widen bf16 to f32 exactly and compute in f32).
swa_decode's log-sum-exp (``return_lse``): within 1e-6 relative of the
plain version's (the same f32 scores summed in another order; the
values are a few units, so that is a few ulps), -inf in both where no
slot is visible; two halves of a cache merged by it are the whole
cache's launch within the same tolerances.
widen_2d: bit-equal (a gather times the same f32 scale).
"""
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

from torch.func import grad, vmap  # noqa: E402

from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels.fedavg import fedavg as fk  # noqa: E402
from repro_torch.kernels.fedavg import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash as ff  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.core import netchange as nc  # noqa: E402
from repro_torch.kernels.netchange import ops as wops  # noqa: E402
from repro_torch.kernels.netchange import widen as wk  # noqa: E402
from repro_torch.kernels.swa_attention import ops as sops  # noqa: E402
from repro_torch.kernels.swa_attention import ref as sref  # noqa: E402
from repro_torch.kernels.swa_attention import swa as sk  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++)")
    return torch.device("cuda", 0)


def _inputs(dev, k=20, n=100_003, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(k, n, generator=g, device=dev)
    w = torch.rand(k, generator=g, device=dev)
    w /= w.sum()
    m = (torch.rand(k, n, generator=g, device=dev) < 0.6).float()
    mu = torch.randint(1, 4, (k, n), generator=g, device=dev).float() * m
    fb = torch.randn(n, generator=g, device=dev)
    return x, w, m, mu, fb


def _close(a, b, x):
    tol = 1e-6 * float(x.abs().max())
    assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("coverage", [False, True])
def test_plane_agg_kernels(dev, coverage):
    x, w, m, mu, fb = _inputs(dev)
    fk.reset_launch_counts()
    if coverage:
        got = ops.plane_agg(x, w, masks=m, mult=mu, fallback=fb)
        want = ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb)
    else:
        got, want = ops.plane_agg(x, w), ref.weighted_sum_ref(x, w)
    torch.cuda.synchronize()
    _close(got, want, x)
    assert fk.launch_counts()["plane_agg" if coverage
                              else "weighted_sum"] == 1


@pytest.mark.parametrize("kc", [1, 7, 20])
def test_stream_kernels(dev, kc):
    x, w, m, mu, fb = _inputs(dev, seed=1)
    acc = ops.PlaneAccumulator(x.shape[1], device=dev)
    for lo in range(0, 20, kc):
        acc.update(x[lo:lo + kc], w[lo:lo + kc], masks=m[lo:lo + kc],
                   mult=mu[lo:lo + kc])
    got = acc.finish(fallback=fb)
    torch.cuda.synchronize()
    _close(got, ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb), x)


@pytest.mark.parametrize("n", [1, 1023, 100_003])
def test_ragged_columns_and_unaligned_rows(dev, n):
    """Any column count, and row slices of an odd-width plane (rows at
    every 4-byte offset): the kernels take them as they are."""
    x, w, m, mu, fb = _inputs(dev, n=n, seed=2)
    xs, ws, ms, mus = x[3:], w[3:], m[3:], mu[3:]
    _close(ops.plane_agg(xs, ws), ref.weighted_sum_ref(xs, ws), x)
    _close(ops.plane_agg(xs, ws, masks=ms, mult=mus, fallback=fb),
           ref.plane_agg_ref(xs, ws, masks=ms, mult=mus, fallback=fb), x)
    z = torch.zeros(n, device=dev)
    trip = ops.plane_accum(z, z, z, xs, ws, masks=ms, mult=mus)
    want = ref.plane_accum_ref(z, z, z, xs, ws, ms, mus)
    for got, exp in zip(trip, want):
        _close(got, exp, x)
    _close(ops.plane_finish(*trip, fallback=fb),
           ref.plane_finish_ref(*want, fb), x)


# ------------------------------------------- this slice's fedavg kernels
@pytest.mark.parametrize("variant", ["plain", "masks", "masked_mult",
                                     "fold"])
@pytest.mark.parametrize("kc,n,tile", [(16, 100_003, 256), (4, 100_003, 256),
                                       (3, 1_001, 512), (2, 4_097, 128)])
def test_plane_accum_q_kernel(dev, variant, kc, n, tile):
    """The fused dequantize-accumulate vs its plain version: rows at
    every byte offset (odd n), a straddling last tile, an all-zero tile."""
    x, w, m, mu, _ = _inputs(dev, k=kc, n=n, seed=5)
    x[:, :tile] = 0.0
    base = torch.randn(n, device=dev)
    xq, s = quant.quantize(x, "int8", tile=tile, mask=m)
    kw = {"plain": {}, "masks": dict(masks=m),
          "masked_mult": dict(masks=m, mult=mu),
          "fold": dict(masks=m, base=base)}[variant]
    z = torch.zeros(n, device=dev)
    fk.reset_launch_counts()
    got = ops.plane_accum_q(z, z, z, xq, s, w, tile=tile, **kw)
    torch.cuda.synchronize()
    assert fk.launch_counts()["plane_accum_q"] == 1
    want = ops.plane_accum_q(z, z, z, xq, s, w, tile=tile, use_kernel=False,
                             **kw)
    deq = quant.dequantize(xq, s, tile=tile)
    scale = max(float(deq.abs().max()), float(base.abs().max()), 1.0)
    for g, e in zip(got, want):
        _close(g, e, torch.tensor(scale))
    # the accumulator's face: in place over two chunks
    acc = ops.PlaneAccumulator(n, device=dev, q_tile=tile)
    h = kc // 2 or 1
    for lo, hi in ((0, h), (h, kc)):
        if hi > lo:
            acc.update_q(xq[lo:hi], s[lo:hi], w[lo:hi],
                         **{k: (v[lo:hi] if k != "base" else v)
                            for k, v in kw.items()})
    for g, e in zip(acc.partials(), want):
        _close(g, e, torch.tensor(scale))


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("renorm", [True, False])
def test_weighted_sum_masked_kernels(dev, mult, renorm):
    x, w, m, mu, _ = _inputs(dev, seed=6)
    m[:, :64] = 0.0                          # uncovered: renorm gives 0
    fk.reset_launch_counts()
    got = ops.weighted_sum_masked(x, w, m, mult=mu if mult else None,
                                  renorm=renorm)
    torch.cuda.synchronize()
    name = "weighted_sum_masked_mult" if mult else "weighted_sum_masked"
    assert fk.launch_counts()[name] == 1
    assert fk.launch_counts()["plane_agg"] == 0
    want = ref.weighted_sum_masked_ref(x, w, m, mult=mu if mult else None,
                                       renorm=renorm)
    _close(got, want, x)
    # on a (K, *shape) leaf
    leaf = x[:, :99_990].reshape(20, 10, 9999)
    ml = m[:, :99_990].reshape(20, 10, 9999)
    got = ops.weighted_sum_masked(leaf, w, ml, renorm=renorm)
    assert tuple(got.shape) == (10, 9999)
    _close(got, ref.weighted_sum_masked_ref(
        leaf.reshape(20, -1), w, ml.reshape(20, -1),
        renorm=renorm).reshape(10, 9999), x)


@pytest.mark.parametrize("masks", [False, True])
def test_plane_accum_bf16_chunk(dev, masks):
    x, w, m, mu, _ = _inputs(dev, seed=7)
    xb = x.to(torch.bfloat16)
    acc = ops.PlaneAccumulator(x.shape[1], device=dev)
    fk.reset_launch_counts()
    acc.update(xb, w, masks=m if masks else None,
               mult=mu if masks else None)
    torch.cuda.synchronize()
    assert fk.launch_counts()["plane_accum"] == 1
    assert acc.stats()["chunk_bytes"] == 20 * x.shape[1] * (2 + 8 * masks)
    z = torch.zeros(x.shape[1], device=dev)
    want = ref.plane_accum_ref(z, z, z, xb.float(), w,
                               m if masks else None, mu if masks else None)
    for g, e in zip(acc.partials(), want):
        _close(g, e, x)


def test_new_wrappers_refuse_what_they_cannot_take(dev):
    x, w, m, mu, _ = _inputs(dev, k=4, n=1000, seed=8)
    z = torch.zeros(1, 1000, device=dev)
    xq, s = quant.quantize(x, "int8", tile=256)
    with pytest.raises(ValueError, match="int8"):
        fk.plane_accum_q_2d(z, z.clone(), z.clone(), x, s, w)
    with pytest.raises(ValueError, match="shape"):
        fk.plane_accum_q_2d(z, z.clone(), z.clone(), xq, s[:, :2], w)
    with pytest.raises(ValueError, match="dtype"):
        fk.plane_accum_2d(z, z.clone(), z.clone(), x, w,
                          m.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        fk.weighted_sum_masked_2d(x, w, m.to(torch.bfloat16))
    with pytest.raises(ValueError, match="fold"):
        fk.plane_accum_q_2d(z, z.clone(), z.clone(), xq, s, w, m, mu,
                            z.clone())
    with pytest.raises(ValueError, match="128"):
        fk.plane_accum_q_2d(z, z.clone(), z.clone(), xq, s, w, tile=200)
    # CPU tensors: use_kernel=True raises, the default is the plain path
    xc, wc = x.cpu(), w.cpu()
    with pytest.raises(ValueError, match="CUDA"):
        ops.weighted_sum_masked(xc, wc, m.cpu(), use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.plane_accum_q(*[t.cpu() for t in (z[0], z[0], z[0], xq, s)],
                          wc, use_kernel=True)
    # on the card, use_kernel=False is the only way to the plain version
    fk.reset_launch_counts()
    ops.weighted_sum_masked(x, w, m, use_kernel=False)
    assert sum(fk.launch_counts().values()) == 0


# ----------------------------------------------------------------- flash
# name, (B, KV, G, Sq, Sk, hd), causal, window, positions
FLASH_CASES = [
    ("causal", (2, 2, 4, 128, 128, 128), True, 0, "iota"),
    ("gqa_ragged", (1, 2, 3, 100, 100, 64), True, 0, "iota"),
    ("window", (1, 1, 2, 192, 192, 32), True, 40, "iota"),
    ("mha", (2, 4, 1, 64, 64, 128), True, 0, "iota"),
    ("cross", (2, 1, 2, 70, 90, 16), False, 0, "iota"),
    ("padded", (1, 2, 2, 130, 130, 128), True, 0, "pad"),
    ("dead_rows", (1, 1, 2, 96, 96, 64), True, 0, "dead"),
    # the backward's tiles: 128 query rows or keys a block, 24 a step;
    # Sq, Sk off both, at every head dim
    ("ragged_200x136_hd16", (1, 2, 2, 200, 136, 16), True, 0, "iota"),
    ("ragged_200x136_hd32", (1, 2, 2, 200, 136, 32), True, 0, "iota"),
    ("ragged_200x136_hd64", (1, 1, 3, 200, 136, 64), False, 0, "iota"),
    ("ragged_200x136_hd128", (2, 1, 2, 200, 136, 128), True, 0, "iota"),
    ("group_g16", (1, 2, 16, 160, 160, 128), True, 0, "iota"),
    # dk, dv sum over G x Sq = 16384 rows: long sums stay f32-accurate
    ("long_sums", (1, 1, 16, 1024, 1024, 128), True, 0, "iota"),
    ("window_dead_rows", (1, 2, 4, 300, 300, 64), True, 50, "dead"),
    # the forward's tiles: 128 query rows a block, 48 keys a step; Sk at
    # a step's edges, a ragged last step, a window under one step
    ("fwd_step_minus_1", (1, 2, 2, 47, 47, 64), True, 0, "iota"),
    ("fwd_step", (1, 2, 2, 48, 48, 128), True, 0, "iota"),
    ("fwd_step_plus_1", (1, 1, 3, 129, 49, 32), False, 0, "iota"),
    ("fwd_ragged_last_step", (2, 1, 2, 100, 100, 16), True, 0, "iota"),
    ("fwd_window_under_step", (1, 2, 2, 200, 200, 128), True, 5, "iota"),
]


def _positions(kind, Sq, Sk, dev):
    qp = torch.arange(Sq, dtype=torch.int32, device=dev)
    kp = torch.arange(Sk, dtype=torch.int32, device=dev)
    if kind == "pad":                 # the block padding of ops.py
        qp[Sq - 30:] = -1
        kp[Sk - 30:] = -1
    elif kind == "dead":              # query rows that see no key
        qp[10:30] = -1
        kp[:5] = -1
    return qp, kp


def _scale(t):
    finite = t.abs()[t.abs() < 1e29]
    return max(1.0, float(finite.max())) if finite.numel() else 1.0


def _close_flash(got, want):
    tol = 2e-5 * _scale(want)
    assert float((got - want).abs().max()) <= tol


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
    _close_flash(out, w_out)
    _close_flash(lse, w_lse)
    for got, want in zip((dq, dk, dv), grads):
        _close_flash(got, want)
    if pos == "dead":
        assert bool((lse[..., 10:30] == w_lse[..., 10:30]).all())


@pytest.mark.parametrize("dims,window", [((1, 2, 16, 300, 300, 128), 0),
                                         ((2, 1, 3, 200, 136, 64), 40)])
def test_flash_bwd_deterministic(dev, dims, window):
    """Two launches of each backward kernel on the same inputs are
    bit-equal: the sum over G and over tiles has one fixed order."""
    B, KV, G, Sq, Sk, hd = dims
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, KV, G, Sq, hd, generator=g, device=dev)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=dev)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=dev)
    dout = torch.randn(B, KV, G, Sq, hd, generator=g, device=dev)
    qp, kp = _positions("iota", Sq, Sk, dev)
    out, lse = ff.flash_fwd(q, k, v, qp, kp, window=window)
    delta = (dout * out).sum(-1)
    args = (q, k, v, qp, kp, lse, delta, dout)
    first = (ff.flash_bwd_dq(*args, window=window),
             *ff.flash_bwd_dkv(*args, window=window))
    second = (ff.flash_bwd_dq(*args, window=window),
              *ff.flash_bwd_dkv(*args, window=window))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dims,window,pos", [
    ((1, 2, 16, 300, 300, 128), 0, "iota"),
    ((2, 1, 3, 200, 136, 64), 40, "dead")])
def test_flash_fwd_deterministic(dev, dims, window, pos):
    """Two launches of the forward on the same inputs are bit-equal: its
    sums keep one order (rows that see no key take a second pass)."""
    B, KV, G, Sq, Sk, hd = dims
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(B, KV, G, Sq, hd, generator=g, device=dev)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=dev)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=dev)
    qp, kp = _positions(pos, Sq, Sk, dev)
    first = ff.flash_fwd(q, k, v, qp, kp, window=window)
    second = ff.flash_fwd(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_flash_fwd_refuses_misaligned(dev, operand):
    """The forward copies 16 bytes at a time too: an operand that starts
    4 bytes off a 16-byte boundary is refused, not read wrongly."""
    B, KV, G, S, hd = 1, 1, 1, 64, 32
    ops = {"q": torch.zeros(B, KV, G, S, hd, device=dev),
           "k": torch.zeros(B, S, KV, hd, device=dev),
           "v": torch.zeros(B, S, KV, hd, device=dev)}
    t = ops[operand]
    ops[operand] = torch.zeros(t.numel() + 1, device=dev)[1:].view(t.shape)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    ff.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        ff.flash_fwd(ops["q"], ops["k"], ops["v"], pos, pos)
    assert ff.launch_counts()["flash_fwd"] == 0


def test_flash_bwd_refuses_misaligned(dev):
    """The backward copies 16 bytes at a time: a q that starts 4 bytes off
    a 16-byte boundary is refused, not read wrongly."""
    B, KV, G, S, hd = 1, 1, 1, 64, 32
    q = torch.zeros(B * KV * G * S * hd + 1, device=dev)[1:].view(
        B, KV, G, S, hd)
    k = torch.zeros(B, S, KV, hd, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    lse = torch.zeros(B, KV, G, S, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        ff.flash_bwd_dq(q, k, k, pos, pos, lse, lse, q.clone())


def test_flash_vmap_grad_one_launch(dev):
    """vmap(grad) over 3 clients launches each kernel once per call, and
    equals the plain version through the same autograd Functions."""
    n, B, S, KV, G, hd = 3, 2, 96, 2, 2, 128
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(n, B, S, KV, G, hd, generator=g, device=dev)
    k = torch.randn(n, B, S, KV, hd, generator=g, device=dev)
    v = torch.randn(n, B, S, KV, hd, generator=g, device=dev)
    cot = torch.randn(n, B, S, KV * G, hd, generator=g, device=dev)
    pos = torch.arange(S, device=dev)

    def loss(use_kernel):
        def f(q, k, v, c):
            return (flash_attention(q, k, v, pos, pos, block_q=64,
                                    block_kv=64, use_kernel=use_kernel)
                    * c).sum()
        return f

    ff.reset_launch_counts()
    got = vmap(grad(loss(True), argnums=(0, 1, 2)))(q, k, v, cot)
    torch.cuda.synchronize()
    assert ff.launch_counts() == dict.fromkeys(ff.KERNELS, 1)
    want = vmap(grad(loss(False), argnums=(0, 1, 2)))(q, k, v, cot)
    for a, b in zip(got, want):
        _close_flash(a, b)


# ------------------------------------------------------------ swa decode
# name, (B, KV, G, hd, S), window, q_pos, key_pos kind, kv dtype, q dtype
DECODE_CASES = [
    ("window", (2, 4, 2, 128, 1000), 256, 999, "iota", "float32", "float32"),
    ("ring_partial", (1, 2, 2, 128, 256), 256, 37, "ring", "float32",
     "float32"),
    ("ring_wrapped", (2, 4, 2, 64, 256), 256, 700, "ring", "float32",
     "float32"),
    ("window0_odd_S", (3, 2, 4, 64, 333), 0, 300, "iota", "float32",
     "float32"),
    ("bf16_kv", (2, 4, 2, 128, 1000), 256, 999, "iota", "bfloat16",
     "float32"),
    ("bf16_all", (1, 2, 3, 32, 517), 0, 516, "iota", "bfloat16", "bfloat16"),
    ("no_visible_slot", (2, 2, 2, 128, 300), 0, 40, "late", "float32",
     "float32"),
    ("G16_hd16", (1, 2, 16, 16, 129), 64, 128, "iota", "float32", "float32"),
]


def _key_pos(kind, S, q_pos, dev):
    if kind == "ring":
        return tattn.ring_positions(q_pos, S, device=dev).int()
    kp = torch.arange(S, dtype=torch.int32, device=dev)
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
    _close_flash(got, want)
    if kind == "late":              # the mean of v over every slot
        _close_flash(got, v.float().mean(1)[:, :, None].expand_as(got))


# name, (B, KV, G, hd, S), window, q_pos, key_pos kind
DECODE_LSE_CASES = [
    ("gemma3_global_half", (1, 16, 2, 128, 4096), 0, 4095, "iota"),
    ("whisper_self", (1, 12, 1, 64, 420), 0, 419, "iota"),
    ("ring_partly_written", (1, 4, 2, 128, 1024), 1024, 700, "ring"),
    ("no_visible_slot", (2, 2, 2, 64, 300), 0, 40, "late"),
]


@pytest.mark.parametrize("name,dims,window,q_pos,kind", DECODE_LSE_CASES)
def test_swa_decode_lse_matches_plain(dev, name, dims, window, q_pos, kind):
    from repro_torch.sharding.collectives import merge_parts
    B, KV, G, hd, S = dims
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, KV, G, hd, generator=g, device=dev)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev)
    kp = _key_pos(kind, S, q_pos, dev)
    sk.reset_launch_counts()
    out, lse = sk.swa_decode(q, k, v, kp, q_pos, window=window,
                             return_lse=True)
    torch.cuda.synchronize()
    assert sk.launch_counts()["swa_decode"] == 1 and sk.lse_launches() == 1
    want, want_lse = sref.decode_ref(q, k, v, kp, q_pos, window=window,
                                     return_lse=True)
    _close_flash(out, want)
    empty = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), empty)
    assert bool(((lse - want_lse).abs() <= 1e-6 * want_lse.abs())[
        ~empty].all())
    # without the flag the launch writes the same out
    assert torch.equal(sk.swa_decode(q, k, v, kp, q_pos, window=window), out)
    # the two halves of the slots, merged by their lse, are the whole
    # copies: a view of a block may start off the kernel's 16-byte
    # alignment (the model's blocks are tensors of their own)
    h = S // 2
    parts = [sk.swa_decode(q, k[:, i * h:(i + 1) * h].clone(),
                           v[:, i * h:(i + 1) * h].clone(),
                           kp[i * h:(i + 1) * h].clone(), q_pos,
                           window=window, return_lse=True)
             for i in range(2)]
    merged = merge_parts(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))
    _close_flash(merged, out)
    top = torch.logsumexp(torch.stack([p[1] for p in parts]), 0)
    assert torch.equal(torch.isneginf(top), empty)
    assert bool(((top - lse).abs() <= 1e-6 * lse.abs())[~empty].all())


def test_swa_decode_ops_vs_model(dev):
    """ops.decode_attention (the kernel) == the model's plain einsum on a
    ring cache, as the serve path calls it."""
    B, H, KV, hd, W = 2, 8, 4, 64, 128
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(B, H, hd, generator=g, device=dev)
    k = torch.randn(B, W, KV, hd, generator=g, device=dev)
    v = torch.randn(B, W, KV, hd, generator=g, device=dev)
    kp = tattn.ring_positions(300, W, device=dev)
    got = sops.decode_attention(q, k, v, kp, 300, window=W)
    want = tattn.decode_attention(q, k, v, kp, 300, window=W)
    _close_flash(got, want)


# ----------------------------------------------------------- swa prefill
# name, (B, KV, G, S, hd), window, causal, dtype
PREFILL_CASES = [
    ("window", (1, 2, 2, 1000, 128), 256, True, "float32"),
    ("window_not_tile", (2, 1, 2, 300, 64), 100, True, "float32"),
    ("causal", (1, 2, 1, 256, 32), 0, True, "float32"),
    ("bidirectional", (1, 1, 2, 200, 16), 0, False, "float32"),
    ("bf16", (1, 2, 2, 517, 128), 128, True, "bfloat16"),
    ("small_window", (1, 1, 2, 130, 16), 16, True, "float32"),
    # 128 queries a block, 48 keys a step: S at a step's edges, a ragged
    # last step (bf16 too), a window under one step
    ("step_minus_1", (1, 1, 2, 47, 64), 0, True, "float32"),
    ("step", (1, 1, 2, 48, 16), 0, False, "float32"),
    ("step_plus_1", (1, 2, 1, 49, 32), 16, True, "float32"),
    ("ragged_last_step_bf16", (1, 2, 2, 161, 128), 40, True, "bfloat16"),
    ("window_under_step", (2, 1, 2, 300, 128), 5, True, "float32"),
]


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
    _close_flash(got, sref.prefill_ref(q, k, v, window=window,
                                       causal=causal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_prefill_deterministic(dev, dtype):
    """Two launches of swa_prefill on the same inputs are bit-equal."""
    B, KV, G, S, hd = 1, 2, 2, 700, 128
    g = torch.Generator(device=dev).manual_seed(8)
    dt = getattr(torch, dtype)
    q = torch.randn(B, KV, G, S, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    first = sk.swa_prefill(q, k, v, window=200)
    second = sk.swa_prefill(q, k, v, window=200)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_swa_wrappers_refuse(dev):
    q = torch.randn(1, 2, 2, 64, device=dev)
    k = torch.randn(1, 50, 2, 64, device=dev)
    kp = torch.arange(50, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        sk.swa_decode(q, k, k, kp.long(), 49)
    with pytest.raises(ValueError, match="head dim"):
        sk.swa_decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                      k[..., :48].contiguous(), kp, 49)
    k_strided = torch.randn(1, 50, 2, 128, device=dev)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        sk.swa_decode(q, k_strided, k, kp, 49)
    q5 = torch.randn(1, 2, 2, 50, 64, device=dev)
    with pytest.raises(ValueError, match="one type"):
        sk.swa_prefill(q5, k.bfloat16(), k.bfloat16(), window=8)
    with pytest.raises(ValueError, match="not defined"):
        sops.swa_prefill(q5, k, k, window=8, causal=False)
    sk.reset_launch_counts()
    sops.decode_attention(q.reshape(1, 4, 64), k, k, kp, 49,
                          use_kernel=False)
    assert sum(sk.launch_counts().values()) == 0


# ----------------------------------------------------------------- widen
@pytest.mark.parametrize("shape,axis", [((300, 260), 1), ((7, 30), 1),
                                        ((2, 100, 64), 1), ((130,), 0),
                                        ((3, 3, 20, 33), 3),
                                        ((3, 3, 20, 33), 2),
                                        ((4, 13000), 1)])
@pytest.mark.parametrize("split", [False, True])
def test_widen_matches_plain(dev, shape, axis, split):
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(shape, generator=g, device=dev)
    old = shape[axis]
    m = nc.dup_mapping(old, old + old // 2 + 1, tag="c", seed=2)
    wk.reset_launch_counts()
    got = wops.widen(x, m, axis=axis, split=split)
    torch.cuda.synchronize()
    assert wk.launch_counts()["widen_2d"] == 1
    want = wops.widen(x, m, axis=axis, split=split, use_kernel=False)
    assert got.shape == want.shape and torch.equal(got, want)
    # core.netchange routes through the kernel, bit-equal to the CPU
    core = (nc.widen_out(x, m, old, axis=axis) if split
            else nc.widen_in(x, m, axis=axis))
    assert wk.launch_counts()["widen_2d"] == 2
    cpu = (nc.widen_out(x.cpu(), m, old, axis=axis) if split
           else nc.widen_in(x.cpu(), m, axis=axis))
    assert torch.equal(core.cpu(), cpu)


def test_widen_wrapper_refuses(dev):
    x = torch.randn(4, 6, device=dev)
    m = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        wk.widen_2d(x.double(), m)
    with pytest.raises(ValueError, match="dtype"):
        wk.widen_2d(x, m.long())
    with pytest.raises(ValueError, match="contiguous"):
        wk.widen_2d(x.t(), m)
    with pytest.raises(ValueError, match="f32"):
        wops.widen_cols(x.double(), [0, 1, 2])
