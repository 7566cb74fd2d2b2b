"""The one-launch ``swa_decode`` and the realigned ``plane_accum_q``.

On the CPU (here): ``swa.decode_split``'s plan of the decode cluster;
a plain torch model of the cluster's merge (chunked online softmax per
block, the blocks' states merged in rank order, the mean of v when no
block saw a slot) held against the JAX package's
``repro.kernels.swa_attention.ref.decode_ref`` through numpy at 1e-6;
and a numpy model of ``plane_accum_q``'s load-and-realign step
(``fedavg.cu`` ``RowC``) at every row byte offset.

On the card (marked ``cuda``; they skip where there is none):

    python -m pytest -m cuda tests/test_torch_decode_accum_q.py

``swa_decode`` at clusters of 1, 2, 8 and 16 blocks makes one kernel
launch and one allocation a call, two launches are bit-equal, and it
holds against the plain version at 2e-5 x the largest |value| (the card
tests' attention tolerance, ``tests/test_torch_cuda.py``);
``plane_accum_q`` in all four variants at N in {1, 15, 16, 17, 31,
100_003}, on row slices whose base is at an odd byte offset, at tiles
128 and 384, within 1e-6 x scale of its plain version. The JAX package
is imported only by the CPU tests: the card's machine has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels.fedavg import fedavg as fk  # noqa: E402
from repro_torch.kernels.fedavg import ops  # noqa: E402
from repro_torch.kernels.swa_attention import ref as sref  # noqa: E402
from repro_torch.kernels.swa_attention import swa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

SERVE_LOCAL = (4, 16, 2, 1024)       # gemma3-27b serve, ring W 1024
SERVE_GLOBAL = (4, 16, 2, 4128)      # 4096 prompt + 32 tokens
JAX_BENCH = (1, 8, 2, 16384)         # benchmarks/kernels.py's decode
H100_SMS = 132                       # the H100 SXM's SMs
HD = 128                             # gemma3-27b's head dim


# ------------------------------------------------------- decode plan (CPU)
@pytest.mark.parametrize("B,KV,G,S", [
    SERVE_LOCAL, SERVE_GLOBAL, JAX_BENCH, (1, 1, 1, 1), (1, 1, 1, 31),
    (1, 2, 2, 50), (3, 6, 1, 129), (2, 2, 16, 1000), (2, 4, 2, 3001),
    (1, 2, 16, 129), (64, 16, 2, 1024), (1, 1, 3, 100_000)])
def test_decode_split_plan(B, KV, G, S):
    """Each cluster's blocks cover S exactly once, no block is empty, the
    groups are multiples of 16 keys, and a cluster holds at most the
    portable 8 blocks, or 16 where 8 would leave SMs idle."""
    n = swa.decode_split(B, KV, G, S, H100_SMS, HD)
    group = swa.DECODE_KEYS_PER_STEP
    rows = B * KV * -(-G // swa.group_chunk(G, HD))
    limit = (swa.DECODE_CLUSTER_MAX
             if rows * swa.DECODE_CLUSTER < H100_SMS
             else swa.DECODE_CLUSTER)
    assert group % 16 == 0 and 1 <= n <= limit
    slots = swa.decode_slots(S, n)
    assert all(slots), "a block without a slot"
    flat = sorted(s for block in slots for s in block)
    assert flat == list(range(S))
    assert n * rows >= min(swa.DECODE_BLOCKS_PER_SM * H100_SMS,
                           rows * limit, rows * -(-S // group))


def test_decode_split_cluster_sizes():
    """The serve shapes take portable clusters of 8; the JAX benchmark's
    8 (b, kv head) pairs take 16, so 128 blocks rather than 64 share the
    1,024 visible slots; a short cache takes fewer blocks; a card of
    fewer SMs takes fewer blocks and keeps clusters of 16 for fewer
    pairs."""
    g = swa.DECODE_KEYS_PER_STEP
    assert swa.decode_split(*SERVE_LOCAL, H100_SMS, HD) == 8
    assert swa.decode_split(*SERVE_GLOBAL, H100_SMS, HD) == 8
    assert swa.decode_split(*JAX_BENCH, H100_SMS, HD) == 16
    assert swa.decode_split(1, 1, 1, g + 9, H100_SMS, HD) == 2
    assert swa.decode_split(1, 1, 1, g - 3, H100_SMS, HD) == 1
    assert swa.decode_split(*SERVE_LOCAL, 16, HD) == 1
    assert swa.decode_split(*JAX_BENCH, 64, HD) == 8
    with pytest.raises(ValueError, match="65535"):
        swa.decode_split(65536, 1, 1, 64, H100_SMS, HD)


# ------------------------------------------ the cluster merge, modelled (CPU)
def cluster_model(q, k, v, key_pos, q_pos, window, n_split):
    """What one decode cluster computes, in plain torch (f32): block r
    walks its slots (``swa.decode_slots``) a warp step at a time with an
    online softmax; the blocks' (m, l, acc) merge in rank order; if no
    block saw a slot, the mean of v over all S slots."""
    step = swa.DECODE_KEYS_PER_STEP // 4
    B, KV, G, hd = q.shape
    S = k.shape[1]
    qs = q.float() * hd ** -0.5
    vis = (key_pos >= 0) & (key_pos <= q_pos)
    if window > 0:
        vis = vis & (q_pos - key_pos < window)
    states = []
    for block in swa.decode_slots(S, n_split):
        m = torch.full((B, KV, G), -torch.inf)
        l = torch.zeros(B, KV, G)
        acc = torch.zeros(B, KV, G, hd)
        for i in range(0, len(block), step):
            idx = torch.tensor(block[i:i + step])
            ok = vis[idx]
            if not bool(ok.any()):
                continue
            kk = k[:, idx].float().permute(0, 2, 1, 3)      # B KV s hd
            vv = v[:, idx].float().permute(0, 2, 1, 3)
            sc = torch.einsum("bkgd,bksd->bkgs", qs, kk)
            mx = torch.maximum(m, sc.masked_fill(~ok, -torch.inf).amax(-1))
            p = torch.exp(sc - mx[..., None]) * ok
            corr = torch.exp(m - mx)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgs,bksd->bkgd",
                                                       p, vv)
            m = mx
        states.append((m, l, acc))
    if not any(bool((l > 0).any()) for _, l, _ in states):
        return v.float().mean(1)[:, :, None].expand(B, KV, G, hd)
    M = torch.full((B, KV, G), -torch.inf)
    for m, l, _ in states:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    L = torch.zeros(B, KV, G)
    A = torch.zeros(B, KV, G, hd)
    for m, l, acc in states:
        c = torch.where(l > 0, torch.exp(m - M), torch.zeros(()))
        L = L + l * c
        A = A + acc * c[..., None]
    return A / torch.clamp(L, min=1e-30)[..., None]


def _key_pos(kind, S, q_pos):
    if kind == "ring":
        return tattn.ring_positions(q_pos, S).to(torch.int32)
    kp = torch.arange(S, dtype=torch.int32)
    return kp + q_pos + 1 if kind == "late" else kp


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("kind,S,window,q_pos", [
    ("iota", 1000, 256, 999),          # a window: most blocks see nothing
    ("iota", 333, 0, 300),             # odd S, full causal
    ("ring", 256, 256, 37),            # a partly written ring
    ("ring", 256, 256, 700),           # a wrapped ring
    ("late", 300, 0, 40),              # no visible slot: the mean of v
])
def test_cluster_merge_matches_jax(n_split, kind, S, window, q_pos):
    import jax.numpy as jnp

    from repro.kernels.swa_attention import ref as jref

    B, KV, G, hd = 2, 2, 3, 32
    rng = np.random.default_rng(1000 * n_split + S)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kp = _key_pos(kind, S, q_pos)
    got = cluster_model(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), kp, q_pos, window, n_split)
    want = jref.decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(kp.numpy()), jnp.int32(q_pos),
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------- plane_accum_q's realignment, modelled
def row_model(mem, lo, n, c0s, E, C):
    """``fedavg.cu`` ``RowC<E, C>`` for one warp: lane i's first column is
    ``c0s[i]``; returns each lane's C elements' bytes and every word
    address read. ``mem`` is the allocation (aligned at 0), the row its
    bytes [lo, lo + n E)."""
    B = C * E
    V = min(B, 16)
    end = lo + n * E
    o = lo % V
    words, reads, tails = [], set(), {}
    for lane, c0 in enumerate(c0s):
        a = lo + c0 * E - o
        own = []
        for j in range(B // V):
            if a + V * j < end:
                reads.add(a + V * j)
                own.append(mem[a + V * j:a + V * j + V])
            else:
                own.append(np.zeros(V, np.uint8))
        words.append(own)
        if lane == len(c0s) - 1 and o and a + B < end:
            reads.add(a + B)
            tails[lane] = mem[a + B:a + B + V]
    out = []
    for lane in range(len(c0s)):
        nxt = (words[lane + 1][0] if lane + 1 < len(c0s)
               else tails.get(lane, np.zeros(V, np.uint8)))
        x = np.concatenate(words[lane] + [nxt])
        out.append(x[o:o + B])
    return out, reads, V


@pytest.mark.parametrize("E,C", [(1, 8), (1, 4), (4, 8), (4, 4)])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 100, 513, 1029])
def test_row_realignment_model(E, C, n):
    """Every lane gets its C columns at every row offset, including the
    ragged end and rows narrower than a lane's columns; no word outside
    the row's granules is read."""
    rng = np.random.default_rng(n)
    for off in range(0, 16, E):
        mem = rng.integers(0, 256, 64 + n * E + 64, dtype=np.uint8)
        lo = 32 + off
        for warp0 in range(0, n, 32 * C):
            c0s = [warp0 + C * i for i in range(32)]
            got, reads, V = row_model(mem, lo, n, c0s, E, C)
            for c0, g in zip(c0s, got):
                cols = min(C, max(0, n - c0))
                want = mem[lo + c0 * E:lo + (c0 + cols) * E]
                assert bytes(g[:cols * E]) == bytes(want), (off, c0)
            first, last = lo - lo % V, lo + n * E - 1
            assert all(a % V == 0 and first <= a <= last for a in reads)


# ------------------------------------------------------------- on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++)")
    return torch.device("cuda", 0)


def _close_flash(got, want):
    want = want.float()
    finite = want[torch.isfinite(want)]
    scale = max(float(finite.abs().max()) if finite.numel() else 0.0, 1.0)
    err = float((got.float() - want).abs().max())
    assert err <= 2e-5 * scale, (err, scale)


def _decode_kernels(fn):
    """The CUDA kernels ``fn`` launched, by name (torch.profiler)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "decode" in e.name]


# name, (B, KV, G, hd, S), window, q_pos, key_pos kind, kv dtype, n_split
GROUP = swa.DECODE_KEYS_PER_STEP
CLUSTER_CASES = [
    ("one_block", (2, 2, 2, 128, GROUP - 3), 0, GROUP - 4, "iota",
     torch.float32, 1),
    ("two_blocks", (1, 2, 2, 64, GROUP + 9), 0, GROUP + 8, "iota",
     torch.float32, 2),
    ("eight_serve_local", (4, 16, 2, 128, 1024), 1024, 4127, "ring",
     torch.float32, 8),
    ("sixteen_jax_bench", (1, 8, 2, 128, 16384), 1024, 16383, "iota",
     torch.float32, 16),
    ("sixteen_bf16", (1, 8, 2, 128, 4096), 512, 4000, "iota",
     torch.bfloat16, 16),
    ("sixteen_no_visible_slot", (1, 4, 2, 64, 3001), 0, 40, "late",
     torch.float32, 16),
    ("eight_no_visible_slot", (4, 16, 2, 128, 777), 0, 40, "late",
     torch.float32, 8),
    ("G16_hd16_odd_S", (1, 2, 16, 16, 1001), 64, 900, "iota",
     torch.float32, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dims,window,q_pos,kind,dtype,n_split",
                         CLUSTER_CASES)
def test_swa_decode_one_cluster_launch(dev, name, dims, window, q_pos, kind,
                                       dtype, n_split):
    B, KV, G, hd, S = dims
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert swa.decode_split(B, KV, G, S, sms, hd) == n_split
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, KV, G, hd, generator=g, device=dev)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    kp = _key_pos(kind, S, q_pos).to(dev)
    got = swa.swa_decode(q, k, v, kp, q_pos, window=window)
    torch.cuda.synchronize()
    # one allocation (out) and one kernel launch a call
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    swa.reset_launch_counts()
    again = swa.swa_decode(q, k, v, kp, q_pos, window=window)
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.synchronize()
    assert after - before == 1
    assert swa.launch_counts()["swa_decode"] == 1
    names = _decode_kernels(
        lambda: swa.swa_decode(q, k, v, kp, q_pos, window=window))
    assert len(names) == 1 and "swa_decode_kernel" in names[0], names
    assert torch.equal(got, again)                     # bit-equal
    want = sref.decode_ref(q, k, v, kp, q_pos, window=window)
    _close_flash(got, want)
    if kind == "late":              # the mean of v over every slot
        _close_flash(got, v.float().mean(1)[:, :, None].expand_as(got))


@pytest.mark.cuda
def test_swa_decode_refuses(dev):
    """Inputs the kernel does not take raise; nothing falls back."""
    q = torch.randn(1, 2, 2, 64, device=dev)
    k = torch.randn(1, 40, 2, 64, device=dev)
    kp = torch.arange(40, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        swa.swa_decode(torch.randn(1, 2, 2, 48, device=dev),
                       torch.randn(1, 40, 2, 48, device=dev),
                       torch.randn(1, 40, 2, 48, device=dev), kp, 39)
    with pytest.raises(ValueError, match="int32"):
        swa.swa_decode(q, k, k, kp.long(), 39)
    with pytest.raises(ValueError, match="contiguous"):
        swa.swa_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                       k, kp, 39)
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa.swa_decode(q.cpu(), k.cpu(), k.cpu(), kp.cpu(), 39)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "masks", "masked_mult",
                                     "fold"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 100_003])
@pytest.mark.parametrize("tile", [128, 384])
def test_plane_accum_q_realigned(dev, variant, n, tile):
    """Row slices ``xq[3:]`` (base at byte 3 n: odd for odd n), so with
    n = 17 the 16 rows start at every byte offset 0-15; the masks and
    multiplicities are row slices too."""
    K = 19
    g = torch.Generator(device=dev).manual_seed(n + tile)
    x = torch.randn(K, n, generator=g, device=dev)
    w = torch.rand(K, generator=g, device=dev) + 0.1
    w /= w.sum()
    m = (torch.rand(K, n, generator=g, device=dev) < 0.6).float()
    mu = torch.randint(1, 4, (K, n), generator=g, device=dev).float() * m
    base = torch.randn(n, generator=g, device=dev)
    xq, s = quant.quantize(x, "int8", tile=tile)
    xq, s, w, m, mu = xq[3:], s[3:], w[3:], m[3:], mu[3:]
    assert xq.is_contiguous() and xq.data_ptr() % 16 == (3 * n) % 16
    kw = {"plain": {}, "masks": dict(masks=m),
          "masked_mult": dict(masks=m, mult=mu),
          "fold": dict(masks=m, base=base)}[variant]
    z = torch.zeros(n, device=dev)
    fk.reset_launch_counts()
    got = ops.plane_accum_q(z, z, z, xq, s, w, tile=tile, **kw)
    again = ops.plane_accum_q(z, z, z, xq, s, w, tile=tile, **kw)
    torch.cuda.synchronize()
    assert fk.launch_counts()["plane_accum_q"] == 2
    want = ops.plane_accum_q(z, z, z, xq, s, w, tile=tile, use_kernel=False,
                             **kw)
    deq = quant.dequantize(xq, s, tile=tile)
    big = max(float(deq.abs().max()), float(base.abs().max()), 1.0)
    wsum = float(w.abs().sum())
    for got_t, again_t, want_t, scale in zip(got, again, want,
                                             (big * wsum, wsum, K - 3)):
        assert torch.equal(got_t, again_t)
        err = float((got_t - want_t).abs().max())
        assert err <= 1e-6 * scale, (err, scale)
