"""The port's fedavg aggregation ops vs the JAX package's.

The plain PyTorch versions (``repro_torch.kernels.fedavg.ref``, what the
port runs on CPU tensors and what ``chip_smoke.py`` holds each CUDA
kernel against on the card) are held against

  * the JAX package's jnp oracles (``repro.kernels.fedavg.ref``), and
  * its Pallas kernels run as its own tests run them on the CPU
    (``interpret=True``),

on the same numpy-seeded inputs, to 1e-6 — the kernel-vs-oracle
tolerance of ``tests/test_plane.py``: both sides sum the same <= 6 f32
products per coordinate in different orders. Covered: lane-odd P,
``k_chunk`` in {1, 2, K-1, K}, the w = 0 corner (coordinates covered
only by zero-weight clients — why ``plane_accum`` keeps ``cov`` apart
from ``den``), and streamed == whole-plane.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fedavg import fedavg as jfk  # noqa: E402
from repro.kernels.fedavg import ops as jops  # noqa: E402
from repro.kernels.fedavg import ref as jref  # noqa: E402
from repro_torch.kernels.fedavg import ops as tops  # noqa: E402
from repro_torch.kernels.fedavg import ref as tref  # noqa: E402

ATOL = 1e-6
K = 6


def _inputs(n, *, k=K, seed=0, zero_rows=0):
    """numpy x, w (normalized; the first ``zero_rows`` are 0), 0/1 masks
    m (the last 3 columns uncovered; with ``zero_rows``, columns 0:4
    covered only by zero-weight clients), multiplicities mu (0 where m
    is 0) and fallback fb."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, n)).astype(np.float32)
    w = (rng.random(k) + 0.1).astype(np.float32)
    w[:zero_rows] = 0.0
    w = (w / w.sum()).astype(np.float32)
    m = (rng.random((k, n)) < 0.6).astype(np.float32)
    if zero_rows:
        m[:, :4] = 0.0
        m[:zero_rows, :4] = 1.0
    m[:, -3:] = 0.0
    mu = (rng.integers(1, 4, (k, n)) * m).astype(np.float32)
    fb = rng.standard_normal(n).astype(np.float32)
    return x, w, m, mu, fb


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a.copy())
            for a in arrays]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


AGG_CASES = [  # (masks, mult, fallback, renorm)
    (False, False, False, True),
    (True, False, False, True),
    (True, False, False, False),
    (True, True, False, True),
    (True, True, True, True),
    (True, False, True, False),
]


@pytest.mark.parametrize("masks,mult,fallback,renorm", AGG_CASES)
@pytest.mark.parametrize("n,zero_rows", [(300, 0), (257, 2)])
def test_plane_agg_ref_matches_jax(masks, mult, fallback, renorm, n,
                                   zero_rows):
    x, w, m, mu, fb = _inputs(n, zero_rows=zero_rows)
    opt = dict(masks=m if masks else None, mult=mu if mult else None,
               fallback=fb if fallback else None)
    want = jref.plane_agg_ref(
        jnp.asarray(x), jnp.asarray(w), renorm=renorm,
        **{k: None if v is None else jnp.asarray(v) for k, v in opt.items()})
    tx, tw = _t(x, w)
    topt = dict(zip(opt, _t(*opt.values())))
    _close(tref.plane_agg_ref(tx, tw, renorm=renorm, **topt), want)
    # the ops layer on CPU tensors runs exactly this plain version
    _close(tops.plane_agg(tx, tw, renorm=renorm, **topt), want)


@pytest.mark.parametrize("masks,mult", [(False, False), (True, False),
                                        (True, True)])
@pytest.mark.parametrize("two_d", [False, True])
def test_plane_accum_ref_matches_jax(masks, mult, two_d):
    x, w, m, mu, _ = _inputs(259, seed=1)
    rng = np.random.default_rng(2)
    shape = (1, 259) if two_d else (259,)
    bufs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    mm = m if masks else None
    uu = mu if mult else None
    want = jref.plane_accum_ref(*[jnp.asarray(b) for b in bufs],
                                jnp.asarray(x), jnp.asarray(w),
                                None if mm is None else jnp.asarray(mm),
                                None if uu is None else jnp.asarray(uu))
    got = tref.plane_accum_ref(*_t(*bufs), *_t(x, w, mm, uu))
    for g, e in zip(got, want):
        assert tuple(g.shape) == tuple(e.shape)
        _close(g, e)


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("fallback", [True, False])
def test_plane_finish_ref_matches_jax(renorm, fallback):
    rng = np.random.default_rng(3)
    num = rng.standard_normal(200).astype(np.float32)
    den = np.where(rng.random(200) < 0.2, 0.0,
                   rng.random(200)).astype(np.float32)
    cov = np.where(rng.random(200) < 0.2, 0.0, 2.0).astype(np.float32)
    fb = rng.standard_normal(200).astype(np.float32) if fallback else None
    want = jref.plane_finish_ref(
        jnp.asarray(num), jnp.asarray(den), jnp.asarray(cov),
        None if fb is None else jnp.asarray(fb), renorm=renorm)
    got = tref.plane_finish_ref(*_t(num, den, cov, fb), renorm=renorm)
    _close(got, want)
    _close(tops.plane_finish(*_t(num, den, cov), fallback=_t(fb)[0],
                             renorm=renorm), want)


def test_plain_versions_match_pallas_interpret():
    """The four TPU kernels, run in interpret mode on the lane-padded
    operands, against the port's plain versions on the same inputs."""
    n = 384
    x, w, m, mu, fb = _inputs(n, seed=4, zero_rows=1)
    jx, jw, jm, jmu, jfb = map(jnp.asarray, (x, w, m, mu, fb))
    tx, tw, tm, tmu, tfb = _t(x, w, m, mu, fb)
    kw = dict(block=128, interpret=True)
    _close(tref.weighted_sum_ref(tx, tw), jfk.weighted_sum_2d(jx, jw, **kw))
    _close(tref.plane_agg_ref(tx, tw, masks=tm, mult=tmu, fallback=tfb),
           jfk.plane_agg_2d(jx, jw, jm, jmu, jfb, **kw))
    z = np.zeros((1, n), np.float32)
    trip = jfk.plane_accum_2d(*[jnp.asarray(z)] * 3, jx, jw, jm, jmu, **kw)
    mine = tref.plane_accum_ref(*_t(z, z, z), tx, tw, tm, tmu)
    for g, e in zip(mine, trip):
        _close(g, e)
    jfin = jfk.plane_finish_2d(*trip, jnp.asarray(fb[None]), **kw)
    _close(tref.plane_finish_ref(*mine, torch.from_numpy(fb[None])), jfin)


@pytest.mark.parametrize("kc", [1, 2, K - 1, K])
@pytest.mark.parametrize("zero_rows", [0, 2])
def test_stream_equals_plane(kc, zero_rows):
    """PlaneAccumulator chunks + finish == the whole-plane pass == the
    JAX package's whole-plane pass, at a lane-odd P, coverage (masks,
    mult, fallback) and plain Eq. 1."""
    n = 389
    x, w, m, mu, fb = _inputs(n, seed=5, zero_rows=zero_rows)
    tx, tw, tm, tmu, tfb = _t(x, w, m, mu, fb)
    want_c = jops.plane_agg(*map(jnp.asarray, (x, w)), masks=jnp.asarray(m),
                            mult=jnp.asarray(mu), fallback=jnp.asarray(fb),
                            use_kernel=False)
    want_f = jops.plane_agg(jnp.asarray(x), jnp.asarray(w), use_kernel=False)
    acc_c = tops.PlaneAccumulator(n, device="cpu")
    acc_f = tops.PlaneAccumulator(n, device="cpu")
    for lo in range(0, K, kc):
        hi = min(lo + kc, K)
        acc_c.update(tx[lo:hi], tw[lo:hi], masks=tm[lo:hi], mult=tmu[lo:hi])
        acc_f.update(tx[lo:hi], tw[lo:hi])
    _close(acc_c.finish(fallback=tfb), want_c)
    _close(acc_f.finish(renorm=False), want_f)
    _close(tops.plane_agg(tx, tw, masks=tm, mult=tmu, fallback=tfb),
           want_c)
    st = acc_c.stats()
    assert st["rows"] == K and st["chunks"] == -(-K // kc)
    assert st["peak_chunk_rows"] == min(kc, K)
    if zero_rows:
        # covered only by zero-weight clients: renorm gives 0, not fb
        assert np.all(np.asarray(acc_c.finish(fallback=tfb))[:4] == 0.0)


def test_accumulator_merge_equals_single():
    n = 261
    x, w, m, mu, fb = _inputs(n, seed=6)
    tx, tw, tm, tmu, tfb = _t(x, w, m, mu, fb)
    a = tops.PlaneAccumulator(n, device="cpu").update(
        tx[:2], tw[:2], masks=tm[:2], mult=tmu[:2])
    b = tops.PlaneAccumulator(n, device="cpu").update(
        tx[2:], tw[2:], masks=tm[2:], mult=tmu[2:])
    whole = tops.PlaneAccumulator(n, device="cpu").update(
        tx, tw, masks=tm, mult=tmu)
    _close(a.merge(b).finish(fallback=tfb), whole.finish(fallback=tfb))
    for p, q in zip(a.partials(), whole.partials()):
        assert tuple(p.shape) == (n,)
        _close(p, q)


def test_functional_plane_accum_matches_jax():
    n = 130
    x, w, m, mu, _ = _inputs(n, seed=7)
    z = np.zeros(n, np.float32)
    want = jops.plane_accum(*[jnp.asarray(z)] * 3, jnp.asarray(x),
                            jnp.asarray(w), masks=jnp.asarray(m),
                            mult=jnp.asarray(mu), use_kernel=False)
    got = tops.plane_accum(*_t(z, z, z), *_t(x, w), masks=_t(m)[0],
                           mult=_t(mu)[0])
    for g, e in zip(got, want):
        _close(g, e)


@pytest.mark.parametrize("n", [1, 130, 389])
def test_accumulator_buffers_are_unpadded(n):
    """The kernels take any parameter count, so the accumulator holds
    exactly three ``(1, n)`` buffers and streams chunks without padding
    copies: its memory accounting is 3·4·n plus the largest chunk."""
    x, w, m, mu, _ = _inputs(n, seed=8)
    tx, tw, tm, tmu = _t(x, w, m, mu)
    acc = tops.PlaneAccumulator(n, device="cpu")
    acc.update(tx[:4], tw[:4], masks=tm[:4], mult=tmu[:4])
    acc.update(tx[4:], tw[4:])
    st = acc.stats()
    assert st["buffer_bytes"] == 3 * 4 * n
    assert st["chunk_bytes"] == 4 * n * 4 * 3
    assert st["peak_bytes"] == st["buffer_bytes"] + st["chunk_bytes"]
    assert all(tuple(p.shape) == (n,) for p in acc.partials())


def test_filler_finish_is_the_numerator():
    """renorm off and no fallback (the filler stream round): the
    numerator is the result, so ``finish`` returns it without a pass —
    the same numbers as the JAX package's finish."""
    n = 257
    x, w, _, _, _ = _inputs(n, seed=9)
    tx, tw = _t(x, w)
    acc = tops.PlaneAccumulator(n, device="cpu").update(tx, tw)
    out = acc.finish(renorm=False)
    assert out.data_ptr() == acc.partials()[0].data_ptr()
    jacc = jops.PlaneAccumulator(n, use_kernel=False).update(
        jnp.asarray(x), jnp.asarray(w))
    _close(out, jacc.finish(renorm=False))
    num = tops.plane_agg(tx, tw)
    z = torch.zeros(n)
    assert torch.equal(tops.plane_finish(num, z, z, renorm=False), num)
