"""The hand-written fedavg CUDA kernels vs their plain PyTorch versions,
on the card (marked ``cuda``; they skip where there is none):

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance 1e-6 × max|x|: both sum the same <= 20 f32 products per
coordinate, in different orders.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fedavg import fedavg as fk  # noqa: E402
from repro_torch.kernels.fedavg import ops, ref  # noqa: E402

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
