"""The port's To-Wider gather vs the JAX package's, on the CPU: the plain
version (``kernels/netchange/ref.py``) and the CPU dispatch of
``ops.widen_cols`` / ``ops.widen`` against
``repro.kernels.netchange.ops.widen_cols`` (the Pallas one-hot matmul in
interpret mode) and ``repro.kernels.netchange.ref.widen_ref``, at the
shapes of the JAX package's ``tests/test_kernels.py``, duplicate and
split; and against the port's own ``core.netchange.widen_in`` /
``widen_out``, which route through it.

Inputs come from a numpy seed; mappings from the shared sha256-seeded
``dup_mapping``. Tolerance 1e-6: a gather times one f32 scale per column
is exact, and the Pallas kernel's one-hot matmul adds only zeros to it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import netchange as jnc  # noqa: E402
from repro.kernels.netchange import ops as jops  # noqa: E402
from repro.kernels.netchange import ref as jref  # noqa: E402
from repro_torch.core import netchange as nc  # noqa: E402
from repro_torch.kernels.netchange import ops, ref  # noqa: E402
from repro_torch.kernels.netchange import widen as kwiden  # noqa: E402

TOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rows,old,new", [(7, 30, 50), (64, 128, 256),
                                          (5, 3, 100), (300, 260, 261)])
@pytest.mark.parametrize("split", [False, True])
def test_widen_cols_matches_jax(rows, old, new, split):
    x = np.random.default_rng(rows + old).standard_normal(
        (rows, old)).astype(np.float32)
    mapping = nc.dup_mapping(old, new, tag="k", seed=3)
    np.testing.assert_array_equal(
        mapping, jnc.dup_mapping(old, new, tag="k", seed=3))
    scale = ops.split_scale(mapping, old) if split else np.ones(new,
                                                                np.float32)
    want_kernel = jops.widen_cols(jnp.asarray(x), mapping, split=split)
    want_ref = jref.widen_ref(jnp.asarray(x), jnp.asarray(mapping),
                              jnp.asarray(scale))
    got = ops.widen_cols(torch.from_numpy(x), mapping, split=split)
    got_ref = ref.widen_ref(torch.from_numpy(x), torch.from_numpy(mapping),
                            torch.from_numpy(scale))
    assert got.shape == (rows, new) and got.dtype == torch.float32
    _close(got_ref, want_ref)
    _close(got, want_kernel)
    _close(got, got_ref)


def test_widen_matches_core_semantics():
    """ops.widen_cols == core.netchange.widen_in / widen_out on real
    weights, in both packages (JAX ``test_widen_kernel_matches_core_...``),
    and the port's widen_in / widen_out match the JAX ones."""
    w = np.random.default_rng(7).standard_normal((40, 24)).astype(np.float32)
    m = nc.dup_mapping(24, 40, tag="q", seed=7)
    tw = torch.from_numpy(w)
    _close(ops.widen_cols(tw, m, split=False), nc.widen_in(tw, m, axis=-1))
    _close(ops.widen_cols(tw, m, split=True),
           nc.widen_out(tw.T, m, 24, axis=0).T)
    _close(nc.widen_in(tw, m, axis=-1),
           jnc.widen_in(jnp.asarray(w), m, axis=-1))
    _close(nc.widen_out(tw.T, m, 24, axis=0),
           jnc.widen_out(jnp.asarray(w).T, m, 24, axis=0))
    _close(ops.widen_cols(tw, m, split=True),
           jops.widen_cols(jnp.asarray(w), m, split=True))


@pytest.mark.parametrize("shape,axis", [((3, 5, 6, 4), 2), ((6, 7), 0),
                                        ((2, 9, 5), 1), ((11,), 0),
                                        ((4, 3, 3, 8), -1)])
@pytest.mark.parametrize("split", [False, True])
def test_widen_any_axis(shape, axis, split):
    """``ops.widen`` along any axis (what NetChange's conv, fc and FFN
    leaves need) == the JAX package's ``widen_in`` / ``widen_out``."""
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    old = shape[axis]
    m = nc.dup_mapping(old, old + 5, tag="a", seed=1)
    got = ops.widen(torch.from_numpy(x), m, axis=axis, split=split)
    want = (jnc.widen_out(jnp.asarray(x), m, old, axis=axis) if split
            else jnc.widen_in(jnp.asarray(x), m, axis=axis))
    assert got.shape == want.shape
    _close(got, want)


def test_widen_refuses_bad_mappings_and_cpu_kernel():
    x = torch.zeros(3, 4)
    for bad in ([0, 4], [-1, 0], []):
        with pytest.raises(ValueError, match="mapping"):
            ops.widen_cols(x, np.asarray(bad, np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.widen_cols(x, [0, 1, 1], use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kwiden.widen_2d(x, torch.zeros(5, dtype=torch.int32))
