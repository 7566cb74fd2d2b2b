"""The port's wire formats (``repro_torch.core.quant``) vs the JAX
package's (``repro.core.quant``).

The encode is plain tensor code in both packages, so the port must give
the same BITS for the same input: int8 values, f32 per-tile scales,
error-feedback residuals and bf16 payloads are compared for equality,
not to a tolerance — lane-odd rows (the last tile straddles the row
end), 0/1 masks (the sparse wire), all-zero tiles (scale 0) and tiles
of 128 / 256 / 512 coordinates. Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402

SHAPES = [(3, 1000), (2, 4096 * 2 + 517), (4, 256), (1, 100), (777,)]


def _inputs(shape, tile, seed):
    """x with an all-zero first tile and (2-D) an all-zero row, a small
    residual e and a 0/1 mask."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 5.0).astype(np.float32)
    x[..., :tile] = 0.0
    if len(shape) == 2 and shape[0] > 1:
        x[1] = 0.0
    e = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    m = rng.integers(0, 2, shape).astype(np.float32)
    return x, e, m


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_quantize_bit_equal(shape, tile, masked):
    x, _, m = _inputs(shape, tile, seed=sum(shape) + tile)
    jv, js = jq.quantize(jnp.asarray(x), "int8", tile=tile,
                         mask=jnp.asarray(m) if masked else None)
    tv, ts = tq.quantize(torch.from_numpy(x), "int8", tile=tile,
                         mask=torch.from_numpy(m) if masked else None)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == shape[:-1] + (tq.n_tiles(shape[-1], tile),)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the all-zero tile: scale 0, payload 0
    assert float(ts[..., 0].abs().max()) == 0.0
    assert int(tv[..., :tile].abs().max()) == 0
    np.testing.assert_array_equal(
        tq.dequantize(tv, ts, tile=tile).numpy(),
        np.asarray(jq.dequantize(jv, js, tile=tile)))


@pytest.mark.parametrize("fmt", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_encode_bit_equal(fmt, shape, masked):
    tile = 256
    x, e, m = _inputs(shape, tile, seed=len(shape) * 7 + shape[-1])
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    for res in (e, None):
        jvals, jsc, jres = jq.encode(
            jnp.asarray(x), None if res is None else jnp.asarray(res), fmt,
            tile=tile, mask=jm)
        tvals, tsc, tres = tq.encode(
            torch.from_numpy(x), None if res is None else
            torch.from_numpy(res), fmt, tile=tile, mask=tm)
        assert str(tvals.dtype).split(".")[-1] == \
            {"int8": "int8", "bf16": "bfloat16", "f32": "float32"}[fmt]
        np.testing.assert_array_equal(_np(tvals), _np(jvals))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        if fmt == "int8":
            np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        else:
            assert tsc is None and jsc is None


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_residual_identity_exact(fmt):
    """deq(q) + e' == x + e bit for bit (tests/test_quant.py:47), and
    off the mask there is neither payload nor residual."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 700)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((2, 700)) * 0.05
                          ).astype(np.float32))
    vals, scales, e2 = tq.encode(x, e, fmt, tile=256)
    assert torch.equal(tq.dequantize(vals, scales, tile=256) + e2, x + e)
    m = torch.from_numpy(rng.integers(0, 2, (2, 700)).astype(np.float32))
    vals, scales, e2 = tq.encode(x, e, fmt, tile=128, mask=m)
    off, on = m == 0, m == 1
    assert float(vals.float()[off].abs().max()) == 0.0
    assert float(e2[off].abs().max()) == 0.0
    lhs = tq.dequantize(vals, scales, tile=128) + e2
    assert torch.equal(lhs[on], (x + e)[on])


def test_payload_bytes_and_tiles_match_jax():
    for n in (1, 127, 1000, 40_717_642):
        for tile in (128, 256, 512):
            assert tq.n_tiles(n, tile) == jq.n_tiles(n, tile)
            for fmt in tq.WIRE_FORMATS:
                for covered in (None, 0, n // 3):
                    assert tq.payload_nbytes(fmt, n, tile=tile,
                                             covered=covered) == \
                        jq.payload_nbytes(fmt, n, tile=tile, covered=covered)
    # the VGG main path's int8 round: 20 clients of P = 40,717,642
    assert 20 * tq.payload_nbytes("int8", 40_717_642) == 827_077_160
    assert tq.WIRE_FORMATS == jq.WIRE_FORMATS
    assert tq.DEFAULT_TILE == jq.DEFAULT_TILE


@pytest.mark.parametrize("tile", [0, -128, 100, 130, 64, True, None, 128.0,
                                  128, 384, 512])
def test_validate_tile_rejects_the_same_tiles(tile):
    def outcome(mod):
        try:
            return mod.validate_tile(tile)
        except (ValueError, TypeError) as err:
            return type(err)
    assert outcome(tq) == outcome(jq)


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="wire="):
        tq.quantize(torch.zeros(4), "fp4")
    with pytest.raises(ValueError, match="wire="):
        tq.wire_itemsize("fp4")
