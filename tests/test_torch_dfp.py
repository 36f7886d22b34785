"""Port vs reference: DFP arithmetic, 2-bit packing and the scale table,
bit for bit on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dfp as jdfp
from repro.core import quantizer as jquant
from repro_torch.core import dfp as tdfp
from repro_torch.core import quantizer as tquant

F32 = np.float32


def _bits(a):
    return np.asarray(a).view(np.uint32) if np.asarray(a).dtype == F32 else np.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edge_maxima():
    """|x| maxima at the exponent boundaries: 127 * 2**k, one ulp above and
    below, for the exponents DFP activations and scales live at."""
    k = np.arange(-24, 25)
    at = (F32(127) * np.ldexp(F32(1), k)).astype(F32)
    up = np.nextafter(at, F32(np.inf)).astype(F32)
    down = np.nextafter(at, F32(0)).astype(F32)
    return np.concatenate([at, up, down])


def test_exp2i_bit_exact():
    e = np.arange(-140, 141, dtype=np.int32)
    assert np.array_equal(_bits(jdfp.exp2i(jnp.asarray(e))), _bits(tdfp.exp2i(_t(e)).numpy()))
    ef = e.astype(F32)  # integer-valued float exponents too
    assert np.array_equal(_bits(jdfp.exp2i(jnp.asarray(ef))), _bits(tdfp.exp2i(_t(ef)).numpy()))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_choose_exponent_random_bit_exact(bits):
    rng = np.random.default_rng(bits)
    m = np.abs(rng.normal(size=20000) * np.exp(rng.uniform(-20, 20, size=20000))).astype(F32)
    want = np.asarray(jdfp.choose_exponent(jnp.asarray(m), bits))
    got = tdfp.choose_exponent(_t(m), bits).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_choose_exponent_edges_bit_exact():
    tiny = np.finfo(F32).tiny
    m = np.concatenate([
        _edge_maxima(),
        np.asarray([0.0, 127.0, 1.0, tiny, 127 * tiny, 1e-40, 1e-45, np.nan, 3e38], F32),
    ]).astype(F32)
    want = np.asarray(jdfp.choose_exponent(jnp.asarray(m), 8))
    got = tdfp.choose_exponent(_t(m), 8).numpy()
    assert np.array_equal(got, want)


def test_quantize_bit_exact_random_and_edges():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 33)) * 3).astype(F32)
    x[0, :] = 0.0
    x[1, :3] = [127.0, -127.0, 63.5]  # +-qmax and a half-way tie
    x[2, :2] = [np.nan, 1.0]
    x[3, :4] = [2.5, -2.5, 0.5, -0.5]  # round half to even
    e = np.array(jdfp.choose_exponent(jnp.max(jnp.abs(jnp.asarray(x)), axis=1, keepdims=True), 8))
    e[3] = 0
    want = np.asarray(jdfp.quantize(jnp.asarray(x), jnp.asarray(e), 8))
    got = tdfp.quantize(_t(x), _t(e), 8).numpy()
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert got[2, 0] == 0  # NaN -> mantissa 0, as the reference's cast gives


def test_quantize_edge_maxima_rows_bit_exact():
    """Rows whose max|x| sits at 127 * 2**k and one ulp around it."""
    rng = np.random.default_rng(1)
    mx = _edge_maxima()
    x = (rng.uniform(-1, 1, size=(mx.size, 16)) * mx[:, None]).astype(F32)
    x[:, 0] = mx
    jq, je = jdfp.quantize_tensor(jnp.asarray(x), 8, axis=(1,))
    tq, te = tdfp.quantize_tensor(_t(x), 8, axis=(1,))
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(tq.numpy(), np.asarray(jq))


def test_quantize_tensor_and_dequantize():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(16, 40)) * 1e-3).astype(F32)
    for axis in (None, (0,), (1,)):
        jq, je = jdfp.quantize_tensor(jnp.asarray(x), 8, axis)
        tq, te = tdfp.quantize_tensor(_t(x), 8, axis)
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(te.numpy(), np.asarray(je))
        assert np.array_equal(_bits(tdfp.dequantize(tq, te).numpy()), _bits(jdfp.dequantize(jq, je)))


@pytest.mark.parametrize("k,n", [(16, 5), (64, 24), (256, 3)])
def test_pack2_same_bytes_as_reference(k, n):
    rng = np.random.default_rng(k)
    codes = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    want = np.asarray(jquant.pack2(jnp.asarray(codes)))
    got = tquant.pack2(_t(codes)).numpy()
    assert want.dtype == np.uint32 and got.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(tquant.unpack2(_t(got), k).numpy(), codes)
    # every 2-bit code decodes like the reference, the unused code 2 included
    words = rng.integers(0, 2**32, size=(4, 7), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(
        tquant.unpack2(_t(words.view(np.int32)), 64).numpy(),
        np.asarray(jquant.unpack2(jnp.asarray(words), 64)),
    )


def test_quantize_scales_identical():
    rng = np.random.default_rng(3)
    for scale in (1e-4, 0.02, 3.0):
        alpha = np.abs(rng.normal(size=(8, 12)) * scale).astype(F32)
        alpha[0, 0] = 0.0
        jm, je = jquant.quantize_scales(jnp.asarray(alpha))
        tm, te = tquant.quantize_scales(_t(alpha))
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        assert int(te) == int(je)
        assert np.array_equal(_bits(tquant.dequantize_scales(tm, te).numpy()),
                              _bits(jquant.dequantize_scales(jm, je)))
