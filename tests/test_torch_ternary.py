"""Port vs reference: Algorithms 1 & 2 (codes and alpha) and the packed
weight formats (``packed`` / ``scale_m`` / ``scale_e``), identical bytes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jtern
from repro.quant import formats as jfmt
from repro_torch.core import ternary as ttern
from repro_torch.quant import formats as tfmt


def _w(k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    w[:, 0] = 0.0  # an all-zero column: alpha 0, codes 0
    w[:16, 1] = 0.01  # a tied column
    return w


@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("filter_size,refit", [(1, False), (4, False), (1, True)])
def test_ternarize_matrix_identical(group, filter_size, refit):
    w = _w(256, 48, group + filter_size)
    jc, ja = jtern.ternarize_matrix(jnp.asarray(w), group, filter_size, refit)
    tc, ta = ttern.ternarize_matrix(torch.from_numpy(w), group, filter_size, refit)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ta.numpy().view(np.uint32), np.asarray(ja).view(np.uint32))


def test_filter_threshold_identical():
    w = np.random.default_rng(5).normal(size=(300, 9)).astype(np.float32)
    want = np.asarray(jtern.filter_threshold(jnp.asarray(w)))
    got = ttern.filter_threshold(torch.from_numpy(w)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fmt,bits", [("ternary", 2), ("int8", 8)])
@pytest.mark.parametrize("group", [16, 64])
def test_quantize_weights_identical(fmt, bits, group):
    w = _w(128, 40, bits * group)
    jq = jfmt.quantize_weights(jnp.asarray(w), bits, group, fmt=fmt)
    tq = tfmt.quantize_weights(torch.from_numpy(w), bits, group, fmt=fmt)
    assert tq.fmt == jq.fmt and tq.bits == jq.bits and tq.shape == tuple(jq.shape)
    assert tq.packed.numpy().tobytes() == np.asarray(jq.packed).tobytes()
    assert np.array_equal(tq.scale_m.numpy(), np.asarray(jq.scale_m))
    assert int(tq.scale_e) == int(jq.scale_e)
    assert np.array_equal(tfmt.decode_codes(tq).numpy(), np.asarray(jfmt.decode_codes(jq)))
    assert np.array_equal(
        tfmt.dequantize_weights(tq).numpy().view(np.uint32),
        np.asarray(jfmt.dequantize_weights(jq)).view(np.uint32),
    )


@pytest.mark.parametrize("n", [1, 3, 16, 17, 64, 300])
def test_cumsum_in_reference_order(n):
    """Prefix sums round exactly as the reference's CPU cumsum does."""
    x = (np.random.default_rng(n).normal(size=(40, n)) ** 2).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    got = ttern.cumsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
