"""Port vs reference: the kv_int8 and kv_mx cache formats.

The same numpy K/V go through the reference's ``kv_cache.write`` and the
port's; every leaf (codes and exponent planes) must match byte for byte.
The port writes in place and rescales only the mx blocks a write touches;
the reference re-quantizes the whole cache -- the bytes are the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kv_cache as jkv
from repro_torch.convert import cache_from_jax
from repro_torch.models import kv_cache as tkv

B, T, KH, HD = 2, 96, 2, 16


def _fresh(fmt):
    return jkv.get_kv_format(fmt).init((B,), T, KH, HD, jnp.bfloat16), \
        tkv.get_kv_format(fmt).init((B,), T, KH, HD, torch.bfloat16, "cpu")


def _tokens(rng, s, zero_rows=()):
    x = (rng.normal(size=(B, s, KH, HD)) * rng.uniform(0.01, 40, size=(B, s, KH, 1))).astype(np.float32)
    for r in zero_rows:
        x[:, r] = 0.0
    return x


def _write(jc, tc, fmt, k, v, where):
    jw = jnp.int32(where) if np.ndim(where) == 0 else jnp.asarray(where)
    tw = where if np.ndim(where) == 0 else torch.from_numpy(np.asarray(where))
    jc, jvalid = jkv.write(fmt, jc, jnp.asarray(k), jnp.asarray(v), jw)
    tc, tvalid = tkv.write(fmt, tc, torch.from_numpy(k), torch.from_numpy(v), tw)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    return jc, tc


def _assert_same(jc, tc):
    """Same leaf names, dtypes (by name and width) and bytes."""
    assert sorted(jc) == sorted(tc)
    for name in jc:
        want = np.asarray(jc[name])
        got = tc[name]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, name
        np.testing.assert_array_equal(got.contiguous().view(torch.uint8).numpy(),
                                      np.ascontiguousarray(want).view(np.uint8), err_msg=name)


@pytest.mark.parametrize("fmt", ["kv_int8", "kv_mx"])
@pytest.mark.parametrize("writes", [[(0, 5), (5, 40), (45, 3)], [(30, 4), (34, 31)], [(0, 64), (64, 32)]],
                         ids=["ragged", "cross_block", "whole_blocks"])
def test_aligned_writes_bit_exact(fmt, writes):
    rng = np.random.default_rng(len(writes))
    jc, tc = _fresh(fmt)
    for idx, s in writes:
        jc, tc = _write(jc, tc, fmt, _tokens(rng, s), _tokens(rng, s), idx)
        _assert_same(jc, tc)


@pytest.mark.parametrize("fmt", ["kv_int8", "kv_mx"])
def test_masked_writes_at_ragged_positions(fmt):
    rng = np.random.default_rng(7)
    jc, tc = _fresh(fmt)
    jc, tc = _write(jc, tc, fmt, _tokens(rng, 40), _tokens(rng, 40), 0)  # a prefix to rescale
    for step in range(6):
        pos = np.array([40 + step, 3 + 13 * step], np.int32)  # one row inside written blocks
        jc, tc = _write(jc, tc, fmt, _tokens(rng, 1), _tokens(rng, 1), pos)
        _assert_same(jc, tc)


def test_zero_token_keeps_the_mx_sentinel():
    rng = np.random.default_rng(3)
    jc, tc = _fresh("kv_mx")
    zero = np.zeros((B, 1, KH, HD), np.float32)
    jc, tc = _write(jc, tc, "kv_mx", zero, zero, np.array([33, 70], np.int32))
    _assert_same(jc, tc)
    assert (tc["ke"].numpy() == -127).all()  # an all-zero token raises no exponent
    jc, tc = _write(jc, tc, "kv_mx", _tokens(rng, 8, zero_rows=(0, 5)), _tokens(rng, 8), 60)
    _assert_same(jc, tc)
    assert (tc["ke"].numpy()[:, 0] == -127).all()  # untouched blocks keep it


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
def test_attend_view_and_bytes_per_token(fmt):
    rng = np.random.default_rng(5)
    jc, tc = _fresh(fmt)
    jc, tc = _write(jc, tc, fmt, _tokens(rng, 37), _tokens(rng, 37), 2)
    for want, got in zip(jkv.attend_view(fmt, jc), tkv.attend_view(fmt, tc)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    jf, tf = jkv.get_kv_format(fmt), tkv.get_kv_format(fmt)
    assert (tf.mant_bits, tf.seq_block, tf.quantized) == (jf.mant_bits, jf.seq_block, jf.quantized)
    assert tf.bytes_per_token(8, 128) == jf.bytes_per_token(8, 128)


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
def test_cache_from_jax_is_byte_identical_and_writable(fmt):
    rng = np.random.default_rng(9)
    jc, tc = _fresh(fmt)
    jc, _ = jkv.write(fmt, jc, jnp.asarray(_tokens(rng, 9)), jnp.asarray(_tokens(rng, 9)), jnp.int32(30))
    conv = cache_from_jax({n: np.asarray(a) for n, a in jc.items()}, device="cpu")
    _assert_same(jc, conv)
    x = _tokens(rng, 1)
    jc, _ = jkv.write(fmt, jc, jnp.asarray(x), jnp.asarray(x), jnp.asarray([31, 60], np.int32))
    tkv.write(fmt, conv, torch.from_numpy(x), torch.from_numpy(x), torch.tensor([31, 60]))
    _assert_same(jc, conv)


def test_pack_unpack_i4_match_reference():
    codes = np.arange(-8, 8, dtype=np.int32).reshape(2, 8)
    packed = tkv.pack_i4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jkv.pack_i4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tkv.unpack_i4(packed).numpy(), codes)
    assert tkv.MX_KV_BLOCK == jkv.MX_KV_BLOCK and tkv._MX_E_EMPTY == jkv._MX_E_EMPTY
