"""Port vs reference: the whole quantized dense site, for every ported
weight format (ternary, int4, int8, nf4, mx).

The port's ``qdense`` on CPU tensors -- the fused kernel's plain version
(backend ``cuda``), the unfused composition of the ``quantize_rows`` and
packed-matmul plain versions (``cuda`` with ``fused=False``) and the
``ref`` oracle -- against the reference's ``qdense`` with
``backend="pallas"`` (interpret mode, fused and unfused) and
``backend="ref"``: bit for bit (``np.array_equal``) on the cases of
``tests/test_qdense.py``.  With ``act="silu"`` the pre-activation output is
bit-exact and the activated output agrees to 2 ulp: the reference's
sigmoid runs XLA's CPU ``exp``, the port's runs torch's, and the two
libraries round ``exp`` differently in the last bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import qdense as jqdense
from repro.quant import qmatmul as jqmatmul
from repro.quant import quantize_weights as jquantize
from repro_torch.core.quantizer import QTensor
from repro_torch.kernels.quantize import quantize_rows
from repro_torch.kernels.ternary_matmul import ternary_matmul, ternary_matmul_fused
from repro_torch.quant import qdense as tqdense
from repro_torch.quant import qmatmul as tqmatmul

FMT_BITS = {"ternary": 2, "int4": 4, "int8": 8, "nf4": 4, "mx": 8}
FMTS = list(FMT_BITS)


def _site(m, k, n, g, fmt, seed, bias, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    jq = jquantize(jnp.asarray(w), FMT_BITS[fmt], g, fmt=fmt)
    tq = QTensor(
        torch.from_numpy(np.asarray(jq.packed).view(np.int32) if jq.packed.dtype == jnp.uint32 else np.asarray(jq.packed)),
        torch.from_numpy(np.asarray(jq.scale_m)), torch.tensor(int(jq.scale_e), dtype=torch.int32),
        jq.bits, jq.group_size, tuple(jq.shape), jq.fmt,
    )
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bf16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bf16" else torch.from_numpy(x)
    return jx, tx, jq, tq, b


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _check(jx, tx, jq, tq, b, act, static_e, block_k):
    kw = dict(act_exponent=static_e, block_k=block_k)
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    want_pallas = np.asarray(jqdense(jx, jq, bias=jb, act=act, backend="pallas", **kw))
    want_ref = np.asarray(jqdense(jx, jq, bias=jb, act=act, backend="ref", **kw))
    got_fused = tqdense(tx, tq, bias=tb, act=act, backend="cuda", **kw).numpy()
    got_ref = tqdense(tx, tq, bias=tb, act=act, backend="ref", **kw).numpy()
    assert got_fused.shape == want_pallas.shape
    if act is None:
        for got in (got_fused, got_ref):
            assert np.array_equal(_bits(got), _bits(want_pallas))
            assert np.array_equal(_bits(got), _bits(want_ref))
    else:
        pre = {
            "jax": np.asarray(jqdense(jx, jq, bias=jb, backend="pallas", **kw)),
            "port": tqdense(tx, tq, bias=tb, backend="cuda", **kw).numpy(),
        }
        assert np.array_equal(_bits(pre["port"]), _bits(pre["jax"]))
        for got in (got_fused, got_ref):
            np.testing.assert_array_max_ulp(got, want_pallas, maxulp=2)
            np.testing.assert_array_max_ulp(got, want_ref, maxulp=2)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("static_e", [None, -4])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [None, "silu"])
def test_qdense_bit_exact_vs_reference(fmt, static_e, bias, act):
    # m=7: bucket padding; block_k=32 < K: several k-tiles into the epilogue
    jx, tx, jq, tq, b = _site(7, 64, 32, 16, fmt, FMT_BITS[fmt], bias)
    _check(jx, tx, jq, tq, b, act, static_e, block_k=32)


@pytest.mark.parametrize("fmt", FMTS)
def test_qdense_bf16_and_leading_dims(fmt):
    jx, tx, jq, tq, _ = _site(12, 64, 16, 16, fmt, 9, False, dtype="bf16")
    want = np.asarray(jqdense(jx.reshape(3, 4, 64), jq, backend="pallas"))
    got = tqdense(tx.reshape(3, 4, 64), tq, backend="cuda").numpy()
    assert got.shape == (3, 4, 16)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", FMTS)
def test_qdense_group64_many_tiles(fmt):
    """group 64 (the served size) over K = 1024: 2 k-tiles of 512."""
    jx, tx, jq, tq, b = _site(4, 1024, 48, 64, fmt, 11, True)
    _check(jx, tx, jq, tq, b, None, None, block_k=512)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("static_e", [None, -4])
def test_qdense_unfused_bit_exact_vs_reference(fmt, static_e):
    """fused=False: quantize, the packed matmul, exponents, then bias, in the
    reference's order (m=7 ragged, block_k=32: several k-tiles); equal to
    the fused site too."""
    jx, tx, jq, tq, b = _site(7, 64, 32, 16, fmt, FMT_BITS[fmt] + 1, True)
    kw = dict(act_exponent=static_e, block_k=32)
    want = np.asarray(jqdense(jx, jq, bias=jnp.asarray(b), backend="pallas", fused=False, **kw))
    oracle = np.asarray(jqdense(jx, jq, bias=jnp.asarray(b), backend="ref", fused=False, **kw))
    assert np.array_equal(_bits(want), _bits(oracle))
    for backend, fused in (("cuda", False), ("ref", False), ("cuda", True)):
        got = tqdense(tx, tq, bias=torch.from_numpy(b), backend=backend, fused=fused, **kw).numpy()
        assert np.array_equal(_bits(got), _bits(want)), (backend, fused)


def test_qdense_edge_rows_bit_exact():
    """Rows holding a NaN, an exact 127 * 2**k maximum and one ulp above it,
    all zeros, and an infinity."""
    jx, tx, jq, tq, _ = _site(6, 64, 32, 16, "ternary", 4, False)
    x = np.array(tx.numpy())
    x[0, 5] = np.nan
    x[1, :] *= 0.25
    x[1, 3] = 127.0 * 2.0**-3
    x[2, 7] = np.nextafter(np.float32(127.0 * 2.0**-3), np.float32(1))
    x[3, :] = 0.0
    x[4, 9] = np.inf
    want = np.asarray(jqdense(jnp.asarray(x), jq, backend="pallas"))
    got = tqdense(torch.from_numpy(x), tq, backend="cuda").numpy()
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all()


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_qdense_other_epilogue_activations(act):
    """relu is exact; gelu's tanh rounds differently in XLA and torch."""
    jx, tx, jq, tq, b = _site(7, 64, 32, 16, "ternary", 5, True)
    want = np.asarray(jqdense(jx, jq, bias=jnp.asarray(b), act=act, backend="pallas", block_k=32))
    got = tqdense(tx, tq, bias=torch.from_numpy(b), act=act, backend="cuda", block_k=32).numpy()
    if act == "relu":
        assert np.array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("static_e", [None, -4])
def test_qmatmul_bit_exact_vs_reference(fmt, static_e):
    jx, tx, jq, tq, _ = _site(5, 64, 24, 16, fmt, 7, False)
    want = np.asarray(jqmatmul(jx, jq, backend="ref", act_exponent=static_e))
    for backend in ("auto", "cuda"):  # the oracle, and the kernels' plain versions
        got = tqmatmul(tx, tq, backend=backend, act_exponent=static_e).numpy()
        assert np.array_equal(_bits(got), _bits(want)), backend


def test_cpu_tensors_take_the_plain_version():
    _, tx, _, tq, _ = _site(3, 64, 16, 16, "ternary", 1, False)
    before = (ternary_matmul_fused.launches, ternary_matmul.launches, quantize_rows.launches)
    tqdense(tx, tq, backend="cuda")  # a CPU tensor runs the plain version
    tqdense(tx, tq, backend="cuda", fused=False)
    tqmatmul(tx, tq, backend="cuda")
    assert (ternary_matmul_fused.launches, ternary_matmul.launches, quantize_rows.launches) == before
