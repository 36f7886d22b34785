"""Port vs reference: the 4-bit packings, the int4 / nf4 / mx weight codes,
the plans ``QuantCtx.from_config`` compiles for them, PTQ conversion of a
JAX tree, and the ``quantize_rows`` prologue of the unfused path.

Integer results are compared bit for bit (``np.array_equal``): packed
words, codes, scale tables and exponents, mantissas.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quantizer as jquantizer
from repro.kernels.quantize import quantize_rows as jquantize_rows
from repro.models import build_model as jbuild
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.quant import quantize_weights as jquantize
from repro.quant.plan import QuantCtx as JQuantCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import quantizer as tquantizer
from repro_torch.core.quantizer import QTensor
from repro_torch.kernels.quantize import quantize_rows as tquantize_rows
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.quant import quantize_weights as tquantize
from repro_torch.quant.formats import format_for_bits, format_names, get_format
from repro_torch.quant.plan import QuantCtx as TQuantCtx

FMT_BITS = {"int4": 4, "nf4": 4, "mx": 8}


def _words(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,n", [(8, 1), (64, 24)])
def test_pack4_unpack4_bytes_match_reference(k, n):
    rng = np.random.default_rng(k + n)
    q = rng.integers(-7, 8, size=(k, n)).astype(np.int8)
    q[0, : min(n, 3)] = [-7, 7, 0][: min(n, 3)]  # both ends of the range
    want = _words(jquantizer.pack4(jnp.asarray(q)))
    got = tquantizer.pack4(torch.from_numpy(q)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tquantizer.unpack4(torch.from_numpy(got), k).numpy(), q)
    # every 4-bit field, -8 included, decodes as the reference's does
    words = rng.integers(-(2**31), 2**31, size=(k // 8, n), dtype=np.int64).astype(np.int32)
    assert np.array_equal(tquantizer.unpack4(torch.from_numpy(words), k).numpy(),
                          np.asarray(jquantizer.unpack4(jnp.asarray(words.view(np.uint32)), k)))


@pytest.mark.parametrize("k,n", [(8, 3), (128, 16)])
def test_pack4u_unpack4u_and_nf4_table_match_reference(k, n):
    rng = np.random.default_rng(k * n)
    c = rng.integers(0, 16, size=(k, n)).astype(np.int8)
    want = _words(jquantizer.pack4u(jnp.asarray(c)))
    got = tquantizer.pack4u(torch.from_numpy(c)).numpy()
    assert np.array_equal(got, want)
    back = tquantizer.unpack4u(torch.from_numpy(got), k)
    assert np.array_equal(back.numpy(), c)
    assert np.array_equal(tquantizer.nf4_lut_decode(back).numpy(),
                          np.asarray(jquantizer.nf4_lut_decode(jnp.asarray(c))))
    assert tquantizer.NF4_LUT_I8 == jquantizer.NF4_LUT_I8


def test_pack4_range_contracts():
    with pytest.raises(AssertionError):
        tquantizer.pack4(torch.full((8, 1), -8, dtype=torch.int8))
    with pytest.raises(AssertionError):
        tquantizer.pack4u(torch.full((8, 1), 16, dtype=torch.int8))


# ---------------------------------------------------------------------------
# weight codes
# ---------------------------------------------------------------------------
def _weights(kind, k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32)
    if kind == "zero_clusters":
        w[:32, :] = 0.0  # every cluster of the first rows dead
        w[:, 1] = 0.0  # a whole dead column
    elif kind == "octaves":  # blocks 2**-3 .. 2**-12 below the loudest: the 6-octave clamp
        for b in range(k // 32):
            w[b * 32:(b + 1) * 32] *= np.float32(2.0 ** -(3 * b))
    elif kind == "midpoints":  # values on NF4 decision midpoints (searchsorted side)
        lut = np.asarray(jquantizer.NF4_LUT_I8, np.float32)
        mids = (lut[:-1] + lut[1:]) / 2
        w = np.resize(np.concatenate([mids, -mids, lut]), (k, n)).astype(np.float32)
        w[::16] = 127.0  # each 16-row cluster's max is 127: the scale is 1
    return w


@pytest.mark.parametrize("fmt", list(FMT_BITS))
@pytest.mark.parametrize("kind,group", [("normal", 16), ("normal", 64), ("zero_clusters", 32),
                                        ("octaves", 32), ("midpoints", 16)])
def test_weight_codes_match_reference(fmt, kind, group):
    w = _weights(kind, 128, 24, seed=group)
    jq = jquantize(jnp.asarray(w), FMT_BITS[fmt], group, fmt=fmt)
    tq = tquantize(torch.from_numpy(w), FMT_BITS[fmt], group, fmt=fmt)
    assert (tq.fmt, tq.bits, tq.group_size, tq.shape) == (jq.fmt, jq.bits, jq.group_size, tuple(jq.shape))
    assert np.array_equal(tq.packed.numpy(), _words(jq.packed))
    assert np.array_equal(tq.scale_m.numpy(), np.asarray(jq.scale_m))
    assert int(tq.scale_e) == int(jq.scale_e)
    if fmt == "mx":
        assert tq.group_size == 32  # the format pins its block


@pytest.mark.parametrize("m,k,decode,group,rows", [(4, 4096, "int8", 64, 4), (8, 12288, "int8", 32, 8),
                                                   (8, 49152, "int8", 32, 3), (1, 49152, "int8", 64, 1),
                                                   (8, 8192, "int8", 64, 8), (2, 4096, "int8", 4, 2)])
def test_rows_per_block_fit_shared_memory(m, k, decode, group, rows):
    """The int8 loop keeps all M rows of x (up to 8) in a block beside its
    smallest rings, fewer where they would overflow shared memory (K =
    49152 at M = 8 takes 3); mx's and group 4's extra scale rows fit."""
    from repro_torch.kernels.fused_qmm import LOOP_MIN_WARPS, LOOP_SMEM, rows_per_block, smem_bytes

    assert decode == "int8"  # the loop's only decode
    assert rows_per_block(m, k, group) == rows
    assert smem_bytes(LOOP_MIN_WARPS, rows, k, group) <= LOOP_SMEM


def test_registry_order_keeps_bits_defaults():
    """Every format of the reference is registered (ttq, the trained
    ternary format, since QAT came to the port); the width defaults stay
    the built-ins; an unknown name is refused."""
    assert format_names() == ("int4", "int8", "mx", "nf4", "ternary", "ttq")
    assert format_for_bits(2).name == "ternary"
    assert format_for_bits(4).name == "int4" and format_for_bits(8).name == "int8"
    assert get_format("mx").block_size == 32 and get_format("nf4").block_size is None
    with pytest.raises(KeyError, match="registered"):
        get_format("int3")


# ---------------------------------------------------------------------------
# plans and PTQ conversion of the smoke model
# ---------------------------------------------------------------------------
QUANTS = {"int4": dict(w_bits=4), "nf4": dict(fmt="nf4"), "mx": dict(fmt="mx"), "int8": dict(w_bits=8)}


def _table(plan):
    return {p: dataclasses.astuple(prec) for p, prec in zip(plan.site_paths, plan.site_precisions)}


def _qtensors(tree, path=""):
    if isinstance(tree, QTensor):
        yield path, tree
    elif isinstance(tree, dict):
        for key, val in tree.items():
            yield from _qtensors(val, f"{path}/{key}")
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from _qtensors(val, f"{path}/{i}")


@pytest.mark.parametrize("name", list(QUANTS))
def test_from_config_plan_and_ptq_match_reference(name):
    q = dict(QUANTS[name], group_size=16, mode="ptq")
    jcfg = jconfigs.get_smoke("qwen3-8b", JQuantConfig(backend="ref", **q))
    tcfg = tconfigs.get_smoke("qwen3-8b", TQuantConfig(backend="cuda", **q))
    assert dataclasses.astuple(TQuantCtx.from_config(tcfg.quant).policy.default) == dataclasses.astuple(
        JQuantCtx.from_config(jcfg.quant).policy.default)
    japi = jbuild(jcfg)
    params = japi.init(jax.random.PRNGKey(1))
    jq, jplan, _ = jquantize_and_plan(japi, params)
    tq, tplan, _ = tquantize_and_plan(tbuild(tcfg, device="cpu"), params_from_jax(params, device="cpu"))
    assert _table(tplan) == _table(jplan)
    converted = dict(_qtensors(params_from_jax(jq, device="cpu")))
    made = dict(_qtensors(tq))
    assert converted.keys() == made.keys() and made
    for path, a in made.items():
        b = converted[path]
        assert (a.fmt, a.bits, a.group_size, a.shape) == (b.fmt, b.bits, b.group_size, b.shape), path
        for f in ("packed", "scale_m", "scale_e"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (path, f)
    fmts = {a.fmt for a in made.values()}
    assert fmts == {"int8", name}  # the paper's pinned sites stay int8


# ---------------------------------------------------------------------------
# quantize_rows: the prologue of the unfused path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 5, 8, 13])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_match_reference_kernel(m, dtype):
    """Ragged M (the reference pads to a power-of-two bucket), zero rows,
    NaN rows, a max of exactly 127 * 2**-3 and one ulp above it."""
    rng = np.random.default_rng(m)
    x = (rng.normal(size=(m, 64)) * 0.5).astype(np.float32)
    x[0, 3] = np.nan
    if m > 1:
        x[1] = 0.0
    if m > 3:
        x[2, 4] = 127.0 * 2.0**-3
        x[3, 4] = np.nextafter(np.float32(127.0 * 2.0**-3), np.float32(1))
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    wq, we = jquantize_rows(jx, interpret=True)
    q, e = tquantize_rows(tx)
    assert q.dtype == torch.int8 and e.dtype == torch.int32 and e.shape == (m, 1)
    assert np.array_equal(q.numpy(), np.asarray(wq))
    assert np.array_equal(e.numpy(), np.asarray(we))
