"""The quantized dense site at any K that is a multiple of the cluster, and
the plans that size the kernels for the dense siblings' shapes.

``cluster_sums`` (the plain version of ``fused_qmm`` and ``packed_qmm``)
takes k-tiles of 512 from 0, the last one ragged (gemma3's d_model 3840 =
7 x 512 + 256): bit for bit an independent float32 sum in that order, in
all four decodes, and within float32 rounding of the reference's
``qmatmul_ref`` (its Pallas kernel asserts ``k % bk == 0``, so it has no
kernel result at these K).  At K % 512 == 0 it is the earlier loop's
result bit for bit.  The GEMV and tile emulations of
``test_torch_qmm_gemv.py`` / ``test_torch_qmm_tile.py`` follow the kernels'
ragged rules and give the same bits.  The GEMV plans K = 49152
(qwen1.5-110b's down projection) at M <= 8 and the flash kernels size
head_dim 240 (gemma3) within their caps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import QTensor as JQTensor
from repro.kernels.ref import qmatmul_ref as jqmatmul_ref
from repro_torch.kernels.flash_attention import HEAD_DIMS as FA_HEAD_DIMS
from repro_torch.kernels.flash_attention import smem_bytes as fa_smem_bytes
from repro_torch.kernels.flash_prefill import (
    FORMATS, HEAD_DIMS, decode_smem_bytes, launch_plan, prefill_smem_bytes,
)
from repro_torch.kernels.fused_qmm import (
    GEMV_SMEM, _decode, check_tile, check_weights, cluster_sums, fused_qmm_ref, gemv_plan, gemv_smem_bytes,
    n_tiles, rows_per_block, smem_bytes, tile_plan,
)
from repro_torch.kernels.packed_qmm import packed_qmm
from repro_torch.quant.formats import quantize_weights
from test_torch_qmm_gemv import emulate_gemv
from test_torch_qmm_tile import emulate_tile

# (format, decode, group): the four decodes; mx is int8 at group 32
DECODES = [("ternary", "ternary", 64), ("int4", "int4", 64), ("nf4", "nf4", 64), ("mx", "int8", 32)]
FMT_BITS = {"ternary": 2, "int4": 4, "nf4": 4, "mx": 8, "int8": 8}
_MAX_SMEM = 232_448


def _site(fmt, group, m, k, n, seed, biased=True):
    """(x_q, QTensor).  biased: positive weights and activations, so the
    cluster products and their sums pass 2**24 and the float order shows."""
    gen = np.random.default_rng(seed)
    w = gen.normal(size=(k, n)).astype(np.float32)
    xq = gen.integers(-127, 128, size=(m, k))
    if biased:
        w, xq = np.abs(w) + 0.5, np.abs(xq) // 2 + 64
    qt = quantize_weights(torch.from_numpy(w), FMT_BITS[fmt], group, fmt=fmt)
    return torch.from_numpy(xq.astype(np.int8)), qt


def _tile_order(xq, qt, decode, group, bk=512):
    """An independent float32 sum: per cluster the exact dot times its scale
    mantissa, clusters in order into a k-tile sum from 0, the tiles of bk
    from 0 (the last ragged) in order into the output from 0."""
    k = xq.shape[1]
    w = _decode(qt.packed, decode, k).numpy().astype(np.int64)
    x = xq.numpy().astype(np.int64)
    sm = qt.scale_m.numpy().astype(np.float32)
    out = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for t0 in range(0, k, bk):
        acc = np.zeros_like(out)
        for k0 in range(t0, min(t0 + bk, k), group):
            dot = (x[:, k0:k0 + group] @ w[k0:k0 + group]).astype(np.float32)  # exact: |dot| < 2**24
            acc = (acc + dot * sm[k0 // group][None, :]).astype(np.float32)
        out = (out + acc).astype(np.float32)
    return out


def _whole_tiles_only(xq, qt, decode, group, bk=512):
    """The loop before ragged tiles: k // bk tiles (a ragged tail dropped)."""
    k = xq.shape[1]
    part = torch.stack([
        xq[:, c * group:(c + 1) * group].to(torch.float32) @ _decode(qt.packed, decode, k)[c * group:(c + 1) * group]
        .to(torch.float32) for c in range(k // group)])
    sm = qt.scale_m.to(torch.float32)
    out = torch.zeros(xq.shape[0], qt.packed.shape[1])
    per_tile = bk // group
    for t in range(k // bk):
        acc = torch.zeros_like(out)
        for s in range(t * per_tile, (t + 1) * per_tile):
            acc = acc + part[s] * sm[s]
        out = out + acc
    return out


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("fmt,decode,group", DECODES)
@pytest.mark.parametrize("k", [768, 3840])
def test_cluster_sums_cover_the_ragged_tile(fmt, decode, group, k):
    """The whole K in the stated tile order, bit for bit; the earlier loop
    (whole tiles only) dropped the last K mod 512 columns."""
    xq, qt = _site(fmt, group, 4, k, 32, k + group)
    got = cluster_sums(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    want = _tile_order(xq, qt, decode, group)
    assert np.array_equal(_bits(got), _bits(want))
    assert not np.array_equal(_bits(got), _bits(_whole_tiles_only(xq, qt, decode, group)))
    assert n_tiles(k) == -(-k // 512)


@pytest.mark.parametrize("fmt,decode,group", DECODES)
@pytest.mark.parametrize("k", [768, 3840])
def test_cluster_sums_agree_with_the_reference_oracle(fmt, decode, group, k):
    """Within float32 rounding of the reference's ``qmatmul_ref`` (one flat
    sum over clusters): the two differ only in the order of the float adds."""
    xq, qt = _site(fmt, group, 4, k, 32, 7 * k + group, biased=False)
    got = cluster_sums(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    packed = qt.packed.numpy().view(np.uint32) if qt.packed.dtype == torch.int32 else qt.packed.numpy()
    jqt = JQTensor(jnp.asarray(packed), jnp.asarray(qt.scale_m.numpy()), jnp.asarray(0, jnp.int32),
                   qt.bits, qt.group_size, tuple(qt.shape), qt.fmt)
    want = np.asarray(jqmatmul_ref(jnp.asarray(xq.numpy()), jnp.asarray(0, jnp.int32), jqt))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=scale * 2**-20)


@pytest.mark.parametrize("fmt,decode,group", DECODES)
@pytest.mark.parametrize("k", [512, 1536, 4096])
def test_whole_tiles_keep_todays_bits(fmt, decode, group, k):
    xq, qt = _site(fmt, group, 3, k, 16, k + 1)
    got = cluster_sums(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    assert torch.equal(got.view(torch.int32), _whole_tiles_only(xq, qt, decode, group).view(torch.int32))


@pytest.mark.parametrize("fmt,decode,group", DECODES)
def test_fused_and_packed_plain_versions_take_the_ragged_k(fmt, decode, group):
    """fused_qmm's and packed_qmm's CPU paths at K = 3840 (gemma3's wq)."""
    k = 3840
    xq, qt = _site(fmt, group, 4, k, 64, 5)
    check_weights(4, k, qt.packed, qt.scale_m, decode=decode, group=group, block_k=512)
    check_weights(256, k, qt.packed, qt.scale_m, decode=decode, group=group, block_k=512)
    want = _tile_order(xq, qt, decode, group)
    got = packed_qmm(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    assert np.array_equal(_bits(got), _bits(want))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, k)).astype(np.float32))
    y = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, group=group)
    assert y.shape == (4, 64) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("fmt,decode,group", DECODES)
@pytest.mark.parametrize("m,k,n", [(4, 768, 40), (8, 3840, 32)])
def test_gemv_emulation_takes_the_ragged_tile(fmt, decode, group, m, k, n):
    xq, qt = _site(fmt, group, m, k, n, m + k + n)
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    for cpp in (512 // group, 1):  # whole-tile pieces, single clusters
        plan = dict(gemv_plan(m, k, n, decode, group), cpp=cpp)
        got = emulate_gemv(xq, qt.packed, qt.scale_m, decode=decode, group=group, plan=plan)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), cpp


@pytest.mark.parametrize("fmt,decode,group", DECODES)
@pytest.mark.parametrize("m,k,n", [(17, 768, 136), (256, 3840, 64)])
def test_tile_emulation_takes_the_ragged_tile(fmt, decode, group, m, k, n):
    """The ragged tile's last stage zero-filled past K; unsplit and split."""
    xq, qt = _site(fmt, group, m, k, n, m + k)
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    check_tile(k, group, 512)
    for plan in (tile_plan(m, k, n, decode, group), dict(splits=2, tps=-(-n_tiles(k) // 2))):
        got = emulate_tile(xq, qt.packed, qt.scale_m, decode=decode, group=group, splits_plan=plan)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), plan


@pytest.mark.parametrize("decode,group", [("ternary", 64), ("int4", 64), ("nf4", 64), ("int8", 64), ("int8", 32)])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_gemv_plans_k_49152(decode, group, m):
    """qwen1.5-110b's down projection (K = 49152, N = 8192): the plan fits
    the GEMV's shared memory -- block 0 reads the splits' tile sums from
    their own shared memory (96 tiles would not fit its own); at M = 4
    every block holds its whole k range of x, at M = 8 (8 x 12 KB a
    split) it stages x a few tiles at a time."""
    plan = gemv_plan(m, 49152, 8192, decode, group)
    assert plan["smem"] == gemv_smem_bytes(m, 49152, decode, group, 512, plan["tps"], plan["cpp"], plan["wn"],
                                           plan["tpc"], plan["pull"]) <= GEMV_SMEM
    assert 1 <= plan["tpc"] <= plan["tps"] and plan["blocks"] >= 132
    assert plan["pull"] == (plan["splits"] > 1)
    if m <= 4:
        assert plan["tpc"] == plan["tps"]


@pytest.mark.parametrize("decode,group", [("ternary", 64), ("int4", 64), ("nf4", 64), ("int8", 32)])
@pytest.mark.parametrize("k,n", [(3840, 3840), (3840, 1920), (3840, 15360), (15360, 3840)])
def test_gemma3_sites_plan(decode, group, k, n):
    """gemma3-12b's layer sites at M = 4 (GEMV) and M = 256 (tile)."""
    plan = gemv_plan(4, k, n, decode, group)
    assert plan["smem"] <= GEMV_SMEM and plan["tpc"] == plan["tps"] and not plan["pull"]
    assert (plan["splits"] - 1) * plan["tps"] < n_tiles(k) <= plan["splits"] * plan["tps"]
    t = tile_plan(256, k, n, decode, group)
    assert t["smem"] <= _MAX_SMEM and (t["splits"] - 1) * t["tps"] < n_tiles(k)


def test_int8_loop_sizes_the_ragged_lm_head():
    """gemma3's int8 lm_head (K = 3840, N = 262144) on the int8 loop: its
    tile sums count the ragged tile."""
    assert smem_bytes(4, 3840, "int8", 64) == 4 * 3840 + 32 + 8 * 4 * 128 * 4 + 60 * 128
    assert rows_per_block(4, 3840, "int8", 64) == 8


@pytest.mark.parametrize("fmt", FORMATS)
def test_flash_hd_240_fits(fmt):
    """head_dim 240 is an instance of both flash kernels, and its prefill
    block (one an SM), decode block and flash_attention block fit."""
    assert 240 in HEAD_DIMS and 240 in FA_HEAD_DIMS
    want = {"kv_bf16": 222_208, "kv_int8": 220_416, "kv_mx": 189_696}[fmt]
    assert prefill_smem_bytes(fmt, 240) == want <= _MAX_SMEM
    assert decode_smem_bytes(240, 512) == 47_168 <= 48 * 1024
    for b, s, t in ((4, 1, 2048), (1, 256, 2048), (4, 1, 256), (1, 1900, 2048)):
        plan = launch_plan(fmt, b, s, t, 8, 2, 240)
        assert plan["smem"] <= plan["smem_cap"]
    assert fa_smem_bytes(torch.bfloat16, 240) == 222_208
    assert fa_smem_bytes(torch.float32, 240) == 204_288


@pytest.mark.parametrize("fmt", FORMATS)
def test_flash_hd_112_fits(fmt):
    """head_dim 112 (zamba2) is an instance of flash_attend: its prefill
    block (two an SM), decode block and zamba2's launches fit."""
    assert 112 in HEAD_DIMS
    want = {"kv_bf16": 107_520, "kv_int8": 105_728, "kv_mx": 91_392}[fmt]
    assert prefill_smem_bytes(fmt, 112) == want and 2 * want <= _MAX_SMEM
    assert decode_smem_bytes(112, 512) == 30_784 <= 48 * 1024
    for b, s, t in ((4, 1, 1024), (1, 128, 1024), (1, 1, 64)):
        plan = launch_plan(fmt, b, s, t, 32, 1, 112)
        assert plan["smem"] <= plan["smem_cap"]
