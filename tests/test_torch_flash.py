"""Port vs reference: flash attention over the packed KV cache.

The port's ``flash_attend`` / ``flash_decode`` on CPU tensors (the kernel's
plain version) against the reference's ``flash_attend`` (interpret mode)
and against the port's own ``_attend_dense`` oracle, at atol 5e-5 -- the
reference's own tolerance (``tests/test_flash_prefill.py``): the two sum
the scores in different orders.  kv_int8 and kv_mx caches are random
packed codes and exponents (mx blocks past the fill level hold the empty
sentinel -127), handed to both packages as the same numpy bytes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_attend as jflash
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import (
    KEY_TILE, ROW_TILE, decode_split, flash_attend, launch_plan, pick_kv_block, pick_q_block, row_blocks,
)
from repro_torch.models.attention import _attend_dense, _mask_bias


def _case(b, t, kh, g, hd, s, starts, window, seed=0):
    rng = np.random.default_rng(seed)
    k = (rng.normal(size=(b, t, kh, hd)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, t, kh, hd)) * 0.5).astype(np.float32)
    q = rng.normal(size=(b, s, kh, g, hd)).astype(np.float32)
    starts = np.asarray(starts, np.int32).reshape(b, 1)
    valid = starts + s
    win = np.full((1, 1), 2**30 if window is None else window, np.int32)
    kt = torch.from_numpy(k).to(torch.bfloat16)  # the cache stores bf16
    vt = torch.from_numpy(v).to(torch.bfloat16)
    kj = jnp.asarray(k).astype(jnp.bfloat16)
    vj = jnp.asarray(v).astype(jnp.bfloat16)
    return q, kt, vt, kj, vj, starts, valid, win


def _port(q, kt, vt, starts, valid, win, **kw):
    return flash_attend(
        torch.from_numpy(q), kt, vt, None, None, torch.from_numpy(starts),
        torch.from_numpy(valid), torch.from_numpy(win), fmt="kv_bf16", **kw,
    ).numpy()


def _dense(q, kt, vt, starts, valid, window):
    b, s = q.shape[:2]
    t = kt.shape[1]
    q_pos = torch.from_numpy(starts) + torch.arange(s)[None]
    bias = _mask_bias(q_pos, torch.arange(t), True, window, torch.from_numpy(valid[:, 0]))
    return _attend_dense(torch.from_numpy(q), kt, vt, bias[:, None, None]).numpy()


@pytest.mark.parametrize("s", [1, 4, 13])
@pytest.mark.parametrize("kh,g", [(2, 2), (4, 1)], ids=["gqa", "mha"])
@pytest.mark.parametrize("window", [None, 8], ids=["global", "window"])
def test_flash_attend_matches_reference(s, kh, g, window):
    b, t, hd = 3, 64, 16
    starts = [0, 13, 40][:b]  # ragged fill levels
    q, kt, vt, kj, vj, st, valid, win = _case(b, t, kh, g, hd, s, starts, window)
    got = _port(q, kt, vt, st, valid, win)
    want = np.asarray(jflash(
        jnp.asarray(q), kj, vj, None, None, jnp.asarray(st), jnp.asarray(valid),
        jnp.asarray(win), fmt="kv_bf16", interpret=True,
    ))
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(got, _dense(q, kt, vt, st, valid, window), atol=5e-5)


def _packed_case(fmt, b, t, kh, g, hd, s, starts, window, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, kh, g, hd)).astype(np.float32)
    starts = np.asarray(starts, np.int32).reshape(b, 1)
    valid = starts + s
    win = np.full((1, 1), 2**30 if window is None else window, np.int32)
    if fmt == "kv_int8":
        k, v = (rng.integers(-127, 128, size=(b, t, kh, hd)).astype(np.int8) for _ in range(2))
        ke, ve = (rng.integers(-9, -4, size=(b, t, kh, 1)).astype(np.int8) for _ in range(2))
    else:
        k, v = (rng.integers(0, 256, size=(b, t, kh, hd // 2)).astype(np.uint8) for _ in range(2))
        ke, ve = (rng.integers(-3, 1, size=(b, t // 32, kh, 1)).astype(np.int8) for _ in range(2))
        empty = np.arange(t // 32)[None, :, None, None] * 32 >= valid[:, :, None, None]
        ke, ve = (np.where(empty, np.int8(-127), e) for e in (ke, ve))  # blocks past the fill level
    return q, k, v, ke, ve, starts, valid, win


@pytest.mark.parametrize("fmt", ["kv_int8", "kv_mx"])
@pytest.mark.parametrize("s", [1, 4, 13])
@pytest.mark.parametrize("kh,g", [(2, 2), (4, 1)], ids=["gqa", "mha"])
@pytest.mark.parametrize("window", [None, 8], ids=["global", "window"])
def test_flash_attend_quantized_cache_matches_reference(fmt, s, kh, g, window):
    b, t, hd = 3, 64, 16
    q, k, v, ke, ve, st, valid, win = _packed_case(fmt, b, t, kh, g, hd, s, [0, 19, 45], window, seed=s)
    arrays = (q, k, v, ke, ve, st, valid, win)
    got = flash_attend(*(torch.from_numpy(a) for a in arrays), fmt=fmt).numpy()
    want = np.asarray(jflash(*(jnp.asarray(a) for a in arrays), fmt=fmt, interpret=True))
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_flash_attend_small_blocks_many_kv_tiles():
    q, kt, vt, kj, vj, st, valid, win = _case(2, 128, 2, 2, 8, 16, [37, 90], None, seed=2)
    got = _port(q, kt, vt, st, valid, win, block_q=4, block_k=16)
    want = np.asarray(jflash(
        jnp.asarray(q), kj, vj, None, None, jnp.asarray(st), jnp.asarray(valid),
        jnp.asarray(win), fmt="kv_bf16", block_q=4, block_k=16, interpret=True,
    ))
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_flash_decode_entry():
    q, kt, vt, kj, vj, st, valid, win = _case(4, 32, 2, 4, 16, 1, [0, 5, 17, 31], None, seed=3)
    got = flash_decode(
        torch.from_numpy(q[:, 0]), kt, vt, None, None, torch.from_numpy(st),
        torch.from_numpy(valid), torch.from_numpy(win), fmt="kv_bf16",
    ).numpy()
    np.testing.assert_allclose(got, _port(q, kt, vt, st, valid, win)[:, 0], atol=0)
    np.testing.assert_allclose(got, _dense(q, kt, vt, st, valid, None)[:, 0], atol=5e-5)


def test_unported_formats_raise():
    """A cache format with no flash kernel is refused, on the CPU too."""
    q, kt, vt, _, _, st, valid, win = _case(1, 32, 1, 1, 8, 1, [3], None)
    with pytest.raises(NotImplementedError):
        flash_attend(torch.from_numpy(q), kt, vt, None, None, torch.from_numpy(st),
                     torch.from_numpy(valid), torch.from_numpy(win), fmt="kv_fp8")


def test_block_pickers_match_reference():
    from repro.kernels.flash_prefill import pick_kv_block as jkv
    from repro.kernels.flash_prefill import pick_q_block as jq

    for s, g in [(64, 1), (64, 2), (8, 16), (13, 2), (1, 4), (7, 16)]:
        assert pick_q_block(s, g) == jq(s, g)
    for t in (256, 2048, 96, 13):
        assert pick_kv_block(t, "kv_bf16") == jkv(t, "kv_bf16")
        assert pick_kv_block(t, "kv_int8", 32) == jkv(t, "kv_int8", 32)
    for t in (32, 96, 1024, 2048):
        for want in (32, 128):
            assert pick_kv_block(t, "kv_mx", want) == jkv(t, "kv_mx", want)


# ---------------------------------------------------------------------------
# the kernel's sizing (the kernel itself runs only on the card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_kernel_sizing_fits_a_block(fmt, hd, g):
    """Shared memory of a prefill and a decode block within what a block
    may have; decode partials are one (m, l, P.V) row per split and row."""
    for b, s, t, kh in ((4, 1, 1024, 8), (1, 256, 1024, 8), (4, 1, 256, 8), (1, 900, 1024, 8), (16, 1, 4096, 8)):
        plan = launch_plan(fmt, b, s, t, kh, g, hd)
        assert plan["smem"] <= plan["smem_cap"] <= 232_448, (s, t, plan)
        if s == 1:
            assert plan["part_floats"] == b * kh * plan["splits"] * g * (hd + 2)
            assert plan["keys"] % 32 == 0  # whole kv_mx blocks a split
        else:
            assert plan["part_floats"] == 0 and plan["keys"] == KEY_TILE


@pytest.mark.parametrize("s", [2, 13, 31, 60, 132, 188, 255, 256])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
def test_row_tiles_cover_ragged_chunks(s, g):
    """Fixed 64-row tiles over the S*G rows: no row lost or repeated, the
    last tile ragged -- where ``pick_q_block`` collapses a prime S to one
    query a block."""
    n = row_blocks(s, g)
    rows = [r for blk in range(n) for r in range(blk * ROW_TILE, min((blk + 1) * ROW_TILE, s * g))]
    assert rows == list(range(s * g))
    assert (n - 1) * ROW_TILE < s * g <= n * ROW_TILE
    assert launch_plan("kv_int8", 2, s, 1024, 8, g, 128)["grid"] == (16, n, 1)
    if s == 31 and g > 1:
        assert pick_q_block(s, g) == 1  # the TPU's divisor rule: one query a block


@pytest.mark.parametrize("b,kh,t", [(4, 8, 1024), (4, 8, 256), (1, 8, 1024), (1, 8, 32), (2, 2, 64),
                                    (64, 8, 1024), (16, 8, 8192), (3, 5, 96)])
def test_decode_split_fills_the_card(b, kh, t):
    """Pairs x splits near two blocks an SM (or 32 keys a split when T is
    too short for that), every split a multiple of 32 keys, no key lost."""
    splits, keys = decode_split(b * kh, t, 132)
    assert keys % 32 == 0 and 32 <= keys <= 512
    assert (splits - 1) * keys < t <= splits * keys
    blocks = b * kh * splits
    assert blocks >= 0.75 * 2 * 132 or keys == 32, (splits, keys)
    assert blocks <= 2 * 2 * 132 or keys == 512 or splits == 1, (splits, keys)
    if (b, kh, t) == (4, 8, 1024):
        assert (splits, keys) == (8, 128)  # the staged decode tick: 256 blocks
