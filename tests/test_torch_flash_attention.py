"""Port vs reference: the standalone flash_attention kernel's plain version
and its dense oracle on the CPU, on every case of
``tests/test_flash_attention.py`` (the reference's own tolerances: 2e-5 in
float32, 3e-2 in bf16; the port's oracle against the reference's at 1e-6).
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_attention import flash_attention_ref as jflash_attention_ref
from repro_torch.kernels import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_plain, smem_bytes

CASES = [  # the reference's (bh, s, t, hd, bq, bk)
    (4, 64, 64, 32, 32, 32),
    (2, 128, 128, 64, 64, 32),
    (3, 64, 128, 32, 64, 64),  # cross-attention length
    (1, 256, 256, 16, 128, 128),
]


def _inputs(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,t,hd,bq,bk", CASES)
def test_plain_matches_reference_kernel_f32(causal, bh, s, t, hd, bq, bk):
    q, k, v = _inputs(0, [(bh, s, hd), (bh, t, hd), (bh, t, hd)])
    want = jflash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,t,hd,bq,bk", CASES)
def test_oracle_matches_reference_oracle(causal, bh, s, t, hd, bq, bk):
    q, k, v = _inputs(1, [(bh, s, hd), (bh, t, hd), (bh, t, hd)])
    want = jflash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # the plain version (tile loop, scale before the dot) against the dense oracle
    plain = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_keeps_dtype_and_matches_reference(causal):
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16, _inputs(1, [(2, 64, 32)] * 3))
    want = jflash_attention(jq, jk, jv, causal=causal, interpret=True, block_q=32, block_k=32)
    got = flash_attention(tq, tk, tv, causal=causal, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)
    oracle = jflash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle, np.float32), atol=3e-2)


def test_masked_row_is_finite():
    """The first query row under the causal mask attends only position 0."""
    q = torch.ones((1, 32, 16))
    k = torch.ones((1, 32, 16))
    v = torch.arange(32, dtype=torch.float32)[None, :, None] * torch.ones((1, 32, 16))
    out = flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    want = jflash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), causal=True,
                            block_q=16, block_k=16, interpret=True)
    assert float(out[0, 0, 0]) == pytest.approx(0.0, abs=1e-6)  # only sees v[0] = 0
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("s,t,block_q,block_k", [(48, 64, 32, 32), (64, 48, 32, 32)])
def test_ragged_tiles_raise_like_the_reference(s, t, block_q, block_k):
    q, k, v = _inputs(2, [(1, s, 16), (1, t, 16), (1, t, 16)])
    with pytest.raises(AssertionError) as want:
        jflash_attention(*map(jnp.asarray, (q, k, v)), block_q=block_q, block_k=block_k, interpret=True)
    with pytest.raises(AssertionError) as got:
        flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=block_q, block_k=block_k)
    assert str(got.value) == str(want.value)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v = map(torch.from_numpy, _inputs(3, [(2, 32, 16)] * 3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_plain(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_smem_fits_a_block(dtype, hd):
    """The kernel's shared memory (three Q planes, the K and V tiles) within
    the 227 KB a block may have, for every head_dim it is built for."""
    assert smem_bytes(dtype, hd) <= 232_448
