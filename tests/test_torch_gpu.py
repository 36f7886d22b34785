"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device each test skips (decided
inside the fixture, so every worker collects the same tests).  Run on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import pytest
import torch

from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
from repro_torch.models import kv_cache
from repro_torch.kernels.fused_qmm import fused_qmm_ref
from repro_torch.kernels.int8_matmul import int8_matmul_fused
from repro_torch.kernels.ternary_matmul import ternary_matmul_fused
from repro_torch.quant.formats import quantize_weights

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("decode", ["ternary", "int8"])
@pytest.mark.parametrize("m", [1, 4, 9])
@pytest.mark.parametrize("act", [None, "silu", "relu"])
@pytest.mark.parametrize("static_e", [None, -3])
def test_fused_qmm_bit_exact(dev, decode, m, act, static_e):
    gen = torch.Generator(device=dev).manual_seed(m)
    k, n, group = 1024, 256, 64
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev), 2 if decode == "ternary" else 8,
                          group, fmt=decode)
    x = torch.randn((m, k), generator=gen, device=dev)
    x[0, 3] = float("nan")
    bias = torch.randn((n,), generator=gen, device=dev)
    entry = ternary_matmul_fused if decode == "ternary" else int8_matmul_fused
    kw = dict(group=group, bias=bias, act=act, act_exponent=static_e, block_k=256)
    got = entry(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("s,g", [(1, 4), (4, 2), (16, 1)])
def test_flash_attend_matches_plain(dev, s, g):
    gen = torch.Generator(device=dev).manual_seed(s)
    b, t, kh, hd = 3, 128, 2, 64
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    k = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(torch.bfloat16)
    valid = torch.tensor([[s], [70], [128]], dtype=torch.int32, device=dev)
    start = valid - s
    win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
    got = flash_attend(q, k, v, None, None, start, valid, win, fmt="kv_bf16")
    want = flash_attend_ref(q, k, v, None, None, start, valid, win, fmt="kv_bf16")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("m", [17, 64, 256])
def test_fused_qmm_prefill_rows_bit_exact(dev, m):
    """Row blocks past the first (M > 8): prefill-chunk projections."""
    gen = torch.Generator(device=dev).manual_seed(m)
    k, n, group = 2048, 512, 64
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev), 2, group)
    x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    got = ternary_matmul_fused(x, qt.packed, qt.scale_m, qt.scale_e, group=group, act="silu")
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="ternary", group=group, act="silu")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _packed_cache(fmt, b, t, kh, hd, gen, dev):
    """A cache filled by the port's own quantize-on-write."""
    c = kv_cache.get_kv_format(fmt).init((b,), t, kh, hd, torch.bfloat16, dev)
    x = lambda: (torch.randn((b, t, kh, hd), generator=gen, device=dev) * 2).to(torch.bfloat16)  # noqa: E731
    kv_cache.write(fmt, c, x(), x(), 0)
    return c


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("s,starts", [(1, [0, 69, 127]), (4, [0, 37, 124]), (32, [0, 32, 96])])
@pytest.mark.parametrize("window", [None, 40])
def test_flash_packed_cache_matches_plain(dev, fmt, s, starts, window):
    gen = torch.Generator(device=dev).manual_seed(s)
    b, t, kh, g, hd = 3, 128, 2, 4, 64
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    start = torch.tensor(starts, dtype=torch.int32, device=dev).reshape(b, 1)
    valid = start + s
    win = torch.tensor([[2**30 if window is None else window]], dtype=torch.int32, device=dev)
    args = (q, c["k"], c["v"], c.get("ke"), c.get("ve"), start, valid, win)
    got = flash_attend(*args, fmt=fmt)
    want = flash_attend_ref(*args, fmt=fmt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


def test_flash_in_chunk_tail_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, kh, g, hd = 2, 96, 2, 4, 128
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    k = torch.randn((b, s, kh, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kh, hd), generator=gen, device=dev).to(torch.bfloat16)
    zero = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    full = torch.full((b, 1), s, dtype=torch.int32, device=dev)
    win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
    got = flash_attend(q, k, v, None, None, zero, full, win, fmt="kv_bf16")
    want = flash_attend_ref(q, k, v, None, None, zero, full, win, fmt="kv_bf16")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


def test_flash_rejects_rows_too_narrow_for_16_byte_loads(dev):
    c = kv_cache.get_kv_format("kv_mx").init((1,), 64, 1, 16, torch.bfloat16, dev)
    q = torch.randn((1, 1, 1, 1, 16), device=dev)
    one = torch.ones((1, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attend(q, c["k"], c["v"], c["ke"], c["ve"], one - 1, one, one, fmt="kv_mx")


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    qt = quantize_weights(torch.randn((64, 32), device=dev), 2, 16)
    with pytest.raises(ValueError):  # group 8 splits a 16-code word
        ternary_matmul_fused(torch.randn((2, 64), device=dev), qt.packed, qt.scale_m, qt.scale_e, group=8)
    with pytest.raises(TypeError):
        ternary_matmul_fused(torch.randn((2, 64), device=dev).half(), qt.packed, qt.scale_m, qt.scale_e, group=16)
