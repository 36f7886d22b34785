"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device each test skips (decided
inside the fixture, so every worker collects the same tests).  Run on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import pytest
import torch

from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    qt = quantize_weights(torch.randn((64, 32), device=dev), 2, 16)
    with pytest.raises(ValueError):  # group 8 splits a 16-code word
        ternary_matmul_fused(torch.randn((2, 64), device=dev), qt.packed, qt.scale_m, qt.scale_e, group=8)
    with pytest.raises(TypeError):
        ternary_matmul_fused(torch.randn((2, 64), device=dev).half(), qt.packed, qt.scale_m, qt.scale_e, group=16)
