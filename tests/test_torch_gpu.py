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


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("s", [31, 60, 132, 188, 255])
def test_flash_ragged_chunks_match_plain(dev, fmt, s):
    """Chunk lengths the 64-row tiles do not divide (prime, the 900-token
    prompt's last chunk of 132), from ragged starts, global and windowed."""
    gen = torch.Generator(device=dev).manual_seed(s)
    b, t, kh, g, hd = 2, 512, 2, 4, 128
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    start = torch.tensor([[0], [t - s - 37]], dtype=torch.int32, device=dev)
    for window in (2**30, 100):
        win = torch.tensor([[window]], dtype=torch.int32, device=dev)
        args = (q, c["k"], c["v"], c.get("ke"), c.get("ve"), start, start + s, win)
        got = flash_attend(*args, fmt=fmt)
        want = flash_attend_ref(*args, fmt=fmt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
def test_flash_decode_is_one_deterministic_launch(dev, fmt):
    """Decode at valid = 1 and at full T: within 5e-5 of plain, two calls
    bit-identical (the last split to arrive combines in split order), one
    CUDA launch a call (the combine runs in the same kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(11)
    b, t, kh, g, hd = 4, 1024, 8, 4, 128
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, 1, kh, g, hd), generator=gen, device=dev)
    valid = torch.tensor([[1], [300], [1000], [t]], dtype=torch.int32, device=dev)
    win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
    args = (q, c["k"], c["v"], c.get("ke"), c.get("ve"), valid - 1, valid, win)
    first = flash_attend(*args, fmt=fmt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):  # the first session of a process may miss its kernels
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = flash_attend(*args, fmt=fmt)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 1, [(e.key, e.count) for e in kernels]
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    torch.testing.assert_close(first, flash_attend_ref(*args, fmt=fmt), atol=5e-5, rtol=0)


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
    """kv_mx rows that are not whole 16-byte pieces: hd 48 (24 bytes) has
    no kernel instance and raises by name; hd 16 (8 bytes) is copied in
    8-byte pieces, as hd 240's 120-byte rows are, and matches plain."""
    one = torch.ones((1, 1), dtype=torch.int32, device=dev)
    c = kv_cache.get_kv_format("kv_mx").init((1,), 64, 1, 48, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attend(torch.randn((1, 1, 1, 1, 48), device=dev), c["k"], c["v"], c["ke"], c["ve"], one - 1, one, one,
                     fmt="kv_mx")
    gen = torch.Generator(device=dev).manual_seed(16)
    c = _packed_cache("kv_mx", 2, 64, 2, 16, gen, dev)
    for s in (1, 9):
        q = torch.randn((2, s, 2, 2, 16), generator=gen, device=dev)
        start = torch.tensor([[0], [64 - s - 5]], dtype=torch.int32, device=dev)
        win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
        args = (q, c["k"], c["v"], c["ke"], c["ve"], start, start + s, win)
        got = flash_attend(*args, fmt="kv_mx")
        want = flash_attend_ref(*args, fmt="kv_mx")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    qt = quantize_weights(torch.randn((64, 32), device=dev), 2, 16)
    with pytest.raises(ValueError):  # group 8 splits a 16-code word
        ternary_matmul_fused(torch.randn((2, 64), device=dev), qt.packed, qt.scale_m, qt.scale_e, group=8)
    with pytest.raises(TypeError):
        ternary_matmul_fused(torch.randn((2, 64), device=dev).half(), qt.packed, qt.scale_m, qt.scale_e, group=16)


# ---------------------------------------------------------------------------
# 4-bit fused decodes, the unfused pair (quantize_rows, packed_qmm), qmatmul
# ---------------------------------------------------------------------------
FMT_BITS = {"ternary": 2, "int4": 4, "int8": 8, "nf4": 4, "mx": 8}
ROWS = [1, 4, 9, 17, 256]


def _edge_x(m, k, gen, dev, dtype):
    """Random rows, then (where there is room) a NaN, a max of exactly
    127 * 2**-3, one ulp above it, an all-zero row and a subnormal max."""
    x = torch.randn((m, k), generator=gen, device=dev) * 0.1
    edits = [(7, float("nan")), (11, 127.0 * 2.0**-3), (13, 127.0 * 2.0**-3 * (1 + 2.0**-7))]
    for r, (c, v) in enumerate(edits[:m]):
        x[r, c] = v
    if m > 4:
        x[3] = 0.0
        x[4] = 0.0
        x[4, 5] = 1e-39
    return x.to(dtype)


@pytest.mark.parametrize("decode", ["int4", "nf4"])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("static_e", [None, -3])
def test_fused_qmm_4bit_bit_exact(dev, decode, m, static_e):
    from repro_torch.kernels.int4_matmul import int4_matmul_fused
    from repro_torch.kernels.nf4_matmul import nf4_matmul_fused

    gen = torch.Generator(device=dev).manual_seed(m)
    k, n, group = 1024, 256, 64
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev), 4, group, fmt=decode)
    x = _edge_x(m, k, gen, dev, torch.bfloat16)
    bias = torch.randn((n,), generator=gen, device=dev)
    entry = int4_matmul_fused if decode == "int4" else nf4_matmul_fused
    kw = dict(group=group, bias=bias, act="silu", act_exponent=static_e, block_k=256)
    before = entry.launches
    got = entry(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("fmt", list(FMT_BITS))
@pytest.mark.parametrize("m", ROWS)
def test_packed_qmm_bit_exact(dev, fmt, m):
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(m)
    k, n = 1024, 256
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev), FMT_BITS[fmt], 64, fmt=fmt)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    entry = get_format(fmt).kernel
    got = entry(xq, qt.packed, qt.scale_m, group=qt.group_size, block_k=256)
    decode = "int8" if fmt == "mx" else fmt
    want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size, block_k=256)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", ROWS)
def test_quantize_rows_bit_exact(dev, dtype, m):
    from repro_torch.kernels.quantize import quantize_rows, quantize_rows_plain

    gen = torch.Generator(device=dev).manual_seed(m)
    x = _edge_x(m, 4096, gen, dev, dtype)
    before = quantize_rows.launches
    q, e = quantize_rows(x)
    wq, we = quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    assert torch.equal(q, wq) and torch.equal(e, we)


@pytest.mark.parametrize("fmt", list(FMT_BITS))
@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("static_e", [None, -4])
def test_unfused_site_equals_fused(dev, fmt, m, static_e):
    """quantize_rows -> packed_qmm -> 2**(scale_e + e) -> bias -> silu is
    the fused kernel's site, bit for bit."""
    from repro_torch.quant import qdense

    gen = torch.Generator(device=dev).manual_seed(m)
    k, n = 2048, 512
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * 0.02, FMT_BITS[fmt], 64, fmt=fmt)
    x = _edge_x(m, k, gen, dev, torch.bfloat16)
    bias = torch.randn((n,), generator=gen, device=dev)
    kw = dict(bias=bias, act="silu", backend="cuda", act_exponent=static_e)
    fused = qdense(x, qt, fused=True, **kw)
    unfused = qdense(x, qt, fused=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fused.view(torch.int32), unfused.view(torch.int32))


def test_qmatmul_on_cuda_launches_the_kernels(dev):
    """The public qmatmul on a CUDA tensor goes through quantize_rows and the
    packed kernel (it used to run the plain oracle on the card)."""
    from repro_torch.kernels.int4_matmul import int4_matmul
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant import qdense, qmatmul

    qt = quantize_weights(torch.randn((512, 128), device=dev), 4, 64)
    x = torch.randn((3, 5, 512), device=dev)
    before = (quantize_rows.launches, int4_matmul.launches)
    got = qmatmul(x, qt)
    want = qdense(x, qt, backend="cuda")  # the fused site, no bias or activation
    torch.cuda.synchronize()
    assert (quantize_rows.launches, int4_matmul.launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == (3, 5, 128) and torch.equal(got, want)


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_fused
    from repro_torch.kernels.quantize import quantize_rows

    qt = quantize_weights(torch.randn((64, 32), device=dev), 4, 16)
    with pytest.raises(ValueError):  # group 4 splits an 8-field word
        int4_matmul_fused(torch.randn((2, 64), device=dev), qt.packed, qt.scale_m, qt.scale_e, group=4)
    with pytest.raises(TypeError):
        int4_matmul(torch.zeros((2, 64), device=dev), qt.packed, qt.scale_m, group=16)  # float, not int8
    with pytest.raises(ValueError):  # ternary-shaped words for an int4 site
        int4_matmul(torch.zeros((2, 64), dtype=torch.int8, device=dev), qt.packed[:4], qt.scale_m, group=16)
    with pytest.raises(TypeError):
        quantize_rows(torch.randn((2, 64), device=dev).half())
    with pytest.raises(ValueError):
        quantize_rows(torch.randn((2, 12), device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("m", [4, 17])
def test_mx_long_rows_take_fewer_rows_per_block(dev, m):
    """mx at d_ff = 12288: the int8 loop keeps all of x's rows (up to 8) in
    a block beside its rings (32-element clusters: one scale row a stage);
    at M = 17 the tile runs the same site."""
    from repro_torch.kernels.fused_qmm import rows_per_block
    from repro_torch.quant import qdense

    gen = torch.Generator(device=dev).manual_seed(m)
    qt = quantize_weights(torch.randn((12288, 256), generator=gen, device=dev) * 0.01, 8, 32, fmt="mx")
    assert rows_per_block(m, 12288, 32) == min(m, 8)
    x = _edge_x(m, 12288, gen, dev, torch.bfloat16)
    fused = qdense(x, qt, backend="cuda")
    unfused = qdense(x, qt, backend="cuda", fused=False)
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="int8", group=32)
    torch.cuda.synchronize()
    assert torch.equal(fused.view(torch.int32), want.view(torch.int32))
    assert torch.equal(unfused.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the GEMV (M <= 8): every decode and cluster length on the layer's sites
# ---------------------------------------------------------------------------
GEMV_SITES = [(4096, 4096, None), (4096, 1024, None), (4096, 12288, "silu"), (12288, 4096, None),
              (4096, 1040, "gelu")]  # wq / wo, wk / wv, gate (up: gate's shape), down, a ragged last strip
GEMV_CASES = [(fmt, g) for fmt in ("ternary", "int4", "nf4", "int8") for g in (16, 32, 64, 128)] + [("mx", 32)]
GEMV_EPILOGUES = [(torch.bfloat16, None, None), (torch.float32, -3, "silu"), (torch.bfloat16, -3, "gelu"),
                  (torch.float32, None, "relu")]  # (x dtype, static exponent, activation), cycled over M


@pytest.mark.parametrize("fmt,group", GEMV_CASES)
def test_gemv_bit_exact_on_the_layer_sites(dev, fmt, group):
    """Fused and packed at M = 1..8 on the real site shapes and N = 1040: 0
    ulps from the plain versions with bias, bf16 and float32 x, dynamic
    and static exponent and every activation; the unfused site equals the
    fused one; one launch a call."""
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.quant import qdense
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(group)
    decode = "int8" if fmt == "mx" else fmt
    entry = get_format(fmt)
    for k, n, site_act in GEMV_SITES:
        qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * k**-0.5, FMT_BITS[fmt], group,
                              fmt=fmt)
        bias = torch.randn((n,), generator=gen, device=dev)
        for m in range(1, 9):
            dtype, static_e, act = GEMV_EPILOGUES[(m + n) % len(GEMV_EPILOGUES)]
            act = act or site_act
            x = _edge_x(m, k, gen, dev, dtype)
            kw = dict(group=qt.group_size, bias=bias, act=act, act_exponent=static_e)
            before = entry.fused_kernel.mode_launches["m<=8"]
            got = entry.fused_kernel(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
            want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
            torch.cuda.synchronize()
            assert entry.fused_kernel.mode_launches["m<=8"] == before + 1
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (k, n, m, dtype, static_e, act)
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            got = entry.kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
            want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), ("packed", k, n, m)
            if m in (1, 4, 8):
                qkw = dict(bias=bias, act=act, act_exponent=static_e, backend="cuda")
                fused, unfused = qdense(x, qt, fused=True, **qkw), qdense(x, qt, fused=False, **qkw)
                torch.cuda.synchronize()
                assert torch.equal(fused.view(torch.int32), unfused.view(torch.int32)), ("unfused", k, n, m)
        del qt


@pytest.mark.parametrize("fmt,group", [("ternary", 64), ("int4", 64), ("nf4", 16), ("ternary", 32), ("mx", 32)])
def test_gemv_k_splits_are_repeatable(dev, fmt, group):
    """wk / wv and wq / wo split their k-tiles over a cluster of blocks
    (gemv_plan); block 0 adds every split's tile sums in tile order, so a
    second call, fused or packed, gives the same bits."""
    from repro_torch.kernels.fused_qmm import gemv_plan
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(7)
    decode = "int8" if fmt == "mx" else fmt
    entry = get_format(fmt)
    for k, n in ((4096, 1024), (4096, 4096)):
        assert gemv_plan(4, k, n, decode, group)["splits"] > 1
        qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * 0.02, FMT_BITS[fmt], group, fmt=fmt)
        x = _edge_x(4, k, gen, dev, torch.bfloat16)
        first = entry.fused_kernel(x, qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size, act="silu")
        second = entry.fused_kernel(x, qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size, act="silu")
        want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, group=qt.group_size, act="silu")
        xq = torch.randint(-127, 128, (4, k), generator=gen, device=dev, dtype=torch.int8)
        p1 = entry.kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
        p2 = entry.kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int32), want.view(torch.int32))
        assert torch.equal(second.view(torch.int32), first.view(torch.int32))
        assert torch.equal(p2.view(torch.int32), p1.view(torch.int32))


def test_gemv_rejects_groups_it_does_not_take(dev):
    from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_fused

    qt = quantize_weights(torch.randn((1024, 64), device=dev), 4, 8)
    with pytest.raises(ValueError, match="GEMV"):  # group 8: no mma k takes it
        int4_matmul_fused(torch.randn((4, 1024), device=dev), qt.packed, qt.scale_m, qt.scale_e, group=8)
    # an int8 site that fills the card takes the int8 loop, which takes any group of whole 4-row units
    from repro_torch.kernels.fused_qmm import uses_int8_loop
    assert uses_int8_loop("int8", 4, 1024, 152064, 64) and not uses_int8_loop("int8", 4, 1024, 64, 64)
    assert uses_int8_loop("int8", 4, 1024, 64, 8)
    with pytest.raises(ValueError, match="GEMV"):
        int4_matmul(torch.zeros((4, 1024), dtype=torch.int8, device=dev), qt.packed, qt.scale_m, group=8)


# ---------------------------------------------------------------------------
# the int8 loop (M <= 8, csrc/qmm_gemv8.cuh): every lm_head K, the mx sites
# ---------------------------------------------------------------------------
LOOP_KS = [512, 3072, 3584, 3840, 4096, 6144, 7168, 8192]  # every family's lm_head K; 3840: a ragged last tile


def _loop_site(k, n, group, gen, dev):
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    sm = torch.randint(-127, 128, (k // group, n), generator=gen, device=dev, dtype=torch.int8)
    return w, sm, torch.tensor([-9], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("k", LOOP_KS)
@pytest.mark.parametrize("m", range(1, 9))
def test_int8_loop_bit_exact_at_lm_head_k(dev, k, m):
    """The loop (N sized so its units fill the card) against the plain
    versions: fused in bf16 with the dynamic exponent, in float32 with a
    static one, a bias and silu / gelu; packed over quantize_rows' rows."""
    from repro_torch.kernels.fused_qmm import fused_qmm, uses_int8_loop
    from repro_torch.kernels.packed_qmm import packed_qmm, packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(k + m)
    n = 128 * 72  # 72 items of 128 columns: the loop's route
    assert uses_int8_loop("int8", m, k, n, 64)
    w, sm, se = _loop_site(k, n, 64, gen, dev)
    bias = torch.randn((n,), generator=gen, device=dev)
    for dtype, kw in ((torch.bfloat16, {}), (torch.float32, dict(act_exponent=-3, bias=bias, act="silu")),
                      (torch.bfloat16, dict(bias=bias, act="gelu"))):
        x = _edge_x(m, k, gen, dev, dtype)
        got = fused_qmm(x, w, sm, se, decode="int8", group=64, **kw)
        want = fused_qmm_ref(x, w, sm, se, decode="int8", group=64, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    xq, _ = quantize_rows(x)
    got = packed_qmm(xq, w, sm, decode="int8", group=64)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), packed_qmm_ref(xq, w, sm, decode="int8", group=64).view(torch.int32))


@pytest.mark.parametrize("name,k,n", [("wq", 4096, 4096), ("wk", 4096, 1024), ("wo", 4096, 4096),
                                      ("gate", 4096, 12288), ("down", 12288, 4096)])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_mx_sites_bit_exact_on_their_route(dev, name, k, n, m):
    """The mx layer's sites (group 32) on the route the plan picks, fused
    and unfused, against the plain version."""
    from repro_torch.quant import qdense

    gen = torch.Generator(device=dev).manual_seed(k + n + m)
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * 0.01, 8, 32, fmt="mx")
    x = _edge_x(m, k, gen, dev, torch.bfloat16)
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="int8", group=32, act="silu")
    for fused in (True, False):
        got = qdense(x, qt, backend="cuda", fused=fused, act="silu")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("k,n", [(7168, 32000), (3584, 32000), (4096, 12288)])
def test_int8_loop_k_splits_bit_exact_and_repeatable(dev, k, n):
    """Plans that split the k-tiles (arctic's and zamba2's lm_head, an int8
    site as wide as mx's gate): the fold through scratch gives the plain
    version's bits on every call, whichever warp arrives last."""
    from repro_torch.kernels.fused_qmm import fused_qmm, int8_loop_plan, uses_int8_loop

    assert int8_loop_plan(4, k, n, 64)["splits"] > 1 and uses_int8_loop("int8", 4, k, n, 64)
    gen = torch.Generator(device=dev).manual_seed(k)
    w, sm, se = _loop_site(k, n, 64, gen, dev)
    x = _edge_x(4, k, gen, dev, torch.bfloat16)
    want = fused_qmm_ref(x, w, sm, se, decode="int8", group=64)
    for _ in range(3):
        got = fused_qmm(x, w, sm, se, decode="int8", group=64)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("group,k", [(4, 1024), (12, 1536), (20, 2560), (48, 3072)])
def test_int8_loop_takes_any_group_of_whole_4_row_units(dev, group, k):
    """Clusters the GEMV does not take: they end inside a 16-k step and
    close there; float32 x, K a multiple of the cluster."""
    from repro_torch.kernels.fused_qmm import fused_qmm, uses_int8_loop

    gen = torch.Generator(device=dev).manual_seed(group)
    n = 512
    assert uses_int8_loop("int8", 5, k, n, group)
    w, sm, se = _loop_site(k, n, group, gen, dev)
    x = _edge_x(5, k, gen, dev, torch.float32)
    got = fused_qmm(x, w, sm, se, decode="int8", group=group, block_k=k // 2)
    want = fused_qmm_ref(x, w, sm, se, decode="int8", group=group, block_k=k // 2)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the tensor-core tile (M > 8): every decode, ragged rows and columns, k-splits
# ---------------------------------------------------------------------------
TILE_FMTS = ["ternary", "int4", "nf4", "mx"]  # ternary, the 4-bit table twice, int8 at group 32
TILE_ROWS = [9, 17, 31, 132, 256]
# the tile's other cluster lengths, each its own code path: 16 (mma k16,
# 64-k stages, a 4-deep ring) and 128, for each decode
OTHER_GROUPS = [(fmt, g) for g in (16, 128) for fmt in ("ternary", "int4", "int8")]


@pytest.mark.parametrize("fmt,group", [(fmt, 64) for fmt in TILE_FMTS] + OTHER_GROUPS)
@pytest.mark.parametrize("m", TILE_ROWS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tile_fused_bit_exact(dev, fmt, group, m, dtype):
    """The fused site at M > 8 (quantize pre-pass + tile): 0 ulps from the
    plain version with bias, dynamic and static exponent, every activation
    (mx pins group 32)."""
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(m)
    k, n = 1024, 520  # N = 4 blocks of 128 + 8: a ragged last block column
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * 0.05, FMT_BITS[fmt], group, fmt=fmt)
    x = _edge_x(m, k, gen, dev, dtype)
    bias = torch.randn((n,), generator=gen, device=dev)
    entry = get_format(fmt).fused_kernel
    decode = "int8" if fmt == "mx" else fmt
    before = entry.mode_launches["m>8"]
    for static_e, act in [(None, None), (-3, "silu"), (None, "gelu"), (-3, "relu")]:
        kw = dict(group=qt.group_size, bias=bias, act=act, act_exponent=static_e)
        got = entry(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
        want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (static_e, act)
    assert entry.mode_launches["m>8"] == before + 4


@pytest.mark.parametrize("fmt,group", [(fmt, 64) for fmt in FMT_BITS] + OTHER_GROUPS)
@pytest.mark.parametrize("m", [31, 132])
def test_tile_packed_bit_exact(dev, fmt, group, m):
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(m)
    k, n = 2048, 520
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev), FMT_BITS[fmt], group, fmt=fmt)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    got = get_format(fmt).kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
    decode = "int8" if fmt == "mx" else fmt
    want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("fmt", list(FMT_BITS))
def test_tile_unfused_site_equals_fused_at_m_132(dev, fmt):
    from repro_torch.quant import qdense

    gen = torch.Generator(device=dev).manual_seed(132)
    k, n = 2048, 520
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * 0.02, FMT_BITS[fmt], 64, fmt=fmt)
    x = _edge_x(132, k, gen, dev, torch.bfloat16)
    kw = dict(bias=torch.randn((n,), generator=gen, device=dev), act="silu", backend="cuda")
    fused, unfused = qdense(x, qt, fused=True, **kw), qdense(x, qt, fused=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fused.view(torch.int32), unfused.view(torch.int32))


@pytest.mark.parametrize("decode", ["ternary", "int4"])
def test_tile_k_splits_bit_exact_and_repeatable(dev, decode):
    """A site with few output blocks splits its k-tiles over the grid; the
    last block adds the slots in tile order and resets its counter, so a
    second call gives the same bits."""
    from repro_torch.kernels.fused_qmm import tile_plan
    from repro_torch.kernels.int4_matmul import int4_matmul_fused

    gen = torch.Generator(device=dev).manual_seed(17)
    m, k, n = 17, 4096, 1024
    assert tile_plan(m, k, n, decode, 64)["splits"] > 1
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * 0.02, FMT_BITS[decode], 64, fmt=decode)
    x = _edge_x(m, k, gen, dev, torch.bfloat16)
    entry = ternary_matmul_fused if decode == "ternary" else int4_matmul_fused
    first = entry(x, qt.packed, qt.scale_m, qt.scale_e, group=64, act="silu")
    second = entry(x, qt.packed, qt.scale_m, qt.scale_e, group=64, act="silu")
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, group=64, act="silu")
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), want.view(torch.int32))
    assert torch.equal(second.view(torch.int32), first.view(torch.int32))


def test_tile_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.int4_matmul import int4_matmul_fused

    qt = quantize_weights(torch.randn((1024, 64), device=dev), 4, 8)
    x = torch.randn((9, 1024), device=dev)
    with pytest.raises(ValueError):  # group 8: no mma takes it
        int4_matmul_fused(x, qt.packed, qt.scale_m, qt.scale_e, group=8)
    qt = quantize_weights(torch.randn((1024, 64), device=dev), 4, 64)
    with pytest.raises(ValueError):  # k-tiles of 64: not whole 128-wide stages
        int4_matmul_fused(x, qt.packed, qt.scale_m, qt.scale_e, group=64, block_k=64)


# ---------------------------------------------------------------------------
# standalone flash_attention; the guarded decode tick
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,t,hd", [(4, 64, 64, 32), (2, 128, 128, 64), (3, 64, 128, 32), (1, 256, 256, 16),
                                       (2, 96, 160, 128), (1, 16, 40, 64)])
def test_flash_attention_matches_plain(dev, causal, dtype, bh, s, t, hd):
    """The kernel against its plain version: the reference's shapes, hd 128,
    and tails shorter than the kernel's 32-row and 64-key tiles."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device=dev).manual_seed(s + t + hd)
    q, k, v = (torch.randn((bh, n, hd), generator=gen, device=dev).to(dtype) for n in (s, t, t))
    before = flash_attention.launches
    blocks = dict(block_q=min(s, 32), block_k=min(t, 8))
    got = flash_attention(q, k, v, causal=causal, **blocks)
    want = flash_attention_plain(q, k, v, causal=causal, **blocks)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=2e-5 if dtype == torch.float32 else 3e-2, rtol=0)


def test_flash_attention_masked_row_sees_only_key_zero(dev):
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.ones((1, 32, 16), device=dev)
    v = torch.arange(32, dtype=torch.float32, device=dev)[None, :, None] * torch.ones((1, 32, 16), device=dev)
    out = flash_attention(q, q.clone(), v, causal=True, block_q=16, block_k=16)
    torch.cuda.synchronize()
    assert float(out[0, 0, 0]) == pytest.approx(0.0, abs=1e-6) and bool(torch.isfinite(out).all())


def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    """hd 48 has no kernel instance: a CUDA tensor raises, never falls back."""
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn((2, 32, 48), device=dev)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q[..., :32].half().contiguous(), q[..., :32].half().contiguous(),
                        q[..., :32].half().contiguous())
    with pytest.raises(ValueError):  # k in another dtype
        flash_attention(q[..., :32].contiguous(), q[..., :32].to(torch.bfloat16).contiguous(),
                        q[..., :32].contiguous())
    assert flash_attention.launches == before


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_decode_tick_makes_one_host_sync(dev, monkeypatch, engine):
    """With guardrails on, a generate tick moves its tokens and poison flags
    to the host with one ``.cpu()`` and reads nothing else back."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import build_model, init_quantized
    from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine

    cfg = dataclasses.replace(configs.get_smoke("qwen3-8b", QuantConfig(w_bits=2, group_size=16, mode="ptq")),
                              flash_decode=True, flash_prefill=True, kv_fmt="kv_int8")
    qparams, _, api = init_quantized(build_model(cfg, device=dev), torch.Generator(device=dev).manual_seed(0))
    kw = dict(sched=SchedulerConfig(prefill_chunk=4)) if engine == "staged" else {}
    eng = (StagedEngine if engine == "staged" else ServingEngine)(api, qparams, n_slots=2, max_len=32, **kw)
    assert eng.health.guardrails
    for i in range(2):
        eng.submit(Request(uid=i, prompt=[3 + i, 5, 7], max_new_tokens=20))
    for _ in range(8):  # past admission and prefill: every slot generating
        eng.step()
    calls = []
    for name in ("cpu", "item", "tolist"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _n=name, _f=orig, **k: (calls.append(_n), _f(
            self, *a, **k))[1])
    tick0 = eng._tick
    for _ in range(3):
        eng.step()
    assert eng._tick == tick0 + 3 and calls == ["cpu"] * 3
    assert all(len(r.output) > 0 for r in eng.slot_req)


def test_cold_start_from_artifact_on_the_card(dev, tmp_path):
    """Calibrate and save on the card, cold-start both engines from the
    artifact onto the card: the same tokens as the in-memory model, through
    the fused kernels with the plan's static exponents."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import build_model, make_smoke_batch, quantize_and_plan, save_servable
    from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine

    cfg = dataclasses.replace(configs.get_smoke("qwen3-8b", QuantConfig(w_bits=2, group_size=16, mode="ptq")),
                              flash_decode=True, flash_prefill=True, kv_fmt="kv_int8")
    api = build_model(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    calib = [make_smoke_batch(torch.Generator(device=dev).manual_seed(100 + i), cfg, 2, 16) for i in range(2)]
    qparams, plan, qapi = quantize_and_plan(api, params, calib_batches=calib)
    assert len(plan.act_exponents) == len(plan.site_paths) == 8
    save_servable(str(tmp_path), qapi, qparams, plan)
    for cls, kw in ((ServingEngine, {}), (StagedEngine, dict(sched=SchedulerConfig(prefill_chunk=4)))):
        outs = []
        for eng in (cls(qapi, qparams, n_slots=2, max_len=32, **kw),
                    cls.from_artifact(str(tmp_path), n_slots=2, max_len=32, **kw)):
            for i, prompt in enumerate([[3, 5, 7], [11, 2, 9, 4, 6]]):
                eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
            before = ternary_matmul_fused.launches
            outs.append({r.uid: r.output for r in eng.run()})
            assert eng.api.device.type == "cuda" and ternary_matmul_fused.launches > before
        assert outs[0] == outs[1] and all(len(t) == 6 for t in outs[0].values())


# ---------------------------------------------------------------------------
# the dense siblings' shapes: a ragged last k-tile (gemma3's K = 3840 =
# 7 x 512 + 256), K = 49152 (qwen1.5-110b's down projection), head_dim 240
# ---------------------------------------------------------------------------
SIBLING_DECODES = [("ternary", 2, 64), ("int4", 4, 64), ("nf4", 4, 64), ("mx", 8, 32)]


@pytest.mark.parametrize("fmt,bits,group", SIBLING_DECODES)
@pytest.mark.parametrize("m,k,n", [(1, 3840, 1920), (4, 3840, 3840), (8, 768, 256), (17, 3840, 512),
                                   (256, 3840, 1920), (4, 49152, 1024), (8, 49152, 512)])
def test_qdense_any_k_bit_exact(dev, fmt, bits, group, m, k, n):
    """Fused and packed, GEMV (M <= 8) and tile (M > 8), 0 ulps from the
    plain versions; at K = 49152 and M = 8 the GEMV stages x by k range."""
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * k**-0.5, bits, group, fmt=fmt)
    decode = "int8" if fmt == "mx" else fmt
    x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    f = get_format(fmt)
    got = f.fused_kernel(x, qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size, act="silu")
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, group=qt.group_size, act="silu")
    xq, _ = quantize_rows(x)
    got_p = f.kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
    want_p = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got_p.view(torch.int32), want_p.view(torch.int32))


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("s", [1, 31, 256])
def test_flash_hd_240_matches_plain(dev, fmt, s):
    """gemma3's head_dim, global and a 300-token window, decode and chunks."""
    gen = torch.Generator(device=dev).manual_seed(s)
    b, t, kh, g, hd = 2, 1024, 2, 2, 240
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    start = torch.tensor([[0], [t - s - 37]], dtype=torch.int32, device=dev)
    for window in (2**30, 300):
        win = torch.tensor([[window]], dtype=torch.int32, device=dev)
        args = (q, c["k"], c["v"], c.get("ke"), c.get("ve"), start, start + s, win)
        got = flash_attend(*args, fmt=fmt)
        want = flash_attend_ref(*args, fmt=fmt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_flash_attention_hd_240_matches_plain(dev, dtype, atol):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device=dev).manual_seed(240)
    q, k, v = (torch.randn((3, n, 240), generator=gen, device=dev).to(dtype) for n in (128, 256, 256))
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# MoE: the expert-batched packed_qmm (one launch over every expert) and the
# router site's few columns.
# ---------------------------------------------------------------------------
EXPERT_ROUTES = [  # (format, E, K, N, C): the expert GEMV at C <= 8 (every decode, N 16896 too), the tile
    ("ternary", 4, 1024, 384, 8), ("int4", 8, 512, 256, 3), ("nf4", 4, 1024, 192, 8), ("mx", 4, 768, 256, 5),
    ("int8", 2, 256, 16896, 8), ("int8", 4, 512, 256, 8),
    ("ternary", 4, 1024, 384, 80), ("int4", 3, 512, 1040, 17), ("nf4", 8, 512, 256, 132), ("mx", 4, 768, 256, 24),
    ("int8", 4, 512, 256, 256),
]


@pytest.mark.parametrize("fmt,e,k,n,c", EXPERT_ROUTES)
def test_expert_packed_qmm_one_launch_bit_exact(dev, fmt, e, k, n, c):
    """x_q (E, C, K) over an expert site's stacked weights in ONE launch:
    bit for bit the plain per-expert loop and each expert's own launch,
    with the capacity buffer's zero rows."""
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(e * c)
    qt = quantize_weights(torch.randn((e, k, n), generator=gen, device=dev) * k**-0.5, FMT_BITS[fmt], 64, fmt=fmt)
    xq = torch.randint(-127, 128, (e, c, k), generator=gen, device=dev, dtype=torch.int8)
    xq[:, c // 2 + 1:] = 0
    entry, decode = get_format(fmt).kernel, "int8" if fmt == "mx" else fmt
    before = entry.launches
    got = entry(xq, qt.packed, qt.scale_m, group=qt.group_size)
    assert entry.launches == before + 1
    want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
    alone = torch.stack([entry(xq[i].contiguous(), qt.packed[i].contiguous(), qt.scale_m[i].contiguous(),
                               group=qt.group_size) for i in range(e)])
    torch.cuda.synchronize()
    assert got.shape == (e, c, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), alone.view(torch.int32))


def test_expert_qmatmul_on_cuda_is_one_quantize_and_one_packed_launch(dev):
    """The expert qmatmul: one quantize_rows over every E * C row and one
    packed launch, equal to the ref backend's per-expert loop to float32
    rounding (other cluster orders)."""
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.quant import qmatmul

    gen = torch.Generator(device=dev).manual_seed(3)
    qt = quantize_weights(torch.randn((8, 1024, 256), generator=gen, device=dev) * 0.03, 2, 64)
    x = torch.randn((8, 16, 1024), generator=gen, device=dev).to(torch.bfloat16)
    x[:, 9:] = 0
    before = (quantize_rows.launches, ternary_matmul.launches)
    got = qmatmul(x, qt, backend="cuda")
    assert (quantize_rows.launches, ternary_matmul.launches) == (before[0] + 1, before[1] + 1)
    want = qmatmul(x, qt, backend="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [8, 128])
@pytest.mark.parametrize("m", [1, 4, 8, 256])
def test_router_site_few_columns_bit_exact(dev, n, m):
    """The int8 router site (grok N 8, arctic N 128) under the GEMV's
    32-column strips and the tile's 128-column blocks: fused and packed,
    0 ulps."""
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.packed_qmm import packed_qmm_ref

    gen = torch.Generator(device=dev).manual_seed(n + m)
    k = 2048
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * k**-0.5, 8, 64)
    x = _edge_x(m, k, gen, dev, torch.bfloat16)
    got = int8_matmul_fused(x, qt.packed, qt.scale_m, qt.scale_e, group=64)
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="int8", group=64)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    got_p = int8_matmul(xq, qt.packed, qt.scale_m, group=64)
    want_p = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode="int8", group=64)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got_p.view(torch.int32), want_p.view(torch.int32))


# ---------------------------------------------------------------------------
# The expert-batched GEMV over the routed experts only (csrc/qmm_gemv_experts.cuh)
# and quantize_rows reading each row once, at the MoE capacity buffers.
# ---------------------------------------------------------------------------
EXPERT_DECODES = [("ternary", 64), ("ternary", 16), ("ternary", 32), ("int4", 64), ("int4", 16), ("nf4", 64),
                  ("nf4", 16), ("int8", 64), ("int8", 16), ("mx", 32)]
ROUTED = {  # routed experts of E, and the rows each routed expert fills (of C)
    "none": lambda e: [], "one": lambda e: [e - 1], "some": lambda e: list(range(1, e, 3)),
    "all": lambda e: list(range(e)),
}


def _routed_x(e, c, k, routed, gen, dev, partial=True):
    """A capacity buffer: random int8 rows for the routed experts (the
    first of them partly filled, as a tick's replicas leave them), zero
    rows elsewhere."""
    xq = torch.zeros((e, c, k), dtype=torch.int8, device=dev)
    for i, ex in enumerate(routed):
        rows = max(1, c // 2) if partial and i == 0 else c
        xq[ex, :rows] = torch.randint(-127, 128, (rows, k), generator=gen, device=dev, dtype=torch.int8)
    return xq


@pytest.mark.parametrize("fmt,group", EXPERT_DECODES)
@pytest.mark.parametrize("routed", list(ROUTED))
def test_expert_gemv_routed_subsets_bit_exact(dev, fmt, group, routed):
    """Routed sets of 0, 1, some and all of E experts, the first routed
    one's rows partly filled, C 3 and 8, K with a ragged last k-tile: the
    int32 bits equal the plain per-expert loop's, the skipped experts' out
    +0 (bits 0), one launch on the format's entry."""
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.quant.formats import get_format

    gen = torch.Generator(device=dev).manual_seed(group + len(routed))
    e, k, n = 6, 1280, 200
    g = 32 if fmt == "mx" else group
    qt = quantize_weights(torch.randn((e, k, n), generator=gen, device=dev) * k**-0.5, FMT_BITS[fmt], g, fmt=fmt)
    entry, decode = get_format(fmt).kernel, "int8" if fmt == "mx" else fmt
    for c in (3, 8):
        experts = ROUTED[routed](e)
        xq = _routed_x(e, c, k, experts, gen, dev)
        before = entry.launches
        got = entry(xq, qt.packed, qt.scale_m, group=qt.group_size)
        want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        skipped = [i for i in range(e) if i not in experts]
        assert not got[skipped].view(torch.int32).any()


@pytest.mark.parametrize("e,k,n,routed", [(8, 6144, 32768, 5), (8, 32768, 6144, 8), (128, 7168, 4864, 8)])
def test_expert_gemv_full_width_routed_bit_exact(dev, e, k, n, routed):
    """grok-1's gate and down and arctic's gate at their widths, C 8, with
    a decode tick's routed experts: bit for bit the plain loop."""
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.ternary_matmul import ternary_matmul

    gen = torch.Generator(device=dev).manual_seed(e + routed)
    packed = torch.randint(-2**31, 2**31 - 1, (e, k // 16, n), generator=gen, device=dev, dtype=torch.int32)
    scale_m = torch.randint(-127, 128, (e, k // 64, n), generator=gen, device=dev, dtype=torch.int8)
    experts = sorted(torch.randperm(e, generator=torch.Generator().manual_seed(e))[:routed].tolist())
    xq = _routed_x(e, 8, k, experts, gen, dev)
    got = ternary_matmul(xq, packed, scale_m, group=64)
    want = packed_qmm_ref(xq, packed, scale_m, decode="ternary", group=64)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(4, 4096), (256, 12288), (64, 6144), (64, 32768), (1024, 7168), (1024, 4864),
                                 (8, 49152), (3, 131072), (5, 64)])
def test_quantize_rows_one_read_bit_exact(dev, dtype, m, d):
    """The redesigned quantize_rows at the decode tick's, the prefill
    chunk's and the four capacity buffers' shapes, a row split over a
    cluster (64 x 32768 f32, 8 x 49152), the two-pass long rows (131072
    f32) and a short row; NaN, +-inf, zero and subnormal-max rows: the
    plain version's bytes and exponents."""
    from repro_torch.kernels.quantize import quantize_rows, quantize_rows_plain

    gen = torch.Generator(device=dev).manual_seed(m + d)
    x = _edge_x(m, d, gen, dev, torch.float32)
    if m > 6:
        x[5, 3], x[6, 2] = float("inf"), float("-inf")
        x[m // 2:] = 0.0  # the capacity buffer's empty rows
    x = x.to(dtype)
    q, e = quantize_rows(x)
    wq, we = quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, wq) and torch.equal(e, we)


# ---------------------------------------------------------------------------
# The VLM, SSM and hybrid families: flash_attend at head_dim 112 (zamba2's
# shared attention, G = 1) and at G = 8 (qwen2-vl's 64 over 8 kv heads);
# the new qdense shapes (qwen2-vl's K / N 29568, falcon-mamba's x_proj N 288
# and dt_proj K 256 with a bias, zamba2's bc_proj N 128).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("s", [1, 31, 256])
def test_flash_hd_112_matches_plain(dev, fmt, s):
    """zamba2's head_dim, one query head a kv head, global and a 300-token
    window, decode and chunks."""
    gen = torch.Generator(device=dev).manual_seed(112 + s)
    b, t, kh, g, hd = 2, 1024, 4, 1, 112
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    start = torch.tensor([[0], [t - s - 37]], dtype=torch.int32, device=dev)
    for window in (2**30, 300):
        win = torch.tensor([[window]], dtype=torch.int32, device=dev)
        args = (q, c["k"], c["v"], c.get("ke"), c.get("ve"), start, start + s, win)
        got = flash_attend(*args, fmt=fmt)
        want = flash_attend_ref(*args, fmt=fmt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
def test_flash_decode_g8_matches_plain(dev, fmt):
    """qwen2-vl's grouping: 8 query heads a kv head (the decode kernel's
    whole row group in registers) at hd 128, ragged fill levels."""
    gen = torch.Generator(device=dev).manual_seed(8)
    b, t, kh, g, hd = 4, 1024, 2, 8, 128
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, 1, kh, g, hd), generator=gen, device=dev)
    valid = torch.tensor([[1], [300], [777], [1024]], dtype=torch.int32, device=dev)
    win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
    args = (q, c["k"], c["v"], c.get("ke"), c.get("ve"), valid - 1, valid, win)
    got = flash_attend(*args, fmt=fmt)
    want = flash_attend_ref(*args, fmt=fmt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("m", [1, 4, 17])
@pytest.mark.parametrize("k,n,bias", [(29568, 1024, False), (1024, 29568, False), (8192, 288, False),
                                      (256, 8192, True), (3584, 128, False)])
def test_qdense_new_family_shapes_bit_exact(dev, m, k, n, bias):
    """Fused ternary at the new families' shapes (N of qwen2-vl's gate cut
    to 1024 columns where K is whole), with a bias where the site has one:
    0 ulps from the plain version."""
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * k**-0.5, 2, 64)
    x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(torch.bfloat16) if bias else None
    got = ternary_matmul_fused(x, qt.packed, qt.scale_m, qt.scale_e, group=64, bias=b)
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="ternary", group=64, bias=b)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# The enc-dec family (whisper-base): flash_attend at head_dim 64 (G = 1),
# qdense at its shapes (K 512 in one k-tile, up with its bias, down K 2048,
# the int8 lm_head at N 51968), and QAT's forward and backward on the card.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("s", [1, 31, 64])
def test_flash_hd_64_matches_plain(dev, fmt, s):
    """whisper's decoder self-attention: 8 heads of 64 over 8 kv heads, T
    448 (the decoder's position table), ragged fills; kv_mx rows of 32
    bytes."""
    gen = torch.Generator(device=dev).manual_seed(64 + s)
    b, t, kh, g, hd = 4, 448, 8, 1, 64
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    valid = torch.tensor([[s], [100], [447], [448]], dtype=torch.int32, device=dev)
    win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
    args = (q, c["k"], c["v"], c.get("ke"), c.get("ve"), valid - s, valid, win)
    got = flash_attend(*args, fmt=fmt)
    want = flash_attend_ref(*args, fmt=fmt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("m", [1, 4, 17, 1500])
@pytest.mark.parametrize("k,n,bias,fmt", [(512, 512, False, "ternary"), (512, 2048, True, "ternary"),
                                          (2048, 512, True, "ternary"), (512, 51968, False, "int8")])
def test_qdense_whisper_shapes_bit_exact(dev, m, k, n, bias, fmt):
    """whisper's projections (bias on up and down), the tile at the
    encoder's 1500 rows, the int8 lm_head at N 51968: 0 ulps."""
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    qt = quantize_weights(torch.randn((k, n), generator=gen, device=dev) * k**-0.5, 2 if fmt == "ternary" else 8, 64,
                          fmt=fmt)
    x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(torch.bfloat16) if bias else None
    entry = ternary_matmul_fused if fmt == "ternary" else int8_matmul_fused
    got = entry(x, qt.packed, qt.scale_m, qt.scale_e, group=64, bias=b)
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=fmt, group=64, bias=b)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_qat_straight_through_gradient_on_the_card(dev):
    """QAT's backward on the card: one ternary site, 8-bit activations; the
    master weight's gradient equals the gradient taken with respect to the
    fake-quantized weight, bit for bit; the fake-quantized weight equals
    the same function on the CPU."""
    from repro_torch.core import ste
    from repro_torch.quant.formats import fake_quantize_weights

    gen = torch.Generator(device=dev).manual_seed(7)
    w = (torch.randn((512, 256), generator=gen, device=dev) * 512**-0.5).requires_grad_(True)
    x = torch.randn((32, 512), generator=gen, device=dev)
    wq = ste.weights_ste(w, 2, 64)
    wq.retain_grad()
    loss = (ste.act_ste(x, 8) @ wq).square().mean()
    loss.backward()
    assert torch.equal(w.grad, wq.grad)
    cpu = fake_quantize_weights(w.detach().cpu(), 2, 64)
    assert torch.equal(wq.detach().cpu(), cpu)


def test_adamw_step_on_the_card_matches_the_cpu(dev):
    """One AdamW step with DFP-8 moments on the card against the same step on
    the CPU, from the same state: every mantissa and exponent of m and v
    equal (the update's fmas are emulated in float64 on both devices),
    the parameters within PARAM_TOL of tests/test_torch_optimizer.py."""
    from repro_torch.training import optimizer as opt
    from repro_torch.tree import tree_map

    gen = torch.Generator().manual_seed(3)

    def tree(scale):
        return {"blocks": [{"w": torch.randn(64, 96, generator=gen) * scale} for _ in range(2)],
                "embed": torch.randn(300, 96, generator=gen) * scale, "norm": torch.randn(96, generator=gen) * scale}

    params, grads = tree(1.0), [tree(1e-2) for _ in range(3)]
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=0, state_bits=8)

    def run(device):
        # copies: the step updates its params in place
        p = tree_map(lambda t: t.to(device, copy=True), params)
        s = opt.init_state(p, cfg)
        for g in grads:
            p, s, _ = opt.apply_updates(p, tree_map(lambda t: t.to(device), g), s, cfg)
        return p, s

    (pc, sc), (pg, sg) = run("cpu"), run(dev)
    for key in ("m", "v"):
        for name in ("embed", "norm"):
            for part in ("q", "e"):
                assert torch.equal(sg[key][name][part].cpu(), sc[key][name][part]), (key, name, part)
        for i in range(2):
            assert torch.equal(sg[key]["blocks"][i]["w"]["q"].cpu(), sc[key]["blocks"][i]["w"]["q"])
    for name in ("embed", "norm"):
        want = pc[name]
        assert bool(((pg[name].cpu() - want).abs() <= 2.0**-21 * (want.abs() + 1e-2)).all()), name


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-base", "falcon-mamba-7b", "zamba2-7b"])
def test_remat_step_matches_the_step_without_remat(dev, arch):
    """cfg.remat recomputes each block in the backward pass: the loss and
    every gradient equal the run without it, bit for bit, on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build_model, make_smoke_batch
    from repro_torch.tree import tree_leaves

    out = []
    for remat in (False, True):
        qc = dict(w_bits=8, group_size=4) if arch == "falcon-mamba-7b" else dict(w_bits=2, group_size=16)  # C15
        cfg = dataclasses.replace(configs.get_smoke(arch, configs.QuantConfig(mode="qat", **qc)), remat=remat)
        api = build_model(cfg, device=dev)
        params = api.init(torch.Generator(device=dev).manual_seed(0))
        api = api.compiled(params)
        leaves = [t for t in tree_leaves(params) if isinstance(t, torch.Tensor) and t.is_floating_point()]
        for t in leaves:
            t.requires_grad_(True)
        batch = make_smoke_batch(torch.Generator(device=dev).manual_seed(1), cfg, 2, 16)
        loss = api.train_loss(params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# grok-1-314b's sites at their published widths split over model = 2 and 4
# (models/spmd.py): a rank's launch on its columns, experts or kv heads is
# bit for bit the whole site's slice, and its plain version.
# ---------------------------------------------------------------------------
GROK_SHARDED_SITES = [  # (decode, K, N of the whole site, ranks): wq, wk / wv, the int8 lm_head, the router
    ("ternary", 6144, 6144, 4), ("ternary", 6144, 1024, 4), ("int8", 6144, 131072, 4), ("int8", 6144, 8, 2),
]


def _random_site(decode, k, n, gen, dev, lead=()):
    """Random packed words (or int8 codes), scale rows and an exponent."""
    if decode == "int8":
        packed = torch.randint(-127, 128, lead + (k, n), generator=gen, device=dev, dtype=torch.int8)
    else:
        packed = torch.randint(-2**31, 2**31 - 1, lead + (k // 16, n), generator=gen, device=dev, dtype=torch.int32)
    scale_m = torch.randint(-127, 128, lead + (k // 64, n), generator=gen, device=dev, dtype=torch.int8)
    scale_e = torch.full(lead, -9, dtype=torch.int32, device=dev)
    return packed, scale_m, scale_e


@pytest.mark.parametrize("decode,k,n,ranks", GROK_SHARDED_SITES)
@pytest.mark.parametrize("m", [1, 4, 17])
def test_grok_site_columns_equal_the_whole_site(dev, decode, k, n, ranks, m):
    gen = torch.Generator(device=dev).manual_seed(n + m)
    packed, scale_m, scale_e = _random_site(decode, k, n, gen, dev)
    x = _edge_x(m, k, gen, dev, torch.bfloat16)
    entry = ternary_matmul_fused if decode == "ternary" else int8_matmul_fused
    whole = entry(x, packed, scale_m, scale_e, group=64)
    for parts in (2, ranks):
        cols = n // parts
        for r in (0, parts - 1):
            p, s = packed[:, r * cols:(r + 1) * cols].contiguous(), scale_m[:, r * cols:(r + 1) * cols].contiguous()
            got = entry(x, p, s, scale_e, group=64)
            want = fused_qmm_ref(x, p, s, scale_e, decode=decode, group=64)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert torch.equal(got.view(torch.int32), whole[:, r * cols:(r + 1) * cols].contiguous().view(torch.int32))


@pytest.mark.parametrize("k,n", [(6144, 32768), (32768, 6144)])
def test_grok_experts_split_equal_the_whole_stack(dev, k, n):
    """E 8 split 4 and 2 a rank (gate / up, down), C 8 over every expert."""
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.ternary_matmul import ternary_matmul

    gen = torch.Generator(device=dev).manual_seed(k)
    packed, scale_m, _ = _random_site("ternary", k, n, gen, dev, (8,))
    xq = _routed_x(8, 8, k, list(range(8)), gen, dev)
    whole = ternary_matmul(xq, packed, scale_m, group=64)
    for el in (4, 2):
        for r in (0, 8 // el - 1):
            sl = slice(r * el, (r + 1) * el)
            got = ternary_matmul(xq[sl].contiguous(), packed[sl].contiguous(), scale_m[sl].contiguous(), group=64)
            want = packed_qmm_ref(xq[sl], packed[sl], scale_m[sl], decode="ternary", group=64)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert torch.equal(got.view(torch.int32), whole[sl].contiguous().view(torch.int32))


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("s", [1, 64])
def test_grok_kv_heads_split_equal_the_whole_call(dev, fmt, s):
    """48 q heads over 8 kv heads (G 6, hd 128) split 4 and 2 kv heads a
    rank: a decode planned for the whole call's pairs (``plan_pairs``) and
    a prefill chunk equal the whole call's heads bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(s + len(fmt))
    b, t, kh, g, hd = 4, 1024, 8, 6, 128
    c = _packed_cache(fmt, b, t, kh, hd, gen, dev)
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev)
    start = torch.tensor([[t - s - 5], [0], [300], [t - s]], dtype=torch.int32, device=dev)
    win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
    whole = flash_attend(q, c["k"], c["v"], c.get("ke"), c.get("ve"), start, start + s, win, fmt=fmt)
    for per in (4, 2):
        for r in (0, kh // per - 1):
            hs = slice(r * per, (r + 1) * per)
            part = {name: leaf[:, :, hs].contiguous() for name, leaf in c.items()}
            args = (q[:, :, hs].contiguous(), part["k"], part["v"], part.get("ke"), part.get("ve"), start, start + s,
                    win)
            got = flash_attend(*args, fmt=fmt, plan_pairs=b * kh)
            want = flash_attend_ref(*args, fmt=fmt)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
            assert torch.equal(got, whole[:, :, hs])
