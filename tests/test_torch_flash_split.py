"""The split-bf16 arithmetic of the tensor-core flash kernels, emulated on
the CPU (the kernels themselves run only on the card).

``csrc/flash_attend.cu`` and ``csrc/flash_attention.cu`` multiply on the
bf16 tensor cores with float32 sums.  Cache tiles and bf16 inputs go in
exactly; ``q * hd**-0.5`` and the probabilities p go in as three bf16
terms each (hi + mid + lo), float32 k and v of ``flash_attention`` too,
so the float32 tolerances of the plain versions hold.  Here torch
emulates that arithmetic (bf16 rounding is ``.to(torch.bfloat16)``, round
to nearest even; each product of bf16 terms is exact in float32) and holds
it against ``flash_attend_ref`` and ``flash_attention_plain`` at their
tolerances, on the shapes of ``tests/test_torch_flash.py`` and the
reference's flash_attention tests.  Single-term bf16 operands err far
more, which is why the split is there.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_prefill import NEG_INF, dequant_tile, flash_attend_ref

KEY_TILE = 64  # the kernels' key tile


def split_bf16(x: torch.Tensor, n: int) -> list:
    """``n`` bf16 terms of float32 ``x`` (as float32 values), each the
    round-to-nearest of what the earlier ones left, as the kernels split."""
    terms, r = [], x
    for _ in range(n):
        t = r.to(torch.bfloat16).to(torch.float32)
        terms.append(t)
        r = r - t
    return terms


def split_dot(a, b, na: int, nb: int) -> torch.Tensor:
    """a @ b with a in ``na`` and b in ``nb`` bf16 terms, keeping the term
    products (i, j) with i + j < max(na, nb), summed in float32 as the
    kernels issue them."""
    at, bt = split_bf16(a, na), split_bf16(b, nb)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i in range(na):
        for j in range(nb):
            if i + j < max(na, nb):
                out = out + at[i] @ bt[j]
    return out


def _online(qf, kf, vf, live, *, nq, nk, np_, nv):
    """The kernels' tile loop: (rows, hd) float32 queries, (T, hd) keys and
    values, live (rows, T) -> (rows, hd) float32."""
    rows, hd = qf.shape[-2:]
    m = torch.full(qf.shape[:-1] + (1,), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape)
    for j0 in range(0, kf.shape[-2], KEY_TILE):
        kt, vt = kf[..., j0:j0 + KEY_TILE, :], vf[..., j0:j0 + KEY_TILE, :]
        sc = split_dot(qf, kt.transpose(-1, -2), nq, nk)
        sc = torch.where(live[..., j0:j0 + KEY_TILE], sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + split_dot(p, vt, np_, nv)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def emulate_flash_attend(q, k, v, ke, ve, q_start, valid, window, *, fmt, nq=3, np_=3):
    """flash_attend's kernel arithmetic on the CPU (B, S, Kh, G, hd)."""
    b, s, kh, g, hd = q.shape
    t = k.shape[1]
    kf = dequant_tile(k, ke, fmt, 0, t).permute(0, 2, 1, 3)  # (b, kh, t, hd)
    vf = dequant_tile(v, ve, fmt, 0, t).permute(0, 2, 1, 3)
    for c in (kf, vf):  # the tiles go into the tensor cores as bf16 unchanged
        assert torch.equal(c.to(torch.bfloat16).to(torch.float32), c)
    qf = (q.to(torch.float32) * hd**-0.5).permute(0, 2, 1, 3, 4).reshape(b, kh, s * g, hd)
    q_pos = (q_start.reshape(b, 1) + torch.arange(s).repeat_interleave(g)[None])[:, None, :, None]
    k_pos = torch.arange(t)
    live = (k_pos < valid.reshape(b, 1, 1, 1)) & (k_pos <= q_pos) & (q_pos - k_pos < window.reshape(()))
    out = _online(qf, kf, vf, live, nq=nq, nk=1, np_=np_, nv=1)
    return out.reshape(b, kh, s, g, hd).permute(0, 2, 1, 3, 4)


def emulate_flash_attention(q, k, v, *, causal, nq=3, np_=3):
    """flash_attention's kernel arithmetic: bf16 inputs are exact bf16
    operands; float32 k and v are split into three terms."""
    qf = q.to(torch.float32) * q.shape[-1] ** -0.5
    s, t = q.shape[1], k.shape[1]
    live = torch.ones((s, t), dtype=torch.bool)
    if causal:
        live = torch.arange(t)[None, :] <= torch.arange(s)[:, None]
    nkv = 3 if q.dtype == torch.float32 else 1
    return _online(qf, k.to(torch.float32), v.to(torch.float32), live, nq=nq, nk=nkv, np_=np_, nv=nkv)


def _bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of the larger magnitude, less a
    1e-6 absolute allowance (as chip_smoke.py holds the kernel)."""
    mag = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return float(((got.float() - want.float()).abs() - 1e-6).clamp(min=0).div(ulp).max())


def test_three_bf16_terms_hold_a_float32_exactly():
    rng = np.random.default_rng(0)
    x = rng.normal(size=200_000) * np.exp2(rng.integers(-60, 60, size=200_000))
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = split_bf16(x, 3)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert not torch.equal(hi, x)  # one or two terms would not do
    assert not torch.equal(hi.double() + mid.double(), x.double())


def test_two_bf16_terms_of_p_within_2_pow_minus_17():
    rng = np.random.default_rng(1)
    p = torch.exp(-torch.from_numpy(rng.uniform(0, 40, size=200_000).astype(np.float32)))
    p = torch.cat([p, torch.tensor([1.0, 0.5, 0.0])])
    hi, lo = split_bf16(p, 2)
    err = (p.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-17 * p.double()).all())
    assert float((err / p.double().clamp(min=1e-300)).max()) > 2.0**-25  # two terms are not exact
    hi, mid, lo = split_bf16(p, 3)  # the kernels take three
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())


def _cache(fmt, b, t, kh, hd, rng, valid):
    if fmt == "kv_bf16":
        k, v = (torch.from_numpy((rng.normal(size=(b, t, kh, hd)) * 2).astype(np.float32)).to(torch.bfloat16)
                for _ in range(2))
        return k, v, None, None
    if fmt == "kv_int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(b, t, kh, hd)).astype(np.int8)) for _ in range(2))
        ke, ve = (torch.from_numpy(rng.integers(-9, -4, size=(b, t, kh, 1)).astype(np.int8)) for _ in range(2))
        return k, v, ke, ve
    k, v = (torch.from_numpy(rng.integers(0, 256, size=(b, t, kh, hd // 2)).astype(np.uint8)) for _ in range(2))
    ke, ve = (rng.integers(-3, 1, size=(b, t // 32, kh, 1)).astype(np.int8) for _ in range(2))
    empty = np.arange(t // 32)[None, :, None, None] * 32 >= np.asarray(valid).reshape(b, 1, 1, 1)
    ke, ve = (torch.from_numpy(np.where(empty, np.int8(-127), e)) for e in (ke, ve))
    return k, v, ke, ve


def _attend_case(fmt, s, kh, g, window, starts, t=64, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    b = len(starts)
    q = torch.from_numpy(rng.normal(size=(b, s, kh, g, hd)).astype(np.float32))
    q_start = torch.tensor(starts, dtype=torch.int32).reshape(b, 1)
    valid = q_start + s
    win = torch.tensor([[2**30 if window is None else window]], dtype=torch.int32)
    k, v, ke, ve = _cache(fmt, b, t, kh, hd, rng, valid.flatten().tolist())
    return q, k, v, ke, ve, q_start, valid, win


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
@pytest.mark.parametrize("s", [1, 4, 13])
@pytest.mark.parametrize("kh,g", [(2, 2), (4, 1)], ids=["gqa", "mha"])
@pytest.mark.parametrize("window", [None, 8], ids=["global", "window"])
def test_split_flash_attend_within_5e_5_of_plain(fmt, s, kh, g, window):
    args = _attend_case(fmt, s, kh, g, window, [0, 19, 45], seed=s)
    want = flash_attend_ref(*args, fmt=fmt)
    got = emulate_flash_attend(*args, fmt=fmt)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("fmt", ["kv_bf16", "kv_int8", "kv_mx"])
def test_split_flash_attend_long_ragged_chunk(fmt):
    """A prime chunk length from a ragged start over several key tiles at
    head_dim 128, with a window, in every format."""
    args = _attend_case(fmt, 31, 2, 4, 40, [0, 77], t=192, hd=128, seed=5)
    torch.testing.assert_close(emulate_flash_attend(*args, fmt=fmt), flash_attend_ref(*args, fmt=fmt),
                               atol=5e-5, rtol=0)


ATTN_CASES = [(4, 64, 64, 32, 32, 32), (2, 128, 128, 64, 64, 32), (3, 64, 128, 32, 64, 64),
              (1, 256, 256, 16, 128, 128)]  # the reference's (bh, s, t, hd, bq, bk)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,t,hd,bq,bk", ATTN_CASES)
def test_split_flash_attention_f32_within_2e_5(causal, bh, s, t, hd, bq, bk):
    rng = np.random.default_rng(bh + s + t)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, n, hd)).astype(np.float32)) for n in (s, t, t))
    want = flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    got = emulate_flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,t,hd,bq,bk", ATTN_CASES)
def test_split_flash_attention_bf16_within_one_ulp(causal, bh, s, t, hd, bq, bk):
    rng = np.random.default_rng(bh + s + t + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, n, hd)).astype(np.float32)).to(torch.bfloat16)
               for n in (s, t, t))
    want = flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    got = emulate_flash_attention(q, k, v, causal=causal).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)
    assert _bf16_ulps(got, want) <= 1.0


def test_single_bf16_terms_err_ten_times_more():
    """One bf16 term for q and for p misses what the split keeps."""
    for fmt in ("kv_bf16", "kv_int8", "kv_mx"):
        args = _attend_case(fmt, 13, 2, 2, None, [0, 19, 45], seed=3)
        want = flash_attend_ref(*args, fmt=fmt)
        split = float((emulate_flash_attend(*args, fmt=fmt) - want).abs().max())
        single = float((emulate_flash_attend(*args, fmt=fmt, nq=1, np_=1) - want).abs().max())
        assert single >= 10 * max(split, 1e-7) and single > 5e-5, (fmt, split, single)
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 128, 64)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=True, block_q=64, block_k=32)
    split = float((emulate_flash_attention(q, k, v, causal=True) - want).abs().max())
    single = float((emulate_flash_attention(q, k, v, causal=True, nq=1, np_=1) - want).abs().max())
    assert single >= 10 * max(split, 1e-7), (split, single)
