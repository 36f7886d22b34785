"""Flash attention over the packed KV cache: one CUDA kernel
(``csrc/flash_attend.cu``), its plain PyTorch version, and the wrapper.

Replaces the TPU kernel ``repro/kernels/flash_prefill.py::flash_attend``
(body ``_kernel``, tile dequant ``_dequant_tile``).  A (B, S, Kh, G, hd)
query block attends to a packed (B, T, Kh, ...) cache with online softmax;
the G heads of a KV group ride as bq*G rows; row s of batch b sits at
absolute position q_start[b] + s (contiguous rows), and key k is live iff

    k < valid[b],  k <= q_pos,  q_pos - k < window  (2**30 = global).

The cache stays packed in device memory and is dequantized per tile:

  * kv_bf16: bf16 rows, cast;
  * kv_int8: int8 rows times 2**e, one int8 exponent per (token, head);
  * kv_mx:   nibble pairs along head_dim (low nibble = even channel),
             sign-extended, times 2**e, one exponent per 32-token block.

Every product q * 2**e is exact in float32, so dequantizing changes no bit.

What bounds it on the H100.  At decode (S == 1) each step reads the live
part of the layer's cache once against a few FLOPs per byte: the bound is
cache bytes at 3.35 TB/s.  There are only B * Kh (batch row, kv head)
pairs, too few blocks to keep the card busy, so the kernel splits the key
axis (flash decoding): one block per pair and run of ``_SPLIT_KEYS`` keys
writes its softmax (max, sum, unnormalized P.V) and a second launch
combines the runs.  For a prefill chunk (S > 1) there are B * Kh * S / bq
blocks already, and a split would need partial sums of B*Kh*S*T/tk rows
(~134 MB per layer call at S = 256, T = 1024), so each block loops over the
key tiles itself with a running (m, l, acc), as the TPU kernel does, and
writes the output directly.  Tiles wholly past ``valid[b]``, after the
block's last query or before its first query's window are skipped: they
would add exact zeros.  A chunk attends over ~S * T / 2 scores per head,
so its bound is float32 arithmetic (the kernel does not use tensor cores).
Sums run in another order than the reference's 128-key tiles, within the
reference's 5e-5.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from repro_torch.core import dfp
from repro_torch.kernels import _build
from repro_torch.models.kv_cache import MX_KV_BLOCK, unpack_i4

NEG_INF = -1e30
FORMATS = ("kv_bf16", "kv_int8", "kv_mx")
_FMT_IDS = {"kv_bf16": 0, "kv_int8": 1, "kv_mx": 2}
_MAX_SMEM = 232_448
_SPLIT_KEYS = 32  # keys per tile (a multiple of MX_KV_BLOCK)


def _check_fmt(fmt: str) -> None:
    if fmt not in FORMATS:
        raise NotImplementedError(f"kv format {fmt!r} has no flash kernel; supported: {FORMATS}")


def pick_kv_block(t: int, fmt: str, want: int = 128) -> int:
    """Largest divisor of T that is <= want; a 32-multiple for kv_mx."""
    _check_fmt(fmt)
    if fmt == "kv_mx":
        nb = t // MX_KV_BLOCK
        b = min(nb, max(1, want // MX_KV_BLOCK))
        while nb % b:
            b -= 1
        return b * MX_KV_BLOCK
    b = min(t, want)
    while t % b:
        b -= 1
    return b


def pick_q_block(s: int, g: int, want: int = 64) -> int:
    """Largest divisor of S keeping bq*G query rows near ``want``."""
    b = min(s, max(1, want // g))
    while s % b:
        b -= 1
    return b


def dequant_tile(c: torch.Tensor, e, fmt: str, j0: int, bk: int) -> torch.Tensor:
    """Keys [j0, j0 + bk) of a packed (B, T, Kh, .) leaf as float32 (B, bk, Kh, hd)."""
    tile = c[:, j0:j0 + bk]
    if fmt == "kv_bf16":
        return tile.to(torch.float32)
    if fmt == "kv_int8":
        return tile.to(torch.float32) * dfp.exp2i(e[:, j0:j0 + bk])
    eb = e[:, j0 // MX_KV_BLOCK:(j0 + bk) // MX_KV_BLOCK]  # (B, bk/32, Kh, 1)
    return unpack_i4(tile).to(torch.float32) * torch.repeat_interleave(dfp.exp2i(eb), MX_KV_BLOCK, dim=1)


def flash_attend_ref(q, k, v, ke, ve, q_start, valid, window, *, fmt: str,
                     block_q: int = 64, block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the reference's tiled online softmax."""
    b, s, kh, g, hd = q.shape
    t = k.shape[1]
    bk = pick_kv_block(t, fmt, block_k)
    rows = s * g
    qf = (q.to(torch.float32) * hd**-0.5).permute(0, 2, 1, 3, 4).reshape(b, kh, rows, hd)
    dev = q.device
    q_pos = (q_start.reshape(b, 1) + torch.arange(s, device=dev).repeat_interleave(g)[None])[:, None, :, None]
    vl = valid.reshape(b, 1, 1, 1)
    win = window.reshape(())
    m = torch.full((b, kh, rows, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, rows, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, t, bk):
        kf = dequant_tile(k, ke, fmt, j0, bk).permute(0, 2, 3, 1)  # (b, kh, hd, bk)
        vf = dequant_tile(v, ve, fmt, j0, bk).permute(0, 2, 1, 3)  # (b, kh, bk, hd)
        sc = qf @ kf
        k_pos = j0 + torch.arange(bk, device=dev)
        ok = (k_pos < vl) & (k_pos <= q_pos) & (q_pos - k_pos < win)
        sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vf
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, kh, s, g, hd).permute(0, 2, 1, 3, 4).contiguous()


@functools.cache
def _lib():
    fn = _build.load("flash_attend").flash_attend_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(rows: int, hd: int, tk: int) -> int:
    """Dynamic shared memory of one block: float32 queries, scores,
    accumulator, running (m, l, corr) and the dequantized K and V tiles
    (rows padded by one word)."""
    return 4 * (2 * rows * hd + rows * tk + 3 * rows + 2 * tk * (hd + 1))


def _mode(fmt: str, s: int) -> str:
    return f"{fmt}/{'decode' if s == 1 else 'prefill'}"


def _check_cache(fmt, k, v, ke, ve, b, t, kh, hd):
    if fmt == "kv_bf16":
        want = [("k", k, torch.bfloat16, (b, t, kh, hd)), ("v", v, torch.bfloat16, (b, t, kh, hd))]
        align = 8
    elif fmt == "kv_int8":
        want = [("k", k, torch.int8, (b, t, kh, hd)), ("v", v, torch.int8, (b, t, kh, hd)),
                ("ke", ke, torch.int8, (b, t, kh, 1)), ("ve", ve, torch.int8, (b, t, kh, 1))]
        align = 16
    else:
        want = [("k", k, torch.uint8, (b, t, kh, hd // 2)), ("v", v, torch.uint8, (b, t, kh, hd // 2)),
                ("ke", ke, torch.int8, (b, t // MX_KV_BLOCK, kh, 1)),
                ("ve", ve, torch.int8, (b, t // MX_KV_BLOCK, kh, 1))]
        align = 32
    if hd % align:
        raise ValueError(f"{fmt} needs head_dim % {align} == 0 for 16-byte cache-row loads, got {hd}")
    for name, c, dtype, shape in want:
        if c is None or c.dtype != dtype or tuple(c.shape) != shape:
            got = None if c is None else (c.dtype, tuple(c.shape))
            raise ValueError(f"{fmt} {name} must be {dtype} {shape}, got {got}")
    return [c for _, c, _, _ in want]


def flash_attend(q, k, v, ke, ve, q_start, valid, window, *, fmt: str,
                 block_q: int = 64, block_k: int = 128) -> torch.Tensor:
    """Returns (B, S, Kh, G, hd) float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check_fmt(fmt)
    if q.device.type == "cpu":
        return flash_attend_ref(q, k, v, ke, ve, q_start, valid, window, fmt=fmt,
                                block_q=block_q, block_k=block_k)
    b, s, kh, g, hd = q.shape
    t = k.shape[1]
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    cache = _check_cache(fmt, k, v, ke, ve, b, t, kh, hd)
    for name, c, n in (("q_start", q_start, b), ("valid", valid, b), ("window", window, 1)):
        if c.dtype != torch.int32 or c.numel() != n:
            raise ValueError(f"{name} must hold {n} int32")
    bq = pick_q_block(s, g, block_q)
    tk = pick_kv_block(t, fmt, _SPLIT_KEYS)
    rows = bq * g
    smem = smem_bytes(rows, hd, tk)
    if smem > _MAX_SMEM:
        raise ValueError(f"{rows} query rows need {smem} bytes of shared memory (max {_MAX_SMEM})")
    for c in [q, *cache, q_start, valid, window]:
        if not c.is_cuda or c.device != q.device:
            raise ValueError("all operands must lie on the same CUDA device")
        if not c.is_contiguous():
            raise ValueError("all operands must be contiguous")
    for c in (q, k, v):
        if c.data_ptr() % 16:
            raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty((b, s, kh, g, hd), dtype=torch.float32, device=q.device)
    splits = t // tk if s == 1 else 1  # split the keys over blocks at decode only
    part_ml = part_acc = None
    if splits > 1:
        runs = b * kh * (s // bq) * splits * rows  # one (m, l, P.V) per row and key run
        part_ml = torch.empty((runs, 2), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((runs, hd), dtype=torch.float32, device=q.device)
    ptr = lambda c: 0 if c is None else c.data_ptr()  # noqa: E731
    err = _lib()(
        _FMT_IDS[fmt], q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ke), ptr(ve),
        q_start.data_ptr(), valid.data_ptr(), window.data_ptr(), ptr(part_ml), ptr(part_acc),
        out.data_ptr(), b, s, t, kh, g, hd, bq, tk, splits,
        float(torch.tensor(hd**-0.5, dtype=torch.float32)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attend")
    flash_attend.launches += 1
    flash_attend.mode_launches[_mode(fmt, s)] += 1
    return out


flash_attend.launches = 0
flash_attend.mode_launches = Counter()  # "<fmt>/decode" (S == 1) | "<fmt>/prefill" (S > 1)
