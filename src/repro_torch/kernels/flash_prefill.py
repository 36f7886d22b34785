"""Flash attention over the packed KV cache: one CUDA kernel
(``csrc/flash_attend.cu``, its tensor-core tile loop in
``csrc/flash_mma.cuh``), its plain PyTorch version, and the wrapper.

Replaces the TPU kernel ``repro/kernels/flash_prefill.py::flash_attend``
(body ``_kernel``, tile dequant ``_dequant_tile``).  A (B, S, Kh, G, hd)
query block attends to a packed (B, T, Kh, ...) cache with online softmax;
the G heads of a KV group ride as S*G rows; row s of batch b sits at
absolute position q_start[b] + s (contiguous rows), and key k is live iff

    k < valid[b],  k <= q_pos,  q_pos - k < window  (2**30 = global).

The cache stays packed in device memory and is dequantized per tile:

  * kv_bf16: bf16 rows, cast;
  * kv_int8: int8 rows times 2**e, one int8 exponent per (token, head);
  * kv_mx:   nibble pairs along head_dim (low nibble = even channel),
             sign-extended, times 2**e, one exponent per 32-token block.

Every dequantized value has at most 8 significant bits and is a normal
number, so it is exact in float32 and in bf16 alike.

What bounds it on the H100, and the design.  A prefill chunk (S > 1)
attends over ~S * T / 2 scores a head: 4 * hd operations per live (query,
key) pair against the bytes of q, the output and the live cache.  At
S = 256 over T = 1024 that is 2.7 GFLOP against ~10 MB: on the bf16
tensor cores (989 TFLOP/s) the two take about the same least time, ~0.003
ms, where float32 arithmetic (67 TFLOP/s) would take 0.04 ms.  Blocks of
64 rows (4 warps, 16 rows each) take fixed row tiles of the S*G rows (a
ragged last tile masks itself; the plain version keeps the reference's
``pick_q_block``), walk key tiles of 64 double-buffered in shared memory
by ``cp.async`` and dequantized to bf16 there, and multiply with
``mma.sync`` m16n8k16 (bf16 in, float32 sums): scores and the output
accumulator live in register fragments, the online softmax reduces across
the four lanes of a row with shuffles, and p goes from the score
fragments into the P.V fragments without touching shared memory.  The
float32 tolerance (5e-5) holds through split operands: q * hd**-0.5 goes
in as three bf16 terms, which hold it exactly, so Q.K^T differs from the
plain version only in the order of its sums; p goes in as three bf16
terms too (two would leave 2^-17 of p, which at the |v| of 8-16 that real
caches reach comes within a factor of two of the tolerance), and the
tensor cores' truncating sums are kept short (see ``csrc/flash_mma.cuh``).
``tests/test_torch_flash_split.py`` emulates this arithmetic on the CPU.
Tiles wholly past ``valid[b]``, after the block's (or the warp's) last
query or before its first query's window are skipped: they would add
exact zeros.

At decode (S == 1) a pair (batch row, kv head) has only G rows, too few for
a tensor-core tile, and the bound is the live cache bytes at 3.35 TB/s.
The key axis is split so that pairs x splits is about two blocks an SM
(``decode_split``), each split a multiple of 32 keys; each block reads its
rows straight into registers (HD / 8 lanes a row, 8 values a lane) on the
CUDA cores and writes its (max, sum, unnormalized P.V).  The last block of
a pair to finish (an arrival counter in device memory, which it resets)
combines the pair's partials in split order, in the same launch.  The
wrapper allocates the partials and keeps the zeroed counters; one decode
call is one CUDA launch.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional

import torch

from repro_torch.core import dfp
from repro_torch.kernels import _build
from repro_torch.models.kv_cache import MX_KV_BLOCK, unpack_i4

NEG_INF = -1e30
FORMATS = ("kv_bf16", "kv_int8", "kv_mx")
_FMT_IDS = {"kv_bf16": 0, "kv_int8": 1, "kv_mx": 2}
_MAX_SMEM = 232_448  # dynamic shared memory a block may have (227 KB)
_DECODE_MAX_SMEM = 48 * 1024  # the decode kernel runs without raising the cap
HEAD_DIMS = (16, 32, 64, 112, 128, 240)  # the kernel's instances (112: zamba2, 240: gemma3)
ROW_TILE = 64  # prefill rows a block: 4 warps of 16 (the mma M)
KEY_TILE = 64  # prefill keys a tile
_MAX_G = 8  # decode rows a block holds in registers at a time
_DECODE_MAX_KEYS = 512  # keys of one decode split, at most


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
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def prefill_smem_bytes(fmt: str, hd: int) -> int:
    """Dynamic shared memory of a prefill block (``Prefill::kSmem`` in the
    source): three bf16 Q planes of 64 rows, then for kv_bf16 two stages of
    K and V planes, for the packed formats one K and one V plane, two stages
    of packed K and V rows and their exponents.  Planes are rows of hd + 8
    bf16 (the pad keeps ldmatrix off bank conflicts)."""
    plane = 2 * (hd + 8)  # bytes of one plane row
    q = 3 * ROW_TILE * plane
    if fmt == "kv_bf16":
        return q + 2 * 2 * KEY_TILE * plane
    row = hd if fmt == "kv_int8" else hd // 2
    return q + 2 * KEY_TILE * plane + 2 * 2 * KEY_TILE * row + 2 * 2 * KEY_TILE


def decode_smem_bytes(hd: int, keys: int) -> int:
    """Dynamic shared memory of a decode block (``decode_smem``): float32
    scores of up to 8 rows, the 4 warps' partial P.V rows, (max, sum)."""
    return 4 * (_MAX_G * keys + 4 * _MAX_G * hd + 2 * _MAX_G)


def row_blocks(s: int, g: int) -> int:
    """Prefill blocks a (batch row, kv head): fixed tiles of 64 of the S*G
    rows, the last one ragged."""
    return -(-s * g // ROW_TILE)


def decode_split(pairs: int, t: int, sms: int = 132):
    """(splits, keys a split) of a decode call: pairs x splits about two
    blocks an SM, keys a multiple of 32 (whole kv_mx blocks), at most 512."""
    want = max(1, round(2 * sms / pairs))
    keys = -(-t // want)
    keys = min(max(MX_KV_BLOCK, -(-keys // MX_KV_BLOCK) * MX_KV_BLOCK), _DECODE_MAX_KEYS)
    return -(-t // keys), keys


def launch_plan(fmt: str, b: int, s: int, t: int, kh: int, g: int, hd: int, sms: int = 132,
                plan_pairs: Optional[int] = None) -> dict:
    """Grid, shared memory and decode partials (floats: one (m, l, P.V)
    row per split and query row) of one call, as the kernel sizes them.
    ``plan_pairs``: the (batch, kv head) pairs a decode's splits are
    planned for (default: this call's b * kh); a rank holding part of a
    sharded call's pairs plans as the whole call does, so each pair's keys
    split alike and its result is the whole call's bit for bit."""
    if s > 1:
        return dict(grid=(b * kh, row_blocks(s, g), 1), smem=prefill_smem_bytes(fmt, hd), splits=1, keys=KEY_TILE,
                    part_floats=0, smem_cap=_MAX_SMEM)
    splits, keys = decode_split(plan_pairs or b * kh, t, sms)
    return dict(grid=(b * kh, splits, 1), smem=decode_smem_bytes(hd, keys), splits=splits, keys=keys,
                part_floats=b * kh * splits * g * (hd + 2), smem_cap=_DECODE_MAX_SMEM)


def _mode(fmt: str, s: int) -> str:
    return f"{fmt}/{'decode' if s == 1 else 'prefill'}"


def _check_cache(fmt, k, v, ke, ve, b, t, kh, hd):
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for head_dim in {HEAD_DIMS}, got {hd}")
    if fmt == "kv_bf16":
        want = [("k", k, torch.bfloat16, (b, t, kh, hd)), ("v", v, torch.bfloat16, (b, t, kh, hd))]
    elif fmt == "kv_int8":
        want = [("k", k, torch.int8, (b, t, kh, hd)), ("v", v, torch.int8, (b, t, kh, hd)),
                ("ke", ke, torch.int8, (b, t, kh, 1)), ("ve", ve, torch.int8, (b, t, kh, 1))]
    else:  # rows of hd / 2 bytes, copied 16 bytes at a time, or 8 where they are not whole 16 (hd 112: 56, 240: 120)
        want = [("k", k, torch.uint8, (b, t, kh, hd // 2)), ("v", v, torch.uint8, (b, t, kh, hd // 2)),
                ("ke", ke, torch.int8, (b, t // MX_KV_BLOCK, kh, 1)),
                ("ve", ve, torch.int8, (b, t // MX_KV_BLOCK, kh, 1))]
    for name, c, dtype, shape in want:
        if c is None or c.dtype != dtype or tuple(c.shape) != shape:
            got = None if c is None else (c.dtype, tuple(c.shape))
            raise ValueError(f"{fmt} {name} must be {dtype} {shape}, got {got}")
    return [c for _, c, _, _ in want]


def flash_attend(q, k, v, ke, ve, q_start, valid, window, *, fmt: str,
                 block_q: int = 64, block_k: int = 128, plan_pairs: Optional[int] = None) -> torch.Tensor:
    """Returns (B, S, Kh, G, hd) float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.  ``plan_pairs``: see
    ``launch_plan``."""
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
    plan = launch_plan(fmt, b, s, t, kh, g, hd, _build.sm_count(q.device), plan_pairs)
    if plan["smem"] > plan["smem_cap"]:
        raise ValueError(f"{fmt} head_dim {hd} needs {plan['smem']} bytes of shared memory (max {plan['smem_cap']})")
    for c in [q, *cache, q_start, valid, window]:
        if not c.is_cuda or c.device != q.device:
            raise ValueError("all operands must lie on the same CUDA device")
        if not c.is_contiguous():
            raise ValueError("all operands must be contiguous")
    for c in (q, k, v):
        if c.data_ptr() % 16:
            raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty((b, s, kh, g, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = counters = None
    if s == 1:  # the splits' (m, l, P.V) rows and the pairs' arrival counters
        part = torch.empty(plan["part_floats"], dtype=torch.float32, device=q.device)
        counters = _build.arrival_counters(q.device, stream, b * kh)
    ptr = lambda c: 0 if c is None else c.data_ptr()  # noqa: E731
    err = _lib()(
        _FMT_IDS[fmt], q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ke), ptr(ve),
        q_start.data_ptr(), valid.data_ptr(), window.data_ptr(), ptr(part), ptr(counters),
        out.data_ptr(), b, s, t, kh, g, hd, plan["splits"], plan["keys"],
        float(torch.tensor(hd**-0.5, dtype=torch.float32)), plan["smem"], stream,
    )
    _build.check(err, "flash_attend")
    flash_attend.launches += 1
    flash_attend.mode_launches[_mode(fmt, s)] += 1
    return out


flash_attend.launches = 0
flash_attend.mode_launches = Counter()  # "<fmt>/decode" (S == 1) | "<fmt>/prefill" (S > 1)
