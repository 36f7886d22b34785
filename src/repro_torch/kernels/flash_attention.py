"""Standalone causal flash attention: one CUDA kernel
(``csrc/flash_attention.cu``), its plain PyTorch version, the wrapper, and
the dense-softmax oracle.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(body ``_kernel``): queries (BH, S, hd) attend to keys and values (BH, T, hd),
float32 or bf16, with an online softmax over key tiles, so the S x T score
matrix never reaches device memory.  Scores are ``(q * hd**-0.5) . k`` in
float32 (the scale applied to q before the dot); under ``causal`` key k is
live for query s iff k <= s, both counted from 0 (top-left aligned when
S != T), and masked scores are -1e30, not -inf.  The output is
``acc / max(l, 1e-30)`` in q's dtype.

What bounds it on the H100, and the design.  A call reads q, k, v and
writes the output once; its work is 4 * hd operations per live (query,
key) pair.  At the widths it is used at (hd 128, S = T = 1024, 128
(batch, head) rows) that is 34 GFLOP under the causal mask against 134 MB
of bf16 traffic: 0.035 ms on the bf16 tensor cores, under the 0.040 ms the
bytes take, so the least time is the bytes'.  The kernel runs the tile
loop of ``csrc/flash_mma.cuh`` on the tensor cores (``mma.sync`` m16n8k16,
bf16 in, float32 sums): a block of 8 warps owns 128 query rows (16 a
warp), key tiles of 64 are double-buffered in shared memory by
``cp.async``, scores and the accumulator live in register fragments, and
p passes from the score fragments to the P.V fragments in registers.  The
tolerances of the plain version (2e-5 in float32; in bf16, one bf16 ulp
per element) hold through split operands: q * scale and p go in as three
bf16 terms each (hi + mid + lo hold a float32 exactly; two terms of p,
2^-17, left near-zero bf16 outputs 5 ulps off on the card), bf16 k and v
are exact, and the tensor cores' truncating sums are kept short (see
``csrc/flash_mma.cuh``).  Float32 inputs (the reference's test shapes)
split k and v into three terms too and take the term products down to
2^-16 of the leading one, with 4 warps and 32-key tiles (the split planes
take the room).  Causal key tiles past a warp's last row are skipped
(exact, see the source).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 240)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tile_shape(dtype, hd: int):
    """(warps, keys a tile) of a block: bf16 8 warps over 64-key tiles,
    float32 4 over 32; at hd 240 (gemma3) those do not fit a block's shared
    memory (317,440 and 313,344 bytes), so 4 warps over 64 (bf16) or 16
    (float32) keys."""
    f32 = dtype == torch.float32
    if hd == 240:
        return 4, 16 if f32 else 64
    return (4, 32) if f32 else (8, 64)


def smem_bytes(dtype, hd: int) -> int:
    """Dynamic shared memory of a block (``Cfg::kSmem`` in the source):
    three bf16 Q planes of 16 rows a warp, then bf16: two stages of K and V
    planes; float32: three K and three V planes and two float32 stages of K
    and V (``tile_shape``).  Planes are rows of hd + 8 bf16."""
    warps, bk = tile_shape(dtype, hd)
    plane = 2 * (hd + 8)
    if dtype == torch.float32:
        return 3 * 16 * warps * plane + 6 * bk * plane + 2 * 2 * bk * hd * 4
    return 3 * 16 * warps * plane + 2 * 2 * bk * plane


def _blocks(q, k, block_q: int, block_k: int):
    """The reference's tile sizes and its shape check (an ``assert`` there,
    so the same calls fail with the same ``AssertionError``)."""
    s, t = q.shape[1], k.shape[1]
    bq, bk = min(block_q, s), min(block_k, t)
    if s % bq or t % bk:
        raise AssertionError((s, t, bq, bk))
    return bq, bk


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the reference's tile loop over
    key tiles with a running (m, l, acc).  Query rows are independent, so
    every query tile runs at once; each row sees the reference's
    arithmetic."""
    bq, bk = _blocks(q, k, block_q, block_k)
    bh, s, hd = q.shape
    t = k.shape[1]
    dev = q.device
    qf = q.to(torch.float32) * hd**-0.5
    q_pos = torch.arange(s, device=dev)[:, None]
    m = torch.full((bh, s, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((bh, s, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, t, bk):
        kt = k[:, j0:j0 + bk].to(torch.float32)
        vt = v[:, j0:j0 + bk].to(torch.float32)
        sc = qf @ kt.transpose(1, 2)
        if causal:
            k_pos = j0 + torch.arange(bk, device=dev)[None, :]
            sc = torch.where(k_pos <= q_pos, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vt
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """Dense-softmax oracle, line for line the reference's (the scale is
    applied after the dot)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bsh,bth->bst", q.to(torch.float32), k.to(torch.float32))
    s = s * scale
    if causal:
        sq, t = s.shape[1], s.shape[2]
        mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,bth->bsh", p, v.to(torch.float32)).to(q.dtype)


@functools.cache
def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@_build.counted
def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q (BH, S, hd), k and v (BH, T, hd) -> (BH, S, hd) in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise
    (hd in ``HEAD_DIMS``, float32 or bf16).  ``block_q`` / ``block_k`` are
    the reference's tiles: they set which shapes are accepted, and the
    plain version's key tile; the kernel tiles by its own sizes."""
    _blocks(q, k, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    bh, s, hd = q.shape
    t = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, c in (("k", k), ("v", v)):
        if c.dtype != q.dtype or tuple(c.shape) != (bh, t, hd):
            raise ValueError(f"{name} must be {q.dtype} {(bh, t, hd)}, got {c.dtype} {tuple(c.shape)}")
    for c in (q, k, v):
        if not c.is_cuda or c.device != q.device:
            raise ValueError("q, k and v must lie on the same CUDA device")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("q, k and v must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    err = _lib()(_DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, t,
                 int(causal), float(torch.tensor(hd**-0.5, dtype=torch.float32)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out
