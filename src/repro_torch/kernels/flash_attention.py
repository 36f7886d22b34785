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

What bounds it on the H100.  A call reads q, k, v and writes the output
once; its float32 work is 4 * hd multiply-adds per live (query, key) pair.
At the widths it is used at (hd 128, S = T = 1024) that is ~34 GFLOP for
128 (batch, head) rows under the causal mask against 67 MB of traffic, so
it is bound by float32 arithmetic (~0.5 ms), not by bytes.  The kernel is
the simple design: a block of 128 threads per 32 query rows, K and V tiles
widened to float32 in shared memory, scores and the accumulator in
registers (4 rows a thread), no tensor cores; causal key tiles past the
block's last row are skipped (exact, see the source).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
