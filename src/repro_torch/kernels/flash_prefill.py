"""Flash attention over the packed KV cache: one CUDA kernel
(``csrc/flash_attend.cu``), its plain PyTorch version, and the wrapper.

Replaces the TPU kernel ``repro/kernels/flash_prefill.py::flash_attend``
(body ``_kernel``, tile dequant ``_dequant_tile``).  A (B, S, Kh, G, hd)
query block attends to a (B, T, Kh, hd) cache with online softmax; the G
heads of a KV group ride as bq*G rows; row s of batch b sits at absolute
position q_start[b] + s (contiguous rows), and key k is live iff

    k < valid[b],  k <= q_pos,  q_pos - k < window  (2**30 = global).

Only the kv_bf16 cache is ported; kv_int8 and kv_mx raise
NotImplementedError (their dequant comes with a later slice).

What bounds it on the H100: at decode (S == 1) each step reads the live
part of the layer's cache once -- 2 * B * valid * Kh * hd bf16 values --
against a few FLOPs per byte, so the bound is cache bytes at 3.35 TB/s.
At decode there are only B * Kh (batch row, kv head) pairs, too few blocks
to keep the card busy, so the kernel splits the key axis (flash decoding):
one block per pair and run of ``_SPLIT_KEYS`` keys loads its K and V rows
into shared memory with 16-byte loads all in flight together and writes
its softmax (max, sum, unnormalized P.V); a second launch combines the
runs.  Blocks wholly past ``valid[b]`` read nothing.  The combine sums in
another order than the reference's sequential tiles, within the same 5e-5.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_MAX_SMEM = 232_448
_SPLIT_KEYS = 32  # keys per block of the split kernel


def pick_kv_block(t: int, fmt: str, want: int = 128) -> int:
    """Largest divisor of T that is <= want."""
    if fmt != "kv_bf16":
        raise NotImplementedError(f"kv format {fmt!r} is not ported yet")
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


def flash_attend_ref(q, k, v, ke, ve, q_start, valid, window, *, fmt: str,
                     block_q: int = 64, block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the same tiled online softmax."""
    if fmt != "kv_bf16":
        raise NotImplementedError(f"kv format {fmt!r} is not ported yet")
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
        kf = k[:, j0:j0 + bk].to(torch.float32).permute(0, 2, 3, 1)  # (b, kh, hd, bk)
        vf = v[:, j0:j0 + bk].to(torch.float32).permute(0, 2, 1, 3)  # (b, kh, bk, hd)
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
    fn = _build.load("flash_attend").flash_attend_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(rows: int, hd: int, tk: int) -> int:
    """Dynamic shared memory of one split block: q and scores in float32,
    the padded bf16 K and V rows."""
    return 4 * (rows * hd + rows * tk) + 2 * 2 * tk * (hd + 2)


def flash_attend(q, k, v, ke, ve, q_start, valid, window, *, fmt: str,
                 block_q: int = 64, block_k: int = 128) -> torch.Tensor:
    """Returns (B, S, Kh, G, hd) float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if fmt != "kv_bf16":
        raise NotImplementedError(f"kv format {fmt!r} is not ported yet (kv_bf16 only)")
    if q.device.type == "cpu":
        return flash_attend_ref(q, k, v, ke, ve, q_start, valid, window, fmt=fmt,
                                block_q=block_q, block_k=block_k)
    b, s, kh, g, hd = q.shape
    t = k.shape[1]
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    for name, c in (("k", k), ("v", v)):
        if c.dtype != torch.bfloat16 or c.shape != (b, t, kh, hd):
            raise ValueError(f"{name} must be bfloat16 {(b, t, kh, hd)}, got {c.dtype} {tuple(c.shape)}")
    for name, c, n in (("q_start", q_start, b), ("valid", valid, b), ("window", window, 1)):
        if c.dtype != torch.int32 or c.numel() != n:
            raise ValueError(f"{name} must hold {n} int32")
    if hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 (16-byte cache rows)")
    bq = pick_q_block(s, g, block_q)
    tk = pick_kv_block(t, fmt, min(block_k, _SPLIT_KEYS))
    rows = bq * g
    smem = smem_bytes(rows, hd, tk)
    if smem > _MAX_SMEM:
        raise ValueError(f"{rows} query rows need {smem} bytes of shared memory (max {_MAX_SMEM})")
    for c in (q, k, v, q_start, valid, window):
        if not c.is_cuda or c.device != q.device:
            raise ValueError("all operands must lie on the same CUDA device")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("all operands must be contiguous and 16-byte aligned")
    out = torch.empty((b, s, kh, g, hd), dtype=torch.float32, device=q.device)
    runs = b * kh * (s // bq) * (t // tk) * rows  # one (m, l, P.V) per row and key run
    part_ml = torch.empty((runs, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((runs, hd), dtype=torch.float32, device=q.device)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_start.data_ptr(), valid.data_ptr(),
        window.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        b, s, t, kh, g, hd, bq, tk,
        float(torch.tensor(hd**-0.5, dtype=torch.float32)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attend")
    flash_attend.launches += 1
    return out


flash_attend.launches = 0
