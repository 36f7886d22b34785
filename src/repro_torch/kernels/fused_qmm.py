"""The fused quantized dense site: one CUDA kernel for a whole PTQ
projection (``csrc/fused_qmm.cu``), its plain PyTorch version, and the
wrapper that picks between them by the device of its input.

Replaces the TPU kernel ``repro/kernels/_common.py::fused_qmm_call``
(body ``_fused_kernel``, decodes ``decode2_tile`` and the int8 identity),
reached through ``ternary_matmul.py::ternary_matmul_fused`` and
``int8_matmul.py::int8_matmul_fused``.  It computes, for x (M, K):

  prologue : per-row DFP exponent over the FULL K row (or the plan's
             static exponent), x -> int8 mantissas (round half to even,
             clip to +-qmax, NaN -> 0; a row holding a NaN gets e = 0)
  matmul   : per cluster of ``group`` K-elements an exact int32 dot of
             int8 mantissas with decoded weights (ternary: 16 2-bit codes
             per word, ((c+1)&3)-1; int8: raw), times the cluster's int8
             scale mantissa -- one multiply per cluster
  epilogue : x 2**(scale_e + e), + bias, silu | gelu | relu

Float sums follow the reference's order: clusters in order within each
k-tile of ``block_k`` (512) elements, starting from 0, then tiles in order
starting from 0.  No product is contracted into an fma, so the kernel and
the plain version agree bit for bit.

What bounds it on the H100: at decode M is the slot count (4), so the
site is a GEMV over the weight stream -- 2 bits per ternary weight, one
byte per int8 weight, 3.35 TB/s.  The design reads each weight word once
from device memory with coalesced 32-bit loads, many in flight per lane
(ternary: a lane per output column, a whole 512-wide k-tile of words
loaded at once; int8: four columns per lane, transposed in registers for
``__dp4a``), reads x with 16-byte loads and keeps its quantized rows in
shared memory, and runs the whole K reduction inside one block so the
per-tile partial sums never leave the SM.  No tensor cores: at M <= 8 the matrix unit would idle
on the weight stream either way.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import dfp
from repro_torch.kernels import _build
from repro_torch.kernels.ref import cluster_dots

TERNARY_PER_WORD = 16
DECODES = ("ternary", "int8")
_ACTS = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
_ROWS_PER_BLOCK = 8  # rows per block; the kernel takes any M, no padded copy
_MAX_SMEM = 232_448 - 512  # a Hopper block's shared memory, less the kernel's static part


# ---------------------------------------------------------------------------
# Activations: the one table both the kernel epilogue and the plain path use
# (the formulas the reference's jax.nn functions lower to).
# ---------------------------------------------------------------------------
def _silu(y):
    return y * torch.sigmoid(y)


def _gelu(y):  # tanh approximation, jax.nn.gelu's default
    c = float(torch.tensor((2.0 / torch.pi) ** 0.5, dtype=torch.float32))
    cdf = 0.5 * (1.0 + torch.tanh(c * (y + 0.044715 * (y * y * y))))
    return y * cdf


ACTIVATIONS = {None: lambda y: y, "silu": _silu, "gelu": _gelu, "relu": torch.relu}


def activation_fn(name: Optional[str]):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; supported: {sorted(k for k in ACTIVATIONS if k)}"
        ) from None


def _decode(packed: torch.Tensor, decode: str, k: int) -> torch.Tensor:
    if decode == "int8":
        return packed
    lanes = [((((packed >> (2 * i)) & 3) + 1) & 3) - 1 for i in range(TERNARY_PER_WORD)]
    return torch.stack(lanes, dim=1).reshape(k, packed.shape[1]).to(torch.int8)


def _row_exponents(x: torch.Tensor, act_bits: int, act_exponent: Optional[int]) -> torch.Tensor:
    """(M, 1) float32 exponents, as the reference kernel keeps them."""
    m = x.shape[0]
    if act_exponent is not None:
        return torch.full((m, 1), float(act_exponent), dtype=torch.float32, device=x.device)
    max_abs = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    e = dfp.log2_ceil(max_abs, float(dfp.qmax(act_bits)))
    return torch.where(max_abs >= torch.finfo(torch.float32).tiny, e, torch.zeros_like(e))


def fused_qmm_ref(
    x, packed, scale_m, scale_e, *, decode: str, group: int, bias=None,
    act: Optional[str] = None, act_bits: int = 8,
    act_exponent: Optional[int] = None, block_k: int = 512,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, operation for operation."""
    xf = x.to(torch.float32)
    m, k = xf.shape
    bk = min(block_k, k)
    qmax = float(dfp.qmax(act_bits))
    e = _row_exponents(xf, act_bits, act_exponent)
    xq = torch.clamp(torch.round(xf * dfp.exp2i(-e)), -qmax, qmax)
    xq = torch.nan_to_num(xq, nan=0.0).to(torch.int8)
    part = cluster_dots(xq, _decode(packed, decode, k), group)  # (K/g, M, N)
    sm = scale_m.to(torch.float32)
    out = torch.zeros((m, part.shape[-1]), dtype=torch.float32, device=x.device)
    per_tile = bk // group
    for t in range(k // bk):
        acc = torch.zeros_like(out)
        for s in range(t * per_tile, (t + 1) * per_tile):
            acc = acc + part[s] * sm[s]
        out = out + acc
    y = out * dfp.exp2i(scale_e.to(torch.float32) + e)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return activation_fn(act)(y)


@functools.cache
def _lib():
    lib = _build.load("fused_qmm")
    fn = lib.fused_qmm_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(m: int, k: int, decode: str, group: int, block_k: int = 512) -> int:
    """Dynamic shared memory of one block: int8 rows, exponents, tile
    sums, the block's scale mantissas."""
    rows = min(m, _ROWS_PER_BLOCK)
    bn = 32 if decode == "ternary" else 128
    return rows * k + 4 * _ROWS_PER_BLOCK + (k // min(block_k, k)) * rows * bn * 4 + (k // group) * bn


def fused_qmm(
    x, packed, scale_m, scale_e, *, decode: str, group: int, bias=None,
    act: Optional[str] = None, act_bits: int = 8,
    act_exponent: Optional[int] = None, block_k: int = 512,
) -> torch.Tensor:
    """x f32/bf16 (M, K) -> f32 (M, N).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.  The launch counts
    live on the two entries (``ternary_matmul_fused``,
    ``int8_matmul_fused``), one per compiled decode."""
    if decode not in DECODES:
        raise ValueError(f"unknown decode {decode!r}; supported: {DECODES}")
    if act not in _ACTS:
        activation_fn(act)  # raises with the supported names
    if x.device.type == "cpu":
        return fused_qmm_ref(
            x, packed, scale_m, scale_e, decode=decode, group=group, bias=bias,
            act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
        )
    m, k = x.shape
    n = packed.shape[1]
    bk = min(block_k, k)
    wdtype, wrows = (torch.int32, k // TERNARY_PER_WORD) if decode == "ternary" else (torch.int8, k)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if packed.dtype != wdtype or packed.shape != (wrows, n):
        raise ValueError(f"{decode} weights must be {wdtype} {(wrows, n)}, got {packed.dtype} {tuple(packed.shape)}")
    if scale_m.dtype != torch.int8 or scale_m.shape != (k // group, n):
        raise ValueError(f"scale_m must be int8 {(k // group, n)}, got {scale_m.dtype} {tuple(scale_m.shape)}")
    if scale_e.dtype != torch.int32 or scale_e.numel() != 1:
        raise ValueError("scale_e must be one int32")
    if k % bk or bk % group or group % (16 if decode == "ternary" else 4) or n % 4:
        raise ValueError(f"unsupported tiling K={k} block_k={bk} group={group} N={n} for {decode}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        bias = bias.to(torch.float32).reshape(n)
    if not 1 <= act_bits <= 8:
        raise ValueError(f"act_bits={act_bits} outside the int8 mantissa range")
    smem = smem_bytes(m, k, decode, group, block_k)
    if smem > _MAX_SMEM:
        raise ValueError(f"K={k} needs {smem} bytes of shared memory per block (max {_MAX_SMEM})")
    tensors = (x, packed, scale_m, scale_e) + (() if bias is None else (bias,))
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("all operands must lie on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("all operands must be contiguous and 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _lib()(
        int(x.dtype == torch.bfloat16), int(decode == "ternary"),
        x.data_ptr(), packed.data_ptr(), scale_m.data_ptr(), scale_e.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        m, k, n, group, bk, _ACTS[act], act_bits,
        int(act_exponent is not None), 0 if act_exponent is None else int(act_exponent),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "fused_qmm")
    return out
