"""Per-row dynamic DFP activation quantization: one CUDA kernel
(``csrc/quantize_rows.cu``), its plain PyTorch version and the wrapper.

Replaces the TPU kernel ``repro/kernels/quantize.py::quantize_rows``
(body ``_kernel``): x (M, D) -> int8 mantissas (M, D) and int32 exponents
(M, 1), e = ceil(log2(max|x| / qmax)) over the row (0 for a zero,
subnormal or NaN-holding row), mantissas rounded half to even and clipped.
It is the prologue of the unfused path (``quant/backends.py``) and shares
its device code with the fused kernel's prologue (``csrc/qmm_common.cuh``),
so both quantize a row to the same bytes.  The exponent is computed in
float32 as in the TPU kernel and cast as XLA casts (-inf -> int32 min):
that differs from the ``kernels/ref.quantize_rows_ref`` oracle only for
a row whose max / qmax is subnormal, as the two reference versions do.

What bounds it on the H100: the bytes, x read once and the mantissas
written once.  One block of 256 threads per row reads it with 16-byte
loads, reduces max|x| across the block and reads it again (from L1/L2) to
quantize; rows are independent, so M rows fill M blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import dfp
from repro_torch.kernels import _build
from repro_torch.kernels.fused_qmm import check_operands, quantize_prologue


def quantize_rows_plain(x: torch.Tensor, bits: int = 8):
    """Plain version of the kernel: (int8 (M, D), int32 (M, 1))."""
    xq, e = quantize_prologue(x, bits, None)
    return xq, dfp.f32_to_i32(e)


@functools.cache
def _lib():
    fn = _build.load("quantize_rows").quantize_rows_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@_build.counted
def quantize_rows(x: torch.Tensor, bits: int = 8):
    """x f32/bf16 (M, D) -> (int8 (M, D), int32 (M, 1)).  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, bits)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 2:
        raise TypeError(f"x must be float32 or bfloat16 (M, D), got {x.dtype} {tuple(x.shape)}")
    m, d = x.shape
    if d % (16 // x.element_size()):
        raise ValueError(f"D={d} does not split into 16-byte loads of {x.dtype}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits={bits} outside the int8 mantissa range")
    check_operands(x)
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    e = torch.empty((m, 1), dtype=torch.int32, device=x.device)
    if m:
        err = _lib()(int(x.dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(), e.data_ptr(), m, d, bits,
                     torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "quantize_rows")
        _build.count_launch(quantize_rows, x)
    return q, e
