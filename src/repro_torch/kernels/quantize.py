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
written once; at a decode tick's (4, 4096) the launch and one round trip
to device memory.  Each row is read from device memory once: its
16-byte loads (all issued before the reduction) stay in registers for the
quantize pass.  ``rows_plan`` splits a row over a thread block cluster of
``cs`` blocks where one block's registers do not hold it, or where few
long rows would leave SMs idle (a capacity buffer's (64, 32768) float32
rows: 4 blocks a row); the blocks exchange their max |x| through
distributed shared memory (a max is order-free).  Rows past 8 blocks of
registers (256 KB) take the two-pass row of the fused tile's pre-pass.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import dfp
from repro_torch.kernels import _build
from repro_torch.kernels.fused_qmm import check_operands, quantize_prologue


# csrc/quantize_rows.cu: threads a block, 16-byte loads a thread (at most),
# blocks a row (one portable cluster, at most).
ROWS_THREADS, ROWS_MAX_LOADS, ROWS_MAX_BLOCKS = 256, 8, 8


def rows_plan(m: int, d: int, itemsize: int, sms: int = 132) -> dict:
    """``cs`` blocks a row and ``nv`` 16-byte loads a thread: the fewest
    blocks whose registers hold the row, doubled while the rows give fewer
    blocks than SMs and each block would still hold 4 loads a thread; nv
    0 (the two-pass kernel, a block a row) past ROWS_MAX_BLOCKS."""
    vecs = d * itemsize // 16
    cap = ROWS_THREADS * ROWS_MAX_LOADS
    cs = 1
    while cs < ROWS_MAX_BLOCKS and -(-vecs // cs) > cap:
        cs *= 2
    if -(-vecs // cs) > cap:
        return dict(cs=1, nv=0)
    while cs < ROWS_MAX_BLOCKS and m * cs < sms and -(-vecs // (2 * cs)) >= 4 * ROWS_THREADS:
        cs *= 2
    return dict(cs=cs, nv=max(1, -(-(-(-vecs // cs)) // ROWS_THREADS)))


def quantize_rows_plain(x: torch.Tensor, bits: int = 8):
    """Plain version of the kernel: (int8 (M, D), int32 (M, 1))."""
    xq, e = quantize_prologue(x, bits, None)
    return xq, dfp.f32_to_i32(e)


@functools.cache
def _lib():
    fn = _build.load("quantize_rows").quantize_rows_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
        plan = rows_plan(m, d, x.element_size(), _build.sm_count(x.device))
        err = _lib()(int(x.dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(), e.data_ptr(), m, d, bits,
                     plan["cs"], plan["nv"], torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "quantize_rows")
        _build.count_launch(quantize_rows, x)
    return q, e
