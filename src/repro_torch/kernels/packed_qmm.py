"""The unfused quantized matmul: int8 activations (already quantized) x
packed weights -> f32 cluster sums, without exponents.  One CUDA kernel
(``csrc/packed_qmm.cu``), its plain PyTorch version and the wrapper.

Replaces the TPU kernel ``repro/kernels/_common.py::packed_qmm_call``
(body ``_packed_kernel``), reached through ``ternary_matmul``,
``int4_matmul``, ``int8_matmul``, ``nf4_matmul`` and ``mx_matmul`` (an
alias of ``int8_matmul``).  The caller applies ``2**(scale_e + x_e)``,
bias and activation (``quant/backends.py``), after ``quantize_rows``.

It is the fused kernel's matmul without its prologue and epilogue: the
same kernels (the GEMV of ``csrc/qmm_gemv.cuh`` at M <= 8 -- int8:
``csrc/qmm_gemv8.cuh`` --, the tensor-core tile of ``csrc/qmm_mma.cuh`` at
M > 8, one launch each), plans, decodes and float order
(clusters in order within each k-tile, then tiles in order), so
quantize_rows -> packed_qmm -> exponents -> bias -> activation equals the
fused site bit for bit.  Bound on the H100 as the fused site: the weight
stream at decode M, int8 operations at prefill M; it reads int8 rows (one
byte per element) instead of float.

MoE expert sites (``models/moe.py``): x_q (E, C, K) against an expert
site's stacked weights (E, K/w, N) and scales (E, K/g, N) -> (E, C, N) in
ONE launch of the same kernel, the expert a grid axis with per-expert base
pointers -- what the reference's ``jax.vmap`` over ``packed_qmm_call``
lowers to.  Each expert's sums are bit for bit a launch over that expert
alone.  The plans see the card as ``sms / E`` SMs an expert, so the E x
per-expert blocks fill it (a Python loop would be 24 launches a layer for
grok-1 and 384 for arctic, and the tile 48 blocks a launch at grok's down
projection where one launch has 8 x 48).  The plain version loops over
the experts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_qmm import (
    _GEMV_MODE, _MODE, _ptr, check_operands, check_weights, cluster_sums, gemv_args, gemv_plan, lut_words,
    rows_per_block, tile_plan, tile_scratch, uses_int8_loop, uses_tile,
)


def packed_qmm_ref(x_q, packed, scale_m, *, decode: str, group: int, block_k: int = 512) -> torch.Tensor:
    """The plain version: ``cluster_sums`` (the kernels' float order,
    operation for operation), an expert at a time for (E, C, K) x_q."""
    kw = dict(decode=decode, group=group, block_k=block_k)
    if x_q.ndim == 3:
        return torch.stack([cluster_sums(x, p, s, **kw) for x, p, s in zip(x_q, packed, scale_m)])
    return cluster_sums(x_q, packed, scale_m, **kw)


@functools.cache
def _lib():
    lib = _build.load("packed_qmm")
    fn = lib.packed_qmm_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_uint] * 4
                   + [ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    int8 = lib.packed_qmm_int8_launch
    int8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    int8.restype = ctypes.c_int
    tile = lib.packed_qmm_tile_launch
    tile.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_uint] * 4
                     + [ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p])
    tile.restype = ctypes.c_int
    return fn, int8, tile


def packed_qmm(x_q, packed, scale_m, *, decode: str, group: int, block_k: int = 512) -> torch.Tensor:
    """int8 (M, K) -> f32 (M, N), or an expert site's int8 (E, C, K) ->
    f32 (E, C, N) in one launch.  CPU tensors take the plain version; CUDA
    tensors launch the GEMV kernel (M <= 8) or the tensor-core tile (M >
    8), or raise.  The launch counts live on the format entries
    (``ternary_matmul``, ...)."""
    if x_q.device.type == "cpu":
        return packed_qmm_ref(x_q, packed, scale_m, decode=decode, group=group, block_k=block_k)
    if x_q.dtype != torch.int8 or x_q.ndim not in (2, 3):
        raise TypeError(f"x_q must be int8 (M, K) or (E, C, K), got {x_q.dtype} {tuple(x_q.shape)}")
    e = x_q.shape[0] if x_q.ndim == 3 else 1  # the experts on the grid: 1 for one site
    m, k = x_q.shape[-2:]
    if k % 16:
        raise ValueError(f"K={k} does not split into 16-byte rows")
    n = check_weights(m, k, packed, scale_m, decode=decode, group=group, block_k=block_k, lead=x_q.shape[:-2])
    check_operands(x_q, packed, scale_m)
    out = torch.empty(x_q.shape[:-1] + (n,), dtype=torch.float32, device=x_q.device)
    sms = -(-_build.sm_count(x_q.device) // e)  # the card's SMs an expert: E x the plan's blocks fill it
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    gemv, gemv8, tile = _lib()
    head = (x_q.data_ptr(), packed.data_ptr(), scale_m.data_ptr(), out.data_ptr())
    if uses_tile(m):
        plan = tile_plan(m, k, n, decode, group, block_k, sms)
        ws, counters = tile_scratch(x_q.device, plan, stream, e)
        err = tile(_MODE[decode], group, *head, _ptr(ws), _ptr(counters), m, k, n, min(block_k, k), plan["tps"],
                   plan["splits"], *lut_words(decode), plan["smem"], e, stream)
    elif uses_int8_loop(decode, n, _build.sm_count(x_q.device)):
        err = gemv8(*head, m, k, n, group, min(block_k, k), rows_per_block(m, k, decode, group, block_k), e, stream)
    else:
        plan = gemv_plan(m, k, n, decode, group, block_k, sms)
        err = gemv(_GEMV_MODE[decode], *head, m, k, n, group, min(block_k, k), *gemv_args(plan), *lut_words(decode),
                   plan["smem"], e, stream)
    _build.check(err, "packed_qmm")
    return out
