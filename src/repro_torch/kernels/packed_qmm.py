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
one call -- what the reference's ``jax.vmap`` over ``packed_qmm_call``
lowers to; each expert's sums are bit for bit a launch over that expert
alone.  C > 8: the tile, the expert a grid axis, planned for ``sms / E``
SMs an expert.  C <= 8 (every decode): ``csrc/qmm_gemv_experts.cuh``.  What
bounds it is the packed weights of the experts a tick routes to; the
static capacity buffer is zero in every other expert's rows, and an
all-zero expert's sums are exactly +0 (``fma(1.5 * 2^23 + 0, sm, -1.5 *
2^23 * sm)`` and ``cluster_sums`` alike).  So a scan of x's rows on the
card finds the routed experts (no host synchronisation), and ONE
persistent grid sized to the card (``expert_plan``) gives each warp whole
strips of 32 columns x the whole K of routed experts, in order, its
weights, x and scales streamed through a per-warp cp.async ring, and
writes the skipped experts' out as +0.  The plain version loops over the
experts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_qmm import (
    _GEMV_MODE, _MODE, GEMV_BLOCKS_PER_SM, GEMV_STRIP, GEMV_WARPS, _ptr, check_operands, check_weights,
    cluster_sums, gemv_args, gemv_plan, gemv_step, lut_words, rows_per_block, tile_plan, tile_scratch,
    uses_int8_loop, uses_tile,
)

# The expert-batched GEMV (csrc/qmm_gemv_experts.cuh): the experts a site
# may have (its list in shared memory), slices of an expert's rows the
# scan ORs (at most), 16-byte vectors a slice reads (at least).
EXPERT_MAX = 256
EXPERT_MAX_SLICES, EXPERT_SLICE_VECS = 32, 256


def expert_x_bytes(decode: str, group: int) -> int:
    """x bytes a lane copies a step: its B registers (sk / 4), or for
    ternary and int4 at 16-k steps the 8 raw bytes of its perm8 half."""
    sk = gemv_step(decode, group)[0]
    return 8 if sk == 16 and decode in ("ternary", "int4") else sk // 4


def expert_plan(e: int, m: int, k: int, decode: str, group: int, sms: int = 132) -> dict:
    """The expert-batched GEMV's launch: ``grid`` persistent blocks
    (GEMV_BLOCKS_PER_SM an SM: the whole card, whatever E and however
    many experts are routed), ``smem`` (each warp's ring of weight bytes,
    x bytes and scale words; the kernel refuses another size), and the
    scan's ``slices`` of each expert's M * K bytes (about two blocks an SM
    in all, at least EXPERT_SLICE_VECS 16-byte loads a slice)."""
    _, ring, lane = gemv_step(decode, group)
    vecs = m * k // 16
    slices = max(1, min(EXPERT_MAX_SLICES, -(-2 * sms // e), vecs // EXPERT_SLICE_VECS))
    return dict(grid=sms * GEMV_BLOCKS_PER_SM, slices=slices,
                smem=GEMV_WARPS * ring * 32 * (lane + expert_x_bytes(decode, group) + 4))


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
                   + [ctypes.c_size_t, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    int8 = lib.packed_qmm_int8_launch
    int8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    int8.restype = ctypes.c_int
    tile = lib.packed_qmm_tile_launch
    tile.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_uint] * 4
                     + [ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p])
    tile.restype = ctypes.c_int
    experts = lib.packed_qmm_experts_launch
    experts.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_uint] * 4
                        + [ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p])
    experts.restype = ctypes.c_int
    return fn, int8, tile, experts


def packed_qmm(x_q, packed, scale_m, *, decode: str, group: int, block_k: int = 512) -> torch.Tensor:
    """int8 (M, K) -> f32 (M, N), or an expert site's int8 (E, C, K) ->
    f32 (E, C, N) in one call.  CPU tensors take the plain version; CUDA
    tensors launch the GEMV kernel (M <= 8; an expert site: the scan of its
    rows and the expert GEMV, two launches on the stream) or the
    tensor-core tile (M > 8), or raise.  The launch counts live on the
    format entries (``ternary_matmul``, ...), one a call."""
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
    sms = _build.sm_count(x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    gemv, gemv8, tile, experts = _lib()
    head = (x_q.data_ptr(), packed.data_ptr(), scale_m.data_ptr(), out.data_ptr())
    if uses_tile(m):
        plan = tile_plan(m, k, n, decode, group, block_k, -(-sms // e))  # E x the plan's blocks fill the card
        ws, counters = tile_scratch(x_q.device, plan, stream, e)
        err = tile(_MODE[decode], group, *head, _ptr(ws), _ptr(counters), m, k, n, min(block_k, k), plan["tps"],
                   plan["splits"], *lut_words(decode), plan["smem"], e, stream)
    elif x_q.ndim == 3:
        if e > EXPERT_MAX:
            raise ValueError(f"an expert site takes at most {EXPERT_MAX} experts, got {e}")
        plan = expert_plan(e, m, k, decode, group, sms)
        flags = torch.empty(e * plan["slices"], dtype=torch.int32, device=x_q.device)
        err = experts(_GEMV_MODE[decode], x_q.data_ptr(), packed.data_ptr(), scale_m.data_ptr(), flags.data_ptr(),
                      out.data_ptr(), e, plan["slices"], m, k, n, group, min(block_k, k), *lut_words(decode),
                      plan["grid"], plan["smem"], stream)
    elif uses_int8_loop(decode, n, sms):
        err = gemv8(*head, m, k, n, group, min(block_k, k), rows_per_block(m, k, decode, group, block_k), stream)
    else:
        plan = gemv_plan(m, k, n, decode, group, block_k, sms)
        err = gemv(_GEMV_MODE[decode], *head, m, k, n, group, min(block_k, k), *gemv_args(plan), *lut_words(decode),
                   plan["smem"], stream)
    _build.check(err, "packed_qmm")
    return out
