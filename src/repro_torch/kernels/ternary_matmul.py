"""Ternary entries of the quantized dense kernels (counterpart of
``repro/kernels/ternary_matmul.py``): 16 2-bit codes per int32 word."""
from __future__ import annotations

from repro_torch.kernels._build import count_launch, counted
from repro_torch.kernels.fused_qmm import fused_qmm
from repro_torch.kernels.packed_qmm import packed_qmm


@counted
def ternary_matmul(x_q, packed, scale_m, *, group: int, block_k: int = 512):
    """int8 activations (M, K) x packed (K/16, N) -> f32 cluster sums,
    exponents left to the caller."""
    out = packed_qmm(x_q, packed, scale_m, decode="ternary", group=group, block_k=block_k)
    count_launch(ternary_matmul, x_q)
    return out


@counted
def ternary_matmul_fused(x, packed, scale_m, scale_e, *, group: int, bias=None, act=None,
                         act_bits: int = 8, act_exponent=None, block_k: int = 512):
    """Whole dense site: quantize prologue + 2-bit decode + int dot per
    cluster + exponent/bias/activation epilogue.  packed: int32 (K/16, N)."""
    out = fused_qmm(
        x, packed, scale_m, scale_e, decode="ternary", group=group, bias=bias,
        act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
    )
    count_launch(ternary_matmul_fused, x)
    return out
