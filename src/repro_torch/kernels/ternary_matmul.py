"""Ternary entry of the fused dense kernel (counterpart of
``repro/kernels/ternary_matmul.py::ternary_matmul_fused``)."""
from __future__ import annotations

from collections import Counter

from repro_torch.kernels.fused_qmm import fused_qmm


def ternary_matmul_fused(x, packed, scale_m, scale_e, *, group: int, bias=None, act=None,
                         act_bits: int = 8, act_exponent=None, block_k: int = 512):
    """Whole dense site: quantize prologue + 2-bit decode + int dot per
    cluster + exponent/bias/activation epilogue.  packed: int32 (K/16, N)."""
    out = fused_qmm(
        x, packed, scale_m, scale_e, decode="ternary", group=group, bias=bias,
        act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
    )
    if x.is_cuda:  # fused_qmm launched the kernel (or raised)
        ternary_matmul_fused.launches += 1
        ternary_matmul_fused.mode_launches["m<=8" if x.shape[0] <= 8 else "m>8"] += 1
    return out


ternary_matmul_fused.launches = 0
ternary_matmul_fused.mode_launches = Counter()  # by rows: "m<=8" (one row block) | "m>8"
