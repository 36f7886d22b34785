"""int8 entry of the fused dense kernel (counterpart of
``repro/kernels/int8_matmul.py::int8_matmul_fused``): the identity decode,
raw int8 weights (the sites the paper's policy pins to 8 bits)."""
from __future__ import annotations

from collections import Counter

from repro_torch.kernels.fused_qmm import fused_qmm


def int8_matmul_fused(x, w_q, scale_m, scale_e, *, group: int, bias=None, act=None,
                      act_bits: int = 8, act_exponent=None, block_k: int = 512):
    """Whole dense site over raw int8 weights w_q (K, N)."""
    out = fused_qmm(
        x, w_q, scale_m, scale_e, decode="int8", group=group, bias=bias,
        act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
    )
    if x.is_cuda:  # fused_qmm launched the kernel (or raised)
        int8_matmul_fused.launches += 1
        int8_matmul_fused.mode_launches["m<=8" if x.shape[0] <= 8 else "m>8"] += 1
    return out


int8_matmul_fused.launches = 0
int8_matmul_fused.mode_launches = Counter()  # by rows: "m<=8" (one row block) | "m>8"
