"""int8 entries of the quantized dense kernels (counterpart of
``repro/kernels/int8_matmul.py``): the identity decode, raw int8 weights
(the sites the paper's policy pins to 8 bits, and the mx format)."""
from __future__ import annotations

from repro_torch.kernels._build import count_launch, counted
from repro_torch.kernels.fused_qmm import fused_qmm
from repro_torch.kernels.packed_qmm import packed_qmm


@counted
def int8_matmul(x_q, w_q, scale_m, *, group: int, block_k: int = 512):
    """int8 activations (M, K) x raw int8 weights (K, N) -> f32 cluster
    sums, exponents left to the caller."""
    out = packed_qmm(x_q, w_q, scale_m, decode="int8", group=group, block_k=block_k)
    count_launch(int8_matmul, x_q)
    return out


@counted
def int8_matmul_fused(x, w_q, scale_m, scale_e, *, group: int, bias=None, act=None,
                      act_bits: int = 8, act_exponent=None, block_k: int = 512):
    """Whole dense site over raw int8 weights w_q (K, N)."""
    out = fused_qmm(
        x, w_q, scale_m, scale_e, decode="int8", group=group, bias=bias,
        act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
    )
    count_launch(int8_matmul_fused, x)
    return out
