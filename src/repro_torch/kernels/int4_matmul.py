"""int4 entries of the quantized dense kernels (counterpart of
``repro/kernels/int4_matmul.py``): 8 two's-complement 4-bit mantissas per
int32 word, field c >= 8 decoding to c - 16 (the encoder keeps [-7, 7])."""
from __future__ import annotations

from repro_torch.kernels._build import count_launch, counted
from repro_torch.kernels.fused_qmm import fused_qmm
from repro_torch.kernels.packed_qmm import packed_qmm


@counted
def int4_matmul(x_q, packed, scale_m, *, group: int, block_k: int = 512):
    """int8 activations (M, K) x packed (K/8, N) -> f32 cluster sums,
    exponents left to the caller."""
    out = packed_qmm(x_q, packed, scale_m, decode="int4", group=group, block_k=block_k)
    count_launch(int4_matmul, x_q)
    return out


@counted
def int4_matmul_fused(x, packed, scale_m, scale_e, *, group: int, bias=None, act=None,
                      act_bits: int = 8, act_exponent=None, block_k: int = 512):
    """Whole dense site: quantize prologue + 4-bit decode + int dot per
    cluster + exponent/bias/activation epilogue.  packed: int32 (K/8, N)."""
    out = fused_qmm(
        x, packed, scale_m, scale_e, decode="int4", group=group, bias=bias,
        act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
    )
    count_launch(int4_matmul_fused, x)
    return out
