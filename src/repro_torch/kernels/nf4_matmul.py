"""nf4 entries of the quantized dense kernels (counterpart of
``repro/kernels/nf4_matmul.py``): 8 unsigned 4-bit table indices per int32
word, each decoded to its ``NF4_LUT_I8`` int8 mantissa, after which the
matmul is every other format's."""
from __future__ import annotations

from repro_torch.kernels._build import count_launch, counted
from repro_torch.kernels.fused_qmm import fused_qmm
from repro_torch.kernels.packed_qmm import packed_qmm


@counted
def nf4_matmul(x_q, packed, scale_m, *, group: int, block_k: int = 512):
    """int8 activations (M, K) x packed table codes (K/8, N) -> f32
    cluster sums, exponents left to the caller."""
    out = packed_qmm(x_q, packed, scale_m, decode="nf4", group=group, block_k=block_k)
    count_launch(nf4_matmul, x_q)
    return out


@counted
def nf4_matmul_fused(x, packed, scale_m, scale_e, *, group: int, bias=None, act=None,
                     act_bits: int = 8, act_exponent=None, block_k: int = 512):
    """Whole dense site: quantize prologue + nf4 table decode + int dot per
    cluster + exponent/bias/activation epilogue.  packed: int32 (K/8, N)."""
    out = fused_qmm(
        x, packed, scale_m, scale_e, decode="nf4", group=group, bias=bias,
        act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
    )
    count_launch(nf4_matmul_fused, x)
    return out
