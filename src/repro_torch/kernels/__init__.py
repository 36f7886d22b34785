"""Hand-written Hopper kernels and their plain PyTorch versions
(counterpart of ``repro/kernels``).  Sources live in ``repro_torch/csrc``;
``kernels/_build.py`` compiles them on first use.  The quantized matmul's
public entry points are ``repro_torch.quant.qmatmul`` / ``qdense``."""
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_attend
from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_fused
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_fused
from repro_torch.kernels.mx_matmul import mx_matmul, mx_matmul_fused
from repro_torch.kernels.nf4_matmul import nf4_matmul, nf4_matmul_fused
from repro_torch.kernels.quantize import quantize_rows
from repro_torch.kernels.ternary_matmul import ternary_matmul, ternary_matmul_fused

__all__ = [
    "flash_attend", "flash_attention", "flash_attention_ref", "flash_decode", "int4_matmul",
    "int4_matmul_fused", "int8_matmul", "int8_matmul_fused", "mx_matmul", "mx_matmul_fused", "nf4_matmul",
    "nf4_matmul_fused", "quantize_rows", "ternary_matmul", "ternary_matmul_fused",
]
