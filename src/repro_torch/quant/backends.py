"""qdense / qmatmul backends (counterpart of ``repro/quant/backends.py``).

  * ``ref``  : the plain oracle -- activation quantization, exact integer
               cluster dots (``kernels/ref.qmatmul_ref``), then exponents,
               bias and activation as separate steps.
  * ``cuda`` : the fused strategy, the counterpart of ``pallas``: the whole
               site is one call of ``kernels/fused_qmm.fused_qmm``, which
               launches the CUDA kernel for a CUDA tensor and runs its
               plain version for a CPU tensor.
  * ``auto`` : ``cuda`` for a CUDA tensor, ``ref`` for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import dfp
from repro_torch.core.quantizer import QTensor
from repro_torch.kernels.fused_qmm import activation_fn
from repro_torch.kernels.int8_matmul import int8_matmul_fused
from repro_torch.kernels.ref import qmatmul_ref, quantize_rows_ref
from repro_torch.kernels.ternary_matmul import ternary_matmul_fused

BACKENDS = ("ref", "cuda")
_FUSED_ENTRIES = {"ternary": ternary_matmul_fused, "int8": int8_matmul_fused}


def resolve_backend(name: str, x: torch.Tensor) -> str:
    if name == "auto":
        return "cuda" if x.is_cuda else "ref"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; registered: {BACKENDS + ('auto',)}")
    return name


def quantize_activations(x: torch.Tensor, bits: int = 8, *, exponent=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFP-quantize activations -> (int8 mantissas, int32 exponent(s)):
    against a static exponent, or per-row dynamic exponents."""
    if exponent is not None:
        e = torch.tensor(int(exponent), dtype=torch.int32, device=x.device)
        return dfp.quantize(x, e, bits), e
    return quantize_rows_ref(x, bits)


def qmatmul(x: torch.Tensor, qt: QTensor, *, act_bits: int = 8, act_exponent=None) -> torch.Tensor:
    """x [..., K] (float) x QTensor (K, N) -> [..., N] f32 through the oracle."""
    lead = x.shape[:-1]
    xq, xe = quantize_activations(x.reshape(-1, x.shape[-1]), act_bits, exponent=act_exponent)
    return qmatmul_ref(xq, xe, qt).reshape(*lead, qt.n)


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    return activation_fn(act)(y)  # the same table as the kernel epilogue


def qdense(
    x: torch.Tensor, qt: QTensor, *, bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None, backend: str = "auto", act_bits: int = 8,
    act_exponent=None, fused: bool = True, block_k: int = 512,
) -> torch.Tensor:
    """One quantized dense site: x [..., K] -> f32 [..., N] with exponents,
    ``bias`` and ``act`` applied."""
    from repro_torch.quant.formats import format_of

    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    name = resolve_backend(backend, x)
    decode = format_of(qt).kernel_decode
    if name == "cuda" and fused and decode in _FUSED_ENTRIES:
        out = _FUSED_ENTRIES[decode](
            xm.contiguous(), qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size,
            bias=bias, act=act, act_bits=act_bits, act_exponent=act_exponent,
            block_k=block_k,
        )
    elif name == "cuda":
        raise ValueError(f"the cuda backend has no unfused path (format {qt.fmt!r}, fused={fused})")
    else:
        xq, xe = quantize_activations(xm, act_bits, exponent=act_exponent)
        out = qmatmul_ref(xq, xe, qt)
        if bias is not None:
            out = out + bias.to(torch.float32)
        out = apply_act(out, act)
    return out.reshape(*lead, qt.n)
