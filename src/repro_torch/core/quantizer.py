"""QTensor container, 2-bit packing and the scale-table re-quantization
(counterpart of ``repro/core/quantizer.py``).

Packed ternary words are int32 bit-views of the reference's uint32 words
(identical bytes): torch on the CPU cannot shift uint32, and ``>>`` on
int32 is arithmetic, so every right shift is masked.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import dfp

TERNARY_PER_WORD = 16  # 2-bit codes per 32-bit word


@dataclasses.dataclass
class QTensor:
    """Quantized 2-D weight (K, N) with per-(k-group, out) DFP scales.

    packed  : int32 (K/16, N) ternary words, or int8 (K, N) raw mantissas
    scale_m : int8 (K/group_size, N) cluster scale mantissas
    scale_e : int32 0-d tensor, the shared scale exponent
    """

    packed: torch.Tensor
    scale_m: torch.Tensor
    scale_e: torch.Tensor
    bits: int = 2
    group_size: int = 64
    shape: Tuple[int, int] = (0, 0)
    fmt: str = ""

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def n_groups(self) -> int:
        return self.shape[0] // self.group_size

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scale_m, self.scale_e))


def pack2(codes: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in {-1,0,1} -> (K/16, N) int32 (2-bit two's complement)."""
    k, n = codes.shape
    assert k % TERNARY_PER_WORD == 0, k
    c = (codes.to(torch.int32) & 3).reshape(k // TERNARY_PER_WORD, TERNARY_PER_WORD, n)
    word = torch.zeros((k // TERNARY_PER_WORD, n), dtype=torch.int32, device=codes.device)
    for i in range(TERNARY_PER_WORD):
        word |= c[:, i, :] << (2 * i)  # lane 15 lands in the sign bit
    return word


def unpack2(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack2 -> (K, N) int8; code c decodes to ((c+1)&3)-1."""
    lanes = []
    for i in range(TERNARY_PER_WORD):
        c = (packed >> (2 * i)) & 3  # mask: >> on int32 is arithmetic
        lanes.append((((c + 1) & 3) - 1).to(torch.int8))
    return torch.stack(lanes, dim=1).reshape(k, packed.shape[1])


def quantize_scales(alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 alpha table -> (int8 mantissa, shared int32 exponent)."""
    e = dfp.choose_exponent(torch.max(torch.abs(alpha)), bits=8)
    return dfp.quantize(alpha, e, bits=8), e


def dequantize_scales(scale_m: torch.Tensor, scale_e: torch.Tensor) -> torch.Tensor:
    return dfp.dequantize(scale_m, scale_e)
