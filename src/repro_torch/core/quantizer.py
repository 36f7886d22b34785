"""QTensor container, 2- and 4-bit packing, the nf4 table and the
scale-table re-quantization (counterpart of ``repro/core/quantizer.py``).

Packed words are int32 bit-views of the reference's uint32 words
(identical bytes): torch on the CPU cannot shift uint32, and ``>>`` on
int32 is arithmetic, so every right shift is masked.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import dfp

TERNARY_PER_WORD = 16  # 2-bit codes per 32-bit word
INT4_PER_WORD = 8  # 4-bit two's-complement mantissas per 32-bit word
NF4_PER_WORD = 8  # 4-bit nf4 table indices per 32-bit word, packed like int4

# NormalFloat-4 (QLoRA): the 16 quantiles of a standard normal normalized to
# [-1, 1], stored on the int8 DFP grid (round(v * 127)), so an nf4 weight
# decodes to ordinary int8 mantissas under the per-cluster scale table.
NF4_LUT_I8 = (
    -127, -88, -67, -50, -36, -23, -12, 0,
    10, 20, 31, 43, 56, 71, 92, 127,
)


@dataclasses.dataclass
class QTensor:
    """Quantized 2-D weight (K, N) with per-(k-group, out) DFP scales.

    packed  : int32 (K/16, N) ternary words, int32 (K/8, N) int4 or nf4
              words, or int8 (K, N) raw mantissas (int8, mx)
    scale_m : int8 (K/group_size, N) cluster scale mantissas
    scale_e : int32 0-d tensor, the shared scale exponent

    An MoE expert site is one QTensor with a leading expert axis E on every
    field -- packed (E, K/16, N), scale_m (E, K/g, N), scale_e (E,) -- each
    expert quantized on its own, as the reference's vmapped quantizer does.
    ``shape``, ``k`` and ``n`` stay those of one expert.
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

    @property
    def experts(self) -> int:
        """E of an expert site (a leading axis on every field), else 0."""
        return self.scale_e.shape[0] if self.scale_e.ndim else 0

    def expert(self, i: int) -> "QTensor":
        """Expert ``i`` of an expert site, as a 2-D QTensor (views)."""
        return dataclasses.replace(self, packed=self.packed[i], scale_m=self.scale_m[i], scale_e=self.scale_e[i])

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


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    k, n = codes.shape
    assert k % INT4_PER_WORD == 0, k
    c = (codes.to(torch.int32) & 0xF).reshape(k // INT4_PER_WORD, INT4_PER_WORD, n)
    word = torch.zeros((k // INT4_PER_WORD, n), dtype=torch.int32, device=codes.device)
    for i in range(INT4_PER_WORD):
        word |= c[:, i, :] << (4 * i)  # lane 7 lands in the sign nibble
    return word


def _nibbles(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(K/8, N) words -> (K, N) int32 fields in [0, 15]."""
    lanes = [(packed >> (4 * i)) & 0xF for i in range(INT4_PER_WORD)]  # mask: >> is arithmetic
    return torch.stack(lanes, dim=1).reshape(k, packed.shape[1])


def pack4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in the symmetric range [-7, 7] -> (K/8, N) int32 words
    of 4-bit two's-complement fields (the reference asserts the range)."""
    assert int(torch.max(torch.abs(q.to(torch.int32)))) <= dfp.qmax(4), (
        "pack4 expects symmetric int4 mantissas in [-7, 7]"
    )
    return _pack_nibbles(q)


def unpack4(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack4 -> (K, N) int8; a field c >= 8 decodes to c - 16."""
    c = _nibbles(packed, k)
    return torch.where(c >= 8, c - 16, c).to(torch.int8)


def pack4u(codes: torch.Tensor) -> torch.Tensor:
    """(K, N) unsigned 4-bit codes in [0, 15] (nf4 table indices) -> (K/8, N)
    int32 words."""
    lo, hi = int(torch.min(codes)), int(torch.max(codes))
    assert 0 <= lo and hi <= 15, f"pack4u expects unsigned 4-bit codes in [0, 15], got [{lo}, {hi}]"
    return _pack_nibbles(codes)


def unpack4u(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack4u -> (K, N) int8 codes in [0, 15]."""
    return _nibbles(packed, k).to(torch.int8)


def nf4_lut_decode(codes: torch.Tensor) -> torch.Tensor:
    """Table indices [0, 15] -> int8 mantissas on the NF4_LUT_I8 grid."""
    lut = torch.tensor(NF4_LUT_I8, dtype=torch.int8, device=codes.device)
    return lut[codes.to(torch.int64)]


def quantize_scales(alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 alpha table -> (int8 mantissa, shared int32 exponent)."""
    e = dfp.choose_exponent(torch.max(torch.abs(alpha)), bits=8)
    return dfp.quantize(alpha, e, bits=8), e


def dequantize_scales(scale_m: torch.Tensor, scale_e: torch.Tensor) -> torch.Tensor:
    return dfp.dequantize(scale_m, scale_e)
