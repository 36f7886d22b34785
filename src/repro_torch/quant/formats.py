"""Weight-format registry (counterpart of ``repro/quant/formats.py``).

Only the two formats on the served path are registered: ``ternary``
(Algorithms 1 & 2, 16 codes per 32-bit word) and ``int8`` (raw int8
mantissas).  int4, nf4, mx and ttq come with later slices.  A format names
the decode mode of the fused kernel (``kernels/fused_qmm.py``) that
consumes its packed form.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import dfp, ternary
from repro_torch.core.quantizer import (
    QTensor,
    dequantize_scales,
    pack2,
    quantize_scales,
    unpack2,
)


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    name: str
    bits: int
    encode: Callable[[torch.Tensor], torch.Tensor]  # int8 codes (K, N) -> packed
    decode: Callable[[torch.Tensor, int], torch.Tensor]  # (packed, K) -> int8 codes
    weight_codes: Callable  # (w, group, filter, refit) -> (codes, scale_m, scale_e)
    kernel_decode: Optional[str] = None  # decode mode of the fused kernel


_FORMATS: Dict[str, QuantFormat] = {}
_BY_BITS: Dict[int, str] = {}


def register_format(name: str, *, bits: int, encode, decode, weight_codes,
                    kernel_decode: Optional[str] = None) -> QuantFormat:
    if name in _FORMATS:
        raise ValueError(f"format {name!r} already registered")
    fmt = QuantFormat(name, bits, encode, decode, weight_codes, kernel_decode)
    _FORMATS[name] = fmt
    _BY_BITS.setdefault(bits, name)
    return fmt


def get_format(name: str) -> QuantFormat:
    try:
        return _FORMATS[name]
    except KeyError:
        raise KeyError(
            f"unknown quant format {name!r}; registered: {sorted(_FORMATS)}"
        ) from None


def format_for_bits(bits: int) -> QuantFormat:
    try:
        return _FORMATS[_BY_BITS[bits]]
    except KeyError:
        raise ValueError(
            f"no quant format registered for bits={bits}; registered: {sorted(_FORMATS)}"
        ) from None


def format_of(qt: QTensor) -> QuantFormat:
    return get_format(qt.fmt) if qt.fmt else format_for_bits(qt.bits)


def _ternary_weight_codes(w, group_size, filter_size, refit_scale):
    codes, alpha = ternary.ternarize_matrix(w, group_size, filter_size, refit_scale)
    scale_m, scale_e = quantize_scales(alpha)
    return codes, scale_m, scale_e


def _dfp_weight_codes(bits: int):
    def weight_codes(w, group_size, filter_size, refit_scale):
        k, n = w.shape
        blocks = w.reshape(k // group_size, group_size, n)
        alpha = torch.amax(torch.abs(blocks), dim=1) / dfp.qmax(bits)
        scale_m, scale_e = quantize_scales(alpha)
        # mantissas against the *re-quantized* scales: (codes, table) agree
        scale = dequantize_scales(scale_m, scale_e)[:, None, :]
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(blocks / safe), -dfp.qmax(bits), dfp.qmax(bits))
        return q.to(torch.int8).reshape(k, n), scale_m, scale_e

    return weight_codes


register_format(
    "ternary", bits=2, encode=pack2, decode=unpack2,
    weight_codes=_ternary_weight_codes, kernel_decode="ternary",
)
register_format(
    "int8", bits=8, encode=lambda codes: codes, decode=lambda packed, k: packed,
    weight_codes=_dfp_weight_codes(8), kernel_decode="int8",
)


def quantize_weights(
    w: torch.Tensor, bits: int = 2, group_size: int = 64, filter_size: int = 1,
    refit_scale: bool = False, fmt: Optional[str] = None,
) -> QTensor:
    """Quantize a (K, N) projection with the paper's cluster scheme; the
    scale table is re-quantized to 8-bit DFP.  Stamped with the resolved
    format name, as in the reference."""
    k, n = w.shape
    f = get_format(fmt) if fmt else format_for_bits(bits)
    codes, scale_m, scale_e = f.weight_codes(
        w.to(torch.float32), group_size, filter_size, refit_scale
    )
    return QTensor(f.encode(codes), scale_m, scale_e, f.bits, group_size, (k, n), fmt=f.name)


def decode_codes(qt: QTensor) -> torch.Tensor:
    """Integer mantissas (K, N) int8 of a QTensor."""
    return format_of(qt).decode(qt.packed, qt.k)


def dequantize_weights(qt: QTensor) -> torch.Tensor:
    """f32 (K, N) reconstruction."""
    codes = decode_codes(qt).to(torch.float32)
    scale = dequantize_scales(qt.scale_m, qt.scale_e)
    c = codes.reshape(qt.n_groups, qt.group_size, qt.n)
    return (c * scale[:, None, :]).reshape(qt.k, qt.n)
