"""Weight-format registry (counterpart of ``repro/quant/formats.py``).

  * ``ternary`` (bits=2): Algorithms 1 & 2, 16 codes per 32-bit word.
  * ``int4``    (bits=4): per-cluster DFP mantissas in [-7, 7], 8 per word.
  * ``int8``    (bits=8): per-cluster DFP mantissas, raw int8 storage.
  * ``nf4``     (bits=4): NormalFloat table indices against a per-cluster
    absmax scale, 8 per word, decoded through ``NF4_LUT_I8``.
  * ``mx``      (bits=8): raw int8 mantissas under one power-of-two scale
    per 32-element block (``block_size`` pinned to 32).

nf4 and mx share their widths with int4 and int8; both are registered
after the built-ins, so ``format_for_bits`` (which only legacy empty-fmt
QTensors use) keeps 4 -> int4 and 8 -> int8.  ttq comes with training.
Each format names its two kernel entries: ``kernel`` (int8 activations ->
cluster sums, the unfused path) and ``fused_kernel`` (the whole site).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import dfp, ternary
from repro_torch.core.quantizer import (
    NF4_LUT_I8,
    QTensor,
    dequantize_scales,
    nf4_lut_decode,
    pack2,
    pack4,
    pack4u,
    quantize_scales,
    unpack2,
    unpack4,
    unpack4u,
)
from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_fused
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_fused
from repro_torch.kernels.mx_matmul import MX_BLOCK, mx_matmul, mx_matmul_fused
from repro_torch.kernels.nf4_matmul import nf4_matmul, nf4_matmul_fused
from repro_torch.kernels.ternary_matmul import ternary_matmul, ternary_matmul_fused


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    name: str
    bits: int
    encode: Callable[[torch.Tensor], torch.Tensor]  # int8 codes (K, N) -> packed
    decode: Callable[[torch.Tensor, int], torch.Tensor]  # (packed, K) -> int8 codes
    weight_codes: Callable  # (w, group, filter, refit) -> (codes, scale_m, scale_e)
    kernel: Callable  # (x_q, packed, scale_m, *, group) -> f32 cluster sums, no exponents
    fused_kernel: Callable  # (x, packed, scale_m, scale_e, *, group, ...) -> finished site
    block_size: Optional[int] = None  # a cluster length the format fixes (mx: 32)


_FORMATS: Dict[str, QuantFormat] = {}
_BY_BITS: Dict[int, str] = {}


def register_format(name: str, *, bits: int, encode, decode, weight_codes, kernel,
                    fused_kernel, block_size: Optional[int] = None) -> QuantFormat:
    if name in _FORMATS:
        raise ValueError(f"format {name!r} already registered")
    fmt = QuantFormat(name, bits, encode, decode, weight_codes, kernel, fused_kernel, block_size)
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


def format_names() -> Tuple[str, ...]:
    return tuple(sorted(_FORMATS))


def _ternary_weight_codes(w, group_size, filter_size, refit_scale):
    codes, alpha = ternary.ternarize_matrix(w, group_size, filter_size, refit_scale)
    scale_m, scale_e = quantize_scales(alpha)
    return codes, scale_m, scale_e


def _fit_to_scales(blocks, alpha):
    """Scale table from a per-cluster alpha, and the blocks over the
    *re-quantized* scales (so codes and table agree)."""
    scale_m, scale_e = quantize_scales(alpha)
    scale = dequantize_scales(scale_m, scale_e)[:, None, :]
    return blocks / torch.where(scale > 0, scale, torch.ones_like(scale)), scale_m, scale_e


def _dfp_weight_codes(bits: int):
    def weight_codes(w, group_size, filter_size, refit_scale):
        k, n = w.shape
        blocks = w.reshape(k // group_size, group_size, n)
        u, scale_m, scale_e = _fit_to_scales(blocks, torch.amax(torch.abs(blocks), dim=1) / dfp.qmax(bits))
        q = torch.clamp(torch.round(u), -dfp.qmax(bits), dfp.qmax(bits))
        return q.to(torch.int8).reshape(k, n), scale_m, scale_e

    return weight_codes


def _nf4_weight_codes(w, group_size, filter_size, refit_scale):
    """Nearest NF4 quantile against a per-cluster absmax / 127 scale (code
    15, table value 127, rebuilds the cluster max).  The nearest index is
    found among the 15 decision midpoints, left side on a tie, as the
    reference's ``jnp.searchsorted`` does.  ``filter_size`` / ``refit_scale``
    do not apply to a quantile table."""
    del filter_size, refit_scale
    k, n = w.shape
    blocks = w.reshape(k // group_size, group_size, n)
    u, scale_m, scale_e = _fit_to_scales(blocks, torch.amax(torch.abs(blocks), dim=1) / float(NF4_LUT_I8[-1]))
    lut = torch.tensor(NF4_LUT_I8, dtype=torch.float32, device=w.device)
    mids = (lut[:-1] + lut[1:]) / 2.0
    idx = torch.searchsorted(mids, u.reshape(-1).contiguous())
    return idx.to(torch.int8).reshape(k, n), scale_m, scale_e


_MX_SCALE_BITS = 6  # scale_m spans 2**0 .. 2**6


def _mx_weight_codes(w, group_size, filter_size, refit_scale):
    """int8 mantissas under one power-of-two exponent per 32-element block.

    Block b gets e_b = choose_exponent(absmax_b, 8).  The shared base is
    ``scale_e = max over live blocks of e_b - 6`` and each block stores
    ``scale_m = 2**(e_b - scale_e)`` clipped to [1, 64]: blocks more than
    6 octaves below the loudest clamp to the base.  A dead (all-zero)
    block does not enter the base; a subnormal maximum counts as zero, as
    in the reference's flush-to-zero arithmetic."""
    del filter_size, refit_scale
    assert group_size == MX_BLOCK, f"mx blocks are fixed at {MX_BLOCK} elements, got group_size={group_size}"
    k, n = w.shape
    blocks = w.reshape(k // MX_BLOCK, MX_BLOCK, n)
    max_abs = torch.amax(torch.abs(blocks), dim=1)
    e_b = dfp.choose_exponent(max_abs, bits=8)
    live = max_abs >= torch.finfo(torch.float32).tiny
    i32_min = torch.iinfo(torch.int32).min
    e_base = torch.amax(torch.where(live, e_b, torch.full_like(e_b, i32_min)))
    scale_e = (torch.where(live.any(), e_base, torch.zeros_like(e_base)) - _MX_SCALE_BITS).to(torch.int32)
    d = torch.clamp(e_b - scale_e, 0, _MX_SCALE_BITS)
    scale_m = (1 << d).to(torch.int8)  # exact powers of two
    q = torch.clamp(torch.round(blocks * dfp.exp2i(-(scale_e + d))[:, None, :]), -dfp.qmax(8), dfp.qmax(8))
    return q.to(torch.int8).reshape(k, n), scale_m, scale_e


register_format(
    "ternary", bits=2, encode=pack2, decode=unpack2, weight_codes=_ternary_weight_codes,
    kernel=ternary_matmul, fused_kernel=ternary_matmul_fused,
)
register_format(
    "int4", bits=4, encode=pack4, decode=unpack4, weight_codes=_dfp_weight_codes(4),
    kernel=int4_matmul, fused_kernel=int4_matmul_fused,
)
register_format(
    "int8", bits=8, encode=lambda codes: codes, decode=lambda packed, k: packed,
    weight_codes=_dfp_weight_codes(8), kernel=int8_matmul, fused_kernel=int8_matmul_fused,
)
register_format(
    "nf4", bits=4, encode=pack4u, decode=lambda packed, k: nf4_lut_decode(unpack4u(packed, k)),
    weight_codes=_nf4_weight_codes, kernel=nf4_matmul, fused_kernel=nf4_matmul_fused,
)
register_format(
    "mx", bits=8, encode=lambda codes: codes, decode=lambda packed, k: packed,
    weight_codes=_mx_weight_codes, kernel=mx_matmul, fused_kernel=mx_matmul_fused,
    block_size=MX_BLOCK,
)


def quantize_weights(
    w: torch.Tensor, bits: int = 2, group_size: int = 64, filter_size: int = 1,
    refit_scale: bool = False, fmt: Optional[str] = None,
) -> QTensor:
    """Quantize a (K, N) projection with the paper's cluster scheme; the
    scale table is re-quantized to 8-bit DFP.  A format with a fixed block
    (mx) overrides ``group_size``.  Stamped with the resolved format name,
    as in the reference.  An (E, K, N) expert stack quantizes each expert
    on its own (its own shared exponent), as the reference's vmap does,
    into one QTensor with a leading E axis."""
    if w.ndim == 3:
        qts = [quantize_weights(we, bits, group_size, filter_size, refit_scale, fmt) for we in w]
        return dataclasses.replace(qts[0], **{f: torch.stack([getattr(q, f) for q in qts])
                                              for f in ("packed", "scale_m", "scale_e")})
    k, n = w.shape
    f = get_format(fmt) if fmt else format_for_bits(bits)
    group_size = f.block_size or group_size
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
