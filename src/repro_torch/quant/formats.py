"""Weight-format registry (counterpart of ``repro/quant/formats.py``).

  * ``ternary`` (bits=2): Algorithms 1 & 2, 16 codes per 32-bit word.
  * ``int4``    (bits=4): per-cluster DFP mantissas in [-7, 7], 8 per word.
  * ``int8``    (bits=8): per-cluster DFP mantissas, raw int8 storage.
  * ``nf4``     (bits=4): NormalFloat table indices against a per-cluster
    absmax scale, 8 per word, decoded through ``NF4_LUT_I8``.
  * ``mx``      (bits=8): raw int8 mantissas under one power-of-two scale
    per 32-element block (``block_size`` pinned to 32).

  * ``ttq``     (bits=2): Trained Ternary Quantization -- ternary codes
    from a per-cluster threshold, and TWO trained magnitudes per cluster
    (Wp, Wn), so its scale table is (2 * groups, N) and it brings its own
    ``dequantize`` and ``ref_matmul``.

nf4 and mx share their widths with int4 and int8; both are registered
after the built-ins, so ``format_for_bits`` (which only legacy empty-fmt
QTensors use) keeps 4 -> int4 and 8 -> int8.  Each format names its two
kernel entries: ``kernel`` (int8 activations -> cluster sums, the unfused
path) and ``fused_kernel`` (the whole site); ttq has neither, as in the
reference (no Pallas kernel there), so it runs on the plain ``ref``
backend.  Every ``weight_codes`` takes an optional ``scales=`` table (a
trained grid: TTQ's Wp / Wn, INQ's cluster scales), built into the scale
table instead of a fit from ``w``.
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
    weight_codes: Callable  # (w, group, filter, refit, scales=None) -> (codes, scale_m, scale_e)
    kernel: Optional[Callable]  # (x_q, packed, scale_m, *, group) -> f32 cluster sums, no exponents
    fused_kernel: Optional[Callable]  # (x, packed, scale_m, scale_e, *, group, ...) -> finished site
    block_size: Optional[int] = None  # a cluster length the format fixes (mx: 32)
    dequantize: Optional[Callable] = None  # (qt) -> f32 (K, N), where the scale table is not one per cluster
    ref_matmul: Optional[Callable] = None  # (x_q, x_e, qt) -> f32 (M, N), the oracle's override to match


_FORMATS: Dict[str, QuantFormat] = {}
_BY_BITS: Dict[int, str] = {}


def register_format(name: str, *, bits: int, encode, decode, weight_codes, kernel,
                    fused_kernel, block_size: Optional[int] = None, dequantize=None,
                    ref_matmul=None) -> QuantFormat:
    if name in _FORMATS:
        raise ValueError(f"format {name!r} already registered")
    fmt = QuantFormat(name, bits, encode, decode, weight_codes, kernel, fused_kernel, block_size, dequantize,
                      ref_matmul)
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


def _ternary_weight_codes(w, group_size, filter_size, refit_scale, scales=None):
    if scales is not None:  # a trained grid: codes snap to the given alpha, never a re-fit
        k, n = w.shape
        u, scale_m, scale_e = _fit_to_scales(w.reshape(k // group_size, group_size, n), scales)
        return torch.clamp(torch.round(u), -1, 1).to(torch.int8).reshape(k, n), scale_m, scale_e
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
    def weight_codes(w, group_size, filter_size, refit_scale, scales=None):
        k, n = w.shape
        blocks = w.reshape(k // group_size, group_size, n)
        alpha = torch.amax(torch.abs(blocks), dim=1) / dfp.qmax(bits) if scales is None else scales
        u, scale_m, scale_e = _fit_to_scales(blocks, alpha)
        q = torch.clamp(torch.round(u), -dfp.qmax(bits), dfp.qmax(bits))
        return q.to(torch.int8).reshape(k, n), scale_m, scale_e

    return weight_codes


def _nf4_weight_codes(w, group_size, filter_size, refit_scale, scales=None):
    """Nearest NF4 quantile against a per-cluster absmax / 127 scale (code
    15, table value 127, rebuilds the cluster max).  The nearest index is
    found among the 15 decision midpoints, left side on a tie, as the
    reference's ``jnp.searchsorted`` does.  ``filter_size`` / ``refit_scale``
    do not apply to a quantile table; ``scales`` replaces the absmax fit."""
    del filter_size, refit_scale
    k, n = w.shape
    blocks = w.reshape(k // group_size, group_size, n)
    alpha = torch.amax(torch.abs(blocks), dim=1) / float(NF4_LUT_I8[-1]) if scales is None else scales
    u, scale_m, scale_e = _fit_to_scales(blocks, alpha)
    lut = torch.tensor(NF4_LUT_I8, dtype=torch.float32, device=w.device)
    mids = (lut[:-1] + lut[1:]) / 2.0
    idx = torch.searchsorted(mids, u.reshape(-1).contiguous())
    return idx.to(torch.int8).reshape(k, n), scale_m, scale_e


_MX_SCALE_BITS = 6  # scale_m spans 2**0 .. 2**6


def _mx_weight_codes(w, group_size, filter_size, refit_scale, scales=None):
    """int8 mantissas under one power-of-two exponent per 32-element block.

    Block b gets e_b = choose_exponent(absmax_b, 8).  The shared base is
    ``scale_e = max over live blocks of e_b - 6`` and each block stores
    ``scale_m = 2**(e_b - scale_e)`` clipped to [1, 64]: blocks more than
    6 octaves below the loudest clamp to the base.  A dead (all-zero)
    block does not enter the base; a subnormal maximum counts as zero, as
    in the reference's flush-to-zero arithmetic.  Given ``scales`` (per
    block, exact powers of two by the format's construction), the block
    exponents are recovered from them instead of a fit."""
    del filter_size, refit_scale
    assert group_size == MX_BLOCK, f"mx blocks are fixed at {MX_BLOCK} elements, got group_size={group_size}"
    k, n = w.shape
    blocks = w.reshape(k // MX_BLOCK, MX_BLOCK, n)
    if scales is not None:
        max_abs = scales  # live iff its scale is
        tiny = torch.finfo(torch.float32).tiny
        e_b = torch.where(scales > 0, torch.round(torch.log(torch.clamp(scales, min=tiny)) / dfp._LN2_F32),
                          torch.zeros_like(scales)).to(torch.int32)
    else:
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


# ---------------------------------------------------------------------------
# ttq: Trained Ternary Quantization (arxiv 1612.01064).  Ternary codes from
# the per-cluster threshold Delta = t * max|w|; the positive and negative
# cluster magnitudes (Wp, Wn) are trained parameters (``quant/state.py``,
# ``core/ste.ttq_ste``).  scale_m is (2 * groups, N): Wp mantissas, then Wn
# mantissas, one shared exponent.
# ---------------------------------------------------------------------------
TTQ_THRESHOLD = 0.05  # Delta = t * max|w| per cluster (the paper's t)


def ttq_partition(w: torch.Tensor, group_size: int, threshold: float = TTQ_THRESHOLD) -> torch.Tensor:
    """Sign partition into codes {-1, 0, +1}, shared by the QAT forward
    and deployment so they can never disagree."""
    k, n = w.shape
    blocks = w.reshape(k // group_size, group_size, n)
    delta = threshold * torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    c = torch.where(blocks > delta, 1, torch.where(blocks < -delta, -1, 0))
    return c.to(torch.int8).reshape(k, n)


def _ttq_weight_codes(w, group_size, filter_size, refit_scale, scales=None):
    """``scales``: the trained (2, groups, N) or (2 * groups, N) Wp / Wn
    table; without one both magnitudes start from the Algorithm-1 alpha."""
    k, n = w.shape
    g = k // group_size
    if scales is None:
        _, alpha = ternary.ternarize_matrix(w, group_size, filter_size, refit_scale)
        wpn = torch.cat([alpha, alpha], dim=0)
    else:
        wpn = torch.abs(scales.reshape(2 * g, n))
    scale_m, scale_e = quantize_scales(wpn)
    return ttq_partition(w, group_size), scale_m, scale_e


def _ttq_dequantize(qt: QTensor) -> torch.Tensor:
    codes = unpack2(qt.packed, qt.k).to(torch.float32)
    g = qt.n_groups
    sc = dequantize_scales(qt.scale_m, qt.scale_e)  # (2g, N)
    wp, wn = sc[:g][:, None, :], sc[g:][:, None, :]
    c = codes.reshape(g, qt.group_size, qt.n)
    return torch.where(c > 0, c * wp, c * wn).reshape(qt.k, qt.n)


def _ttq_ref_matmul(x_q: torch.Tensor, x_e, qt: QTensor) -> torch.Tensor:
    """Integer oracle: two ternary accumulations a cluster (the positive and
    the negative codes), one mantissa multiply each, shared exponents."""
    from repro_torch.kernels.ref import cluster_dots  # lazy: import cycle

    m = x_q.shape[0]
    codes = unpack2(qt.packed, qt.k)
    part_p = cluster_dots(x_q, torch.clamp(codes, min=0), qt.group_size)  # (G, M, N)
    part_n = cluster_dots(x_q, torch.clamp(codes, max=0), qt.group_size)
    ng = qt.n_groups
    smp = qt.scale_m[:ng].to(torch.float32)[:, None, :]
    smn = qt.scale_m[ng:].to(torch.float32)[:, None, :]
    out = (part_p * smp + part_n * smn).sum(dim=0)
    scale = dfp.exp2i(qt.scale_e.to(torch.int32) + torch.as_tensor(x_e, device=x_q.device).to(torch.int32))
    return out * (scale.expand(m, 1) if scale.ndim else scale)


register_format(
    "ttq", bits=2, encode=pack2, decode=unpack2, weight_codes=_ttq_weight_codes,
    kernel=None, fused_kernel=None, dequantize=_ttq_dequantize, ref_matmul=_ttq_ref_matmul,
)


def quantize_weights(
    w: torch.Tensor, bits: int = 2, group_size: int = 64, filter_size: int = 1,
    refit_scale: bool = False, fmt: Optional[str] = None, scales: Optional[torch.Tensor] = None,
) -> QTensor:
    """Quantize a (K, N) projection with the paper's cluster scheme; the
    scale table is re-quantized to 8-bit DFP.  A format with a fixed block
    (mx) overrides ``group_size``.  Stamped with the resolved format name,
    as in the reference.  ``scales`` (a trained f32 cluster-scale table)
    replaces the fit from ``w``.  An (E, K, N) expert stack quantizes each
    expert on its own (its own shared exponent), as the reference's vmap
    does, into one QTensor with a leading E axis."""
    if w.ndim == 3:
        qts = [quantize_weights(we, bits, group_size, filter_size, refit_scale, fmt,
                                None if scales is None else scales[i]) for i, we in enumerate(w)]
        return dataclasses.replace(qts[0], **{f: torch.stack([getattr(q, f) for q in qts])
                                              for f in ("packed", "scale_m", "scale_e")})
    k, n = w.shape
    f = get_format(fmt) if fmt else format_for_bits(bits)
    group_size = f.block_size or group_size
    codes, scale_m, scale_e = f.weight_codes(w.to(torch.float32), group_size, filter_size, refit_scale,
                                             scales=None if scales is None else scales.to(torch.float32))
    return QTensor(f.encode(codes), scale_m, scale_e, f.bits, group_size, (k, n), fmt=f.name)


def decode_codes(qt: QTensor) -> torch.Tensor:
    """Integer mantissas (K, N) int8 of a QTensor."""
    return format_of(qt).decode(qt.packed, qt.k)


def dequantize_weights(qt: QTensor) -> torch.Tensor:
    """f32 (K, N) reconstruction."""
    f = format_of(qt)
    if f.dequantize is not None:  # a scale table that is not one per cluster (ttq: Wp / Wn)
        return f.dequantize(qt)
    codes = decode_codes(qt).to(torch.float32)
    scale = dequantize_scales(qt.scale_m, qt.scale_e)
    c = codes.reshape(qt.n_groups, qt.group_size, qt.n)
    return (c * scale[:, None, :]).reshape(qt.k, qt.n)


def fake_quantize_weights(w: torch.Tensor, bits: int, group_size: int, filter_size: int = 1,
                          refit_scale: bool = False, fmt: Optional[str] = None) -> torch.Tensor:
    """quantize -> dequantize (the QAT forward, error measurement), on the
    grid of the named format, as deployment would quantize it."""
    return dequantize_weights(quantize_weights(w, bits, group_size, filter_size, refit_scale, fmt=fmt))


def weight_quantization_error(w: torch.Tensor, bits: int, group_size: int, filter_size: int = 1) -> torch.Tensor:
    wq = fake_quantize_weights(w, bits, group_size, filter_size)
    return torch.sum((w - wq) ** 2)
