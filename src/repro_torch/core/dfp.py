"""Dynamic Fixed Point (DFP) representation (counterpart of
``repro/core/dfp.py``):  x ~= q * 2**e  with int8 mantissas
q in [-(2**(b-1)-1), 2**(b-1)-1] and one shared int32 exponent.

Bit-level conventions kept from the reference:

  * ``exp2i`` builds 2**e from the f32 exponent field, never ``exp2``.
  * ``choose_exponent`` is ``ceil(log(m / qmax) / log(2))`` in float32,
    the formula ``jnp.log2`` lowers to, so the port rounds the way the
    reference does wherever the two libraries' ``log`` agree.  Subnormal
    maxima count as 0 and a subnormal quotient m / qmax as 0 (e = -inf,
    the int32 minimum), as the reference's flush-to-zero CPU arithmetic
    has it.
  * ``quantize`` rounds half to even (``torch.round``, like ``jnp.round``)
    and maps NaN to mantissa 0 explicitly: a NaN cast to int8 is undefined
    in torch, and the reference's cast gives 0.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_F32_TINY = torch.finfo(torch.float32).tiny
_LN2_F32 = float(torch.tensor(math.log(2.0), dtype=torch.float32))
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def exp2i(e) -> torch.Tensor:
    """Exact ``2.0**e`` for integer-valued exponents (int or float tensor),
    clamped to the normal-f32 exponent range [-126, 127]."""
    ei = torch.clamp(torch.as_tensor(e), -126, 127).to(torch.int32)
    return ((ei + 127) << 23).view(torch.float32)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating float -> int32 cast (XLA's convert semantics: NaN -> 0,
    out-of-range values clamp), defined for every input unlike ``.to``."""
    x = torch.nan_to_num(x.to(torch.float32), nan=0.0)
    out = torch.clamp(x, -(2.0**31), 2.0**31 - 128).to(torch.int32)
    return torch.where(x >= 2.0**31, torch.full_like(out, _I32_MAX), out)


def choose_exponent(max_abs, bits: int) -> torch.Tensor:
    """Smallest power-of-two exponent e with max_abs <= qmax(bits) * 2**e,
    computed as the reference computes it.  max_abs == 0 (subnormal, NaN) -> 0."""
    m = torch.as_tensor(max_abs, dtype=torch.float32)
    return torch.where(m >= _F32_TINY, f32_to_i32(log2_ceil(m, qmax(bits))),
                       torch.zeros_like(m, dtype=torch.int32))


def log2_ceil(m: torch.Tensor, qmax_value) -> torch.Tensor:
    """float32 ceil(log2(max(m, tiny) / qmax)) as the reference evaluates
    it: log / log(2), with a subnormal quotient flushed to zero."""
    r = torch.clamp(m, min=_F32_TINY) / qmax_value
    r = torch.where(r < _F32_TINY, torch.zeros_like(r), r)
    return torch.ceil(torch.log(r) / _LN2_F32)


def quantize(x: torch.Tensor, e, bits: int) -> torch.Tensor:
    """Round-to-nearest-even mantissas for exponent ``e`` (broadcasts)."""
    scale = exp2i(-torch.as_tensor(e, device=x.device))
    q = torch.clamp(torch.round(x.to(torch.float32) * scale), -qmax(bits), qmax(bits))
    q = torch.nan_to_num(q, nan=0.0)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize(q: torch.Tensor, e) -> torch.Tensor:
    e = torch.as_tensor(e, device=q.device)
    return q.to(torch.float32) * exp2i(e)


def quantize_tensor(
    x: torch.Tensor, bits: int, axis: Optional[Tuple[int, ...]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor (axis=None) or per-axis DFP quantization; ``axis`` lists
    the reduced axes.  Returns (mantissa, exponent)."""
    a = x.to(torch.float32).abs()
    if axis is None:
        max_abs = torch.max(a) if a.numel() else torch.zeros((), device=x.device)
    else:
        max_abs = torch.amax(a, dim=axis, keepdim=True)
    e = choose_exponent(max_abs, bits)
    return quantize(x, e, bits), e


def fake_quantize(x: torch.Tensor, bits: int, axis: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """quantize -> dequantize in one step (the QAT forward, error metrics)."""
    q, e = quantize_tensor(x, bits, axis)
    return dequantize(q, e)
