"""Activation calibration: the paper's 8-bit DFP activations and the
BatchNorm-recompute analogue (counterpart of ``repro/core/calibration.py``).

  1. Observer state records per-site max|x| and mean square over
     calibration batches; ``finalize`` turns them into shared exponents.
  2. ``recalibrate_gamma`` rescales a norm's gain by the ratio of
     full-precision to quantized activation RMS at the same site -- the
     first-moment correction BN re-estimation performs.

Observer state is a plain dict: {site: {"max_abs", "msq", "count"}} of
float32 0-d tensors.  (The PTQ pass records on the host instead, through
``quant.api.Observer``.)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import dfp

ObserverState = Dict[str, Dict[str, torch.Tensor]]


def init_observer() -> ObserverState:
    return {}


def observe(state: ObserverState, site: str, x: torch.Tensor) -> ObserverState:
    """Record one batch at ``site`` (functional update)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    entry = state.get(site, {"max_abs": zero, "msq": zero, "count": zero})
    xf = x.to(torch.float32)
    new = {
        "max_abs": torch.maximum(entry["max_abs"], torch.max(torch.abs(xf))),
        "msq": entry["msq"] + torch.mean(torch.square(xf)),
        "count": entry["count"] + 1.0,
    }
    out = dict(state)
    out[site] = new
    return out


def finalize(state: ObserverState, bits: int = 8) -> Dict[str, torch.Tensor]:
    """Per-site shared exponents from recorded ranges."""
    return {site: dfp.choose_exponent(entry["max_abs"], bits) for site, entry in state.items()}


def quantize_act(x: torch.Tensor, e, bits: int = 8) -> torch.Tensor:
    """Static (calibrated-exponent) activation quantization -> int8."""
    return dfp.quantize(x, e, bits)


def dynamic_quantize_act(x: torch.Tensor, bits: int = 8, per_row: bool = False):
    """Per-batch dynamic quantization: one exponent for the tensor, or one
    per leading-axis row (per token) with ``per_row``.  Returns (int8
    mantissas, int32 exponent)."""
    return dfp.quantize_tensor(x, bits, tuple(range(1, x.ndim)) if per_row else None)


def fake_quantize_act(x: torch.Tensor, bits: int = 8, per_row: bool = False) -> torch.Tensor:
    q, e = dynamic_quantize_act(x, bits, per_row)
    return dfp.dequantize(q, e)


def recalibrate_gamma(gamma: torch.Tensor, rms_fp, rms_q, eps: float = 1e-6) -> torch.Tensor:
    """Rescale a norm gain so the quantized activation RMS matches the
    full-precision one: both are true RMS values, so the gain absorbs their
    plain ratio."""
    return gamma * (rms_fp + eps) / (rms_q + eps)


def rms_from_observer(state: ObserverState, site: str) -> torch.Tensor:
    """True RMS at ``site``: sqrt of the batch-averaged mean square."""
    entry = state[site]
    return torch.sqrt(entry["msq"] / torch.clamp(entry["count"], min=1.0))
