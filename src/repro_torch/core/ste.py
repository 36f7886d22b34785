"""Straight-through estimators for the paper's low-precision training
(Sec. 4; counterpart of ``repro/core/ste.py``).

The forward pass sees fake-quantized weights (Algorithm 1 ternary, 4-bit,
or any registered format) and 8-bit DFP activations; gradients reach the
float32 master copy unchanged (weights) or clipped to the representable
range (activations).  Each of the reference's ``jax.custom_vjp``s is a
``torch.autograd.Function`` here, its backward written out as the
reference has it, so autograd never traces the sorts of Algorithm 1.

  * ``weights_ste`` / ``ternary_weights_ste``: identity backward;
  * ``ttq_ste``: Trained Ternary Quantization's analytic gradients for the
    latent weights and the two trained magnitudes Wp / Wn;
  * ``inq_ste``: the learned-grid INQ forward and backward (frozen
    coordinates get no gradient, the grid gets the code-weighted sums);
    ``inq_freeze`` is the paper's original forward;
  * ``act_ste``: 8-bit DFP activations whose clip carries the gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import calibration, dfp
from repro_torch.core.quantizer import dequantize_scales, quantize_scales


def ste(x: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Value of ``quantized``, gradient of ``x``."""
    return x + (quantized - x).detach()


class _WeightSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, bits, group_size, filter_size, refit, fmt):
        from repro_torch.quant.formats import fake_quantize_weights  # lazy: import cycle

        return fake_quantize_weights(w, bits, group_size, filter_size, refit, fmt=fmt)

    @staticmethod
    def backward(ctx, g):  # straight through: the identity to the master copy
        return g, None, None, None, None, None


def weights_ste(w: torch.Tensor, bits: int, group_size: int, filter_size: int = 1,
                refit_scale: bool = False, fmt: Optional[str] = None) -> torch.Tensor:
    """``fmt`` names a registered format, so QAT trains on the grid PTQ
    will deploy (resolving by bits alone would pick the uniform grid)."""
    if bits >= 16:  # full precision passes through
        return w
    return _WeightSTE.apply(w, bits, group_size, filter_size, refit_scale, fmt)


def ternary_weights_ste(w: torch.Tensor, group_size: int, filter_size: int = 1,
                        refit_scale: bool = False, fmt: Optional[str] = None) -> torch.Tensor:
    """Sec. 4's forward: Algorithm-1 ternary weights, identity gradient."""
    return weights_ste(w, 2, group_size, filter_size, refit_scale, fmt=fmt)


def _ttq_apply(w, wpn, group_size, threshold):
    """The shared forward: ternary codes of the master weights, cluster
    magnitudes of the trained Wp / Wn through the deployment's DFP scale
    table, so the training grid is the serving grid bit for bit.  Returns
    (wq, (pos, neg, dequantized magnitudes, sign of wpn))."""
    from repro_torch.quant.formats import ttq_partition  # lazy: import cycle

    k, n = w.shape
    codes = ttq_partition(w, group_size, threshold).to(torch.float32)
    cb = codes.reshape(k // group_size, group_size, n)
    pos = (cb > 0).to(torch.float32)
    neg = (cb < 0).to(torch.float32)
    mag = torch.abs(wpn)  # (2, G, N)
    sm, se = quantize_scales(mag.reshape(-1, n))
    sq = dequantize_scales(sm, se).reshape(mag.shape)
    wq = pos * sq[0][:, None, :] - neg * sq[1][:, None, :]
    return wq.reshape(k, n), (pos.reshape(k, n), neg.reshape(k, n), sq, torch.sign(wpn))


class _TtqSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, wpn, group_size, threshold):
        wq, res = _ttq_apply(w, wpn, group_size, threshold)
        ctx.save_for_backward(*res)
        ctx.group_size = group_size
        return wq

    @staticmethod
    def backward(ctx, g):
        pos, neg, sq, sgn = ctx.saved_tensors
        k, n = g.shape
        gs = ctx.group_size
        gb = g.reshape(k // gs, gs, n)
        pb = pos.reshape(k // gs, gs, n)
        nb = neg.reshape(k // gs, gs, n)
        # TTQ's rule (arxiv 1612.01064 eq. 5-6): the scales' gradients are
        # the partition sums; the latent weight's is scaled by its cluster
        # magnitude on its partition and the identity in the dead zone
        dwp = torch.sum(gb * pb, dim=1)
        dwn = -torch.sum(gb * nb, dim=1)
        dwpn = torch.stack([dwp, dwn], dim=0) * sgn  # through |wpn|
        dw = gb * (pb * sq[0][:, None, :] + nb * sq[1][:, None, :] + (1.0 - pb - nb))
        return dw.reshape(k, n), dwpn, None, None


def ttq_ste(w: torch.Tensor, wpn: torch.Tensor, group_size: int, threshold: Optional[float] = None) -> torch.Tensor:
    """Trained Ternary Quantization forward / backward: ``w`` (K, N) float32
    master weights, ``wpn`` (2, G, N) trained magnitudes (Wp, then Wn).
    Gradients reach both under the sign-partitioned TTQ rule."""
    from repro_torch.quant.formats import TTQ_THRESHOLD

    t = TTQ_THRESHOLD if threshold is None else threshold
    return _TtqSTE.apply(w, wpn, group_size, float(t))


def inq_freeze(w: torch.Tensor, mask: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """INQ's original forward (arxiv 1702.03044): frozen coordinates (mask
    > 0) carry their value with no gradient; the rest train through
    ``live`` (the raw weights by default)."""
    live = w if live is None else live
    return torch.where(mask > 0, w.detach(), live)


def _inq_apply(w, s, bits, group_size, filter_size, refit, fmt):
    """``w`` fake-quantized onto the given grid ``|s|`` through the
    deployment's own ``quantize_weights(scales=...)``: (values, codes)."""
    from repro_torch.quant.formats import dequantize_weights, quantize_weights

    qt = quantize_weights(w, bits, group_size, filter_size, refit, fmt=fmt, scales=torch.abs(s))
    deq = dequantize_weights(qt).to(torch.float32)
    sq = dequantize_scales(qt.scale_m, qt.scale_e)
    safe = torch.where(sq > 0, sq, torch.ones_like(sq))
    k, n = w.shape
    codes = (deq.reshape(k // group_size, group_size, n) / safe[:, None, :]).reshape(k, n)
    return deq, codes


class _InqSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mask, s, bits, group_size, filter_size, refit, fmt):
        deq, codes = _inq_apply(w, s, bits, group_size, filter_size, refit, fmt)
        ctx.save_for_backward(mask, codes, torch.sign(s))
        ctx.group_size = group_size
        return deq

    @staticmethod
    def backward(ctx, g):
        mask, codes, sgn = ctx.saved_tensors
        k, n = g.shape
        gs = ctx.group_size
        # live coordinates: the identity to the master weights; frozen: zero
        dw = g * (1.0 - (mask > 0).to(torch.float32))
        # the learned grid's rule: each cluster's scale gets the code-weighted
        # gradient sum over ALL its coordinates (frozen codes still steer it)
        ds = torch.sum((g * codes).reshape(k // gs, gs, n), dim=1) * sgn
        return dw, torch.zeros_like(mask), ds, None, None, None, None, None


def inq_ste(w: torch.Tensor, mask: torch.Tensor, scales: torch.Tensor, bits: int, group_size: int,
            filter_size: int = 1, refit_scale: bool = False, fmt: Optional[str] = None) -> torch.Tensor:
    """Learned-grid INQ forward / backward: the whole (K, N) tensor
    fake-quantizes onto the trained cluster grid ``scales`` (G, N) (codes
    from ``w / s`` each step, as deployment derives them); ``mask`` (K, N),
    1.0 = frozen, stops ``w``'s gradient there."""
    return _InqSTE.apply(w, mask, scales, bits, group_size, filter_size, refit_scale, fmt)


def act_ste(x: torch.Tensor, bits: int = 8, per_row: bool = False, exponent: Optional[int] = None) -> torch.Tensor:
    """8-bit DFP activation fake-quant with a clipped STE: zero gradient
    outside the representable range, the identity inside.  With the
    dynamic exponent the clip never binds; a static ``exponent`` (a
    calibrated site's) trains against a fixed range."""
    if bits >= 16:
        return x
    if exponent is None:
        e = dfp.choose_exponent(torch.max(torch.abs(x.detach())), bits)
    else:
        e = torch.tensor(int(exponent), dtype=torch.int32, device=x.device)
    r = dfp.qmax(bits) * dfp.exp2i(e)
    xc = torch.clamp(x, -r, r)
    if exponent is None:
        q = calibration.fake_quantize_act(xc, bits, per_row)
    else:
        q = dfp.dequantize(dfp.quantize(xc, e, bits), e)
    return ste(xc, q)
