"""Trainable quantization state: TTQ's learned scales and INQ's freeze
masks (counterpart of ``repro/quant/state.py``).

State leaves live inside the parameter tree, in the projection site's dict
beside the ``w`` they govern:

  ``ttq_scales`` : (..., 2, G, N) f32 -- trained Wp / Wn cluster magnitudes
  ``inq_mask``   : (..., K, N) f32, 1.0 = frozen -- INQ's accumulated
                   partition mask (not trained)
  ``inq_scales`` : (..., G, N) f32 -- the learned cluster grid the whole
                   tensor fake-quantizes onto (trained; INQ events snap
                   newly frozen coordinates onto it, never re-fit it)

A leading expert axis (an MoE site's (E, K, N)) is mapped over one expert
at a time, as the reference's vmap does; per-layer block lists need no
mapping.  ``QuantState`` is the small schedule record (method, partition
fractions, position) a checkpoint keeps so a resume is faithful.
``quant/api.quantize_params`` deploys the learned ``ttq_scales`` /
``inq_scales`` through ``quantize_weights(scales=...)``: the artifact runs
on the grid training converged to, never a re-fit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.core import ternary
from repro_torch.core.quantizer import dequantize_scales
from repro_torch.quant.api import _quantizable
from repro_torch.quant.formats import dequantize_weights, quantize_weights, ttq_partition
from repro_torch.quant.plan import QuantPlan, is_projection_site, site_subpath

# every key this module may add to a site's dict
STATE_KEYS = ("ttq_scales", "inq_mask", "inq_scales")

DEFAULT_INQ_FRACTIONS = (0.5, 0.75, 0.875, 1.0)


@dataclasses.dataclass(frozen=True)
class QuantState:
    """method 'ttq' | 'inq'; ``fractions``: INQ's accumulated partition
    fractions; ``pos``: INQ events already applied (the resume cursor);
    ``total_steps``: the planned run the event steps derive from."""

    method: str
    fractions: Tuple[float, ...] = DEFAULT_INQ_FRACTIONS
    pos: int = 0
    total_steps: int = 0

    def to_meta(self) -> Dict[str, Any]:
        return {"method": self.method, "fractions": list(self.fractions), "pos": int(self.pos),
                "total_steps": int(self.total_steps)}

    @classmethod
    def from_meta(cls, meta: Dict[str, Any]) -> "QuantState":
        return cls(method=meta["method"], fractions=tuple(float(f) for f in meta["fractions"]),
                   pos=int(meta["pos"]), total_steps=int(meta["total_steps"]))


def inq_event_steps(total_steps: int, fractions: Sequence[float]) -> Tuple[int, ...]:
    """The steps INQ's events fire at: freezing fraction f of the weights
    lands at fraction f of the run; the last event is clamped to the last
    step, so training ends with the whole tensor on its grid."""
    last = max(total_steps - 1, 0)
    return tuple(min(math.floor(total_steps * f), last) for f in fractions)


def _map_site(fn, *tensors):
    """``fn`` over each expert of an (E, K, N) site, or the (K, N) site."""
    if tensors[0].ndim == 2:
        return fn(*tensors)
    outs = [_map_site(fn, *(t[i] for t in tensors)) for i in range(tensors[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def _ttq_init(m: torch.Tensor, p) -> torch.Tensor:
    """L2-optimal scales given the ttq threshold codes: each cluster's mean
    |w| over each sign partition; an empty partition takes the Algorithm-1
    alpha.  (2, G, N)."""
    g = p.group_size
    k, n = m.shape
    cb = ttq_partition(m, g).reshape(k // g, g, n)
    mb = torch.abs(m).reshape(k // g, g, n)
    _, alpha = ternary.ternarize_matrix(m, g, p.filter_size, p.refit_scale)
    scales = []
    for sign in (1, -1):
        part = (cb == sign).to(torch.float32)
        cnt = part.sum(dim=1)
        s = (mb * part).sum(dim=1) / torch.clamp(cnt, min=1.0)
        scales.append(torch.where(cnt > 0, s, alpha))
    return torch.stack(scales, dim=0)


def _inq_init(m: torch.Tensor, p) -> torch.Tensor:
    qt = quantize_weights(m, p.w_bits, p.group_size, p.filter_size, p.refit_scale, fmt=p.fmt)
    return dequantize_scales(qt.scale_m, qt.scale_e)


def init_quant_state(params, plan: QuantPlan, method: str, *, fractions: Sequence[float] = DEFAULT_INQ_FRACTIONS,
                     total_steps: int = 0) -> Tuple[Any, QuantState]:
    """State leaves at every quantizable projection site: ttq (sites whose
    format is ttq) ``ttq_scales`` from each sign partition's mean |w|, so
    TTQ starts from the best grid for its codes; inq an all-zero
    ``inq_mask`` and ``inq_scales`` of the full-tensor fit, which then
    trains by gradient and is never re-fit.  Returns (params, QuantState)."""
    if method not in ("ttq", "inq"):
        raise ValueError(f"unknown stateful quant method: {method!r}")

    def walk(node, path):
        if isinstance(node, list):
            return [walk(item, path) for item in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if is_projection_site(key, val):
                out[key] = val
                prec = plan.resolve(path)
                if not _quantizable(prec, val.shape[-2]):
                    continue
                w = val.to(torch.float32)
                if method == "ttq":
                    if prec.fmt == "ttq":
                        out["ttq_scales"] = _map_site(lambda m, p=prec: _ttq_init(m, p), w)
                else:
                    out["inq_mask"] = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                    out["inq_scales"] = _map_site(lambda m, p=prec: _inq_init(m, p), w)
            elif key in STATE_KEYS:
                out[key] = val  # already there (a second walk changes nothing)
            else:
                out[key] = walk(val, site_subpath(path, key))
        return out

    qs = QuantState(method=method, fractions=tuple(float(f) for f in fractions), pos=0, total_steps=int(total_steps))
    return walk(params, ""), qs


def strip_quant_state(params):
    """The tree without its state leaves."""
    if isinstance(params, list):
        return [strip_quant_state(item) for item in params]
    if not isinstance(params, dict):
        return params
    return {k: strip_quant_state(v) for k, v in params.items() if k not in STATE_KEYS}


def has_quant_state(params) -> bool:
    if isinstance(params, list):
        return any(has_quant_state(item) for item in params)
    if not isinstance(params, dict):
        return False
    return any(k in STATE_KEYS or has_quant_state(v) for k, v in params.items())


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile``'s linear method, in its order of operations."""
    a = torch.sort(flat).values
    n = a.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    lo = a[int(torch.clamp(low, 0, n - 1))]
    hi = a[int(torch.clamp(high, 0, n - 1))]
    return lo * low_w.to(a.device) + hi * high_w.to(a.device)


def advance_inq(params, plan: QuantPlan, fraction: float):
    """One INQ event: at each site grow the frozen set to the smallest
    ``fraction`` of coordinates by magnitude (smallest first, as the
    reference explains) and snap the frozen master weights onto the CURRENT
    learned grid ``inq_scales``.  The mask accumulates; the grid is never
    re-fit."""

    def adv_one(m, mask, sc, p):
        thr = _quantile(torch.abs(m).reshape(-1), fraction)
        new_mask = torch.maximum(mask, (torch.abs(m) <= thr).to(torch.float32))
        qt = quantize_weights(m, p.w_bits, p.group_size, p.filter_size, p.refit_scale, fmt=p.fmt,
                              scales=torch.abs(sc))
        return torch.where(new_mask > 0, dequantize_weights(qt), m), new_mask

    def walk(node, path):
        if isinstance(node, list):
            return [walk(item, path) for item in node]
        if not isinstance(node, dict):
            return node
        if "inq_mask" in node and "w" in node:
            prec = plan.resolve(path)
            w = node["w"].to(torch.float32)
            new_w, new_mask = _map_site(lambda m, k, s: adv_one(m, k, s, prec), w, node["inq_mask"],
                                        node["inq_scales"])
            return dict(node, w=new_w.to(node["w"].dtype), inq_mask=new_mask)
        return {k: walk(v, site_subpath(path, k)) for k, v in node.items()}

    return walk(params, "")
