"""Building-block layers over plain dicts of tensors (counterpart of
``repro/models/layers.py``).

Every projection goes through ``dense``: full precision (``x @ W``), or PTQ
with a QTensor weight through ``qdense`` -- one whole-site call carrying the
bias and activation into the kernel epilogue, with the plan's calibrated
static activation exponent where the site has one.  A ctx carrying an
``observer`` records each site's input range first (the calibration pass).
The QAT branch of the reference comes with the training slice.

Init functions take an explicit ``torch.Generator`` and ``device``, plus a
``leaf(path, key, tensor)`` hook every created parameter passes through, so
a caller can quantize each site as it is made.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.quantizer import QTensor
from repro_torch.quant.api import observe_site
from repro_torch.quant.backends import apply_act, qdense
from repro_torch.quant.plan import QuantCtx

Params = Dict[str, Any]
Leaf = Callable[[str, str, torch.Tensor], Any]


def keep(path: str, key: str, val):
    return val


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def init_dense(gen, d_in: int, d_out: int, bias: bool, dtype, device, path: str = "",
               leaf: Leaf = keep) -> Params:
    w = (_randn(gen, (d_in, d_out), device) * d_in**-0.5).to(dtype)
    p = {"w": leaf(path, "w", w)}
    if bias:
        p["b"] = leaf(path, "b", torch.zeros((d_out,), dtype=dtype, device=device))
    return p


def dense(p: Params, x: torch.Tensor, path: str, ctx: QuantCtx,
          act: Optional[str] = None) -> torch.Tensor:
    """Projection x @ W (+ b) (+ activation ``act``)."""
    w = p["w"]
    if ctx.observer is not None:  # calibration pass: record this site's range
        observe_site(ctx.observer, path, x)
    if isinstance(w, QTensor):  # PTQ: the full integer pipeline, one call
        prec = ctx.resolve(path)
        y = qdense(
            x, w, bias=p.get("b"), act=act, backend=ctx.backend,
            act_bits=prec.act_bits if prec else 8,
            act_exponent=ctx.act_exponent(path),
            fused=prec.fused if prec else True,
        )
        return y.to(x.dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return apply_act(y, act)


def init_rmsnorm(d: int, dtype, device, path: str = "", leaf: Leaf = keep) -> Params:
    return {"scale": leaf(path, "scale", torch.ones((d,), dtype=dtype, device=device))}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    sin, cos = torch.sin(angles)[..., None, :], torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections=(1, 1, 2)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions (3, ..., S) = (t, h, w) ids; the
    hd/2 frequency lanes are split across the three components in the ratio
    ``sections`` (1:1:2 t:h:w by default), each lane rotating by its
    component's position."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    n = hd // 2
    total = sum(sections)
    bounds = [n * sum(sections[:i + 1]) // total for i in range(3)]
    lane = torch.arange(n, device=x.device)
    comp = torch.where(lane < bounds[0], 0, torch.where(lane < bounds[1], 1, 2))
    pos = positions.to(torch.float32)[..., None] * torch.ones_like(freqs)  # (3, ..., S, hd/2)
    pos = torch.gather(pos, 0, comp.expand(1, *positions.shape[1:], n))[0]  # each lane's component
    angles = pos * freqs
    sin, cos = torch.sin(angles)[..., None, :], torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device, path: str = "",
             leaf: Leaf = keep) -> Params:
    return {
        "up": init_dense(gen, d_model, d_ff, False, dtype, device, f"{path}/up", leaf),
        "gate": init_dense(gen, d_model, d_ff, False, dtype, device, f"{path}/gate", leaf),
        "down": init_dense(gen, d_ff, d_model, False, dtype, device, f"{path}/down", leaf),
    }


def mlp(p: Params, x: torch.Tensor, path: str, ctx: QuantCtx) -> torch.Tensor:
    # silu rides into the gate projection's kernel epilogue
    h = dense(p["gate"], x, f"{path}/gate", ctx, act="silu")
    h = h * dense(p["up"], x, f"{path}/up", ctx)
    return dense(p["down"], h, f"{path}/down", ctx)


def init_embedding(gen, vocab: int, d: int, dtype, device, path: str = "embed",
                   leaf: Leaf = keep) -> Params:
    table = (_randn(gen, (vocab, d), device) * d**-0.5).to(dtype)
    return {"table": leaf(path, "table", table)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]
