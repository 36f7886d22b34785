"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2)
(counterpart of ``repro/models/ssm.py``).

The reference runs the sequence recurrence as a chunked ``lax.scan`` with
checkpointed chunks, which bounds training memory; here it is a plain loop
over steps carrying the float32 state, with the reference's dtypes step for
step, in the reference's chunks (``_fit_chunk``), each recomputed in the
backward pass (``layers.remat``).  The recurrence is elementwise (no TPU
kernel reaches it), so it stays plain torch; the projections
(``in_proj``, ``x_proj``, ``dt_proj`` with its bias, ``bc_proj``,
``out_proj``) are ``dense`` sites, quantized through the qdense kernels
under PTQ.  A, D, the conv taps and the dt biases stay in higher
precision, as the reference's policy leaves them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import dense
from repro_torch.quant.plan import QuantCtx


def _dt_rank(cfg) -> int:
    return max(1, -(-cfg.d_model // 16))


SCAN_CHUNK = 64  # the reference's scan chunk: steps recomputed together in the backward pass


def _fit_chunk(s: int, want: int) -> int:
    """Largest divisor of s that is <= want (the scan's chunk length)."""
    c = min(s, want)
    while s % c:
        c -= 1
    return c


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def _m2_heads(cfg) -> Tuple[int, int]:
    nh = cfg.ssm_heads or d_inner(cfg) // 64
    return nh, d_inner(cfg) // nh


def init_mamba(gen, cfg, dtype, device, path: str = "blocks/mamba", leaf=layers.keep) -> Dict[str, Any]:
    di, ds, rank = d_inner(cfg), cfg.ssm_state, _dt_rank(cfg)
    f32 = torch.float32
    p: Dict[str, Any] = {
        "in_proj": layers.init_dense(gen, cfg.d_model, 2 * di, False, dtype, device, f"{path}/in_proj", leaf),
        "out_proj": layers.init_dense(gen, di, cfg.d_model, False, dtype, device, f"{path}/out_proj", leaf),
        "conv_w": leaf(path, "conv_w", (layers._randn(gen, (cfg.ssm_conv, di), device) * 0.1).to(dtype)),
        "conv_b": leaf(path, "conv_b", torch.zeros((di,), dtype=dtype, device=device)),
        "D": leaf(path, "D", torch.ones((di,), dtype=f32, device=device)),
    }
    if cfg.ssm_version == 1:
        p["x_proj"] = layers.init_dense(gen, di, rank + 2 * ds, False, dtype, device, f"{path}/x_proj", leaf)
        p["dt_proj"] = layers.init_dense(gen, rank, di, True, dtype, device, f"{path}/dt_proj", leaf)
        a = torch.arange(1, ds + 1, dtype=f32, device=device).expand(di, ds)
        p["A_log"] = leaf(path, "A_log", torch.log(a))
    else:  # mamba2: a scalar A per head, B / C projected from the block input
        nh, _ = _m2_heads(cfg)
        p["bc_proj"] = layers.init_dense(gen, cfg.d_model, 2 * ds, False, dtype, device, f"{path}/bc_proj", leaf)
        p["dt_bias"] = leaf(path, "dt_bias", torch.zeros((nh,), dtype=f32, device=device))
        p["A_log"] = leaf(path, "A_log", torch.zeros((nh,), dtype=f32, device=device))
        p["norm"] = layers.init_rmsnorm(di, dtype, device, f"{path}/norm", leaf)
    return p


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (K, C), in float32."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].to(torch.float32) * w[i].to(torch.float32)
    return (out + b.to(torch.float32)).to(x.dtype)


def _conv_step(state_conv, xv, w, b):
    """One step of the causal conv: (float32 conv output before the bias
    is added -- the caller adds it --, the shifted window)."""
    buf = torch.cat([state_conv, xv[:, None, :].to(state_conv.dtype)], dim=1)  # (B, K, di)
    xc = torch.einsum("bkd,kd->bd", buf.to(torch.float32), w.to(torch.float32))
    return xc + b.to(torch.float32), buf[:, 1:]


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------
def _m1_chunk(h, dtf, xvf, bf, cf, a):
    """Mamba1's recurrence over one chunk of steps: (final state, outputs (B, c, di))."""
    ys = []
    for t in range(dtf.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * a)
        h = da * h + (dtf[:, t] * xvf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cf[:, t]))
    return h, torch.stack(ys, dim=1)


def mamba1_seq(p, x: torch.Tensor, cfg, ctx: QuantCtx, path: str) -> torch.Tensor:
    """Full-sequence Mamba1: x (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    di, ds, rank = d_inner(cfg), cfg.ssm_state, _dt_rank(cfg)
    xv, z = torch.chunk(dense(p["in_proj"], x, f"{path}/in_proj", ctx), 2, dim=-1)
    xv = _silu(_causal_conv(xv, p["conv_w"], p["conv_b"]))
    dt_in, bmat, cmat = torch.split(dense(p["x_proj"], xv, f"{path}/x_proj", ctx), [rank, ds, ds], dim=-1)
    dt = _softplus(dense(p["dt_proj"], dt_in, f"{path}/dt_proj", ctx))
    a = -torch.exp(p["A_log"])  # (di, ds)
    dtf, xvf = dt.to(torch.float32), xv.to(torch.float32)
    bf, cf = bmat.to(torch.float32), cmat.to(torch.float32)
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    c = _fit_chunk(s, SCAN_CHUNK)
    for t0 in range(0, s, c):
        sl = slice(t0, t0 + c)
        h, yc = layers.remat(_m1_chunk, h, dtf[:, sl], xvf[:, sl], bf[:, sl], cf[:, sl], a)
        ys.append(yc)
    y = (torch.cat(ys, dim=1) + xvf * p["D"]) * _silu(z.to(torch.float32))
    return dense(p["out_proj"], y.to(x.dtype), f"{path}/out_proj", ctx)


def mamba1_step(p, x: torch.Tensor, state, cfg, ctx: QuantCtx, path: str):
    """One decode token: x (B, 1, d); state {'h': (B, di, ds), 'conv':
    (B, K-1, di)} float32.  Returns (out (B, 1, d), new state)."""
    ds, rank = cfg.ssm_state, _dt_rank(cfg)
    xv, z = torch.chunk(dense(p["in_proj"], x[:, 0], f"{path}/in_proj", ctx), 2, dim=-1)
    xc, conv = _conv_step(state["conv"], xv, p["conv_w"], p["conv_b"])
    xv = _silu(xc).to(x.dtype)
    dt_in, bmat, cmat = torch.split(dense(p["x_proj"], xv, f"{path}/x_proj", ctx), [rank, ds, ds], dim=-1)
    dt = _softplus(dense(p["dt_proj"], dt_in, f"{path}/dt_proj", ctx)).to(torch.float32)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * a)
    xvf = xv.to(torch.float32)
    h = da * state["h"] + (dt * xvf)[..., None] * bmat.to(torch.float32)[:, None, :]
    y = torch.einsum("bds,bs->bd", h, cmat.to(torch.float32))
    y = (y + xvf * p["D"]) * _silu(z.to(torch.float32))
    out = dense(p["out_proj"], y[:, None].to(x.dtype), f"{path}/out_proj", ctx)
    return out, {"h": h, "conv": conv}


# ---------------------------------------------------------------------------
# Mamba2 (SSD: a scalar decay per head)
# ---------------------------------------------------------------------------
def _m2_chunk(h, da, dtx, bf, cf):
    """Mamba2's recurrence over one chunk of steps, the (hd x ds) outer-product
    update formed a step at a time: (final state, outputs (B, c, H, hd))."""
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t, :, None, None] * h + dtx[:, t, ..., None] * bf[:, t, None, None, :]
        ys.append(torch.einsum("bhds,bs->bhd", h, cf[:, t]))
    return h, torch.stack(ys, dim=1)


def mamba2_seq(p, x: torch.Tensor, cfg, ctx: QuantCtx, path: str) -> torch.Tensor:
    b, s, _ = x.shape
    di, ds = d_inner(cfg), cfg.ssm_state
    nh, hd = _m2_heads(cfg)
    xv, z = torch.chunk(dense(p["in_proj"], x, f"{path}/in_proj", ctx), 2, dim=-1)
    xv = _silu(_causal_conv(xv, p["conv_w"], p["conv_b"]))
    bmat, cmat = torch.chunk(dense(p["bc_proj"], x, f"{path}/bc_proj", ctx), 2, dim=-1)  # (B, S, ds) each
    a = -torch.exp(p["A_log"])  # (H,)
    # dt from the mean of x over each head (the reference's simplified SSD discretization)
    xh = xv.reshape(b, s, nh, hd).to(torch.float32)
    dt = _softplus(torch.mean(xh, dim=-1) + p["dt_bias"][None, None, :])  # (B, S, H)
    da = torch.exp(dt * a[None, None, :])
    dtx = dt[..., None] * xh  # (B, S, H, hd)
    bf, cf = bmat.to(torch.float32), cmat.to(torch.float32)
    h = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    c = _fit_chunk(s, SCAN_CHUNK)
    for t0 in range(0, s, c):
        sl = slice(t0, t0 + c)
        h, yc = layers.remat(_m2_chunk, h, da[:, sl], dtx[:, sl], bf[:, sl], cf[:, sl])
        ys.append(yc)
    y = torch.cat(ys, dim=1).reshape(b, s, di)
    y = y + xv.to(torch.float32) * p["D"]
    y = layers.rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    y = y * _silu(z)
    return dense(p["out_proj"], y, f"{path}/out_proj", ctx)


def mamba2_step(p, x: torch.Tensor, state, cfg, ctx: QuantCtx, path: str):
    """One decode token: x (B, 1, d); state {'h': (B, H, hd, ds), 'conv':
    (B, K-1, di)} float32.  Returns (out (B, 1, d), new state)."""
    b = x.shape[0]
    di = d_inner(cfg)
    nh, hd = _m2_heads(cfg)
    xv, z = torch.chunk(dense(p["in_proj"], x[:, 0], f"{path}/in_proj", ctx), 2, dim=-1)
    xc, conv = _conv_step(state["conv"], xv, p["conv_w"], p["conv_b"])
    xv = _silu(xc)  # float32: the reference does not cast it back here
    bmat, cmat = torch.chunk(dense(p["bc_proj"], x[:, 0], f"{path}/bc_proj", ctx), 2, dim=-1)
    a = -torch.exp(p["A_log"])
    xh = xv.reshape(b, nh, hd)
    dt = _softplus(torch.mean(xh, dim=-1) + p["dt_bias"][None, :])  # (B, H)
    da = torch.exp(dt * a[None, :])[..., None, None]
    dbx = (dt[..., None] * xh)[..., None] * bmat.to(torch.float32)[:, None, None, :]
    h = da * state["h"] + dbx
    y = torch.einsum("bhds,bs->bhd", h, cmat.to(torch.float32)).reshape(b, di)
    y = y + xv * p["D"]
    y = layers.rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    y = y * _silu(z)
    out = dense(p["out_proj"], y[:, None], f"{path}/out_proj", ctx)
    return out, {"h": h, "conv": conv}


def init_ssm_state(cfg, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    di, ds = d_inner(cfg), cfg.ssm_state
    conv = torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=torch.float32, device=device)
    if cfg.ssm_version == 1:
        return {"h": torch.zeros((batch, di, ds), dtype=torch.float32, device=device), "conv": conv}
    nh, hd = _m2_heads(cfg)
    return {"h": torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device), "conv": conv}
