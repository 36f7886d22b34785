"""Grouped-query attention with qk-norm, RoPE and KV-cache decode
(counterpart of ``repro/models/attention.py``, dense-family flavours).

Two read paths over the cache, as in the reference:

  * ``_attend_dense``: the fold-the-scales oracle over the whole cache,
  * ``_flash_cache_path``: the hand-written flash kernel
    (``kernels/flash_prefill.py``), routed for S == 1 steps when
    ``cfg.flash_decode`` is on.  S > 1 cache-attends (chunked prefill,
    ``cfg.flash_prefill``) come with the prefill slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import kv_cache, layers
from repro_torch.models.layers import dense
from repro_torch.quant.plan import QuantCtx

NEG_INF = -1e30


def init_attention(gen, cfg, dtype, device, path: str = "blocks/attn", leaf=layers.keep) -> dict:
    hd = cfg.hd()
    p = {
        "wq": layers.init_dense(gen, cfg.d_model, cfg.n_heads * hd, cfg.qkv_bias, dtype, device, f"{path}/wq", leaf),
        "wk": layers.init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias, dtype, device, f"{path}/wk", leaf),
        "wv": layers.init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias, dtype, device, f"{path}/wv", leaf),
        "wo": layers.init_dense(gen, cfg.n_heads * hd, cfg.d_model, False, dtype, device, f"{path}/wo", leaf),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(hd, dtype, device, f"{path}/q_norm", leaf)
        p["k_norm"] = layers.init_rmsnorm(hd, dtype, device, f"{path}/k_norm", leaf)
    return p


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int], valid_len=None) -> torch.Tensor:
    """Additive mask (..., S, T): 0 where a key is visible, -1e30 elsewhere."""
    qp = q_pos[..., :, None].to(torch.int32)
    kp = k_pos[None, :].to(torch.int32)
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool, device=qp.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (qp - kp < window)
    if valid_len is not None:
        ok = ok & (kp < valid_len[:, None, None])
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _attend_dense(q, k, v, bias, kscale=None, vscale=None):
    """q (B,S,Kh,G,hd), k/v (B,T,Kh,hd), bias broadcastable to (B,Kh,G,S,T);
    per-token scales (B,T,Kh) fold into scores / probabilities."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgh,btkh->bkgst", q.to(torch.float32), k.to(torch.float32))
    if kscale is not None:
        s = s * kscale.permute(0, 2, 1)[:, :, None, None, :]
    s = s * scale + bias
    p = torch.softmax(s, dim=-1)
    if vscale is not None:
        p = p * vscale.permute(0, 2, 1)[:, :, None, None, :]
    return torch.einsum("bkgst,btkh->bskgh", p, v.to(torch.float32))


def _attend_dense_mha(q, k, v, bias):
    """Full-head layout: q/k/v (B,S|T,H,hd); bias (..., S, T)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), k.to(torch.float32))
    s = s * scale + bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.to(torch.float32))


def _win_arg(window, device) -> torch.Tensor:
    # torch.full fills on the device: no host-to-device copy, no sync
    return torch.full((1, 1), 2**30 if window is None else window, dtype=torch.int32, device=device)


def _flash_cache_path(q, cache, fmt, q_pos, valid, window, cfg):
    """An S >= 1 cache-attend through the flash kernel; rows contiguous
    from q_pos's first entry."""
    from repro_torch.kernels.flash_prefill import flash_attend

    b, s = q.shape[0], q.shape[1]
    hd, kh = cfg.hd(), cfg.n_kv_heads
    g = cfg.n_heads // kh
    qf = q.reshape(b, s, kh, g, hd).to(torch.float32).contiguous()
    qs = q_pos[:, 0] if q_pos.ndim == 2 else q_pos.reshape(-1)[0].expand(b)
    out = flash_attend(
        qf, cache["k"], cache["v"], cache.get("ke"), cache.get("ve"),
        qs.to(torch.int32).reshape(b, 1).contiguous(),
        valid.to(torch.int32).reshape(b, 1).contiguous(),
        _win_arg(window, q.device), fmt=fmt,
    )
    return out.reshape(b, s, cfg.n_heads * hd)


def attention(
    p: dict, x: torch.Tensor, positions: torch.Tensor, cfg, ctx: QuantCtx, path: str,
    *, causal: bool = True, window: Optional[int] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None, cache_index=None,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (output (B,S,d), the cache written in place, or None)."""
    hd = cfg.hd()
    g = cfg.n_heads // cfg.n_kv_heads

    q = _split_heads(dense(p["wq"], x, f"{path}/wq", ctx), cfg.n_heads)
    k = _split_heads(dense(p["wk"], x, f"{path}/wk", ctx), cfg.n_kv_heads)
    v = _split_heads(dense(p["wv"], x, f"{path}/wv", ctx), cfg.n_kv_heads)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    q_pos = positions

    decode = cache is not None and x.shape[1] == 1
    if cache is not None:
        fmt = kv_cache.resolve_kv_fmt(cfg)
        cache, valid = kv_cache.write(fmt, cache, k, v, cache_index)

    if decode:
        if cfg.flash_decode:
            out = _flash_cache_path(q, cache, fmt, q_pos, valid, window, cfg)
        else:
            ck, cv, kscale, vscale = kv_cache.attend_view(fmt, cache)
            t = ck.shape[1]
            bias = _mask_bias(q_pos, torch.arange(t, device=x.device), causal, window, valid)
            bias = bias[None, None, None] if bias.ndim == 2 else bias[:, None, None]
            qh = q.reshape(*q.shape[:2], cfg.n_kv_heads, g, hd)
            out = _attend_dense(qh, ck, cv, bias, kscale=kscale, vscale=vscale)
            out = out.reshape(*x.shape[:2], cfg.n_heads * hd)
        out = out.to(x.dtype)
        return dense(p["wo"], out, f"{path}/wo", ctx), cache

    if cache is not None and cfg.flash_prefill:
        raise NotImplementedError("flash prefill (S > 1 with a cache) is not ported yet")
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    t = k.shape[1]
    if t > chunk:
        raise NotImplementedError("chunked online-softmax prefill (T > chunk) is not ported yet")
    if causal or window is not None:
        bias = _mask_bias(q_pos, torch.arange(t, device=x.device), causal, window)
        bias = bias[None] if bias.ndim == 2 else bias[:, None]
    else:
        bias = torch.zeros((), dtype=torch.float32, device=x.device)
    out = _attend_dense_mha(q, k, v, bias)
    out = out.reshape(*x.shape[:2], cfg.n_heads * hd).to(x.dtype)
    return dense(p["wo"], out, f"{path}/wo", ctx), cache
