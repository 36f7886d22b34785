"""Grouped-query attention with qk-norm, RoPE or M-RoPE (qwen2-vl),
cross-attention (whisper: K / V projected from ``kv_src``, no RoPE) and
KV-cache decode (counterpart of ``repro/models/attention.py``).  Under
M-RoPE, positions are (3, B, S) and the oracle routes mask causality by
the temporal component, as the reference does (ROADMAP Queue C13).

Read paths over the cache, as in the reference:

  * ``_attend_dense``: the fold-the-scales oracle over the whole cache
    (per-token power-of-two scales folded into scores and probabilities);
  * ``_flash_cache_path``: the hand-written flash kernel over the packed
    cache (``kernels/flash_prefill.py``), routed for S == 1 steps under
    ``cfg.flash_decode`` and for S > 1 cache-attends (``attend_cache``,
    chunked prefill) under ``cfg.flash_prefill``;
  * ``_flash_self_path``: the same kernel over a chunk's own bf16 K/V, the
    in-chunk tail of a full-prompt ``prefill`` under ``cfg.flash_prefill``.

Without a cache (or without flash) S > 1 attends densely over the chunk,
or in online-softmax chunks of keys when T > ``chunk``.

On a mesh the reference routes every cache attend to its XLA oracle
(``_flash_routable``: a pallas_call is not partitionable over the kv-head
or sequence axes).  The port's flash kernel runs per rank on the rank's kv
heads instead, which are whole on the rank (``models/spmd.py``); a cache
split on its sequence raises before anything runs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import kv_cache, layers, spmd
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


def _attend_chunked(q, k, v, q_pos, causal, window, chunk: int):
    """Online softmax over key chunks; q (B,S,H,hd), k/v (B,T,H,hd) with KV
    repeated to full heads.  The trailing T % chunk keys run as one final
    partial chunk."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    qf = q.to(torch.float32) * hd**-0.5
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    for j0 in range(0, t, chunk):
        # a whole chunk is recomputed in the backward pass, as the reference's checkpointed scan body
        m, l, acc = layers.maybe_remat(j0 + chunk <= t, _online_chunk, m, l, acc, qf, k[:, j0:j0 + chunk],
                                       v[:, j0:j0 + chunk], q_pos, j0, causal, window)
    return acc / torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]


def _online_chunk(m, l, acc, qf, ks, vs, q_pos, j0: int, causal, window):
    """One key chunk of the online softmax: the carry (m, l, acc) updated."""
    bias = _mask_bias(q_pos, torch.arange(j0, j0 + ks.shape[1], device=qf.device), causal, window)
    bias = bias[None] if bias.ndim == 2 else bias[:, None]
    sc = torch.einsum("bshd,bthd->bhst", qf, ks.to(torch.float32)) + bias
    m_new = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr.permute(0, 2, 1)[..., None] + torch.einsum("bhst,bthd->bshd", p, vs.to(torch.float32))
    return m_new, l, acc


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
    state = spmd.active()
    plan = {} if state is None else {"plan_pairs": spmd.whole_pairs(b * kh, state)}  # a rank plans the whole call
    out = flash_attend(
        qf, cache["k"], cache["v"], cache.get("ke"), cache.get("ve"),
        qs.to(torch.int32).reshape(b, 1).contiguous(),
        valid.to(torch.int32).reshape(b, 1).contiguous(),
        _win_arg(window, q.device), fmt=fmt, **plan,
    )
    return out.reshape(b, s, cfg.n_heads * hd)


def _flash_self_path(q, k, v, window, cfg):
    """In-chunk self-attention tail through the flash kernel: the chunk's
    own just-projected K/V stand in for a kv_bf16 cache, positions are
    chunk-relative, the fill level is the whole chunk."""
    from repro_torch.kernels.flash_prefill import flash_attend

    b, s = q.shape[0], q.shape[1]
    hd, kh = cfg.hd(), cfg.n_kv_heads
    g = cfg.n_heads // kh
    qf = q.reshape(b, s, kh, g, hd).to(torch.float32).contiguous()
    out = flash_attend(
        qf, k.contiguous(), v.contiguous(), None, None,
        torch.zeros((b, 1), dtype=torch.int32, device=q.device),
        torch.full((b, 1), k.shape[1], dtype=torch.int32, device=q.device),
        _win_arg(window, q.device), fmt="kv_bf16",
    )
    return out.reshape(b, s, cfg.n_heads * hd)


def attention(
    p: dict, x: torch.Tensor, positions: torch.Tensor, cfg, ctx: QuantCtx, path: str,  # (S,) | (B,S) | (3,B,S)
    *, causal: bool = True, window: Optional[int] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None, cache_index=None,
    chunk: int = 1024, attend_cache: bool = False, rope: bool = True,
    kv_src: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (output (B,S,d), the cache written in place, or None).

    ``attend_cache`` makes an S > 1 chunk attend over the WHOLE cache after
    its K/V are written at ``cache_index``, so earlier chunks of the same
    prompt stay visible (chunked prefill).  ``kv_src`` (B, T, d) is a
    cross-attention source: K and V project it, and no RoPE applies, as
    with ``rope=False``.  On a mesh whose cache holds the rank's kv heads
    (``models/spmd.py``) q / k / v are the rank's heads and the head
    outputs are all-gathered before ``wo``."""
    state = spmd.active()
    heads_local = state is not None and state.heads_local
    if heads_local:
        cfg = spmd.local_cfg(cfg, state)
    hd = cfg.hd()
    g = cfg.n_heads // cfg.n_kv_heads
    src = x if kv_src is None else kv_src

    def wo(out):
        if heads_local:
            out = spmd.gather_model(out, state)
        return dense(p["wo"], out, f"{path}/wo", ctx)

    q = _split_heads(dense(p["wq"], x, f"{path}/wq", ctx, local_out=heads_local), cfg.n_heads)
    k = _split_heads(dense(p["wk"], src, f"{path}/wk", ctx, local_out=heads_local), cfg.n_kv_heads)
    v = _split_heads(dense(p["wv"], src, f"{path}/wv", ctx, local_out=heads_local), cfg.n_kv_heads)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if not rope or kv_src is not None:
        q_pos = positions
    elif cfg.mrope:
        q = layers.apply_mrope(q, positions, cfg.rope_theta)
        k = layers.apply_mrope(k, positions, cfg.rope_theta)
        q_pos = positions[0]  # the temporal component orders causality (ROADMAP Queue C13)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        q_pos = positions

    decode = cache is not None and (x.shape[1] == 1 or attend_cache)
    if cache is not None:
        fmt = kv_cache.resolve_kv_fmt(cfg)
        cache, valid = kv_cache.write(fmt, cache, k, v, cache_index)

    if decode:
        flash = cfg.flash_decode if x.shape[1] == 1 else cfg.flash_prefill and causal
        if flash:
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
        return wo(out), cache

    if cache is not None and x.shape[1] > 1 and causal and kv_src is None and cfg.flash_prefill:
        out = _flash_self_path(q, k, v, window, cfg).to(x.dtype)
        return wo(out), cache
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    t = k.shape[1]
    if t > chunk:
        out = _attend_chunked(q, k, v, q_pos, causal, window, chunk)
    elif causal or window is not None:
        bias = _mask_bias(q_pos, torch.arange(t, device=x.device), causal, window)
        bias = bias[None] if bias.ndim == 2 else bias[:, None]
        out = _attend_dense_mha(q, k, v, bias)
    else:
        out = _attend_dense_mha(q, k, v, torch.zeros((), dtype=torch.float32, device=x.device))
    out = out.reshape(*x.shape[:2], cfg.n_heads * hd).to(x.dtype)
    return wo(out), cache
