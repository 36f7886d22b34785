"""Decoder-only LM, dense family (counterpart of
``repro/models/transformer.py``; global attention only -- sliding-window
layers, MoE and M-RoPE come with their families).

The reference stacks layers on a leading axis and scans; the port keeps
``params["blocks"]`` as a list of per-layer dicts and loops in Python.  The
KV cache keeps the reference's stacked (L, B, T, Kh, hd) leaves; layer i
works on the contiguous view ``cache[n][i]``, written in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import kv_cache, layers
from repro_torch.quant.plan import QuantCtx


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_block(gen, cfg, dtype, device, leaf=layers.keep) -> Dict[str, Any]:
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device, "blocks/ln1", leaf),
        "attn": attn_lib.init_attention(gen, cfg, dtype, device, "blocks/attn", leaf),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device, "blocks/ln2", leaf),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, "blocks/mlp", leaf),
    }


def init_lm(gen: torch.Generator, cfg, device, leaf=layers.keep) -> Dict[str, Any]:
    """Random parameters from ``gen``.  Each leaf passes through ``leaf``
    as soon as it exists (``model_zoo.init_quantized`` quantizes there)."""
    dtype = _dtype(cfg)
    return {
        "embed": layers.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype, device, "embed", leaf),
        "blocks": [init_block(gen, cfg, dtype, device, leaf) for _ in range(cfg.n_layers)],
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, device, "final_norm", leaf),
        "lm_head": layers.init_dense(gen, cfg.d_model, cfg.padded_vocab, False, dtype, device, "lm_head", leaf),
    }


def _block_apply(bp, x, positions, cfg, ctx: QuantCtx, cache=None, cache_index=None):
    h = layers.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    a, cache = attn_lib.attention(
        bp["attn"], h, positions, cfg, ctx, "blocks/attn", causal=True,
        cache=cache, cache_index=cache_index,
    )
    x = x + a
    h = layers.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + layers.mlp(bp["mlp"], h, "blocks/mlp", ctx), cache


def hidden(params, tokens: torch.Tensor, cfg, ctx: QuantCtx,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = layers.embed(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    for bp in params["blocks"]:
        x, _ = _block_apply(bp, x, positions, cfg, ctx)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, tokens, cfg, ctx: QuantCtx, positions=None):
    x = hidden(params, tokens, cfg, ctx, positions)
    return layers.dense(params["lm_head"], x, "lm_head", ctx)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    """kv leaves stacked (L, B, T, ...), bf16 even for a float32 model."""
    return kv_cache.init_cache(cfg, (cfg.n_layers, batch), max_len, dtype, device)


def decode_step(params, token: torch.Tensor, pos, cfg, ctx: QuantCtx, cache):
    """One decode step.  token (B, 1) int; pos a scalar or per-slot (B,)."""
    x = layers.embed(params["embed"], token)
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos[:, None].to(torch.int32)
    else:
        positions = torch.full((token.shape[0], 1), int(pos), dtype=torch.int32, device=x.device)
    for i, bp in enumerate(params["blocks"]):
        layer_cache = {n: leaf[i] for n, leaf in cache.items()}
        x, _ = _block_apply(bp, x, positions, cfg, ctx, cache=layer_cache, cache_index=pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.dense(params["lm_head"], x, "lm_head", ctx), cache
