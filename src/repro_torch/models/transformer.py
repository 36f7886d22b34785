"""Decoder-only LM of the dense, MoE and VLM families (counterpart of
``repro/models/transformer.py``).  A block's MLP is ``models/moe.py``'s
layer where the config has experts; under ``cfg.mrope`` (qwen2-vl)
positions are (3, B, S) and ``extra_embeds`` (patch embeddings) are
prepended after the token embedding (``models/vlm.py``).

The reference stacks layers on a leading axis and scans; the port keeps
``params["blocks"]`` as a list of per-layer dicts and loops in Python,
each block recomputed in the backward pass under ``cfg.remat``.  The
KV cache keeps the reference's stacked (L, B, T, ...) leaves; layer i
works on the contiguous view ``cache[n][i]``, written in place.

On a mesh (``models/spmd.py``) the block's activations stay replicated
within the model group: the sites, the embedding, attention and the MoE
layer place their collectives themselves, so this file runs unchanged.

Serving entry points: ``prefill`` (a whole prompt at positions [0, S)),
``prefill_chunk`` (one chunk at [start, start + S) attending over the whole
cache, so earlier chunks stay visible) and ``decode_step`` (one token per
batch row, at a shared or a per-row position).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import kv_cache, layers, moe
from repro_torch.quant.plan import QuantCtx


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def window_schedule(cfg, seq_len: int) -> Optional[torch.Tensor]:
    """Per-layer attention window (int32); None when the arch has no local
    layers (qwen3)."""
    if not cfg.sliding_window:
        return None
    ratio = cfg.local_global_ratio
    win = [seq_len + 1 if ratio and (i + 1) % (ratio + 1) == 0 else cfg.sliding_window
           for i in range(cfg.n_layers)]
    return torch.tensor(win, dtype=torch.int32)


def init_block(gen, cfg, dtype, device, leaf=layers.keep) -> Dict[str, Any]:
    p = {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device, "blocks/ln1", leaf),
        "attn": attn_lib.init_attention(gen, cfg, dtype, device, "blocks/attn", leaf),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device, "blocks/ln2", leaf),
    }
    if cfg.n_experts:
        p["moe"] = moe.init_moe(gen, cfg, dtype, device, "blocks/moe", leaf)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, "blocks/mlp", leaf)
    return p


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


def _block_apply(bp, x, positions, cfg, ctx: QuantCtx, window=None, cache=None, cache_index=None,
                 attend_cache=False):
    h = layers.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    a, cache = attn_lib.attention(
        bp["attn"], h, positions, cfg, ctx, "blocks/attn", causal=True, window=window,
        cache=cache, cache_index=cache_index, attend_cache=attend_cache,
    )
    x = x + a
    h = layers.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if cfg.n_experts:
        return x + moe.moe_layer(bp["moe"], h, "blocks/moe", cfg, ctx), cache
    return x + layers.mlp(bp["mlp"], h, "blocks/mlp", ctx), cache


def _block_x(bp, x, positions, cfg, ctx: QuantCtx, window):
    return _block_apply(bp, x, positions, cfg, ctx, window)[0]


def _embed(params, tokens, extra_embeds=None) -> torch.Tensor:
    """Token embeddings, with ``extra_embeds`` (B, n_vis, d) prepended."""
    x = layers.embed(params["embed"], tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def hidden(params, tokens: torch.Tensor, cfg, ctx: QuantCtx, positions: Optional[torch.Tensor] = None,
           extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = _embed(params, tokens, extra_embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    win = window_schedule(cfg, x.shape[1])
    for i, bp in enumerate(params["blocks"]):
        x = layers.maybe_remat(cfg.remat, _block_x, bp, x, positions, cfg, ctx, None if win is None else int(win[i]))
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, tokens, cfg, ctx: QuantCtx, positions=None, extra_embeds=None):
    x = hidden(params, tokens, cfg, ctx, positions, extra_embeds)
    return layers.dense(params["lm_head"], x, "lm_head", ctx)


def loss_fn(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    """Mean token cross entropy of ``batch`` {tokens, labels[, positions,
    extra_embeds]}; with prepended embeddings (a VLM) the loss is on the
    text tail only."""
    x = hidden(params, batch["tokens"], cfg, ctx, positions=batch.get("positions"),
               extra_embeds=batch.get("extra_embeds"))
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:
        x = x[:, -labels.shape[1]:]
    return layers.lm_head_loss(params["lm_head"], x, labels, cfg.vocab, "lm_head", ctx)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    """kv leaves stacked (L, B, T, ...), bf16 even for a float32 model."""
    return kv_cache.init_cache(cfg, (cfg.n_layers, batch), max_len, dtype, device)


def _cache_layers(params, x, positions, cfg, ctx, cache, cache_index, attend_cache=False):
    """Every block over its layer of the cache (written in place)."""
    win = window_schedule(cfg, cache["k"].shape[2])
    for i, bp in enumerate(params["blocks"]):
        layer_cache = {n: leaf[i] for n, leaf in cache.items()}
        x, _ = _block_apply(bp, x, positions, cfg, ctx, None if win is None else int(win[i]),
                            cache=layer_cache, cache_index=cache_index, attend_cache=attend_cache)
    return x


def prefill(params, tokens: torch.Tensor, cfg, ctx: QuantCtx, cache, extra_embeds=None, positions=None):
    """Fill the cache with S tokens (after ``extra_embeds``, if any) at [0,
    S) under ``positions`` (default: 0..S-1); returns (last-token logits,
    cache)."""
    x = _embed(params, tokens, extra_embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x = _cache_layers(params, x, positions, cfg, ctx, cache, 0)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return layers.dense(params["lm_head"], x, "lm_head", ctx), cache


def prefill_chunk(params, tokens: torch.Tensor, start: int, cfg, ctx: QuantCtx, cache):
    """Consume one (B, S) chunk of a prompt at cache positions [start,
    start + S), attending over the WHOLE cache (earlier chunks of the same
    prompt stay visible).  Returns (last-token logits, cache); only the
    final chunk's logits matter to a caller sampling the first token."""
    start = int(start)
    x = layers.embed(params["embed"], tokens)
    positions = start + torch.arange(x.shape[1], device=x.device)
    if cfg.mrope:  # a text-only serving prompt: all three components temporal
        positions = positions.expand(3, tokens.shape[0], x.shape[1])
    x = _cache_layers(params, x, positions, cfg, ctx, cache, start, attend_cache=True)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return layers.dense(params["lm_head"], x, "lm_head", ctx), cache


def decode_step(params, token: torch.Tensor, pos, cfg, ctx: QuantCtx, cache):
    """One decode step.  token (B, 1) int; pos a scalar or per-slot (B,)."""
    x = layers.embed(params["embed"], token)
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos[:, None].to(torch.int32)
    else:
        positions = torch.full((token.shape[0], 1), int(pos), dtype=torch.int32, device=x.device)
    if cfg.mrope:
        positions = positions.expand(3, *positions.shape)
    x = _cache_layers(params, x, positions, cfg, ctx, cache, pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.dense(params["lm_head"], x, "lm_head", ctx), cache
