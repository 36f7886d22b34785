"""Whisper-style encoder-decoder, the audio family (counterpart of
``repro/models/encdec.py``).

The conv frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings (``frames``, (B, n_frames, d_model)).  The
encoder is non-causal self-attention blocks with LayerNorm and a GELU MLP
(with biases); the decoder is causal self-attention over its KV cache,
cross-attention over the encoder output, and the same MLP.  Neither side
has RoPE: the encoder adds a learned position table, the decoder a
448-row one that ``_pos_embed`` reads modulo its length.

``enc_blocks`` and ``dec_blocks`` are lists of per-layer dicts (stacked on
disk as the reference stacks them).  The decode cache holds the decoder's
KV leaves (the registered kv formats, (L, B, T, ...)) and ``enc_out`` (B,
n_audio_frames, d) at the cache dtype; cross-attention re-projects K / V
from ``enc_out`` at every step (no cross cache), as the reference does.
``init_cache`` leaves ``enc_out`` zero and only ``prefill`` (frames and
tokens) fills it, so the serving engines, which call ``decode`` and
``insert`` alone, decode against zero frames, as the reference's do
(ROADMAP Queue C14).

Call paths of ``dense`` are ``enc/attn/wq``, ``dec/self_attn/wq``,
``dec/cross_attn/wk``, ``enc/mlp/up`` ..., while a plan compiled over the
parameters is keyed ``enc_blocks/attn/wq`` ...: such a call path misses the
plan's table and resolves through the policy's rules, and a calibrated
exponent is keyed by the call path -- the reference's behaviour, kept.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.fused_qmm import activation_fn
from repro_torch.models import attention as attn_lib
from repro_torch.models import kv_cache, layers
from repro_torch.models.layers import dense
from repro_torch.quant.plan import QuantCtx

DEC_POSITIONS = 448  # rows of the decoder's position table
KV_LEAF_NAMES = ("k", "v", "ke", "ve")
_gelu = activation_fn("gelu")  # jax.nn.gelu's default, the tanh approximation


def _init_gelu_mlp(gen, d, ff, dtype, device, path, leaf):
    return {"up": layers.init_dense(gen, d, ff, True, dtype, device, f"{path}/up", leaf),
            "down": layers.init_dense(gen, ff, d, True, dtype, device, f"{path}/down", leaf)}


def _gelu_mlp(p, x, path, ctx):
    return dense(p["down"], _gelu(dense(p["up"], x, f"{path}/up", ctx)), f"{path}/down", ctx)


def _init_enc_block(gen, cfg, dtype, device, leaf):
    d, s = cfg.d_model, "enc_blocks"
    return {
        "ln1": layers.init_layernorm(d, dtype, device, f"{s}/ln1", leaf),
        "attn": attn_lib.init_attention(gen, cfg, dtype, device, f"{s}/attn", leaf),
        "ln2": layers.init_layernorm(d, dtype, device, f"{s}/ln2", leaf),
        "mlp": _init_gelu_mlp(gen, d, cfg.d_ff, dtype, device, f"{s}/mlp", leaf),
    }


def _init_dec_block(gen, cfg, dtype, device, leaf):
    d, s = cfg.d_model, "dec_blocks"
    return {
        "ln1": layers.init_layernorm(d, dtype, device, f"{s}/ln1", leaf),
        "self_attn": attn_lib.init_attention(gen, cfg, dtype, device, f"{s}/self_attn", leaf),
        "ln2": layers.init_layernorm(d, dtype, device, f"{s}/ln2", leaf),
        "cross_attn": attn_lib.init_attention(gen, cfg, dtype, device, f"{s}/cross_attn", leaf),
        "ln3": layers.init_layernorm(d, dtype, device, f"{s}/ln3", leaf),
        "mlp": _init_gelu_mlp(gen, d, cfg.d_ff, dtype, device, f"{s}/mlp", leaf),
    }


def init_encdec(gen: torch.Generator, cfg, device, leaf=layers.keep) -> Dict[str, Any]:
    """Random parameters from ``gen``; each leaf passes through ``leaf`` as
    soon as it exists."""
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model

    def table(name, rows):
        return leaf("", name, (layers._randn(gen, (rows, d), device) * 0.01).to(dtype))

    return {
        "enc_pos": table("enc_pos", cfg.n_audio_frames),
        "enc_blocks": [_init_enc_block(gen, cfg, dtype, device, leaf) for _ in range(cfg.n_enc_layers)],
        "enc_norm": layers.init_layernorm(d, dtype, device, "enc_norm", leaf),
        "embed": layers.init_embedding(gen, cfg.padded_vocab, d, dtype, device, "embed", leaf),
        "dec_pos": table("dec_pos", DEC_POSITIONS),
        "dec_blocks": [_init_dec_block(gen, cfg, dtype, device, leaf) for _ in range(cfg.n_layers)],
        "dec_norm": layers.init_layernorm(d, dtype, device, "dec_norm", leaf),
        "lm_head": layers.init_dense(gen, d, cfg.padded_vocab, False, dtype, device, "lm_head", leaf),
    }


def encode(params, frames: torch.Tensor, cfg, ctx: QuantCtx) -> torch.Tensor:
    """frames (B, n_frames, d_model), precomputed embeddings (the stub
    frontend) -> the encoder output (B, n_frames, d_model)."""
    x = frames + params["enc_pos"][None, :frames.shape[1]]
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in params["enc_blocks"]:
        x = layers.maybe_remat(cfg.remat, _enc_block, bp, x, positions, cfg, ctx)
    return layers.layernorm(params["enc_norm"], x)


def _enc_block(bp, x, positions, cfg, ctx: QuantCtx) -> torch.Tensor:
    a, _ = attn_lib.attention(bp["attn"], layers.layernorm(bp["ln1"], x), positions, cfg, ctx, "enc/attn",
                              causal=False, rope=False)
    x = x + a
    return x + _gelu_mlp(bp["mlp"], layers.layernorm(bp["ln2"], x), "enc/mlp", ctx)


def _dec_block(bp, x, enc_out, positions, cfg, ctx, cache=None, cache_index=None):
    a, cache = attn_lib.attention(bp["self_attn"], layers.layernorm(bp["ln1"], x), positions, cfg, ctx,
                                  "dec/self_attn", causal=True, rope=False, cache=cache, cache_index=cache_index)
    x = x + a
    c, _ = attn_lib.attention(bp["cross_attn"], layers.layernorm(bp["ln2"], x), positions, cfg, ctx,
                              "dec/cross_attn", causal=False, rope=False, kv_src=enc_out)
    x = x + c
    return x + _gelu_mlp(bp["mlp"], layers.layernorm(bp["ln3"], x), "dec/mlp", ctx), cache


def _pos_embed(table: torch.Tensor, start, length: int) -> torch.Tensor:
    """Rows [start, start + length) of the table, modulo its length: (L, d)
    for a scalar start, (B, L, d) for per-slot starts (B,)."""
    ar = torch.arange(length, device=table.device)
    if torch.is_tensor(start) and start.ndim == 1:
        idx = (start[:, None].to(ar.device) + ar) % table.shape[0]
    else:
        idx = (int(start) + ar) % table.shape[0]
    return table[idx]


def _dec_input(params, tokens: torch.Tensor) -> torch.Tensor:
    s = tokens.shape[1]
    return layers.embed(params["embed"], tokens) + _pos_embed(params["dec_pos"], 0, s)[None]


def hidden(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    """The training path: batch {frames, tokens} -> the decoder's final
    hidden states (B, S, d)."""
    enc_out = encode(params, batch["frames"], cfg, ctx)
    x = _dec_input(params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in params["dec_blocks"]:
        x = layers.maybe_remat(cfg.remat, _dec_block_x, bp, x, enc_out, positions, cfg, ctx)
    return layers.layernorm(params["dec_norm"], x)


def _dec_block_x(bp, x, enc_out, positions, cfg, ctx: QuantCtx) -> torch.Tensor:
    return _dec_block(bp, x, enc_out, positions, cfg, ctx)[0]


def forward(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    return dense(params["lm_head"], hidden(params, batch, cfg, ctx), "lm_head", ctx)


def loss_fn(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    x = hidden(params, batch, cfg, ctx)
    return layers.lm_head_loss(params["lm_head"], x, batch["labels"], cfg.vocab, "lm_head", ctx)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    """The decoder's self-attention KV through the registered formats
    (stacked (L, B, T, ...)) and a zero ``enc_out`` (B, n_audio_frames, d)
    at ``dtype``; cross-attention reads ``enc_out`` densely."""
    cache = kv_cache.init_cache(cfg, (cfg.n_layers, batch), max_len, dtype, device)
    cache["enc_out"] = torch.zeros((batch, cfg.n_audio_frames, cfg.d_model), dtype=dtype, device=device)
    return cache


def _dec_layers(params, x, enc_out, positions, cfg, ctx, cache, cache_index):
    """Every decoder block over its layer of the KV cache (written in place)."""
    kv = [n for n in KV_LEAF_NAMES if n in cache]
    for i, bp in enumerate(params["dec_blocks"]):
        x, _ = _dec_block(bp, x, enc_out, positions, cfg, ctx, {n: cache[n][i] for n in kv}, cache_index)
    return x


def prefill(params, batch, cfg, ctx: QuantCtx, cache):
    """The audio path: encode ``frames`` into the cache's ``enc_out`` (at
    the cache dtype), then the decoder prompt ``tokens`` at [0, S); returns
    (last-token logits, cache)."""
    enc_out = encode(params, batch["frames"], cfg, ctx).to(cache["enc_out"].dtype)
    cache["enc_out"] = enc_out
    x = _dec_input(params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    x = _dec_layers(params, x, enc_out, positions, cfg, ctx, cache, 0)
    x = layers.layernorm(params["dec_norm"], x[:, -1:])
    return dense(params["lm_head"], x, "lm_head", ctx), cache


def decode_step(params, token: torch.Tensor, pos, cfg, ctx: QuantCtx, cache):
    """One decode step against the cache's ``enc_out``.  token (B, 1) int;
    pos a scalar or per-slot (B,)."""
    pe = _pos_embed(params["dec_pos"], pos, 1)
    if pe.ndim == 2:  # a scalar position: add the batch axis
        pe = pe[None]
    x = layers.embed(params["embed"], token) + pe
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos[:, None].to(torch.int32)
    else:
        positions = torch.full((token.shape[0], 1), int(pos), dtype=torch.int32, device=x.device)
    x = _dec_layers(params, x, cache["enc_out"], positions, cfg, ctx, cache, pos)
    x = layers.layernorm(params["dec_norm"], x)
    return dense(params["lm_head"], x, "lm_head", ctx), cache
