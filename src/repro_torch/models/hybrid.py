"""Zamba2-style hybrid: a Mamba2 backbone with shared attention blocks
(counterpart of ``repro/models/hybrid.py``).

``plan(cfg)`` = (n_super, P, tail): n_layers = n_super * P + tail Mamba2
blocks; after every P-th one, shared transformer block ``j % n_shared``
runs with its OWN KV history but shared weights (zamba2's parameter
sharing).  ``mamba_stack`` (n_super * P), ``tail_stack`` (tail) and
``shared`` (n_shared) are lists of per-layer dicts, stacked on their layer
axis on disk as the reference stacks them.

The decode state: ``ssm`` and ``ssm_tail`` (float32 SSM states stacked
(layers, B, ...)) and one KV cache per superblock through the registered
kv formats (``k``, ``v`` and, quantized, ``ke``, ``ve``: (n_super, B, T,
...)).  Decode takes a shared or a per-slot position, which reaches the
shared block's KV write and its flash decode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import kv_cache, layers, ssm
from repro_torch.models.ssm_lm import stacked_state, step_layer
from repro_torch.quant.plan import QuantCtx


def plan(cfg) -> Tuple[int, int, int]:
    p = cfg.shared_attn_period or 6
    n_super = cfg.n_layers // p
    return n_super, p, cfg.n_layers - n_super * p


def init_hybrid(gen: torch.Generator, cfg, device, leaf=layers.keep) -> Dict[str, Any]:
    dtype = getattr(torch, cfg.dtype)
    n_super, p, tail = plan(cfg)

    def mamba_block(stack):
        return {"norm": layers.init_rmsnorm(cfg.d_model, dtype, device, f"{stack}/norm", leaf),
                "mamba": ssm.init_mamba(gen, cfg, dtype, device, f"{stack}/mamba", leaf)}

    def shared_block():
        return {
            "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device, "shared/ln1", leaf),
            "attn": attn_lib.init_attention(gen, cfg, dtype, device, "shared/attn", leaf),
            "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device, "shared/ln2", leaf),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, "shared/mlp", leaf),
        }

    params = {
        "embed": layers.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype, device, "embed", leaf),
        "mamba_stack": [mamba_block("mamba_stack") for _ in range(n_super * p)],
        "shared": [shared_block() for _ in range(cfg.n_shared_blocks)],
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, device, "final_norm", leaf),
        "lm_head": layers.init_dense(gen, cfg.d_model, cfg.padded_vocab, False, dtype, device, "lm_head", leaf),
    }
    if tail:
        params["tail_stack"] = [mamba_block("tail_stack") for _ in range(tail)]
    return params


def _select_shared(shared, idx: int):
    """Superblock ``idx`` alternates over the shared blocks."""
    return shared[idx % len(shared)]


def _mamba_block(bp, x, cfg, ctx):
    return x + ssm.mamba2_seq(bp["mamba"], layers.rmsnorm(bp["norm"], x, cfg.norm_eps), cfg, ctx, "mamba")


def _shared_block(sp, x, positions, cfg, ctx, cache=None, cache_index=None):
    h = layers.rmsnorm(sp["ln1"], x, cfg.norm_eps)
    a, cache = attn_lib.attention(sp["attn"], h, positions, cfg, ctx, "shared/attn", causal=True, cache=cache,
                                  cache_index=cache_index)
    x = x + a
    h = layers.rmsnorm(sp["ln2"], x, cfg.norm_eps)
    return x + layers.mlp(sp["mlp"], h, "shared/mlp", ctx), cache


def hidden(params, tokens: torch.Tensor, cfg, ctx: QuantCtx, positions: Optional[torch.Tensor] = None):
    n_super, p, _ = plan(cfg)
    x = layers.embed(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    for j in range(n_super):
        for bp in params["mamba_stack"][j * p:(j + 1) * p]:
            x = layers.maybe_remat(cfg.remat, _mamba_block, bp, x, cfg, ctx)
        x, _ = _shared_block(_select_shared(params["shared"], j), x, positions, cfg, ctx)
    for bp in params.get("tail_stack", []):
        x = layers.maybe_remat(cfg.remat, _mamba_block, bp, x, cfg, ctx)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, tokens, cfg, ctx: QuantCtx, positions=None) -> torch.Tensor:
    return layers.dense(params["lm_head"], hidden(params, tokens, cfg, ctx, positions), "lm_head", ctx)


def loss_fn(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    """Mean token cross entropy of ``batch`` {tokens, labels}."""
    x = hidden(params, batch["tokens"], cfg, ctx)
    return layers.lm_head_loss(params["lm_head"], x, batch["labels"], cfg.vocab, "lm_head", ctx)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    """SSM states per Mamba2 layer, plus a KV cache per superblock in the
    config's kv format (bf16 K/V even for a float32 model)."""
    n_super, p, tail = plan(cfg)
    cache = {"ssm": stacked_state(cfg, n_super * p, batch, device)}
    cache.update(kv_cache.init_cache(cfg, (n_super, batch), max_len, dtype, device))
    if tail:
        cache["ssm_tail"] = stacked_state(cfg, tail, batch, device)
    return cache


def decode_step(params, token: torch.Tensor, pos, cfg, ctx: QuantCtx, cache):
    """One decode step.  token (B, 1) int; pos a scalar or per-slot (B,)."""
    n_super, p, _ = plan(cfg)
    x = layers.embed(params["embed"], token)
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos[:, None].to(torch.int32)
    else:
        positions = torch.full((token.shape[0], 1), int(pos), dtype=torch.int32, device=x.device)
    kv_names = [n for n in ("k", "v", "ke", "ve") if n in cache]
    for j in range(n_super):
        for i in range(j * p, (j + 1) * p):
            x = step_layer(ssm.mamba2_step, params["mamba_stack"][i], x, cache["ssm"], i, cfg, ctx)
        kv = {n: cache[n][j] for n in kv_names}
        x, _ = _shared_block(_select_shared(params["shared"], j), x, positions, cfg, ctx, kv, pos)
    for i, bp in enumerate(params.get("tail_stack", [])):
        x = step_layer(ssm.mamba2_step, bp, x, cache["ssm_tail"], i, cfg, ctx)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.dense(params["lm_head"], x, "lm_head", ctx), cache
