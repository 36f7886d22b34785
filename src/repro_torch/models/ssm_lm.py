"""Attention-free Mamba1 LM, the falcon-mamba family (counterpart of
``repro/models/ssm_lm.py``).  ``params["blocks"]`` is a list of per-layer
``{"norm", "mamba"}`` dicts; the decode state is ``{"ssm": {"h", "conv"}}``
with float32 leaves stacked (L, B, ...), written in place layer by layer.
The state is O(1) in context length and carries position implicitly, so
there is no prefill graph: the engines prefill a token at a time.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers, ssm
from repro_torch.quant.plan import QuantCtx


def init_ssm_lm(gen: torch.Generator, cfg, device, leaf=layers.keep) -> Dict[str, Any]:
    dtype = getattr(torch, cfg.dtype)

    def block():
        return {"norm": layers.init_rmsnorm(cfg.d_model, dtype, device, "blocks/norm", leaf),
                "mamba": ssm.init_mamba(gen, cfg, dtype, device, "blocks/mamba", leaf)}

    return {
        "embed": layers.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype, device, "embed", leaf),
        "blocks": [block() for _ in range(cfg.n_layers)],
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, device, "final_norm", leaf),
        "lm_head": layers.init_dense(gen, cfg.d_model, cfg.padded_vocab, False, dtype, device, "lm_head", leaf),
    }


def _block(bp, x, cfg, ctx: QuantCtx) -> torch.Tensor:
    return x + ssm.mamba1_seq(bp["mamba"], layers.rmsnorm(bp["norm"], x, cfg.norm_eps), cfg, ctx, "mamba")


def hidden(params, tokens: torch.Tensor, cfg, ctx: QuantCtx) -> torch.Tensor:
    x = layers.embed(params["embed"], tokens)
    for bp in params["blocks"]:
        x = layers.maybe_remat(cfg.remat, _block, bp, x, cfg, ctx)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, tokens, cfg, ctx: QuantCtx) -> torch.Tensor:
    return layers.dense(params["lm_head"], hidden(params, tokens, cfg, ctx), "lm_head", ctx)


def loss_fn(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    """Mean token cross entropy of ``batch`` {tokens, labels}."""
    x = hidden(params, batch["tokens"], cfg, ctx)
    return layers.lm_head_loss(params["lm_head"], x, batch["labels"], cfg.vocab, "lm_head", ctx)


def stacked_state(cfg, n: int, batch: int, device) -> Dict[str, torch.Tensor]:
    """Zeroed SSM states of ``n`` layers, each leaf (n, B, ...)."""
    return {name: torch.zeros((n, *leaf.shape), dtype=leaf.dtype, device=device)
            for name, leaf in ssm.init_ssm_state(cfg, batch, device).items()}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    """``max_len`` and ``dtype`` are unused: the state is O(1) in context
    length and float32."""
    return {"ssm": stacked_state(cfg, cfg.n_layers, batch, device)}


def step_layer(step, bp, x, states, i, cfg, ctx):
    """One residual Mamba block at decode over layer ``i`` of the stacked
    ``states``, which take the new state in place."""
    out, new = step(bp["mamba"], layers.rmsnorm(bp["norm"], x, cfg.norm_eps),
                    {n: leaf[i] for n, leaf in states.items()}, cfg, ctx, "mamba")
    for n, leaf in states.items():
        leaf[i] = new[n]
    return x + out


def decode_step(params, token: torch.Tensor, pos, cfg, ctx: QuantCtx, cache):
    """One decode step; ``pos`` is unused (the state carries position)."""
    x = layers.embed(params["embed"], token)
    for i, bp in enumerate(params["blocks"]):
        x = step_layer(ssm.mamba1_step, bp, x, cache["ssm"], i, cfg, ctx)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.dense(params["lm_head"], x, "lm_head", ctx), cache
