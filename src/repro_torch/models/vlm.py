"""Qwen2-VL-style VLM (counterpart of ``repro/models/vlm.py``): the
decoder of ``models/transformer.py`` under M-RoPE.  The vision frontend is
a stub, as in the reference: a batch carries precomputed patch embeddings
(``vision_embeds``, (B, n_vis, d)), prepended to the text tokens, and
(3, B, S) position ids from ``build_mrope_positions``.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.quant.plan import QuantCtx


def build_mrope_positions(batch: int, n_vis: int, n_text: int, grid: int = 0, device="cpu") -> torch.Tensor:
    """(3, B, S) int32 position ids: vision tokens get (t=0, h, w) grid
    coordinates, text tokens advance all three components from 1."""
    if grid <= 0:
        grid = max(1, int(n_vis**0.5))
    text = 1 + torch.arange(n_text, dtype=torch.int32, device=device)
    idx = torch.arange(n_vis, dtype=torch.int32, device=device)
    t = torch.cat([torch.zeros(n_vis, dtype=torch.int32, device=device), text])
    h = torch.cat([idx // grid, text])
    w = torch.cat([idx % grid, text])
    return torch.stack([t, h, w])[:, None, :].expand(3, batch, n_vis + n_text)


def forward(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    return transformer.forward(params, batch["tokens"], cfg, ctx, positions=batch["positions"],
                               extra_embeds=batch["vision_embeds"])


def loss_fn(params, batch, cfg, ctx: QuantCtx) -> torch.Tensor:
    """The loss on the text tail, after the patch embeddings."""
    return transformer.loss_fn(params, {"tokens": batch["tokens"], "labels": batch["labels"],
                                        "positions": batch["positions"], "extra_embeds": batch["vision_embeds"]},
                               cfg, ctx)


def prefill(params, batch, cfg, ctx: QuantCtx, cache):
    """Fill the cache with the patch embeddings and the text tokens at
    [0, n_vis + S) under the batch's M-RoPE positions; returns (last-token
    logits, cache)."""
    return transformer.prefill(params, batch["tokens"], cfg, ctx, cache, extra_embeds=batch["vision_embeds"],
                               positions=batch["positions"])
