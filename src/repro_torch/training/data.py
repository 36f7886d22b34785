"""Synthetic, deterministic batches (counterpart of
``repro/training/data.py``).

A batch is a pure function of (seed, step, arch): every data-parallel rank
rebuilds its shard alone, and a restart resumes mid-run from the step
counter (a checkpoint stores just ``step``).  The tokens follow a Zipf-like
marginal (a squared uniform) with induced sequential structure: with
probability ``structure`` the next token is ``(tok * 31 + 7) % vocab``, so
cross-entropy training has signal to learn (the paper's Sec. 4 retraining).

The draws come from a CPU ``torch.Generator`` seeded from (seed, step), so
the card and the CPU train on the same batches; the tensors are then moved
to ``device``.  The reference draws with ``jax.random``, whose bits the port
cannot reproduce: tests that compare the two feed both the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import vlm


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128
    structure: float = 0.8  # P(next token derived from the current one)


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((int(seed) * 1_000_003 + int(step)) % (2**63))


def structured_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int, structure: float) -> torch.Tensor:
    """(batch, seq + 1) int32 tokens: a squared-uniform marginal, each token
    after the first replaced by ``(prev * 31 + 7) % vocab`` with
    probability ``structure``."""
    u = torch.rand((batch, seq + 1), generator=gen)
    base = (u * u * vocab).to(torch.int32)
    follow = torch.rand((batch, seq + 1), generator=gen) < structure
    toks = base.clone()
    for t in range(1, seq + 1):
        toks[:, t] = torch.where(follow[:, t], (toks[:, t - 1] * 31 + 7) % vocab, base[:, t])
    return toks


def make_batch(cfg, data: DataConfig, step: int, device="cpu") -> Dict[str, Any]:
    """The batch of ``step``: tokens and next-token labels (B, S); an
    enc-dec model's ``frames`` (B, n_audio_frames, d_model); a VLM's
    ``vision_embeds`` (B, n_frontend_tokens, d_model) and M-RoPE
    ``positions`` (3, B, n_vis + S)."""
    gen = _generator(data.seed, step)
    toks = structured_tokens(gen, data.batch, data.seq, cfg.vocab, data.structure)
    out: Dict[str, Any] = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        out["frames"] = (torch.randn((data.batch, cfg.n_audio_frames, cfg.d_model), generator=gen) * 0.1).to(dtype)
    if cfg.family == "vlm":
        nv = cfg.n_frontend_tokens
        out["vision_embeds"] = (torch.randn((data.batch, nv, cfg.d_model), generator=gen) * 0.1).to(dtype)
        out["positions"] = vlm.build_mrope_positions(data.batch, nv, data.seq)
    return {k: v.contiguous().to(device) for k, v in out.items()}


def shard_for_rank(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """One data-parallel rank's slice of a global batch (the leading axis,
    where it divides by ``world``)."""

    def sl(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] % world == 0:
            per = x.shape[0] // world
            return x[rank * per:(rank + 1) * per]
        return x

    return {k: sl(v) for k, v in batch.items()}
