"""Token samplers (counterpart of ``repro/serving/sampler.py``).  Greedy is
bit-for-bit the reference's argmax; sampled decoding draws from a
``torch.Generator`` and cannot match ``jax.random`` draws."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => full distribution


def sample(gen: Optional[torch.Generator], logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32."""
    logits = logits.to(torch.float32)
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        cut = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cut, torch.full_like(logits, -torch.inf), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
