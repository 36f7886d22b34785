"""Config registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

The dense family is registered: ``qwen3-8b``, ``phi4-mini-3.8b``,
``qwen1.5-110b`` (qkv biases) and ``gemma3-12b`` (5:1 local:global sliding
windows, head_dim 240); the MoE family: ``grok-1-314b`` (8 experts) and
``arctic-480b`` (128 experts beside a dense residual MLP); the VLM
``qwen2-vl-72b`` (M-RoPE, prepended patch embeddings); the SSM
``falcon-mamba-7b`` (Mamba1) and the hybrid ``zamba2-7b`` (Mamba2 with
two shared attention blocks, head_dim 112); the encoder-decoder
``whisper-base`` (a stub audio frontend: precomputed frame embeddings).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, QuantConfig, config_from_dict, config_to_dict

_MODULES: Dict[str, str] = {
    "qwen3-8b": "qwen3_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "gemma3-12b": "gemma3_12b",
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-7b": "zamba2_7b",
    "whisper-base": "whisper_base",
}

ARCH_IDS: List[str] = list(_MODULES)


def _load(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, quant: QuantConfig | None = None) -> ArchConfig:
    cfg = _load(arch).full()
    return cfg if quant is None else dataclasses.replace(cfg, quant=quant)


def get_smoke(arch: str, quant: QuantConfig | None = None) -> ArchConfig:
    cfg = _load(arch).smoke()
    return cfg if quant is None else dataclasses.replace(cfg, quant=quant)


__all__ = [
    "ARCH_IDS", "ArchConfig", "QuantConfig", "config_from_dict",
    "config_to_dict", "get_config", "get_smoke",
]
