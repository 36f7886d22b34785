"""Architecture + runtime configuration schema (own copy of
``repro/configs/base.py``; the port imports nothing of ``repro``).

Field names and defaults are the reference's, so a serialized ArchConfig
from either package rebuilds in the other with ``config_from_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Paper knobs: weight bits, cluster size (group along reduction dim)."""

    w_bits: int = 2  # 2 = ternary (Algorithm 1), 4, 8, 32 = off
    act_bits: int = 8
    group_size: int = 64  # paper's N*K^2 reduction segment per alpha
    filter_size: int = 1  # Algorithm-2 unit within a cluster
    refit_scale: bool = False  # beyond-paper L2 refit of alpha
    mode: str = "fp"  # 'fp' | 'ptq'
    backend: str = "auto"  # qdense backend for ptq: auto | cuda | ref
    fmt: Optional[str] = None  # registered weight-format name (nf4, mx, ...); None keeps the w_bits ladder


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False
    sliding_window: Optional[int] = None
    local_global_ratio: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    moe_chunk_tokens: int = 65536

    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1
    ssm_heads: int = 0

    # hybrid
    shared_attn_period: int = 0
    n_shared_blocks: int = 2

    # enc-dec
    n_enc_layers: int = 0
    n_audio_frames: int = 1500

    # modality frontend stub
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0

    # numerics / memory
    dtype: str = "bfloat16"
    kv_bits: int = 16
    kv_fmt: Optional[str] = None
    flash_decode: bool = False  # hand-written flash kernel for S == 1 steps
    flash_prefill: bool = False
    remat: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    vocab_pad_to: int = 256

    quant: QuantConfig = QuantConfig()

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab // m) * m if m else self.vocab


def config_to_dict(cfg: ArchConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ArchConfig:
    d = dict(d)
    d["quant"] = QuantConfig(**d.get("quant", {}))
    return ArchConfig(**d)
