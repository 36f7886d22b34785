"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]  (same
values as the reference's ``repro/configs/grok_1_314b.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072, head_dim=128,
        n_experts=8, top_k=2, rope_theta=10_000.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        n_experts=4, top_k=2, remat=False, dtype="float32",
    )
