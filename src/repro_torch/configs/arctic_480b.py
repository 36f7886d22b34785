"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]  (same values as the reference's
``repro/configs/arctic_480b.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab=32000, head_dim=128,
        n_experts=128, top_k=2, moe_dense_residual=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=256, head_dim=16,
        n_experts=8, top_k=2, moe_dense_residual=True, remat=False, dtype="float32",
    )
