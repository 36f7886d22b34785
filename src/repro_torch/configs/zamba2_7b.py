"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 -- Mamba2 backbone + 2 alternating SHARED attention blocks
every 6 layers (zamba2 weight sharing).  [arXiv:2411.15242; unverified]
(same values as the reference's ``repro/configs/zamba2_7b.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000, head_dim=112,
        ssm_state=64, ssm_version=2, ssm_expand=2, ssm_heads=112,
        shared_attn_period=6, n_shared_blocks=2,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16,
        ssm_state=8, ssm_version=2, ssm_expand=2, ssm_heads=2,
        shared_attn_period=3, n_shared_blocks=2, remat=False, dtype="float32",
    )
