"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 -- Mamba1 architecture.  [arXiv:2410.05355; unverified]  (same
values as the reference's ``repro/configs/falcon_mamba_7b.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=65024,
        ssm_state=16, ssm_version=1, ssm_expand=2, ssm_conv=4,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256,
        ssm_state=8, ssm_version=1, ssm_expand=2, ssm_conv=4,
        remat=False, dtype="float32",
    )
