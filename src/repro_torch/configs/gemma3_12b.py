"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 -- 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-*; unverified]  (same values as the
reference's ``repro/configs/gemma3_12b.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="gemma3-12b", family="dense",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        d_ff=15360, vocab=262144, head_dim=240,
        sliding_window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma3-12b-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        sliding_window=8, local_global_ratio=5, remat=False, dtype="float32",
    )
