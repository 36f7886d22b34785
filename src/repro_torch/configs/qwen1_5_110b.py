"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 -- QKV bias.  [hf:Qwen/Qwen1.5-*; hf]  (same values as the
reference's ``repro/configs/qwen1_5_110b.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab=152064, head_dim=128, qkv_bias=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, qkv_bias=True, remat=False, dtype="float32",
    )
