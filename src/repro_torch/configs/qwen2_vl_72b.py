"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- M-RoPE, dynamic resolution (vision frontend stubbed:
inputs carry precomputed patch embeddings).  [arXiv:2409.12191; hf]  (same
values as the reference's ``repro/configs/qwen2_vl_72b.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        mrope=True, frontend="vision", n_frontend_tokens=1024,
        rope_theta=1_000_000.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        mrope=True, frontend="vision", n_frontend_tokens=4,
        remat=False, dtype="float32",
    )
