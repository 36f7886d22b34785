"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 -- enc-dec, conv frontend stubbed (a batch feeds precomputed
frame embeddings).  [arXiv:2212.04356; unverified]  (same values as the
reference's ``repro/configs/whisper_base.py``)"""
from repro_torch.configs.base import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="encdec",
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=51865, head_dim=64,
        frontend="audio", n_audio_frames=1500,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-base-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16,
        frontend="audio", n_audio_frames=16, remat=False, dtype="float32",
    )
