"""Flash decode: the S == 1 entry of the flash kernel (counterpart of
``repro/kernels/flash_decode.py::flash_decode``)."""
from __future__ import annotations

from repro_torch.kernels.flash_prefill import flash_attend


def flash_decode(q, k, v, ke, ve, q_pos, valid, window, *, fmt: str, block_k: int = 128):
    """q (B, Kh, G, hd), one token per batch row -> (B, Kh, G, hd) f32."""
    out = flash_attend(q[:, None].contiguous(), k, v, ke, ve, q_pos, valid, window,
                       fmt=fmt, block_k=block_k)
    return out[:, 0]
