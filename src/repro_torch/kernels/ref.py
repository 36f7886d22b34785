"""Plain PyTorch oracles (counterpart of ``repro/kernels/ref.py``).

CUDA has no int32 matmul, so each cluster's dot is a float32 product of
integer-valued operands: exact while every partial sum stays below 2**24
(a cluster of g int8 x int8 products is at most g * 127 * 127).
"""
from __future__ import annotations

import torch

from repro_torch.core import dfp
from repro_torch.core.quantizer import QTensor


def _assert_exact_matmul(t: torch.Tensor) -> None:
    if t.is_cuda:
        assert torch.backends.cuda.matmul.allow_tf32 is False, (
            "the integer-valued float32 cluster dots need full float32 matmuls"
        )


def cluster_dots(xq: torch.Tensor, codes: torch.Tensor, group: int) -> torch.Tensor:
    """int8 x (M, K) . int8 w (K, N) -> f32 (K/group, M, N), one exact dot
    per cluster of ``group`` K-elements."""
    _assert_exact_matmul(xq)
    m, k = xq.shape
    n = codes.shape[1]
    xg = xq.to(torch.float32).reshape(m, k // group, group).permute(1, 0, 2)
    wg = codes.to(torch.float32).reshape(k // group, group, n)
    return torch.bmm(xg, wg)


def qmatmul_ref(x_q: torch.Tensor, x_e, qt: QTensor) -> torch.Tensor:
    """out[m, n] = sum_g scale_m[g, n] * dot_g[m, n] * 2**(scale_e + x_e[m])."""
    from repro_torch.quant.formats import decode_codes, format_of  # lazy: import cycle

    f = format_of(qt)
    if f.ref_matmul is not None:  # a scale table that is not one per cluster (ttq: Wp / Wn)
        return f.ref_matmul(x_q, x_e, qt)
    m = x_q.shape[0]
    part = cluster_dots(x_q, decode_codes(qt), qt.group_size)  # (G, M, N)
    out = (part * qt.scale_m.to(torch.float32)[:, None, :]).sum(dim=0)
    e = torch.as_tensor(x_e, device=x_q.device).to(torch.int32)
    scale = dfp.exp2i(qt.scale_e.to(torch.int32) + e)
    return out * (scale.expand(m, 1) if scale.ndim else scale)


def quantize_rows_ref(x: torch.Tensor, bits: int = 8):
    """Per-row dynamic activation quantization -> (int8 (M, K), int32 (M, 1))."""
    max_abs = torch.amax(torch.abs(x.to(torch.float32)), dim=-1, keepdim=True)
    e = dfp.choose_exponent(max_abs, bits)
    return dfp.quantize(x, e, bits), e
