"""mx entries (counterpart of ``repro/kernels/mx_matmul.py``): raw int8
mantissas whose per-32-block scale mantissas are exact powers of two, so
the kernels ARE the int8 kernels, aliased (their launches count there)."""
from __future__ import annotations

from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_fused

MX_BLOCK = 32  # mx shared-exponent block length along K

mx_matmul = int8_matmul
mx_matmul_fused = int8_matmul_fused
