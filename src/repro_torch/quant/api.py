"""PTQ entry points over compiled plans (counterpart of
``repro/quant/api.py``, without calibration: every site uses dynamic
per-row activation exponents).

``quantize_params`` walks a float parameter tree and replaces each
projection ``w`` with a QTensor per the plan; the embedding table (a
gather, not a GEMM) is snapped in place to the per-row 8-bit DFP grid.
``quantize_leaf`` is the one-leaf step, so a caller can quantize a model
one site at a time without ever holding the whole float tree.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import dfp
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quantizer import TERNARY_PER_WORD
from repro_torch.quant.formats import quantize_weights
from repro_torch.quant.plan import QuantPlan, compile_policy, is_projection_site, site_subpath


def _quantizable(prec, kdim: int) -> bool:
    return (
        prec is not None
        and prec.quantized
        and kdim % prec.group_size == 0
        and kdim % TERNARY_PER_WORD == 0
    )


def fake_quantize_act(x: torch.Tensor, bits: int = 8, per_row: bool = False) -> torch.Tensor:
    """quantize -> dequantize with dynamic exponents (copied from the
    reference's ``core/calibration.py``): one exponent per leading-axis row
    when ``per_row``, else one for the tensor."""
    axis = tuple(range(1, x.ndim)) if per_row else None
    q, e = dfp.quantize_tensor(x, bits, axis)
    return dfp.dequantize(q, e)


def quantize_leaf(path: str, key: str, val, plan: QuantPlan):
    """The quantized form of one parameter leaf at ``path/key``."""
    if is_projection_site(key, val) and isinstance(val, torch.Tensor):
        prec = plan.resolve(path)
        if _quantizable(prec, val.shape[-2]):
            return quantize_weights(
                val.to(torch.float32), prec.w_bits, prec.group_size,
                prec.filter_size, prec.refit_scale, fmt=prec.fmt,
            )
        return val
    if key == "table" and isinstance(val, torch.Tensor):
        return fake_quantize_act(val.to(torch.float32), 8, per_row=True).to(val.dtype)
    return val


def quantize_params(params, plan: QuantPlan):
    """Walk the tree; projection ``w`` leaves become QTensors."""

    def walk(node, path):
        if isinstance(node, list):
            return [walk(item, path) for item in node]
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if isinstance(val, (dict, list)):
                    out[key] = walk(val, site_subpath(path, key))
                else:
                    out[key] = quantize_leaf(path, key, val, plan)
            return out
        return node

    return walk(params, "")


def quantize_model(params, policy: PrecisionPolicy, *, mode: str = "ptq",
                   backend: str = "auto") -> Tuple[Any, QuantPlan]:
    """Float params -> (QTensor params, compiled plan)."""
    plan = compile_policy(policy, params, mode=mode, backend=backend)
    return quantize_params(params, plan), plan
