"""Quantization: formats, plans, PTQ conversion and the qdense backends
(counterpart of ``repro/quant``)."""
from repro_torch.core.policy import LayerPrecision, PrecisionPolicy
from repro_torch.core.quantizer import QTensor
from repro_torch.quant.api import (
    Artifact, Observer, load_artifact, observe_site, quantize_model, quantize_params, save_artifact,
)
from repro_torch.quant.backends import qdense, qmatmul, quantize_activations
from repro_torch.quant.formats import (
    decode_codes,
    dequantize_weights,
    format_of,
    get_format,
    quantize_weights,
)
from repro_torch.quant.plan import QuantCtx, QuantPlan, compile_policy, iter_weight_sites

__all__ = [
    "Artifact", "LayerPrecision", "Observer", "PrecisionPolicy", "QTensor", "QuantCtx", "QuantPlan",
    "compile_policy", "decode_codes", "dequantize_weights", "format_of",
    "get_format", "iter_weight_sites", "load_artifact", "observe_site", "qdense", "qmatmul",
    "quantize_activations", "quantize_model", "quantize_params", "quantize_weights", "save_artifact",
]
