"""Dense decoder, KV cache and model API (counterpart of ``repro/models``)."""
from repro_torch.models.model_zoo import (
    ModelApi, build_model, init_quantized, insert_prefix, quantize_and_plan,
)

__all__ = ["ModelApi", "build_model", "init_quantized", "insert_prefix", "quantize_and_plan"]
