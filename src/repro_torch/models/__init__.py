"""The ported model families (dense, MoE, VLM, SSM, hybrid), the KV cache and
the model API (counterpart of ``repro/models``)."""
from repro_torch.models.model_zoo import (
    ModelApi, build_model, init_quantized, insert_prefix, load_servable, make_ctx, make_smoke_batch,
    quantize_and_plan, save_servable,
)

__all__ = [
    "ModelApi", "build_model", "init_quantized", "insert_prefix", "load_servable", "make_ctx", "make_smoke_batch",
    "quantize_and_plan", "save_servable",
]
