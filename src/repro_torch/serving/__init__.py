"""Lockstep greedy serving (counterpart of ``repro/serving``)."""
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import SamplerConfig, sample

__all__ = ["Request", "SamplerConfig", "ServingEngine", "sample"]
