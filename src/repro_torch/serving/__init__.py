"""Lockstep and staged serving (counterpart of ``repro/serving``)."""
from repro_torch.serving.engine import Request, ServingEngine, StagedEngine
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import (
    LatencyStats, PrefillTask, SchedulerConfig, chunk_plan, degraded_chunk, next_action,
)

__all__ = [
    "LatencyStats", "PrefillTask", "Request", "SamplerConfig", "SchedulerConfig", "ServingEngine",
    "StagedEngine", "chunk_plan", "degraded_chunk", "next_action", "sample",
]
