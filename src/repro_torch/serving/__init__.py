"""Lockstep and staged serving with the fault-tolerance layer (admission
control, numerical guardrails, watchdog, chaos harness); counterpart of
``repro/serving``."""
from repro_torch.serving.engine import TERMINAL_STATUSES, Request, ServingEngine, StagedEngine
from repro_torch.serving.faults import (
    ARTIFACT_FAULT_KINDS, TICK_FAULT_KINDS, FaultEvent, FaultInjector, FlakyIO, corrupt_payload,
)
from repro_torch.serving.health import HealthConfig, OverloadController, TickWatchdog, describe_poison, poison_flags
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import (
    AdmissionConfig, LatencyStats, PrefillTask, SchedulerConfig, admission_decision, chunk_plan, degraded_chunk,
    estimate_ttft_ms, next_action,
)

__all__ = [
    "ARTIFACT_FAULT_KINDS", "AdmissionConfig", "FaultEvent", "FaultInjector", "FlakyIO", "HealthConfig",
    "LatencyStats", "OverloadController",
    "PrefillTask", "Request", "SamplerConfig", "SchedulerConfig", "ServingEngine", "StagedEngine",
    "TERMINAL_STATUSES", "TICK_FAULT_KINDS", "TickWatchdog", "admission_decision", "chunk_plan", "corrupt_payload",
    "degraded_chunk", "describe_poison", "estimate_ttft_ms", "next_action", "poison_flags", "sample",
]
