"""Serving-side health (counterpart of ``repro/serving/health.py``):
numerical guardrails, the tick watchdog and overload mode.

  * ``poison_flags`` is one reduction over a decode tick's (B, V) logits on
    the device: per-slot bit flags for non-finite values and for magnitudes
    past the DFP saturation horizon (``2**sat_exponent``).  The engine stacks
    the flags with the sampled tokens into one (2, B) tensor, so guardrails
    add no host sync to the tick.
  * ``TickWatchdog`` times every dispatch on the host clock and counts slow
    and hung ticks (it flags; it cannot preempt a running dispatch).
  * ``OverloadController`` watches recent TPOT p95 and queue depth and flips
    the engine into degraded mode (smaller prefill chunks, decode priority)
    with hysteresis.

A poisoned slot is quarantined by the engine: the slot is aborted, its cache
rows are cleared through ``insert``, and the request is re-queued with
exponential backoff up to its retry budget.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

POISON_NONE = 0
POISON_NONFINITE = 1  # NaN/Inf anywhere in the slot's logit row
POISON_SATURATED = 2  # finite but beyond the DFP saturation horizon


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """guardrails: fold the per-slot poison check into the decode tick (on
    by default; it changes no token of a healthy slot).  sat_exponent:
    |logit| >= 2**sat_exponent counts as DFP saturation.  tick_slow_s /
    tick_hang_s: host-clock thresholds the watchdog counts each dispatch
    against.  overload_tpot_ms / overload_queue: a breach of either (recent
    TPOT p95, queue depth) enters overload mode, ``None`` disables that
    trigger; recovery needs both under 80% of their threshold.  window:
    sliding sample window of the recent-TPOT estimate."""

    guardrails: bool = True
    sat_exponent: int = 24
    tick_slow_s: float = 1.0
    tick_hang_s: float = 10.0
    overload_tpot_ms: Optional[float] = None
    overload_queue: Optional[int] = None
    window: int = 32


def poison_flags(logits: torch.Tensor, sat_limit: float) -> torch.Tensor:
    """Per-slot poison bit flags (int32, (B,)) of a (B, V) logit block.
    bit 0 (POISON_NONFINITE): any NaN/Inf in the row; bit 1
    (POISON_SATURATED): any finite magnitude >= ``sat_limit``."""
    x = logits.to(torch.float32)
    finite = torch.isfinite(x)
    nonfinite = (~finite).any(dim=-1)
    sat = (torch.where(finite, x.abs(), 0.0) >= sat_limit).any(dim=-1)
    return nonfinite.to(torch.int32) * POISON_NONFINITE + sat.to(torch.int32) * POISON_SATURATED


def describe_poison(flag: int) -> str:
    """Reason string for a poison bit flag."""
    parts = []
    if flag & POISON_NONFINITE:
        parts.append("non-finite logits")
    if flag & POISON_SATURATED:
        parts.append("DFP-saturated logits")
    return " + ".join(parts) or f"poison flag {flag}"


class TickWatchdog:
    """Host-clock accounting of every engine dispatch: slow and hung tick
    counts, an EWMA tick time (the admission TTFT estimate reads it) and the
    worst tick."""

    def __init__(self, cfg: HealthConfig):
        self.cfg = cfg
        self.n = 0
        self.slow = 0
        self.hung = 0
        self.ewma_ms = 0.0
        self.last_ms = 0.0
        self.worst_ms = 0.0

    def observe(self, dt_s: float) -> Optional[str]:
        """Record one dispatch duration; returns "hung" | "slow" | None."""
        ms = dt_s * 1e3
        self.n += 1
        self.last_ms = ms
        self.worst_ms = max(self.worst_ms, ms)
        # seeded by the first sample; a 0.2 step so one slow first tick
        # does not dominate the TTFT estimate for long
        self.ewma_ms = ms if self.n == 1 else 0.8 * self.ewma_ms + 0.2 * ms
        if dt_s >= self.cfg.tick_hang_s:
            self.hung += 1
            return "hung"
        if dt_s >= self.cfg.tick_slow_s:
            self.slow += 1
            return "slow"
        return None

    def summary(self) -> Dict[str, float]:
        return {
            "ticks": self.n,
            "slow_ticks": self.slow,
            "hung_ticks": self.hung,
            "tick_ms_ewma": self.ewma_ms,
            "tick_ms_last": self.last_ms,
            "tick_ms_worst": self.worst_ms,
        }


class OverloadController:
    """Hysteretic overload detector: enter when recent TPOT p95 exceeds
    ``overload_tpot_ms`` or queue depth exceeds ``overload_queue``; leave
    when every enabled metric is back under 80% of its threshold."""

    def __init__(self, cfg: HealthConfig):
        self.cfg = cfg
        self.overload = False
        self.entered = 0  # times overload mode was entered
        self._tpot_ms = deque(maxlen=cfg.window)

    def note_tpot_ms(self, ms: float) -> None:
        self._tpot_ms.append(ms)

    def tpot_p95_ms(self) -> Optional[float]:
        if not self._tpot_ms:
            return None
        return float(np.percentile(np.asarray(self._tpot_ms), 95))

    def update(self, *, queue_depth: int) -> bool:
        cfg = self.cfg
        p95 = self.tpot_p95_ms()

        def _state(scale: float) -> bool:
            breach = False
            if cfg.overload_tpot_ms is not None and p95 is not None:
                breach |= p95 > cfg.overload_tpot_ms * scale
            if cfg.overload_queue is not None:
                breach |= queue_depth > cfg.overload_queue * scale
            return breach

        if not self.overload and _state(1.0):
            self.overload = True
            self.entered += 1
        elif self.overload and not _state(0.8):
            self.overload = False
        return self.overload

    def summary(self) -> Dict[str, object]:
        return {
            "overload": self.overload,
            "overload_entered": self.entered,
            "tpot_p95_ms_recent": self.tpot_p95_ms(),
        }
