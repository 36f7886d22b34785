"""Staged-serving scheduler (counterpart of ``repro/serving/scheduler.py``).

Everything host-side that decides which stage the staged engine runs next,
how a prompt is cut into chunks, whom to admit and what the user-visible
latency was:

  * ``chunk_plan`` cuts a prompt into full ``chunk``-sized pieces plus a
    descending power-of-two remainder (13 -> [8, 4, 1]), so a prefill chunk
    takes one of O(log chunk) lengths;
  * ``next_action`` arbitrates: decode priority interleaves at most one
    prefill chunk between generate ticks, prefill priority drains prefill
    work first;
  * ``degraded_chunk`` is the overload chunk size (largest power of two
    <= chunk / 2);
  * ``AdmissionConfig`` + ``admission_decision`` shed a request at submit
    when the queue is too deep or its estimated TTFT (``estimate_ttft_ms``)
    already blows its SLO or deadline;
  * ``PrefillTask`` tracks one in-flight prefill (request, reserved slot,
    chunk cursor, private B=1 cache);
  * ``LatencyStats`` aggregates per-request queue wait, TTFT and TPOT and
    reports p50/p95/p99.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

POLICIES = ("decode", "prefill")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """prefill_chunk: token budget of one prefill dispatch.  policy:
    "decode" runs a generate tick between any two prefill chunks whenever
    generation work exists; "prefill" runs all pending prefill work first."""

    prefill_chunk: int = 32
    policy: str = "decode"

    def __post_init__(self):
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {self.policy!r}")


def chunk_plan(n_tokens: int, chunk: int) -> List[int]:
    """Chunk sizes for an ``n_tokens`` prompt under a ``chunk`` budget."""
    if n_tokens < 1:
        raise ValueError(f"need at least one prompt token, got {n_tokens}")
    sizes = [chunk] * (n_tokens // chunk)
    rem = n_tokens % chunk
    while rem:
        p = 1 << (rem.bit_length() - 1)  # largest power of two <= rem
        sizes.append(p)
        rem -= p
    return sizes


def degraded_chunk(chunk: int) -> int:
    """Overload-mode prefill chunk: largest power of two <= max(1, chunk/2)."""
    half = max(1, chunk // 2)
    return 1 << (half.bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Load shedding and deadlines applied at ``engine.submit``.

    max_queue: shed when the queue already holds this many requests (None
        disables).  ttft_slo_ms: shed when the estimated TTFT exceeds this
        budget (None disables).  deadline_ms: default per-request deadline
        (a request's own wins); past it the request is expired, queued or in
        flight.  retry_backoff_ms: base of the exponential backoff a
        quarantined request waits before re-admission (doubles per retry).
    """

    max_queue: Optional[int] = None
    ttft_slo_ms: Optional[float] = None
    deadline_ms: Optional[float] = None
    retry_backoff_ms: float = 20.0


def estimate_ttft_ms(*, queued_tokens: int, n_queued: int, tick_ms: float, chunk: Optional[int] = None) -> float:
    """A monotone floor of the TTFT of a request submitted now: the prefill
    dispatches of every queued prompt (``ceil(tokens / chunk)`` staged, one
    tick per token lockstep when ``chunk`` is None) plus one first-token
    dispatch per queued request, at the recent EWMA tick time."""
    if tick_ms <= 0.0:
        return 0.0  # no dispatch history yet: admit and learn
    if chunk is not None and chunk > 0:
        prefill_dispatches = (queued_tokens + chunk - 1) // chunk
    else:
        prefill_dispatches = queued_tokens
    return (prefill_dispatches + n_queued) * tick_ms


def admission_decision(adm: AdmissionConfig, *, queue_depth: int, est_ttft_ms: float,
                       deadline_ms: Optional[float] = None) -> Optional[str]:
    """Shed reason for a submission, or None to admit: the queue is at
    ``max_queue``, or the estimated TTFT exceeds the tighter of the TTFT SLO
    and the request's own deadline."""
    if adm.max_queue is not None and queue_depth >= adm.max_queue:
        return f"queue depth {queue_depth} >= max_queue {adm.max_queue}"
    budgets = [b for b in (adm.ttft_slo_ms, deadline_ms) if b is not None]
    if budgets and est_ttft_ms > min(budgets):
        return f"estimated TTFT {est_ttft_ms:.0f}ms exceeds budget {min(budgets):.0f}ms"
    return None


def next_action(policy: str, *, prefill_ready: bool, decode_ready: bool, last: str) -> str:
    """"prefill" | "generate" | "idle": which stage to dispatch next.
    ``last`` is the previously dispatched stage (decode priority alternates)."""
    if not prefill_ready and not decode_ready:
        return "idle"
    if not prefill_ready:
        return "generate"
    if not decode_ready:
        return "prefill"
    if policy == "prefill":
        return "prefill"
    return "prefill" if last == "generate" else "generate"


@dataclasses.dataclass
class PrefillTask:
    """One in-flight chunked prefill: a request bound to a reserved slot."""

    req: Any  # Request
    slot: int
    chunks: List[int]
    cache: Any  # private B=1 prefill cache
    idx: int = 0  # next chunk to dispatch
    done_tokens: int = 0  # prompt tokens already consumed

    @property
    def complete(self) -> bool:
        return self.idx >= len(self.chunks)

    def next_chunk(self) -> tuple:
        """(start, size) of the next chunk to dispatch."""
        return self.done_tokens, self.chunks[self.idx]

    def advance(self, size: int) -> None:
        self.done_tokens += size
        self.idx += 1


class LatencyStats:
    """Per-request SLO aggregation: queue wait, TTFT, TPOT (seconds).
    TPOT is defined for requests with two or more output tokens."""

    def __init__(self):
        self.queue_wait: List[float] = []
        self.ttft: List[float] = []
        self.tpot: List[float] = []

    def record(self, req) -> None:
        if req.submit_t is None:
            return
        if req.prefill_start_t is not None:
            self.queue_wait.append(req.prefill_start_t - req.submit_t)
        if req.first_token_t is not None:
            self.ttft.append(req.first_token_t - req.submit_t)
            if req.finish_t is not None and len(req.output) > 1:
                self.tpot.append((req.finish_t - req.first_token_t) / (len(req.output) - 1))

    @staticmethod
    def _pcts(vals: List[float]) -> Optional[Dict[str, float]]:
        if not vals:
            return None
        p50, p95, p99 = np.percentile(np.asarray(vals), [50, 95, 99])
        return {"p50": float(p50), "p95": float(p95), "p99": float(p99), "n": len(vals)}

    def summary(self) -> Dict[str, Optional[Dict[str, float]]]:
        """{"queue_wait"|"ttft"|"tpot": {"p50","p95","p99","n"} | None}."""
        return {"queue_wait": self._pcts(self.queue_wait), "ttft": self._pcts(self.ttft),
                "tpot": self._pcts(self.tpot)}
