"""Serving engines over slot-based decode state (counterpart of
``repro/serving/engine.py``): the lockstep oracle and the staged
continuous-batching engine, with the reference's fault tolerance.

``ServingEngine`` (lockstep): all ``n_slots`` step through one decode call
per tick -- slots consuming their prompt feed the next prompt token,
generating slots feed their last sampled token, idle slots feed a pad token
whose output is discarded.  It is the greedy oracle the staged engine is
tested against.

``StagedEngine`` splits serving into three stages:

  * ``prefill``  -- ``prefill_chunk`` consumes a prompt chunk (B=1) against
    a private cache, chunked at a token budget (``SchedulerConfig``); a
    family without one (SSM, hybrid: a recurrent state has no chunk graph)
    consumes the chunk a token at a time through ``decode`` into the same
    private cache, as the reference's fallback does;
  * ``insert``   -- the finished prefix is copied into the decode cache's
    reserved slot (every leaf's row is overwritten);
  * ``generate`` -- one decode call over the slot batch; the reserved slot
    of an in-flight prefill rides as a pad row whose output is discarded.

Each ``step()`` of the staged engine dispatches one stage, chosen by
``scheduler.next_action``.  With the same prompts both engines give the same
greedy tokens: chunked prefill writes the K/V rows the lockstep tick would
have written, and attention masks stale positions to exact zeros.

Both engines clear a slot's cache rows when a request takes the slot by
inserting a fresh ``init_cache(1, max_len)``, as the reference does: for
kv_mx a fresh cache holds the empty-block exponent -127, which a zeroed
plane would not (exponent 0 would floor the next occupant's blocks).

Fault tolerance, as the reference's:

  * every request ends in one terminal status (``TERMINAL_STATUSES``);
    ``submit`` rejects malformed requests (``strict=True`` raises) and sheds
    by ``AdmissionConfig`` (queue depth, estimated TTFT against the SLO or
    the request's deadline); ``cancel`` works on queued and running
    requests; deadlines expire requests wherever they are;
  * each decode tick computes per-slot poison flags (``health.poison_flags``)
    on the device and stacks them with the sampled tokens into one (2, B)
    tensor, moved to the host with the tick's one ``.cpu()``; a flagged slot
    is quarantined -- aborted, its cache rows cleared through ``insert``, its
    request re-queued from the prompt with exponential backoff until its
    retry budget is spent, then ``failed``;
  * ``TickWatchdog`` times each dispatch; ``OverloadController`` puts the
    staged engine into degraded mode (``degraded_chunk`` prefill chunks,
    decode priority) with hysteresis;
  * a ``FaultInjector`` (``serving/faults.py``) draws one decision per
    decode dispatch: a logit row overwritten before sampling, a NaN-filled
    cache row inserted, or a host stall.

The engines read time through ``self._clock`` (``time.monotonic``), so a
caller may drive them on a clock of its own.

``mesh=`` (a live ``parallel.collectives.Mesh``) serves the dense and MoE
families across the mesh's ranks, one engine a rank (``models/spmd.py``):
each holds its shards of the params and of the decode cache, every rank
runs this same host loop -- scheduler, health, seeded faults, sampler --
on rank 0's clock, and all reach the same tokens.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving import health as health_mod
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.health import HealthConfig, OverloadController, TickWatchdog
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import (
    AdmissionConfig, LatencyStats, PrefillTask, SchedulerConfig, admission_decision, chunk_plan, degraded_chunk,
    estimate_ttft_ms, next_action,
)
from repro_torch.tree import tree_map

# terminal request statuses: the request has left the engine for good
TERMINAL_STATUSES = ("finished", "expired", "shed", "rejected", "failed", "cancelled")
_NO_FAULT = (-1, 0.0)  # (slot, logit value) of a dispatch without a logit fault


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # deadline_ms: budget from submit, past it the request is expired wherever
    # it is (None: the engine's AdmissionConfig default).  max_retries: how
    # often a quarantined request is re-queued before it fails for good.
    deadline_ms: Optional[float] = None
    max_retries: int = 0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # pending -> queued -> running -> finished, with the fault-path terminals
    # expired | shed | rejected | failed | cancelled
    status: str = "pending"
    reason: Optional[str] = None  # why shed / rejected / expired / failed / cancelled
    retries: int = 0  # quarantine retries consumed
    not_before: float = 0.0  # backoff gate: not re-admitted before this time
    admitted_tick: Optional[int] = None  # engine tick this request got a slot
    # SLO trace (engine clock, seconds): submit -> prefill_start (queue wait)
    # -> first_token (TTFT) -> finish
    submit_t: Optional[float] = None
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES


class _EngineBase:
    """Slot and queue bookkeeping, admission, deadlines, quarantine and the
    guarded decode tick shared by the lockstep and staged engines."""

    def __init__(self, api, params: Any, n_slots: int = 4, max_len: int = 256,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 admission: AdmissionConfig = AdmissionConfig(), health: HealthConfig = HealthConfig(),
                 faults: Optional[FaultInjector] = None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            api, params = self._install_mesh(api, params)
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampler = sampler
        self.admission = admission
        self.health = health
        self.faults = faults
        self.watchdog = TickWatchdog(health)
        self._overload_ctl = OverloadController(health)
        self._sat_limit = float(2.0 ** health.sat_exponent)
        # fault-tolerance event counters, in stats()["health"]
        self.events = {
            "rejected": 0, "shed": 0, "expired": 0, "cancelled": 0,
            "quarantined": 0, "retried": 0, "failed": 0, "faults_injected": 0,
        }
        self.device = api.device
        self.cache = api.init_cache(n_slots, max_len)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)  # next cache position
        self.slot_cursor = np.zeros(n_slots, np.int32)  # prompt consumption
        self.next_token = np.zeros(n_slots, np.int32)
        self.queue: Deque[Request] = deque()
        self._tick = 0
        self._tokens = 0  # tokens generated (sampled into outputs)
        # one clock on every rank of a mesh: they take the same branches and reach the same collectives
        self._clock = mesh.clock if mesh is not None and mesh.size > 1 else time.monotonic
        self._lat = LatencyStats()
        self._zero_prefix = None  # lazy fresh B=1 cache (slot clearing)
        self._poison_prefix = None  # lazy NaN-filled B=1 cache (chaos kv_corrupt)

    def _install_mesh(self, api, params):
        """``self.mesh`` as the serving layout (``models/spmd.py``): the
        params to this rank's shards (a whole tree is sliced, a rank-local
        one read from a sharded artifact is taken as it is), and the api's
        serving calls wrapped so each runs under the mesh -- the ambient
        mesh is scoped per call, so engines on different meshes coexist --
        with its caches placed per ``cache_shardings``."""
        from repro_torch.models import spmd  # lazy: serving stays model-agnostic

        params, state = spmd.install(params, self.mesh, api.cfg)
        return spmd.shard_api(api, state), params

    @classmethod
    def from_artifact(cls, artifact_dir: str, *, device=None, mesh=None, **kwargs):
        """Cold-start an engine from a packed artifact (``load_servable``):
        the QTensor tree under the artifact's plan, on ``device`` -- no
        float weights, no calibration, no re-quantization.  With ``mesh``
        each rank reads its own shards."""
        from repro_torch.models.model_zoo import load_servable  # lazy: serving stays model-agnostic

        api, qparams, _ = load_servable(artifact_dir, mesh=mesh, device=device)
        return cls(api, qparams, mesh=mesh, **kwargs)

    # -- client API --------------------------------------------------------
    def submit(self, req: Request, *, strict: bool = False) -> Request:
        """Admit, reject or shed one request; returns it with ``status``
        ``queued`` | ``rejected`` | ``shed``.  A malformed request (empty
        prompt, or one that cannot fit ``max_len``) comes back ``rejected``
        with a reason, or raises ``ValueError`` with ``strict=True``.  Load
        shedding returns ``shed`` in both modes."""
        req.submit_t = self._clock()
        reject = None
        if not req.prompt:
            reject = "empty prompt"
        elif len(req.prompt) >= self.max_len:
            reject = (
                f"prompt of {len(req.prompt)} tokens cannot fit engine "
                f"max_len={self.max_len}: the slot would hit the cache cap "
                "during prefill and finish with truncated or empty output; "
                "raise max_len or truncate the prompt"
            )
        if reject is not None:
            if strict:
                raise ValueError(reject)
            req.status, req.reason = "rejected", reject
            self.events["rejected"] += 1
            return req
        if req.deadline_ms is None:
            req.deadline_ms = self.admission.deadline_ms
        shed = admission_decision(self.admission, queue_depth=len(self.queue), est_ttft_ms=self._est_ttft_ms(),
                                  deadline_ms=req.deadline_ms)
        if shed is not None:
            req.status, req.reason = "shed", shed
            self.events["shed"] += 1
            return req
        req.status = "queued"
        self.queue.append(req)
        return req

    def cancel(self, uid: int) -> bool:
        """Cancel request ``uid``, queued or holding a slot (mid-prefill
        included).  False if no live request has that uid."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                r.status, r.reason = "cancelled", "cancelled by client"
                self.events["cancelled"] += 1
                return True
        for s, r in enumerate(self.slot_req):
            if r is not None and r.uid == uid:
                self._abort_slot(s)
                r.status, r.reason = "cancelled", "cancelled by client"
                self.events["cancelled"] += 1
                return True
        return False

    def run(self, max_ticks: int = 1_000) -> List[Request]:
        """Step until idle or the step budget expires; returns completed
        requests (finished, or expired / failed while running).  Unfinished
        ones stay inside (``leftover``, ``drain``)."""
        completed: List[Request] = []
        ticks = 0
        while self._has_work() and ticks < max_ticks:
            tick0 = self._tick
            out = self.step()
            completed.extend(out)
            if self._tick == tick0 and not out and self.queue:
                # nothing dispatched: every queued request waits out its
                # retry backoff
                wait = min(r.not_before for r in self.queue) - self._clock()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
            ticks += 1
        return completed

    def step(self) -> List[Request]:
        """One engine step: expire deadlines, dispatch one stage or tick,
        feed the watchdog and the overload controller.  Returns the requests
        this step completed (finished, expired or failed)."""
        t0 = self._clock()
        completed = self._expire_deadlines()
        tick0 = self._tick
        completed.extend(self._step_impl())
        if self._tick != tick0:  # a dispatch happened: time it
            self.watchdog.observe(self._clock() - t0)
        self._overload_ctl.update(queue_depth=len(self.queue))
        return completed

    def leftover(self) -> Dict[str, List[Request]]:
        """Unfinished work still inside the engine, without removing it."""
        return {"in_flight": [r for r in self.slot_req if r is not None], "queued": list(self.queue)}

    def drain(self) -> Dict[str, List[Request]]:
        """Remove and return all unfinished requests, resetting every slot."""
        report = self.leftover()
        self._abort_inflight()
        for s in range(self.n_slots):
            if self.slot_req[s] is not None:
                self._reset_slot(s)
        self.queue.clear()
        return report

    def stats(self) -> Dict[str, Any]:
        return {
            "active": sum(r is not None for r in self.slot_req),
            "queued": len(self.queue),
            "tick": self._tick,
            "tokens": self._tokens,
            "admitted_tick": [r.admitted_tick if r is not None else None for r in self.slot_req],
            "positions": self.slot_pos.tolist(),
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            # per-request percentiles over finished requests (seconds)
            "latency": self._lat.summary(),
            # watchdog tick timing, overload mode and the event counters
            "health": {
                **self.watchdog.summary(),
                **self._overload_ctl.summary(),
                "events": dict(self.events),
                "faults": None if self.faults is None else self.faults.summary(),
            },
        }

    @property
    def overload(self) -> bool:
        """Is the engine in degraded (overload) mode?"""
        return self._overload_ctl.overload

    # -- slot lifecycle ----------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def _reset_slot(self, s: int) -> None:
        self.slot_req[s] = None
        self.slot_pos[s] = 0
        self.slot_cursor[s] = 0
        self.next_token[s] = 0

    def _occupy_slot(self, s: int, req: Request) -> None:
        """Reserve slot ``s`` for ``req``: reset host state, clear the
        slot's cache rows, stamp admission."""
        self._reset_slot(s)
        self._clear_slot_cache(s)
        req.status = "running"
        req.admitted_tick = self._tick
        req.prefill_start_t = self._clock()
        self.slot_req[s] = req

    def _clear_slot_cache(self, s: int) -> None:
        """Overwrite slot ``s``'s rows of the decode cache with a fresh
        cache through ``insert``, as the reference does."""
        if self._zero_prefix is None:
            self._zero_prefix = self.api.init_cache(1, self.max_len)
        self.api.insert(self.cache, self._zero_prefix, s)

    def _free_slot(self) -> Optional[int]:
        for s in range(self.n_slots):
            if self.slot_req[s] is None:
                return s
        return None

    def _emit(self, s: int, tok: int, req: Request) -> bool:
        """Append a sampled token; finish the request when it is done.
        Returns True when the request finished."""
        if not req.output:
            req.first_token_t = self._clock()
        req.output.append(tok)
        self._tokens += 1
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if len(req.output) >= req.max_new_tokens or hit_eos or self.slot_pos[s] >= self.max_len - 1:
            self._finish(s, req)
            return True
        self.next_token[s] = tok
        return False

    def _finish(self, s: int, req: Request) -> None:
        req.done = True
        req.status = "finished"
        req.finish_t = self._clock()
        self._lat.record(req)
        if req.first_token_t is not None and len(req.output) > 1:
            self._overload_ctl.note_tpot_ms((req.finish_t - req.first_token_t) / (len(req.output) - 1) * 1e3)
        self._reset_slot(s)

    def _abort_slot(self, s: int) -> None:
        """Tear one slot down mid-request (cancel, expiry, quarantine): host
        state reset and the cache rows cleared, so a poisoned or half-written
        row never outlives its request."""
        self._reset_slot(s)
        self._clear_slot_cache(s)

    def _quarantine(self, s: int, req: Request, flag: int) -> Optional[Request]:
        """Contain a poisoned slot: abort it and either re-queue the request
        from its prompt with exponential backoff (retry budget left) or fail
        it.  Returns the request when it terminated."""
        self.events["quarantined"] += 1
        self._abort_slot(s)
        reason = health_mod.describe_poison(flag)
        if req.retries < req.max_retries:
            req.retries += 1
            self.events["retried"] += 1
            req.not_before = self._clock() + self.admission.retry_backoff_ms * (2 ** (req.retries - 1)) / 1e3
            # partial output came from (or fed) a poisoned cache
            req.output.clear()
            req.first_token_t = None
            req.status, req.reason = "queued", f"retrying after {reason}"
            self.queue.append(req)
            return None
        req.status = "failed"
        req.reason = f"{reason} (retry budget exhausted)" if req.max_retries else reason
        req.finish_t = self._clock()
        self.events["failed"] += 1
        return req

    # -- deadlines and admission -------------------------------------------
    def _deadline_passed(self, req: Request, now: float) -> bool:
        return req.deadline_ms is not None and req.submit_t is not None and (now - req.submit_t) * 1e3 > req.deadline_ms

    def _expire_deadlines(self) -> List[Request]:
        """Expire queued and in-flight requests past their deadline, freeing
        their slots.  Returns the expired."""
        now = self._clock()
        expired: List[Request] = []
        if any(self._deadline_passed(r, now) for r in self.queue):
            keep: Deque[Request] = deque()
            for r in self.queue:
                (expired if self._deadline_passed(r, now) else keep).append(r)
            self.queue = keep
        for s, r in enumerate(self.slot_req):
            if r is not None and self._deadline_passed(r, now):
                self._abort_slot(s)
                expired.append(r)
        for r in expired:
            r.status = "expired"
            r.reason = f"deadline {r.deadline_ms:.0f}ms exceeded"
            r.finish_t = now
            self.events["expired"] += 1
        return expired

    def _pop_eligible(self) -> Optional[Request]:
        """Oldest queued request not gated by retry backoff."""
        now = self._clock()
        for i, r in enumerate(self.queue):
            if r.not_before <= now:
                del self.queue[i]
                return r
        return None

    def _est_ttft_ms(self) -> float:
        return estimate_ttft_ms(queued_tokens=sum(len(r.prompt) for r in self.queue), n_queued=len(self.queue),
                                tick_ms=self.watchdog.ewma_ms, chunk=self._prefill_chunk_hint())

    def _prefill_chunk_hint(self) -> Optional[int]:
        """Prompt tokens one dispatch consumes (None: one a tick, lockstep)."""
        return None

    # -- chaos -------------------------------------------------------------
    def _draw_fault(self) -> Tuple[int, float]:
        """One injector decision for this dispatch.  A logit fault returns
        (slot, value) for the tick to write; cache and stall faults are
        applied here.  No fault: (-1, 0.0)."""
        if self.faults is None:
            return _NO_FAULT
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        ev = self.faults.draw(self._tick, active)
        if ev is None:
            return _NO_FAULT
        self.events["faults_injected"] += 1
        victim = self.slot_req[ev.slot] if 0 <= ev.slot < self.n_slots else None
        ev.uid = victim.uid if victim is not None else None
        if ev.kind in ("nan_logits", "inf_logits", "sat_logits"):
            return ev.slot, float(ev.payload)
        if ev.kind == "kv_corrupt":
            self._corrupt_slot_cache(ev.slot)
        elif ev.kind == "stall_tick":
            time.sleep(float(ev.payload))
        return _NO_FAULT

    def _corrupt_slot_cache(self, s: int) -> None:
        """Chaos: NaN-fill every float leaf of slot ``s``'s cache rows (SSM
        states included) through the same ``insert`` that clears slots (a
        cache without float leaves, kv_int8, gets a fresh row, as in the
        reference)."""
        if self._poison_prefix is None:
            self._poison_prefix = tree_map(
                lambda leaf: torch.full_like(leaf, float("nan")) if leaf.is_floating_point() else leaf,
                self.api.init_cache(1, self.max_len))
        self.api.insert(self.cache, self._poison_prefix, s)

    # -- device ------------------------------------------------------------
    def _guarded_tokens(self, logits: torch.Tensor) -> np.ndarray:
        """(2, B) host array of the tokens sampled from ``logits`` (B, V) and
        their poison flags: one device tensor, one ``.cpu()``."""
        toks = sample(self.gen, logits, self.sampler)
        if self.health.guardrails:
            flags = health_mod.poison_flags(logits, self._sat_limit)
        else:
            flags = torch.zeros_like(toks)
        return torch.stack([toks, flags]).cpu().numpy()

    def _decode_tick(self) -> np.ndarray:
        """One decode call over every slot, with this dispatch's fault
        drawn first; returns (tokens, flags) as a (2, B) host array -- the
        one host sync of the tick."""
        fault_slot, fault_val = self._draw_fault()
        tokens = torch.as_tensor(self.next_token[:, None], device=self.device)
        pos = torch.as_tensor(self.slot_pos, device=self.device)
        with torch.inference_mode():
            logits, self.cache = self.api.decode(self.params, tokens, pos, self.cache)
            last = logits[:, -1, :].to(torch.float32)
            if fault_slot >= 0:  # chaos: one slot's logit row overwritten on the device
                rows = torch.arange(last.shape[0], device=last.device)[:, None]
                last = torch.where(rows == fault_slot, fault_val, last)
            return self._guarded_tokens(last)

    # -- hooks -------------------------------------------------------------
    def _abort_inflight(self) -> None:
        """Engine-specific teardown of partially prefilled state (drain)."""

    def _step_impl(self) -> List[Request]:  # pragma: no cover - abstract
        raise NotImplementedError


class ServingEngine(_EngineBase):
    """Lockstep tick loop (prefill and decode share the tick); the greedy
    oracle of the reference."""

    def _admit(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self._pop_eligible()
                if req is None:  # the whole queue waits out its backoff
                    return
                self._occupy_slot(s, req)
                self.slot_cursor[s] = 1  # token 0 goes in this tick
                self.next_token[s] = req.prompt[0]

    def _step_impl(self) -> List[Request]:
        """One lockstep tick over all slots; returns requests completed."""
        self._admit()
        if not any(r is not None for r in self.slot_req):
            return []
        self._tick += 1
        sampled, flags = self._decode_tick()
        completed: List[Request] = []
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if flags[s]:  # guardrail tripped: contain before consuming
                dead = self._quarantine(s, req, int(flags[s]))
                if dead is not None:
                    completed.append(dead)
                continue
            self.slot_pos[s] += 1
            if self.slot_cursor[s] < len(req.prompt):  # still prefilling
                self.next_token[s] = req.prompt[self.slot_cursor[s]]
                self.slot_cursor[s] += 1
                continue
            if self._emit(s, int(sampled[s]), req):
                completed.append(req)
        return completed


class StagedEngine(_EngineBase):
    """Staged continuous batching: prefill / insert / generate stages,
    chunked prefill and per-request latency percentiles.  Each ``step()``
    dispatches one stage, so a long prompt costs its running co-residents
    at most one chunk of extra latency between ticks.  Under overload new
    prefills take ``degraded_chunk`` chunks and decode has priority."""

    def __init__(self, api, params: Any, *, sched: SchedulerConfig = SchedulerConfig(), **kwargs):
        super().__init__(api, params, **kwargs)
        if api.insert is None:
            raise ValueError(f"model family {api.cfg.family!r} has no per-slot cache insertion (ModelApi.insert)")
        if sched.prefill_chunk >= self.max_len:
            sched = dataclasses.replace(sched, prefill_chunk=self.max_len - 1)
        self.sched = sched
        self._pf: Optional[PrefillTask] = None
        self._last_action = "generate"
        self.counts = {"prefill_chunks": 0, "generate_ticks": 0, "inserts": 0}

    def _decode_ready(self) -> bool:
        """Any slot generating (occupied and not reserved by the prefill)?"""
        reserved = self._pf.slot if self._pf is not None else None
        return any(r is not None and s != reserved for s, r in enumerate(self.slot_req))

    def _effective_chunk(self) -> int:
        """Prefill chunk budget of new tasks: the configured chunk, or its
        ``degraded_chunk`` under overload."""
        chunk = self.sched.prefill_chunk
        return degraded_chunk(chunk) if self._overload_ctl.overload else chunk

    def _prefill_chunk_hint(self) -> Optional[int]:
        return self._effective_chunk()

    def _start_prefill(self) -> None:
        """Reserve a slot and open a PrefillTask for the queue head."""
        if self._pf is not None or not self.queue:
            return
        s = self._free_slot()
        if s is None:
            return
        req = self._pop_eligible()
        if req is None:  # the whole queue waits out its backoff
            return
        self._occupy_slot(s, req)
        self._pf = PrefillTask(req=req, slot=s, chunks=chunk_plan(len(req.prompt), self._effective_chunk()),
                               cache=self.api.init_cache(1, self.max_len))

    def _abort_inflight(self) -> None:
        self._pf = None

    def _abort_slot(self, s: int) -> None:
        # the slot may be reserved by the in-flight prefill: drop the task too
        if self._pf is not None and self._pf.slot == s:
            self._pf = None
        super()._abort_slot(s)

    def _step_impl(self) -> List[Request]:
        """Dispatch one stage (prefill chunk | generate tick); returns
        requests completed by it."""
        self._start_prefill()
        # degraded mode protects running requests' TPOT: decode priority
        policy = "decode" if self._overload_ctl.overload else self.sched.policy
        action = next_action(policy, prefill_ready=self._pf is not None, decode_ready=self._decode_ready(),
                             last=self._last_action)
        if action == "idle":
            return []
        self._tick += 1
        self._last_action = action
        return self._prefill_dispatch() if action == "prefill" else self._generate_dispatch()

    def _prefill_dispatch(self) -> List[Request]:
        pf = self._pf
        start, size = pf.next_chunk()
        req = pf.req
        toks = torch.as_tensor([req.prompt[start:start + size]], dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            if self.api.prefill_chunk is not None:
                logits, pf.cache = self.api.prefill_chunk(self.params, toks, start, pf.cache)
            else:  # budgeted per-token decode into the private B=1 cache
                for j in range(size):
                    logits, pf.cache = self.api.decode(self.params, toks[:, j:j + 1], start + j, pf.cache)
            pf.advance(size)
            self.counts["prefill_chunks"] += 1
            if not pf.complete:
                return []
            # the first generated token comes from the final chunk's logits,
            # under the tick's guardrail; the finished prefix moves into the
            # reserved decode slot
            self.cache = self.api.insert(self.cache, pf.cache, pf.slot)
            self.counts["inserts"] += 1
            (tok,), (flag,) = self._guarded_tokens(logits[:, -1, :].to(torch.float32))  # the one host sync
        s = pf.slot
        self._pf = None
        if flag:  # poisoned prefill: contain before serving its first token
            dead = self._quarantine(s, req, int(flag))
            return [] if dead is None else [dead]
        self.slot_pos[s] = pf.done_tokens  # == len(prompt): next write position
        return [req] if self._emit(s, int(tok), req) else []

    def _generate_dispatch(self) -> List[Request]:
        sampled, flags = self._decode_tick()
        self.counts["generate_ticks"] += 1
        completed: List[Request] = []
        reserved = self._pf.slot if self._pf is not None else None
        for s, req in enumerate(self.slot_req):
            if req is None or s == reserved:
                continue  # idle or mid-prefill: pad row, output discarded
            if flags[s]:  # guardrail tripped: contain before consuming
                dead = self._quarantine(s, req, int(flags[s]))
                if dead is not None:
                    completed.append(dead)
                continue
            self.slot_pos[s] += 1
            if self._emit(s, int(sampled[s]), req):
                completed.append(req)
        return completed

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        pf = self._pf
        out.update(
            engine="staged", policy=self.sched.policy, prefill_chunk=self.sched.prefill_chunk,
            counts=dict(self.counts),
            inflight_prefill=None if pf is None else {
                "uid": pf.req.uid, "slot": pf.slot, "done_tokens": pf.done_tokens,
                "total_tokens": len(pf.req.prompt),
            },
        )
        return out
