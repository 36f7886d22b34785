"""Serving engines over slot-based decode state (counterpart of
``repro/serving/engine.py`` without its fault tolerance): the lockstep
oracle and the staged continuous-batching engine.

``ServingEngine`` (lockstep): all ``n_slots`` step through one decode call
per tick -- slots consuming their prompt feed the next prompt token,
generating slots feed their last sampled token, idle slots feed a pad token
whose output is discarded.  It is the greedy oracle the staged engine is
tested against.

``StagedEngine`` splits serving into three stages:

  * ``prefill``  -- ``prefill_chunk`` consumes a prompt chunk (B=1) against
    a private cache, chunked at a token budget (``SchedulerConfig``);
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

Admission control, deadlines, cancel, guardrail quarantine, retries and
chaos are not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import LatencyStats, PrefillTask, SchedulerConfig, chunk_plan, next_action


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "pending"  # pending -> queued -> running -> finished | rejected
    reason: Optional[str] = None
    admitted_tick: Optional[int] = None  # engine tick this request got a slot
    # wall-clock SLO trace (time.monotonic seconds): submit -> prefill_start
    # (queue wait) -> first_token (TTFT) -> finish
    submit_t: Optional[float] = None
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None


class _EngineBase:
    """Slot and queue bookkeeping shared by the lockstep and staged engines."""

    def __init__(self, api, params: Any, n_slots: int = 4, max_len: int = 256,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0):
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampler = sampler
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
        self._clock = time.monotonic
        self._lat = LatencyStats()
        self._zero_prefix = None  # lazy fresh B=1 cache (slot clearing)

    # -- client API --------------------------------------------------------
    def submit(self, req: Request) -> Request:
        """Queue ``req``, or return it ``rejected`` with a reason (empty
        prompt, or a prompt that cannot fit ``max_len``)."""
        req.submit_t = self._clock()
        if not req.prompt:
            req.status, req.reason = "rejected", "empty prompt"
        elif len(req.prompt) >= self.max_len:
            req.status, req.reason = "rejected", (
                f"prompt of {len(req.prompt)} tokens cannot fit engine max_len={self.max_len}"
            )
        else:
            req.status = "queued"
            self.queue.append(req)
        return req

    def run(self, max_ticks: int = 1_000) -> List[Request]:
        """Step until idle or the step budget expires; returns finished
        requests.  Unfinished ones stay inside (``leftover``, ``drain``)."""
        completed: List[Request] = []
        ticks = 0
        while self._has_work() and ticks < max_ticks:
            completed.extend(self.step())
            ticks += 1
        return completed

    def step(self) -> List[Request]:  # pragma: no cover - abstract
        raise NotImplementedError

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
            # per-request percentiles over finished requests (seconds)
            "latency": self._lat.summary(),
        }

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
            req.done = True
            req.status = "finished"
            req.finish_t = self._clock()
            self._lat.record(req)
            self._reset_slot(s)
            return True
        self.next_token[s] = tok
        return False

    def _abort_inflight(self) -> None:
        """Engine-specific teardown of partially prefilled state (drain)."""

    def _decode_tick(self) -> np.ndarray:
        """One decode call over every slot; the sampled tokens on the host
        (the one host sync of the tick)."""
        tokens = torch.as_tensor(self.next_token[:, None], device=self.device)
        pos = torch.as_tensor(self.slot_pos, device=self.device)
        with torch.inference_mode():
            logits, self.cache = self.api.decode(self.params, tokens, pos, self.cache)
            sampled = sample(self.gen, logits[:, -1, :], self.sampler)
        return sampled.cpu().numpy()


class ServingEngine(_EngineBase):
    """Lockstep tick loop (prefill and decode share the tick); the greedy
    oracle of the reference."""

    def _admit(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                self._occupy_slot(s, req)
                self.slot_cursor[s] = 1  # token 0 goes in this tick
                self.next_token[s] = req.prompt[0]

    def step(self) -> List[Request]:
        """One lockstep tick over all slots; returns requests completed."""
        self._admit()
        if not any(r is not None for r in self.slot_req):
            return []
        self._tick += 1
        sampled = self._decode_tick()
        completed: List[Request] = []
        for s, req in enumerate(self.slot_req):
            if req is None:
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
    at most one chunk of extra latency between ticks."""

    def __init__(self, api, params: Any, *, sched: SchedulerConfig = SchedulerConfig(), **kwargs):
        super().__init__(api, params, **kwargs)
        if api.prefill_chunk is None or api.insert is None:
            raise ValueError(f"model family {api.cfg.family!r} has no prefill_chunk/insert")
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

    def _start_prefill(self) -> None:
        """Reserve a slot and open a PrefillTask for the queue head."""
        if self._pf is not None or not self.queue:
            return
        s = self._free_slot()
        if s is None:
            return
        req = self.queue.popleft()
        self._occupy_slot(s, req)
        self._pf = PrefillTask(req=req, slot=s, chunks=chunk_plan(len(req.prompt), self.sched.prefill_chunk),
                               cache=self.api.init_cache(1, self.max_len))

    def _abort_inflight(self) -> None:
        self._pf = None

    def step(self) -> List[Request]:
        """Dispatch one stage (prefill chunk | generate tick); returns
        requests completed by it."""
        self._start_prefill()
        action = next_action(self.sched.policy, prefill_ready=self._pf is not None,
                             decode_ready=self._decode_ready(), last=self._last_action)
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
            logits, pf.cache = self.api.prefill_chunk(self.params, toks, start, pf.cache)
            pf.advance(size)
            self.counts["prefill_chunks"] += 1
            if not pf.complete:
                return []
            # the first generated token comes from the final chunk's logits;
            # the finished prefix moves into the reserved decode slot
            tok = sample(self.gen, logits[:, -1, :], self.sampler)
            self.cache = self.api.insert(self.cache, pf.cache, pf.slot)
            self.counts["inserts"] += 1
        tok = int(tok.cpu()[0])  # the one host sync
        s = pf.slot
        self._pf = None
        self.slot_pos[s] = pf.done_tokens  # == len(prompt): next write position
        return [req] if self._emit(s, tok, req) else []

    def _generate_dispatch(self) -> List[Request]:
        sampled = self._decode_tick()
        self.counts["generate_ticks"] += 1
        completed: List[Request] = []
        reserved = self._pf.slot if self._pf is not None else None
        for s, req in enumerate(self.slot_req):
            if req is None or s == reserved:
                continue  # idle or mid-prefill: pad row, output discarded
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
