"""Lockstep serving engine (counterpart of the reference's
``repro/serving/engine.py::ServingEngine`` without faults).

All ``n_slots`` step through one decode call per tick: slots consuming
their prompt feed the next prompt token, generating slots feed their last
sampled token, idle slots feed a pad token whose output is discarded.  The
reference's fault-free tick passes ``fault_slot=-1``, so this tick computes
exactly what it computes.  Admission control, deadlines, guardrail
quarantine, retries and chaos come with the staged engine's slice.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.sampler import SamplerConfig, sample


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


class ServingEngine:
    """Lockstep tick loop; the greedy oracle of the reference."""

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

    # -- client API --------------------------------------------------------
    def submit(self, req: Request) -> Request:
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
        """Step until idle or the tick budget expires; returns finished requests."""
        completed: List[Request] = []
        ticks = 0
        while self._has_work() and ticks < max_ticks:
            completed.extend(self.step())
            ticks += 1
        return completed

    def step(self) -> List[Request]:
        """One lockstep tick over all slots; returns requests completed."""
        self._admit()
        if not any(r is not None for r in self.slot_req):
            return []
        self._tick += 1
        tokens = torch.as_tensor(self.next_token[:, None], device=self.device)
        pos = torch.as_tensor(self.slot_pos, device=self.device)
        with torch.inference_mode():
            logits, self.cache = self.api.decode(self.params, tokens, pos, self.cache)
            sampled = sample(self.gen, logits[:, -1, :], self.sampler)
        sampled = sampled.cpu().numpy()  # the one host sync per tick

        completed: List[Request] = []
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_pos[s] += 1
            if self.slot_cursor[s] < len(req.prompt):  # still prefilling
                self.next_token[s] = req.prompt[self.slot_cursor[s]]
                self.slot_cursor[s] += 1
                continue
            tok = int(sampled[s])
            req.output.append(tok)
            self._tokens += 1
            if self._check_done(s, tok, req):
                completed.append(req)
                self._finish(s, req)
            else:
                self.next_token[s] = tok
        return completed

    def stats(self) -> Dict[str, Any]:
        return {
            "active": sum(r is not None for r in self.slot_req),
            "queued": len(self.queue),
            "tick": self._tick,
            "tokens": self._tokens,
            "positions": self.slot_pos.tolist(),
        }

    # -- slot lifecycle ----------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def _reset_slot(self, s: int) -> None:
        self.slot_req[s] = None
        self.slot_pos[s] = 0
        self.slot_cursor[s] = 0
        self.next_token[s] = 0

    def _admit(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                self._reset_slot(s)
                for leaf in self.cache.values():  # scrub the slot's cache rows
                    leaf[:, s].zero_()
                req.status = "running"
                self.slot_req[s] = req
                self.slot_cursor[s] = 1  # token 0 goes in this tick
                self.next_token[s] = req.prompt[0]

    def _check_done(self, s: int, tok: int, req: Request) -> bool:
        hit_eos = req.eos_id is not None and tok == req.eos_id
        return (len(req.output) >= req.max_new_tokens or hit_eos
                or self.slot_pos[s] >= self.max_len - 1)

    def _finish(self, s: int, req: Request) -> None:
        req.done = True
        req.status = "finished"
        self._reset_slot(s)
