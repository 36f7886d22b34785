"""Seeded, deterministic fault injection for the serving engines and the
artifact load (counterpart of ``repro/serving/faults.py``).

A chaos run must replay exactly, so the injector owns a seeded numpy
generator and a one-shot arming queue and never reads the clock; the same
seed draws the same events as the reference's injector.  Tick fault kinds,
consumed by ``FaultInjector.draw`` once per decode dispatch (see
``_EngineBase._draw_fault``):

  * ``nan_logits`` / ``inf_logits`` / ``sat_logits`` -- overwrite one slot's
    logit row on the device with NaN / Inf / a finite value past the DFP
    saturation horizon;
  * ``kv_corrupt`` -- NaN-fill every float leaf of one slot's decode-cache
    row through the same ``insert`` that clears slots;
  * ``stall_tick`` -- a host-side sleep before the dispatch; the watchdog
    must flag it and tokens must not change.

Artifact-load kinds (``ARTIFACT_FAULT_KINDS``), not drawn per tick:
``FlakyIO`` is a transient read failure for ``checkpoint.io_fault_hook``
(the retry loop must absorb it); ``corrupt_payload`` flips bytes in one
payload file (the sha256 gate must fail the step closed).

CLI: ``repro_torch.launch.serve --chaos "rate=0.01,kinds=nan_logits|
kv_corrupt,seed=0"``.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

TICK_FAULT_KINDS = (
    "nan_logits",
    "inf_logits",
    "sat_logits",
    "kv_corrupt",
    "stall_tick",
)
# kinds exercised around artifact load (not drawn per tick)
ARTIFACT_FAULT_KINDS = ("io_flake", "shard_corrupt")

_DEFAULT_PAYLOAD = {
    "nan_logits": float("nan"),
    "inf_logits": float("inf"),
    "sat_logits": float(2.0 ** 30),  # finite, but past any sane DFP horizon
}


@dataclasses.dataclass
class FaultEvent:
    """One injected fault.  ``tick`` and ``uid`` are stamped when it fires
    (the engine tick, and the uid of the request in the target slot)."""

    kind: str
    slot: int = 0
    payload: Optional[float] = None
    tick: Optional[int] = None
    uid: Optional[int] = None


class FaultInjector:
    """Deterministic fault source for the serving engines.

    ``arm(kind, slot=...)`` queues one fault for the next decode dispatch.
    With ``rate`` > 0 every dispatch with an active slot draws from a
    private ``np.random.default_rng(seed)``: with probability ``rate`` one
    fault of a random ``kinds`` entry hits a random active slot.  ``log``
    records every fired event."""

    def __init__(
        self,
        *,
        rate: float = 0.0,
        kinds: Sequence[str] = ("nan_logits",),
        seed: int = 0,
        stall_s: float = 0.25,
    ):
        for k in kinds:
            if k not in TICK_FAULT_KINDS:
                raise ValueError(
                    f"unknown tick fault kind {k!r}; known: {TICK_FAULT_KINDS}"
                )
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.rate = rate
        self.kinds = tuple(kinds)
        self.stall_s = stall_s
        self._rng = np.random.default_rng(seed)
        self._armed: deque = deque()
        self.log: List[FaultEvent] = []

    def arm(self, kind: str, slot: int = 0, payload: Optional[float] = None):
        """Queue a one-shot fault for the next decode dispatch."""
        if kind not in TICK_FAULT_KINDS:
            raise ValueError(
                f"unknown tick fault kind {kind!r}; known: {TICK_FAULT_KINDS}"
            )
        self._armed.append(FaultEvent(kind=kind, slot=slot, payload=payload))
        return self

    def draw(self, tick: int, active_slots: Sequence[int]) -> Optional[FaultEvent]:
        """One injection decision for the dispatch at ``tick``: an armed
        one-shot fires first (whatever the slots hold); the seeded rate
        targets only slots that hold a request."""
        ev: Optional[FaultEvent] = None
        if self._armed:
            ev = self._armed.popleft()
        elif self.rate > 0.0 and active_slots:
            # one generator call per dispatch whether or not a fault fires,
            # so the decisions are a function of the dispatch ordinal alone
            u = self._rng.random()
            if u < self.rate:
                kind = self.kinds[int(self._rng.integers(len(self.kinds)))]
                slot = active_slots[
                    int(self._rng.integers(len(active_slots)))
                ]
                ev = FaultEvent(kind=kind, slot=int(slot))
        if ev is None:
            return None
        if ev.payload is None:
            ev.payload = _DEFAULT_PAYLOAD.get(ev.kind, self.stall_s)
        ev.tick = tick
        self.log.append(ev)
        return ev

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse a CLI spec: ``rate=0.01,kinds=nan_logits|kv_corrupt,seed=0,
        stall=0.25``.  Unknown keys raise."""
        kw = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            k, _, v = part.partition("=")
            if k == "rate":
                kw["rate"] = float(v)
            elif k == "kinds":
                kw["kinds"] = tuple(filter(None, v.split("|")))
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "stall":
                kw["stall_s"] = float(v)
            else:
                raise ValueError(
                    f"unknown --chaos key {k!r} (known: rate, kinds, seed, stall)"
                )
        return cls(**kw)

    def summary(self) -> dict:
        by_kind: dict = {}
        for ev in self.log:
            by_kind[ev.kind] = by_kind.get(ev.kind, 0) + 1
        return {"injected": len(self.log), "by_kind": by_kind}


# ---------------------------------------------------------------------------
# Artifact-load faults.
# ---------------------------------------------------------------------------
class FlakyIO:
    """Transient-IO fault hook for ``checkpoint.io_fault_hook``: raises
    ``OSError`` on the first ``n_failures`` reads whose file name contains
    ``match`` (empty matches everything), then passes everything through.
    ``raised`` counts the injected failures."""

    def __init__(self, n_failures: int, match: str = ""):
        self.remaining = n_failures
        self.match = match
        self.raised = 0

    def __call__(self, path: str) -> None:
        if self.remaining > 0 and self.match in os.path.basename(path):
            self.remaining -= 1
            self.raised += 1
            raise OSError(f"injected transient IO failure reading {path}")


def corrupt_payload(step_dir: str, seed: int = 0) -> str:
    """Flip bytes inside one payload file of a step directory (sorted file
    list, seeded choice and offset).  An integrity fault: the sha256 gate
    must fail the step closed.  Returns the corrupted file's path."""
    victims = sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))
    if not victims:
        raise ValueError(f"no payload files under {step_dir}")
    rng = np.random.default_rng(seed)
    target = os.path.join(step_dir, victims[int(rng.integers(len(victims)))])
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.seek(int(rng.integers(max(1, size))))
        f.write(b"\xde\xad\xbe\xef")
    return target
