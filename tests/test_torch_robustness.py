"""Port vs reference: the serving fault-tolerance layer -- the armed chaos
containment matrix, quarantine and retry, seeded chaos, guardrail flags,
admission and shedding, deadlines, cancel, overload degradation.

Both packages serve the float qwen3-8b smoke model with the same weights
(``params_from_jax``) and must agree on victims, statuses, reasons, outputs
and event counters.  Time runs on a manual clock installed as each engine's
``_clock`` (``time.sleep`` advances it), so no case waits on the wall and
both packages see the same times.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import build_model as jbuild
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.serving import AdmissionConfig as JAdmissionConfig
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import HealthConfig as JHealthConfig
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import ServingEngine as JServing
from repro.serving import StagedEngine as JStaged
from repro.serving.health import OverloadController as JOverloadController
from repro.serving.health import poison_flags as jpoison_flags
from repro.serving.scheduler import admission_decision as jadmission_decision
from repro.serving.scheduler import estimate_ttft_ms as jestimate_ttft_ms
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.serving import (
    AdmissionConfig, FaultInjector, HealthConfig, OverloadController, Request, SchedulerConfig, ServingEngine,
    StagedEngine, admission_decision, degraded_chunk, describe_poison, estimate_ttft_ms, poison_flags,
)
from repro_torch.serving.health import POISON_NONFINITE, POISON_SATURATED

ARCH = "qwen3-8b"
PROMPTS = ([5, 6, 7], [11, 3], [2, 9, 4, 1])
PKGS = {  # the reference's names, then the port's
    "jax": dict(lockstep=JServing, staged=JStaged, Request=JRequest, Sched=JSchedulerConfig,
                Injector=JFaultInjector, Health=JHealthConfig, Admission=JAdmissionConfig),
    "port": dict(lockstep=ServingEngine, staged=StagedEngine, Request=Request, Sched=SchedulerConfig,
                 Injector=FaultInjector, Health=HealthConfig, Admission=AdmissionConfig),
}


class ManualClock:
    """An engine clock that moves only when told to or slept on."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = ManualClock()
    monkeypatch.setattr(time, "sleep", c.sleep)  # backoff waits and stall faults
    return c


@pytest.fixture(scope="module")
def models():
    """The float smoke model in both packages, with the same weights."""
    japi = jbuild(jconfigs.get_smoke(ARCH))
    params = japi.init(jax.random.PRNGKey(0))
    tapi = tbuild(tconfigs.get_smoke(ARCH), device="cpu")
    return {"jax": (japi, params), "port": (tapi, params_from_jax(params, device="cpu"))}


def _engine(models, pkg, engine, clock, *, n_slots=4, faults=None, health=None, admission=None, chunk=2):
    names = PKGS[pkg]
    api, params = models[pkg]
    kw = dict(n_slots=n_slots, max_len=32, faults=faults)
    if health is not None:
        kw["health"] = health
    if admission is not None:
        kw["admission"] = admission
    if engine == "staged":
        kw["sched"] = names["Sched"](prefill_chunk=chunk)
    eng = names[engine](api, params, **kw)
    eng._clock = clock
    return eng


def _submit(eng, pkg, prompts=PROMPTS, max_new=5, **kw):
    return [eng.submit(PKGS[pkg]["Request"](uid=i, prompt=list(p), max_new_tokens=max_new, **kw))
            for i, p in enumerate(prompts)]


def _report(done):
    return {r.uid: (r.status, r.reason, list(r.output), r.retries) for r in done}


def _events(eng):
    return eng.stats()["health"]["events"]


def _baseline(models, pkg, engine, clock):
    eng = _engine(models, pkg, engine, clock)
    _submit(eng, pkg)
    return _report(eng.run(max_ticks=4000))


@pytest.fixture(scope="module")
def baselines(models):
    """Fault-free outputs of both engines in both packages (each package
    gives the other's tokens)."""
    out = {}
    for engine in ("lockstep", "staged"):
        runs = {pkg: _baseline(models, pkg, engine, ManualClock()) for pkg in PKGS}
        assert runs["jax"] == runs["port"]
        assert all(status == "finished" for status, *_ in runs["port"].values())
        out[engine] = runs["port"]
    assert out["lockstep"] == out["staged"]
    return out


# ---------------------------------------------------------------------------
# the chaos matrix: one fault -> one victim, everyone else bit-identical
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["lockstep", "staged"])
@pytest.mark.parametrize("kind", ["nan_logits", "inf_logits", "sat_logits", "kv_corrupt"])
def test_chaos_matrix_matches_reference(models, baselines, clock, engine, kind):
    """Armed on slot 0 after two healthy steps (so a corrupt KV row is
    live): the victim fails with retry budget 0, every other request
    finishes with the fault-free tokens -- in both packages, with the same
    victim, statuses, reasons, outputs and event counters."""
    got = {}
    for pkg in PKGS:
        inj = PKGS[pkg]["Injector"]()
        eng = _engine(models, pkg, engine, clock, faults=inj)
        _submit(eng, pkg)
        done = eng.step() + eng.step()
        inj.arm(kind, slot=0)
        done += eng.run(max_ticks=4000)
        assert len(inj.log) == 1
        got[pkg] = (inj.log[0].uid, inj.log[0].tick, _report(done), _events(eng))
    assert got["port"] == got["jax"]
    victim, _, report, events = got["port"]
    assert victim is not None and report[victim][0] == "failed" and report[victim][1]
    for uid, (status, _, output, _) in report.items():
        if uid != victim:
            assert status == "finished" and output == baselines[engine][uid][2]
    assert events["quarantined"] == events["failed"] == events["faults_injected"] == 1


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_quarantine_retry_recovers_bit_identical(models, baselines, clock, engine):
    """With a retry budget the victim is re-queued (backoff on the manual
    clock), replays from its prompt and gives the fault-free tokens."""
    got = {}
    for pkg in PKGS:
        inj = PKGS[pkg]["Injector"]().arm("nan_logits", slot=0)
        eng = _engine(models, pkg, engine, clock, faults=inj)
        _submit(eng, pkg, max_retries=1)
        got[pkg] = (_report(eng.run(max_ticks=4000)), _events(eng), inj.log[0].uid)
    assert got["port"] == got["jax"]
    report, events, victim = got["port"]
    assert {u: r[2] for u, r in report.items()} == {u: r[2] for u, r in baselines[engine].items()}
    assert all(r[0] == "finished" for r in report.values()) and report[victim][3] == 1
    assert events["quarantined"] == events["retried"] == 1 and events["failed"] == 0


def test_stall_tick_flags_watchdog_not_tokens(models, baselines, clock):
    got = {}
    for pkg in PKGS:
        inj = PKGS[pkg]["Injector"](stall_s=0.12).arm("stall_tick")
        eng = _engine(models, pkg, "lockstep", clock, faults=inj, health=PKGS[pkg]["Health"](tick_slow_s=0.1))
        _submit(eng, pkg)
        report = _report(eng.run(max_ticks=4000))
        h = eng.stats()["health"]
        got[pkg] = (report, h["slow_ticks"], h["hung_ticks"], h["tick_ms_worst"], h["ticks"])
    assert got["port"] == got["jax"]
    assert got["port"][0] == baselines["lockstep"]
    assert got["port"][1] == 1 and got["port"][3] == pytest.approx(120.0)


def test_seeded_rate_injection_matches_reference(models, clock):
    """Rate-mode chaos with retries: the same faults hit the same slots at
    the same ticks in both packages, with the same outcome."""
    got = {}
    for pkg in PKGS:
        inj = PKGS[pkg]["Injector"](rate=0.3, kinds=("nan_logits", "sat_logits", "kv_corrupt"), seed=7)
        eng = _engine(models, pkg, "lockstep", clock, faults=inj,
                      admission=PKGS[pkg]["Admission"](retry_backoff_ms=0.0))
        _submit(eng, pkg, max_retries=2)
        report = _report(eng.run(max_ticks=4000))
        got[pkg] = ([(e.kind, e.slot, e.tick, e.uid, e.payload) for e in inj.log], report, _events(eng))
    assert repr(got["port"]) == repr(got["jax"])  # repr: NaN payloads compare equal
    assert len(got["port"][0]) >= 2


def test_fault_injector_spec_and_draws_match_reference():
    spec = "rate=0.25,kinds=nan_logits|kv_corrupt|stall_tick,seed=9,stall=0.5"
    inj, jinj = FaultInjector.from_spec(spec), JFaultInjector.from_spec(spec)
    assert (inj.rate, inj.kinds, inj.stall_s) == (jinj.rate, jinj.kinds, jinj.stall_s)
    active = [[0, 1, 2, 3], [1, 3], [], [2], [0, 1, 2, 3]] * 20
    for tick, slots in enumerate(active):
        inj.draw(tick, slots), jinj.draw(tick, slots)
    log = [dataclasses.astuple(e) for e in inj.log]
    assert repr(log) == repr([dataclasses.astuple(e) for e in jinj.log]) and len(log) > 5  # NaN payloads
    assert inj.summary() == jinj.summary()
    with pytest.raises(ValueError, match="unknown --chaos key"):
        FaultInjector.from_spec("rat=0.1")
    with pytest.raises(ValueError, match="unknown tick fault kind"):
        FaultInjector(kinds=("bitrot",))
    with pytest.raises(ValueError, match="rate"):
        FaultInjector(rate=1.5)
    assert FaultInjector(rate=1.0).draw(0, []) is None  # nothing active: nothing to poison


def test_poison_flags_bits_match_reference():
    rows = np.asarray([
        [1.0, -2.0, 3.0],  # healthy
        [1.0, np.nan, 0.0],  # NaN
        [np.inf, 0.0, 0.0],  # Inf
        [-np.inf, 0.0, 0.0],  # -Inf
        [2.0 ** 30, 0.0, 0.0],  # finite but saturated
        [0.0, -(2.0 ** 24), 0.0],  # exactly at the horizon
        [np.nan, 2.0 ** 30, 0.0],  # both
    ], np.float32)
    want = np.asarray(jpoison_flags(jnp.asarray(rows), sat_limit=2.0 ** 24))
    got = poison_flags(torch.from_numpy(rows), sat_limit=2.0 ** 24)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert got.tolist() == [0, POISON_NONFINITE, POISON_NONFINITE, POISON_NONFINITE, POISON_SATURATED,
                            POISON_SATURATED, POISON_NONFINITE | POISON_SATURATED]
    bf16 = poison_flags(torch.from_numpy(rows).to(torch.bfloat16), sat_limit=2.0 ** 24)
    assert bf16.tolist() == got.tolist()
    assert "non-finite" in describe_poison(POISON_NONFINITE) and "saturated" in describe_poison(POISON_SATURATED)


def test_guardrails_do_not_change_tokens(models, baselines, clock):
    eng = _engine(models, "port", "lockstep", clock, health=HealthConfig(guardrails=False))
    _submit(eng, "port")
    assert _report(eng.run(max_ticks=4000)) == baselines["lockstep"]


# ---------------------------------------------------------------------------
# admission, shedding, deadlines, cancel
# ---------------------------------------------------------------------------
def test_estimate_and_admission_units_match_reference():
    for kw in [dict(queued_tokens=10, n_queued=2, tick_ms=0.0), dict(queued_tokens=10, n_queued=2, tick_ms=2.0),
               dict(queued_tokens=10, n_queued=2, tick_ms=2.0, chunk=4), dict(queued_tokens=0, n_queued=0,
                                                                             tick_ms=3.5, chunk=8)]:
        assert estimate_ttft_ms(**kw) == jestimate_ttft_ms(**kw)
    assert estimate_ttft_ms(queued_tokens=10, n_queued=2, tick_ms=2.0) == 24.0
    assert estimate_ttft_ms(queued_tokens=10, n_queued=2, tick_ms=2.0, chunk=4) == 10.0
    cases = [(dict(max_queue=2, ttft_slo_ms=50.0), dict(queue_depth=1, est_ttft_ms=10.0)),
             (dict(max_queue=2, ttft_slo_ms=50.0), dict(queue_depth=2, est_ttft_ms=0.0)),
             (dict(max_queue=2, ttft_slo_ms=50.0), dict(queue_depth=0, est_ttft_ms=51.0)),
             (dict(), dict(queue_depth=0, est_ttft_ms=30.0, deadline_ms=20.0)),
             (dict(ttft_slo_ms=50.0), dict(queue_depth=9, est_ttft_ms=30.0, deadline_ms=40.0))]
    got = [admission_decision(AdmissionConfig(**a), **kw) for a, kw in cases]
    assert got == [jadmission_decision(JAdmissionConfig(**a), **kw) for a, kw in cases]
    assert got[0] is None and "max_queue" in got[1] and "TTFT" in got[2] and "TTFT" in got[3] and got[4] is None


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_admission_sheds_on_queue_depth(models, clock, engine):
    got = {}
    for pkg in PKGS:
        eng = _engine(models, pkg, engine, clock, n_slots=1, admission=PKGS[pkg]["Admission"](max_queue=2))
        rs = _submit(eng, pkg, prompts=[[3, 4]] * 4, max_new=2)
        got[pkg] = ([(r.status, r.reason) for r in rs], _report(eng.run()), _events(eng))
    assert got["port"] == got["jax"]
    assert [s for s, _ in got["port"][0]] == ["queued", "queued", "shed", "shed"]
    assert sorted(got["port"][1]) == [0, 1] and got["port"][2]["shed"] == 2


def test_ttft_slo_sheds_on_the_estimate(models, clock):
    """Once a slow tick has set the watchdog's EWMA, the estimated TTFT of
    a deep queue blows the SLO and later submissions are shed."""
    got = {}
    for pkg in PKGS:
        eng = _engine(models, pkg, "staged", clock, n_slots=1, chunk=4,
                      admission=PKGS[pkg]["Admission"](ttft_slo_ms=150.0))
        eng.watchdog.observe(0.030)  # one 30 ms dispatch seen: 9-token prompts cost 3 chunks + 1 tick
        rs = _submit(eng, pkg, prompts=[[1] * 9] * 5, max_new=2)
        got[pkg] = [(r.status, r.reason) for r in rs]
    assert got["port"] == got["jax"]
    assert [s for s, _ in got["port"]] == ["queued", "queued", "shed", "shed", "shed"]


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_deadlines_expire_queued_and_inflight(models, clock, engine):
    """uid 0 expires in its slot, uid 1 in the queue; uid 2 (no deadline)
    takes the freed slot and finishes."""
    got = {}
    for pkg in PKGS:
        eng = _engine(models, pkg, engine, clock, n_slots=1)
        req = PKGS[pkg]["Request"]
        rs = [eng.submit(req(uid=0, prompt=[5, 6], max_new_tokens=6, deadline_ms=5.0)),
              eng.submit(req(uid=1, prompt=[5, 6], max_new_tokens=6, deadline_ms=5.0)),
              eng.submit(req(uid=2, prompt=[7, 8], max_new_tokens=3))]
        done = eng.step()  # uid 0 takes the slot
        assert rs[0] in eng.slot_req
        clock.sleep(0.010)
        done += eng.run()
        got[pkg] = (_report(done), _events(eng))
    assert got["port"] == got["jax"]
    report, events = got["port"]
    assert report[0][0] == report[1][0] == "expired" and "deadline" in report[0][1]
    assert report[2][0] == "finished" and events["expired"] == 2


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_cancel_queued_and_inflight(models, clock, engine):
    got = {}
    for pkg in PKGS:
        eng = _engine(models, pkg, engine, clock, n_slots=1)
        a, b = _submit(eng, pkg, prompts=[[5, 6], [7, 8]], max_new=8)
        eng.step()  # admits a
        flags = [eng.cancel(0), eng.cancel(1), eng.cancel(99)]
        got[pkg] = (flags, a.status, b.status, a.reason, eng.run(), _events(eng)["cancelled"],
                    eng.leftover() == {"in_flight": [], "queued": []})
    assert got["port"] == got["jax"] == ([True, True, False], "cancelled", "cancelled", "cancelled by client",
                                         [], 2, True)


def test_submit_rejects_malformed_and_strict_raises(models, clock):
    for pkg in PKGS:
        eng = _engine(models, pkg, "staged", clock)
        req = PKGS[pkg]["Request"]
        empty, long = eng.submit(req(uid=0, prompt=[])), eng.submit(req(uid=1, prompt=[1] * 32))
        assert (empty.status, empty.reason) == ("rejected", "empty prompt")
        assert long.status == "rejected" and "max_len=32" in long.reason
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(req(uid=2, prompt=[]), strict=True)
        assert _events(eng)["rejected"] == 2 and empty.terminal and not eng.queue


# ---------------------------------------------------------------------------
# overload degradation
# ---------------------------------------------------------------------------
def test_overload_controller_hysteresis_matches_reference():
    for cfg in [dict(overload_queue=4), dict(overload_tpot_ms=10.0), dict(overload_queue=4, overload_tpot_ms=10.0)]:
        ctl, jctl = OverloadController(HealthConfig(**cfg)), JOverloadController(JHealthConfig(**cfg))
        trace = []
        for depth, tpot in [(4, 9.0), (5, 9.0), (4, 11.0), (3, 7.0), (3, 7.0), (0, 1.0), (6, 1.0), (2, 1.0)]:
            ctl.note_tpot_ms(tpot), jctl.note_tpot_ms(tpot)
            trace.append((ctl.update(queue_depth=depth), jctl.update(queue_depth=depth)))
        assert all(a == b for a, b in trace) and ctl.summary() == jctl.summary()
    ctl = OverloadController(HealthConfig(overload_queue=4))
    assert [ctl.update(queue_depth=d) for d in (4, 5, 4, 3)] == [False, True, True, False] and ctl.entered == 1


def test_staged_overload_degrades_and_recovers(models, clock):
    """Queue-depth overload shrinks new prefill chunks to degraded_chunk and
    forces decode priority; everything finishes and the engine recovers."""
    got = {}
    for pkg in PKGS:
        eng = _engine(models, pkg, "staged", clock, n_slots=2, health=PKGS[pkg]["Health"](overload_queue=2))
        eng.sched = dataclasses.replace(eng.sched, prefill_chunk=8, policy="prefill")
        _submit(eng, pkg, prompts=[[1 + i, 2, 3] for i in range(8)], max_new=2)
        eng.step()  # queue depth 7 > 2: overload latches
        degraded = (eng.overload, eng._effective_chunk())
        report = _report(eng.run(max_ticks=4000))
        h = eng.stats()["health"]
        got[pkg] = (degraded, report, h["overload_entered"], eng.overload, eng.counts)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (True, degraded_chunk(8)) and len(got["port"][1]) == 8
    assert got["port"][2] >= 1 and got["port"][3] is False


# ---------------------------------------------------------------------------
# PTQ: the 8-bit DFP quantizers launder a NaN cache row
# ---------------------------------------------------------------------------
def test_ptq_kv_corrupt_matches_reference(clock):
    """kv_corrupt on the PTQ smoke model over kv_bf16: whatever the
    reference does with the NaN rows (its int8 casts map NaN to 0), the port
    does the same -- the same statuses, tokens and events."""
    ptq = dict(w_bits=2, group_size=16, mode="ptq")
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **ptq)), kv_fmt="kv_bf16")
    japi = jbuild(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    jq, jplan, _ = jquantize_and_plan(japi, params)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH, TQuantConfig(backend="cuda", **ptq)), kv_fmt="kv_bf16")
    tq, _, tapi = tquantize_and_plan(tbuild(tcfg, device="cpu"), params_from_jax(params, device="cpu"))
    models = {"jax": (japi.with_plan(jplan), jq), "port": (tapi, tq)}
    got = {}
    for pkg in PKGS:
        inj = PKGS[pkg]["Injector"]()
        eng = _engine(models, pkg, "lockstep", clock, faults=inj)
        _submit(eng, pkg)
        done = eng.step() + eng.step()
        inj.arm("kv_corrupt", slot=0)
        done += eng.run(max_ticks=4000)
        got[pkg] = (inj.log[0].uid, _report(done), _events(eng))
    assert got["port"] == got["jax"]
