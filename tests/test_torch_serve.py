"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU: ``main(argv)`` with ``--smoke --device cpu`` boots the PTQ smoke
model, serves the seeded requests and prints the reference's report."""
import json
import re

import jax
import pytest

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import build_model as jbuild
from repro.models import quantize_and_plan as jquantize_and_plan
from repro_torch.launch import serve

BASE = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--requests", "8"]
CHAOS = "rate=0.05,kinds=nan_logits|inf_logits|sat_logits|stall_tick,seed=0,stall=0.01"


def _serve(capsys, *extra):
    run = serve.main(BASE + list(extra))
    out = capsys.readouterr().out
    printed = {int(u): json.loads(toks) for u, toks in re.findall(r"^  req (\d+): (\[.*\])$", out, re.M)}
    return run, out, printed


@pytest.fixture(scope="module")
def fault_free():
    """The staged engine's fault-free outputs by uid."""
    run = serve.main(BASE)
    return {r.uid: r.output for r in run.done}


def test_staged_and_lockstep_print_the_same_tokens(capsys, fault_free):
    staged, out_s, printed_s = _serve(capsys, "--engine", "staged", "--prefill-chunk", "4")
    lockstep, out_l, printed_l = _serve(capsys, "--engine", "lockstep")
    assert len(printed_s) == 4 and printed_s == printed_l
    assert {r.uid: r.output for r in staged.done} == {r.uid: r.output for r in lockstep.done}
    assert {r.uid: r.output for r in staged.done} == fault_free
    assert len(staged.done) == 8 and all(r.status == "finished" and len(r.output) == 8 for r in staged.done)
    for out in (out_s, out_l):
        assert re.search(r"weights [\d.]+ MB -> [\d.]+ MB \([\d.]+x\)  plan: \d+ sites, 0 calibrated", out)
        assert "kv cache: fmt=kv_bf16 flash_decode=False flash_prefill=False" in out
        assert "8 finished / 64 tokens in" in out and "ticks=" in out and "overload_entered=0" in out
        for name in ("queue_wait", "ttft", "tpot"):
            assert re.search(rf"^  {name}\s+p50=", out, re.M)
    assert "engine=staged policy=decode prefill_chunk=4" in out_s
    assert "engine=lockstep (shared-tick oracle)" in out_l


@pytest.mark.parametrize("engine", ["staged", "lockstep"])
def test_chaos_reports_faults_and_keeps_outputs(capsys, fault_free, engine):
    """Seeded chaos with a retry budget: the faults are reported, every
    finished request prints the fault-free tokens (a retry replays from the
    prompt), anything else failed with its budget spent."""
    run, out, printed = _serve(capsys, "--engine", engine, "--chaos", CHAOS, "--retries", "3")
    assert f"chaos: rate=0.05 kinds={CHAOS.split('kinds=')[1].split(',')[0]}" in out
    faults = run.engine.stats()["health"]["faults"]
    assert faults["injected"] >= 1 and f"chaos injected: {faults}" in out
    events = run.engine.stats()["health"]["events"]
    if events["quarantined"]:
        assert "fault tolerance: shed=0 rejected=0 expired=0 quarantined=" in out
    assert len(run.done) == 8 and not run.engine.leftover()["in_flight"]
    for r in run.done:
        if r.status == "finished":
            assert r.output == fault_free[r.uid]
        else:
            assert r.status == "failed" and "retry budget exhausted" in r.reason
    status = {r.uid: r.status for r in run.done}
    assert all(printed[u] == fault_free[u] for u in printed if status[u] == "finished")


def test_deadline_and_queue_flags_reach_the_engine(capsys):
    run, out, _ = _serve(capsys, "--engine", "lockstep", "--slots", "1", "--max-queue", "3", "--deadline-ms", "1e9")
    statuses = sorted(r.status for r in run.done + run.not_admitted)
    assert statuses == ["finished"] * 3 + ["shed"] * 5  # all 8 submitted before the first tick
    assert "fault tolerance: shed=5" in out and "max_queue 3" in out
    assert all(r.deadline_ms == 1e9 for r in run.done)


@pytest.mark.parametrize("flag,value,step", [
    ("--artifact", "x", "Queue A step 3"), ("--save-artifact", "x", "Queue A steps 3 and 8"),
    ("--calibrate", "2", "Queue A step 8"), ("--mesh", "dp=2", "Queue A step 10"),
    ("--compile-cache", "x", "XLA's persistent compilation cache"),
])
def test_unported_flags_exit_naming_their_step(capsys, flag, value, step):
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + [flag, value])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and step in err


def test_plan_json_is_the_reference_plan(capsys, tmp_path):
    """--plan-json writes the reference's plan JSON for the same config."""
    path = tmp_path / "plan.json"
    serve.main(BASE + ["--requests", "1", "--plan-json", str(path)])
    assert f"wrote QuantPlan to {path}" in capsys.readouterr().out
    got = json.loads(path.read_text())
    japi = jbuild(jconfigs.get_smoke("qwen3-8b", JQuantConfig(w_bits=2, group_size=16, mode="ptq", backend="auto")))
    _, jplan, _ = jquantize_and_plan(japi, japi.init(jax.random.PRNGKey(0)))
    want = json.loads(jplan.to_json())
    assert dict(got.pop("sites")) == dict(want.pop("sites"))  # the same sites, in the port's tree order
    assert got == want
