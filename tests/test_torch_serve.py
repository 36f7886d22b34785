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
from repro.models import make_smoke_batch as jmake_smoke_batch
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.models import save_servable as jsave_servable
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
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


@pytest.mark.parametrize("flag,value,said", [
    ("--mesh", "dp=2", ("--mesh dp=2 has 2 ranks but WORLD_SIZE is 1", "torch.distributed.run --nproc_per_node 2")),
    ("--compile-cache", "x", ("--compile-cache is not ported yet", "XLA's persistent compilation cache")),
])
def test_unported_flags_exit_naming_their_step(capsys, flag, value, said, monkeypatch):
    """--compile-cache names why it is refused; --mesh refuses a mesh whose
    size is not the launch's WORLD_SIZE, naming both."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + [flag, value])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert all(s in err for s in said), err


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


@pytest.mark.parametrize("engine", ["staged", "lockstep"])
def test_calibrate_save_then_artifact_print_the_same_tokens(capsys, tmp_path, engine):
    """Quantize on boot with --calibrate and --save-artifact, then cold-start
    from the artifact: the same plan, the same tokens, in both engines."""
    art = str(tmp_path / "art")
    warm, out_w, printed_w = _serve(capsys, "--engine", engine, "--calibrate", "2", "--save-artifact", art)
    assert re.search(r"plan: 8 sites, 8 calibrated", out_w)
    assert f"saved packed artifact to {art}/step_000000000 (serve it with --artifact {art})" in out_w
    run = serve.main(["--artifact", art, "--device", "cpu", "--requests", "8", "--engine", engine])
    out_c = capsys.readouterr().out
    assert re.search(rf"arch=qwen3-8b-smoke cold-started from {art}/step_000000000 in [\d.]+s: [\d.]+ MB packed, "
                     r"plan: 8 sites, 8 calibrated \(fp32 never materialized\)", out_c)
    assert {r.uid: r.output for r in run.done} == {r.uid: r.output for r in warm.done}
    assert len(run.done) == 8 and all(r.status == "finished" and len(r.output) == 8 for r in run.done)
    assert run.engine.api.ctx.plan.act_exponents == warm.engine.api.ctx.plan.act_exponents


def test_reference_artifact_serves_the_reference_tokens(capsys, tmp_path):
    """An artifact the reference calibrated and wrote, served by the port's
    launcher (lockstep) with the reference engine's greedy tokens."""
    cfg = jconfigs.get_smoke("qwen3-8b", JQuantConfig(w_bits=2, group_size=16, mode="ptq", backend="ref"))
    japi = jbuild(cfg)
    calib = [jmake_smoke_batch(jax.random.PRNGKey(100 + i), cfg, batch=2, seq=16) for i in range(2)]
    jq, jplan, jqapi = jquantize_and_plan(japi, japi.init(jax.random.PRNGKey(0)), calib_batches=calib)
    jsave_servable(str(tmp_path), jqapi, jq, jplan)
    run = serve.main(["--artifact", str(tmp_path), "--device", "cpu", "--requests", "4", "--engine", "lockstep"])
    assert "plan: 8 sites, 8 calibrated" in capsys.readouterr().out
    jeng = JEngine(jqapi, jq, n_slots=4, max_len=64)
    for i, prompt in enumerate(serve.draw_prompts(4, cfg.vocab)):
        jeng.submit(JRequest(uid=i, prompt=prompt, max_new_tokens=serve.NEW_TOKENS))
    assert {r.uid: r.output for r in run.done} == {r.uid: r.output for r in jeng.run()}


@pytest.mark.parametrize("argv", [["--device", "cpu"], BASE + ["--artifact", "x"]], ids=["neither", "both"])
def test_arch_or_artifact_exactly_one(capsys, argv):
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert exc.value.code != 0 and "exactly one of --arch or --artifact is required" in capsys.readouterr().err


GROK = ["--arch", "grok-1-314b", "--smoke", "--device", "cpu", "--requests", "8"]


@pytest.fixture(scope="module")
def grok_lockstep():
    """The MoE smoke model's lockstep outputs by uid."""
    run = serve.main(GROK + ["--engine", "lockstep"])
    return {r.uid: r.output for r in run.done}


@pytest.mark.parametrize("engine", ["staged", "lockstep"])
def test_moe_arch_serves_through_both_engines(capsys, grok_lockstep, engine):
    """``--arch grok-1-314b``: the router and the three expert sites in the
    plan, every request finished, the same tokens from both engines (6-token
    prompts over 4 experts never fill a capacity of 8: nothing drops)."""
    run = serve.main(GROK + ["--engine", engine])
    out = capsys.readouterr().out
    assert re.search(r"arch=grok-1-314b-smoke weights [\d.]+ MB -> [\d.]+ MB \([\d.]+x\)  plan: 9 sites, "
                     r"0 calibrated", out)
    assert len(run.done) == 8 and all(r.status == "finished" and len(r.output) == 8 for r in run.done)
    assert {r.uid: r.output for r in run.done} == grok_lockstep
