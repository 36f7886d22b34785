"""The port's training launcher (``python -m repro_torch.launch.train``)
end to end on the CPU: ``main(argv)`` with ``--smoke --device cpu``.

  * ``--quant inq --ckpt-dir D``: a run that dies after its checkpoint at
    step 5, relaunched with the same command line plus ``--resume``,
    finishes equal to the uninterrupted run, bit for bit (losses, params,
    optimizer state, the INQ schedule record).
  * ``--save-artifact``: the learned-grid artifact cold-starts in the port's
    serving launcher (``--artifact``) and in the reference's
    (``boot_from_artifact``); both serve the tokens of the in-memory
    quantized tree.  The float32 smoke config only: bf16 models serve other
    tokens in the two packages (ROADMAP Queue C8)."""
import re

import pytest
import torch

from _train_parity import leaves
from repro.launch import serve as jserve
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.launch import serve, train
from repro_torch.models import quantize_and_plan
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import checkpoint as ck

INQ = ["--arch", "whisper-base", "--smoke", "--device", "cpu", "--quant", "inq", "--steps", "12", "--batch", "2",
       "--seq", "16", "--opt-bits", "8"]


class _Crash(RuntimeError):
    pass


def test_inq_resume_finishes_equal_to_a_straight_run(tmp_path, monkeypatch, capsys):
    straight = train.main(INQ + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "arch=whisper-base-smoke" in out and "quant=inq" in out and "final loss" in out
    assert straight.trainer.quant_state.pos == 4 and straight.history["step"] == list(range(12))

    make_batch = train.make_batch

    def dies_at_6(cfg, d, i, device="cpu"):
        if i == 6:
            raise _Crash("the node died")
        return make_batch(cfg, d, i, device=device)

    monkeypatch.setattr(train, "make_batch", dies_at_6)
    with pytest.raises(_Crash):
        train.main(INQ + ["--ckpt-dir", str(tmp_path / "b")])
    assert ck.list_steps(str(tmp_path / "b")) == [5]  # ckpt_every = max(5, 12 // 4)
    monkeypatch.setattr(train, "make_batch", make_batch)
    resumed = train.main(INQ + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert "resumed at step 5" in capsys.readouterr().out
    assert resumed.start == 5 and resumed.history["step"] == list(range(5, 12))
    assert resumed.history["loss"] == straight.history["loss"][5:]
    assert resumed.trainer.quant_state == straight.trainer.quant_state
    for tree_a, tree_b in ((straight.trainer.params, resumed.trainer.params),
                           (straight.trainer.opt_state, resumed.trainer.opt_state)):
        la, lb = dict(leaves(tree_a)), dict(leaves(tree_b))
        assert sorted(la) == sorted(lb)
        for path in la:
            assert torch.equal(la[path].detach(), lb[path].detach()), path


def test_saved_artifact_cold_starts_in_both_packages(tmp_path, capsys):
    art = str(tmp_path / "art")
    run = train.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--quant", "ttq", "--steps", "6",
                      "--batch", "2", "--seq", "16", "--save-artifact", art])
    assert re.search(rf"saved serving artifact at {art}/step_000000000", capsys.readouterr().out)
    assert run.artifact == f"{art}/step_000000000"
    # the in-memory tree's tokens: the trained params quantized on their learned grid, the lockstep engine
    with torch.no_grad():
        qparams, _, qapi = quantize_and_plan(run.api, run.trainer.params)
    eng = ServingEngine(qapi, qparams, n_slots=4, max_len=64)
    prompts = serve.draw_prompts(4, run.api.cfg.vocab)
    for i, prompt in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=serve.NEW_TOKENS))
    want = {r.uid: r.output for r in eng.run()}
    assert all(len(v) == serve.NEW_TOKENS for v in want.values())

    cold = serve.main(["--artifact", art, "--device", "cpu", "--requests", "4", "--engine", "lockstep"])
    assert "cold-started from" in capsys.readouterr().out
    assert {r.uid: r.output for r in cold.done} == want

    japi, jq, _ = jserve.boot_from_artifact(art)
    jeng = JEngine(japi, jq, n_slots=4, max_len=64)
    for i, prompt in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=prompt, max_new_tokens=serve.NEW_TOKENS))
    assert {r.uid: r.output for r in jeng.run()} == want
