"""Serving the dense family across ranks on the CPU (gloo), and the
launcher under ``torch.distributed.run``: the smoke qwen3-8b over a
kv_int8 cache on ``tp=2`` (its two kv heads one a rank), cold-started by
both engines from the port's sharded artifact, logits bit-equal to the
single-process port's and tokens equal to the reference's single-device
engines'; then ``--mesh dp=2,ep=2`` on four launcher ranks prints the
single-process launcher's tokens; the launcher refuses a mesh whose size
is not ``WORLD_SIZE``."""
import os
import subprocess
import sys

import pytest

import _mesh_cases as C
from repro.serving import ServingEngine as JServing
from repro.serving import StagedEngine as JStaged
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_dense")
    paths = {"qwen3": C.write(root, "qwen3", "qwen3-8b", {"kv_fmt": "kv_int8"}, {"model": 2}),
             "grok": C.write(root, "grok", "grok-1-314b", {}, {"data": 2, "model": 2})}
    return paths, C.spawn([("tp2", "tp=2", paths["qwen3"][1], C.W.SLOTS)], 2, root)["tp2"]


def test_tp2_logits_equal_single_process(runs):
    paths, got = runs
    assert got["mesh"] == {"model": 2} and got["placed"]["heads_local"]
    assert got["placed"]["layouts"] == {
        "embed/table": -2, "lm_head": -1, "blocks/attn/wq": -1, "blocks/attn/wk": -1, "blocks/attn/wv": -1,
        "blocks/attn/wo": -2, "blocks/mlp/gate": -1, "blocks/mlp/up": -1, "blocks/mlp/down": -2}
    C.assert_logits_equal(got, C.single(paths["qwen3"][0]))


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_tp2_tokens_equal_reference(runs, engine):
    paths, got = runs
    assert got[engine] == C.reference(paths["qwen3"][0], JServing if engine == "lockstep" else JStaged)


def _token_lines(out: str):
    return [line for line in out.splitlines() if line.strip().startswith("req ")]


def test_launcher_under_torchrun_prints_the_single_process_tokens(runs, capsys):
    paths, _ = runs
    whole, sharded = paths["grok"]
    serve.main(["--artifact", whole, "--device", "cpu", "--requests", "4"])
    single = _token_lines(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4", "--master_port",
                        str(C.free_port()), "-m", "repro_torch.launch.serve", "--artifact", sharded, "--device", "cpu",
                        "--requests", "4", "--mesh", "dp=2,ep=2"], capture_output=True, text=True, timeout=240,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.count("onto mesh {'data': 2, 'model': 2} (per-host shards assembled)") == 1  # rank 0 alone
    assert len(single) == 4 and _token_lines(r.stdout) == single


def test_flash_decode_plans_its_splits_for_the_whole_call():
    """A rank's flash decode over its kv heads plans the whole call's key
    splits (grok-1: 4 slots x 8 kv heads), so each head's partials merge
    as the single-device call merges them."""
    from repro_torch.kernels.flash_prefill import launch_plan

    whole = launch_plan("kv_int8", 4, 1, 1024, 8, 6, 128)
    assert launch_plan("kv_int8", 4, 1, 1024, 2, 6, 128)["splits"] != whole["splits"]
    for kh in (4, 2):
        plan = launch_plan("kv_int8", 4, 1, 1024, kh, 6, 128, plan_pairs=4 * 8)
        assert (plan["splits"], plan["keys"]) == (whole["splits"], whole["keys"])
