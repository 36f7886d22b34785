"""Serving the MoE family across ranks on the CPU (gloo): the smoke
grok-1-314b on ``dp=2,ep=2`` (4 ranks) and ``ep=2`` (2 ranks), and at
capacity factor 1.0 over a 16-slot batch, where the decode step drops
replicas.

The port quantizes the model and writes it whole and sharded (its own
single-process sharded write); every rank cold-starts the lockstep and
staged engines from its own shards (``tests/_mesh_worker.py``).  Their
decode and prefill-chunk logits equal the single-process port's bit for
bit, and their tokens equal the reference's single-device engines' on the
same artifact, drops included (the reference's mesh serving has no
passing test: ROADMAP C1)."""
import pytest
import torch

import _mesh_cases as C
import _mesh_worker as W
from repro.serving import ServingEngine as JServing
from repro.serving import StagedEngine as JStaged
from repro_torch.models import moe
from repro_torch.serving import ServingEngine

DP2_EP2 = {"data": 2, "model": 2}
# job -> (artifact, mesh spec, world size, slots)
JOBS = {"dp2_ep2": ("grok", "dp=2,ep=2", 4, W.SLOTS), "drops_dp2_ep2": ("drops", "dp=2,ep=2", 4, W.WIDE_SLOTS),
        "ep2": ("grok", "ep=2", 2, W.SLOTS)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_moe")
    # one sharded write serves both meshes: the serving rules place weights over 'model' only
    paths = {"grok": C.write(root, "grok", "grok-1-314b", {}, DP2_EP2),
             "drops": C.write(root, "drops", "grok-1-314b", {"capacity_factor": 1.0}, DP2_EP2)}
    results = {}
    for world in (4, 2):
        jobs = [(name, spec, paths[art][1], slots) for name, (art, spec, w, slots) in JOBS.items() if w == world]
        results.update(C.spawn(jobs, world, root))
    return paths, results


_SINGLE = {}


def _single(paths, name):
    art, _, _, slots = JOBS[name]
    if (art, slots) not in _SINGLE:
        _SINGLE[art, slots] = C.single(paths[art][0], slots)
    return _SINGLE[art, slots]


@pytest.mark.parametrize("name", list(JOBS))
def test_sharded_logits_equal_single_process(runs, name):
    paths, results = runs
    got = results[name]
    assert got["mesh"] == ({"model": 2} if name == "ep2" else DP2_EP2)
    C.assert_logits_equal(got, _single(paths, name))


@pytest.mark.parametrize("name", list(JOBS))
def test_sharded_tokens_equal_single_process(runs, name):
    paths, results = runs
    want = _single(paths, name)
    assert results[name]["lockstep"] == want["lockstep"] and results[name]["staged"] == want["staged"]
    assert all(len(v) == W.NEW for v in want["lockstep"].values())


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_tokens_equal_reference(runs, engine):
    paths, results = runs
    want = C.reference(paths["grok"][0], JServing if engine == "lockstep" else JStaged)
    assert results["dp2_ep2"][engine] == results["ep2"][engine] == want


def test_capacity_one_drops_replicas_as_the_reference(runs, monkeypatch):
    """16 slots at factor 1.0: the decode step routes 32 replicas into
    capacity 8 an expert over the data group's gathered tokens and drops
    some; the sharded tokens equal the reference's lockstep engine's."""
    paths, results = runs
    dropped = []
    route = moe.route

    def counted(logits, k, c):
        dest, src, gate = route(logits, k, c)
        dropped.append(int((dest == logits.shape[1] * c).sum()))
        return dest, src, gate

    monkeypatch.setattr(moe, "route", counted)
    W.serve(ServingEngine, paths["drops"][0], None, W.WIDE_SLOTS)
    assert sum(dropped) > 0
    assert results["drops_dp2_ep2"]["lockstep"] == C.reference(paths["drops"][0], JServing, W.WIDE_SLOTS)


def test_layouts_place_every_collective(runs):
    """dp=2,ep=2: N-sharded q / k / v and lm_head, K-sharded wo, EP experts
    (each rank its 2 experts' exponents), the vocab-split table, attention
    on the rank's heads; the router's 4 columns would split 2 a rank, below
    the kernels' N % 4, so it is gathered whole."""
    _, results = runs
    placed = results["dp2_ep2"]["placed"]
    assert placed["heads_local"] and placed["layouts"] == {
        "embed/table": -2, "lm_head": -1, "blocks/attn/wq": -1, "blocks/attn/wk": -1, "blocks/attn/wv": -1,
        "blocks/attn/wo": -2, "blocks/moe/experts/gate": -3, "blocks/moe/experts/up": -3,
        "blocks/moe/experts/down": -3}
    assert placed["local_experts"] == (2, (2,)) and placed["router_n"] == 4
