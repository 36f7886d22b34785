"""Port vs reference on the MoE family's smoke configs through the
StagedEngine: grok-1-314b and arctic-480b, ternary PTQ at group 16, 2
slots, 4-token prefill chunks, the reference's default capacity (the same
dispatch on both sides, drops included): greedy tokens equal to the
reference StagedEngine's.  The prompts are whole 4-token chunks, so the
reference compiles one chunk shape."""
import pytest

from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import StagedEngine as JStaged
from repro_torch.serving import Request, SchedulerConfig, StagedEngine
from test_torch_moe_serving import ARCHS, _jax_api, _models, _port, _run

PROMPTS = [[5, 9, 2, 7, 11, 3, 3, 8], [3, 1, 4, 4], [8] * 4, [2, 6, 1, 9]]


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_tokens_match_reference_staged_engine(arch):
    params, qparams, plan = _models(arch)
    want = _run(_jax_api(arch, plan), qparams, JStaged, JRequest, PROMPTS, sched=JSchedulerConfig(prefill_chunk=4))
    tq, tapi = _port(arch, params)
    got = _run(tapi, tq, StagedEngine, Request, PROMPTS, sched=SchedulerConfig(prefill_chunk=4))
    assert got == want and len(got) == len(PROMPTS)
