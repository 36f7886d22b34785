"""Serving the SSM family (falcon-mamba-7b smoke) under ternary PTQ
against the reference: decode steps, the lockstep engine's tokens, and the
staged engine's tokens through its per-token prefill fallback (the
recurrent state has no chunk graph); a reused slot starts from a zero SSM
state.  The hybrid's cases, on the same helpers, are in
``tests/test_torch_hybrid_serving.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import build_model as jbuild
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import ServingEngine as JServing
from repro.serving import StagedEngine as JStaged
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine

PTQ = dict(w_bits=2, group_size=16, mode="ptq")
PROMPTS = [[5, 9, 2, 7, 11, 3, 3, 8, 1], [3, 1], [2]]
SSM = "falcon-mamba-7b"

_MODELS = {}


def _models(arch):
    """(float params, the reference's qparams and plan), once per arch."""
    if arch not in _MODELS:
        params = jbuild(jconfigs.get_smoke(arch)).init(jax.random.PRNGKey(0))
        qparams, plan, _ = jquantize_and_plan(jbuild(jconfigs.get_smoke(arch, JQuantConfig(backend="ref", **PTQ))),
                                              params)
        _MODELS[arch] = params, qparams, plan
    return _MODELS[arch]


def _apis(arch, flash, kv_fmt="kv_int8"):
    """(reference api, its qparams, port api, port qparams)."""
    params, qparams, plan = _models(arch)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch, JQuantConfig(backend="ref", **PTQ)), kv_fmt=kv_fmt,
                               flash_decode=flash, flash_prefill=flash)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch, TQuantConfig(backend="cuda", **PTQ)), kv_fmt=kv_fmt,
                               flash_decode=flash, flash_prefill=flash)
    tq, _, tapi = tquantize_and_plan(tbuild(tcfg, device="cpu"), params_from_jax(params, device="cpu"))
    return jbuild(jcfg).with_plan(plan), qparams, tapi, tq


def check_ptq_decode_steps(arch, flash):
    """8 ternary-PTQ decode steps at per-slot positions: 5e-3, equal argmax."""
    japi, jq, tapi, tq = _apis(arch, flash)
    toks = (np.arange(16).reshape(2, 8) * 7 % 200).astype(np.int32)
    starts = np.asarray([0, 3], np.int32)
    jc, tc = japi.init_cache(2, 32), tapi.init_cache(2, 32)
    jdecode = jax.jit(japi.decode)
    want, got = [], []
    for i in range(8):
        jl, jc = jdecode(jq, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(starts + i), jc)
        with torch.inference_mode():
            tl, tc = tapi.decode(tq, torch.from_numpy(toks[:, i:i + 1]), torch.from_numpy(starts + i), tc)
        want.append(np.asarray(jl, np.float32))
        got.append(tl.numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=5e-3)
    np.testing.assert_array_equal(np.stack(got).argmax(-1), np.stack(want).argmax(-1))


def test_ptq_decode_steps_match():
    check_ptq_decode_steps(SSM, False)


def _run(api, params, engine, request, prompts=PROMPTS, n_slots=2, **kw):
    eng = engine(api, params, n_slots=n_slots, max_len=32, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=4))
    return {r.uid: r.output for r in eng.run(max_ticks=4000)}


def check_lockstep_tokens(arch, flash):
    japi, jq, tapi, tq = _apis(arch, flash)
    want = _run(japi, jq, JServing, JRequest)
    got = _run(tapi, tq, ServingEngine, Request)
    assert got == want and len(got) == len(PROMPTS)


def test_lockstep_tokens_match_reference():
    check_lockstep_tokens(SSM, False)


def check_staged_fallback_tokens(arch, flash):
    """No ``prefill_chunk``: both staged engines prefill a chunk of 4 a
    token at a time through ``decode`` into the private B=1 cache, then
    insert it; the reference's tokens, chunk and insert counts."""
    japi, jq, tapi, tq = _apis(arch, flash)
    assert tapi.prefill_chunk is None and tapi.prefill is None
    jeng = JStaged(japi, jq, n_slots=2, max_len=32, sched=JSchedulerConfig(prefill_chunk=4))
    teng = StagedEngine(tapi, tq, n_slots=2, max_len=32, sched=SchedulerConfig(prefill_chunk=4))
    outs = []
    for eng, request in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(PROMPTS):
            eng.submit(request(uid=i, prompt=list(p), max_new_tokens=4))
        outs.append({r.uid: r.output for r in eng.run(max_ticks=4000)})
    assert outs[1] == outs[0] and len(outs[1]) == len(PROMPTS)
    assert teng.counts == jeng.counts and teng.counts["prefill_chunks"] == 3 + 1 + 1


def test_staged_fallback_tokens_match_reference():
    check_staged_fallback_tokens(SSM, False)


@pytest.mark.parametrize("engine", [ServingEngine, StagedEngine], ids=["lockstep", "staged"])
def test_slot_reuse_no_stale_state(engine):
    """A recurrent state is not masked by cache positions the way a stale
    KV row is: a reused slot must start from zeros, or the previous
    occupant's state leaks into the next request's tokens (the reference's
    ``test_ssm_slot_reuse_no_stale_state``)."""
    api = tbuild(tconfigs.get_smoke("falcon-mamba-7b"), device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    kw = {"sched": SchedulerConfig(prefill_chunk=4)} if engine is StagedEngine else {}
    probe = [5, 9, 2]
    want = _run(api, params, engine, Request, [probe], n_slots=1, **kw)[0]
    got = _run(api, params, engine, Request, [[13, 8, 8, 8, 1], probe], n_slots=1, **kw)
    assert got[1] == want and len(want) == 4
