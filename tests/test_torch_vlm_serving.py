"""Serving the VLM (qwen2-vl-72b smoke) under ternary PTQ against the
reference: decode steps after a vision prefill (the M-RoPE branch
broadcasts (B, 1) positions to (3, B, 1)) and text-only tokens of both
engines.  The model-level cases are in ``tests/test_torch_vlm.py``.
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
from test_torch_vlm import ARCH, N_TEXT, _batch, _jb, _tb

PTQ = dict(w_bits=2, group_size=16, mode="ptq")
PROMPTS = [[5, 9, 2, 7, 11, 3, 3], [3, 1], [2]]


@pytest.fixture(scope="module")
def params():
    return jbuild(jconfigs.get_smoke(ARCH)).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def quantized(params):
    jcfg = jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **PTQ))
    qparams, plan, _ = jquantize_and_plan(jbuild(jcfg), params)
    return qparams, plan


def _apis(params, plan, flash=False, kv_fmt="kv_int8"):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **PTQ)), kv_fmt=kv_fmt,
                               flash_decode=flash, flash_prefill=flash)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH, TQuantConfig(backend="cuda", **PTQ)), kv_fmt=kv_fmt,
                               flash_decode=flash, flash_prefill=flash)
    tq, _, tapi = tquantize_and_plan(tbuild(tcfg, device="cpu"), params_from_jax(params, device="cpu"))
    return jbuild(jcfg).with_plan(plan), tq, tapi


def test_ptq_decode_steps_match(params, quantized):
    """6 ternary-PTQ decode steps at per-slot positions after a vision
    prefill into slot 0 (the M-RoPE branch broadcasts (B, 1) positions to
    (3, B, 1)), flash decode on both sides: 5e-3, equal argmax."""
    qparams, plan = quantized
    japi, tq, tapi = _apis(params, plan, flash=True)
    cfg = japi.cfg
    batch = _batch(cfg, seed=5)
    _, jpre = japi.prefill(qparams, _jb(batch), japi.init_cache(1, 32))
    with torch.inference_mode():
        _, tpre = tapi.prefill(tq, _tb(batch), tapi.init_cache(1, 32))
    jc, tc = japi.init_cache(2, 32), tapi.init_cache(2, 32)
    jc = jax.tree.map(lambda c, p: c.at[:, 0].set(p[:, 0]), jc, jpre)
    tapi.insert(tc, tpre, 0)
    starts = np.asarray([cfg.n_frontend_tokens + N_TEXT, 3], np.int32)
    toks = (np.arange(12).reshape(2, 6) * 7 % 200).astype(np.int32)
    want, got = [], []
    jdecode = jax.jit(japi.decode)
    for i in range(6):
        jl, jc = jdecode(qparams, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(starts + i), jc)
        with torch.inference_mode():
            tl, tc = tapi.decode(tq, torch.from_numpy(toks[:, i:i + 1]), torch.from_numpy(starts + i), tc)
        want.append(np.asarray(jl, np.float32))
        got.append(tl.numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=5e-3)
    np.testing.assert_array_equal(np.stack(got).argmax(-1), np.stack(want).argmax(-1))


def _run(api, params, engine, request, **kw):
    eng = engine(api, params, n_slots=2, max_len=32, **kw)
    for i, p in enumerate(PROMPTS):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=4))
    return {r.uid: r.output for r in eng.run(max_ticks=4000)}


@pytest.mark.parametrize("engine", ["lockstep", "staged"])
def test_text_tokens_match_reference_engines(params, quantized, engine):
    """Text-only serving (three equal M-RoPE components) through each
    engine against the reference's engine: the lockstep engine with flash
    decode, the staged engine's chunks on the oracle cache path (q_pos the
    temporal component)."""
    qparams, plan = quantized
    japi, tq, tapi = _apis(params, plan, flash=engine == "lockstep")
    if engine == "staged":
        want = _run(japi, qparams, JStaged, JRequest, sched=JSchedulerConfig(prefill_chunk=4))
        got = _run(tapi, tq, StagedEngine, Request, sched=SchedulerConfig(prefill_chunk=4))
    else:
        want = _run(japi, qparams, JServing, JRequest)
        got = _run(tapi, tq, ServingEngine, Request)
    assert got == want and len(got) == len(PROMPTS)
