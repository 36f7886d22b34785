"""Port vs reference on the dense siblings' smoke configs: phi4-mini-3.8b,
qwen1.5-110b (qkv biases, seeded non-zero in both trees: init gives
zeros, which would never exercise the bias epilogue) and gemma3-12b
(6 layers, 5 local : 1 global, window 8; prompts and steps cross it).

For each: the fp forward logits (the tolerance of
``tests/test_torch_model.py``), ternary-PTQ decode steps (the fused site's
plain version and flash decode against the reference's), the StagedEngine's
greedy tokens against the reference's with flash off and on, the lockstep
engine's against the reference's, and the reference's packed artifact read
by the port bit for bit at 2, 4 and 8 bits.  ``build_model`` builds the
MoE, VLM, SSM, hybrid and enc-dec families and refuses a family the
reference does not have, by name.  Token
gates pair like with like: flash with flash, oracle with oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.base import config_to_dict as jconfig_to_dict
from repro.models import build_model as jbuild
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.models import save_servable as jsave_servable
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import ServingEngine as JServing
from repro.serving import StagedEngine as JStaged
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import load_servable
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.models.transformer import window_schedule
from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine
from test_torch_artifact import _assert_bit_exact

ARCHS = ["phi4-mini-3.8b", "qwen1.5-110b", "gemma3-12b"]
PTQ = dict(w_bits=2, group_size=16, mode="ptq")
PROMPTS = [[5, 9, 2, 7, 11, 3, 3, 8, 1, 4, 6, 2, 9], [3, 1], [8] * 11, [2]]  # 13 and 11 cross gemma3's window of 8


def _jax_params(arch):
    """The reference's float params; qwen1.5's q / k / v biases seeded
    non-zero (numpy) so the bias epilogue is exercised."""
    api = jbuild(jconfigs.get_smoke(arch))
    params = api.init(jax.random.PRNGKey(0))
    if jconfigs.get_smoke(arch).qkv_bias:
        rng = np.random.default_rng(7)
        attn = dict(params["blocks"]["attn"])
        for site in ("wq", "wk", "wv"):
            b = attn[site]["b"]
            attn[site] = dict(attn[site], b=jnp.asarray(rng.normal(size=b.shape).astype(np.float32) * 0.5, b.dtype))
        params = dict(params, blocks=dict(params["blocks"], attn=attn))
    return params


_CACHE = {}


def _models(arch):
    """(float params, the reference's qparams and plan) of ``arch``, once."""
    if arch not in _CACHE:
        params = _jax_params(arch)
        jcfg = jconfigs.get_smoke(arch, JQuantConfig(backend="ref", **PTQ))
        qparams, plan, _ = jquantize_and_plan(jbuild(jcfg), params)
        _CACHE[arch] = params, qparams, plan
    return _CACHE[arch]


def _jax_api(arch, plan, flash=False, kv_fmt="kv_int8"):
    cfg = dataclasses.replace(jconfigs.get_smoke(arch, JQuantConfig(backend="ref", **PTQ)), kv_fmt=kv_fmt,
                              flash_decode=flash, flash_prefill=flash)
    return jbuild(cfg).with_plan(plan)


def _port(arch, params, flash=False, kv_fmt="kv_int8"):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch, TQuantConfig(backend="cuda", **PTQ)), kv_fmt=kv_fmt,
                              flash_decode=flash, flash_prefill=flash)
    tq, _, tapi = tquantize_and_plan(tbuild(cfg, device="cpu"), params_from_jax(params, device="cpu"))
    return tq, tapi


def _run(api, params, engine, request, prompts, **kw):
    eng = engine(api, params, n_slots=2, max_len=32, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=4))
    return {r.uid: r.output for r in eng.run(max_ticks=4000)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert tconfigs.config_to_dict(tconfigs.get_config(arch)) == jconfig_to_dict(jconfigs.get_config(arch))
    assert tconfigs.config_to_dict(tconfigs.get_smoke(arch)) == jconfig_to_dict(jconfigs.get_smoke(arch))
    assert arch in tconfigs.ARCH_IDS


def test_gemma3_window_schedule_is_five_local_one_global():
    cfg = tconfigs.get_config("gemma3-12b")
    win = window_schedule(cfg, 2048).tolist()
    assert win == [2049 if (i + 1) % 6 == 0 else 1024 for i in range(48)]
    assert cfg.hd() == 240


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_forward_logits_match(arch):
    params = _jax_params(arch)
    jcfg = jconfigs.get_smoke(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 20)).astype(np.int32)
    want = np.asarray(jbuild(jcfg).forward(params, {"tokens": jnp.asarray(tokens)}))
    tapi = tbuild(tconfigs.get_smoke(arch), device="cpu")
    got = tapi.forward(params_from_jax(params, device="cpu"), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _decode_logits(decode, init_cache, params, to_dev, steps=12):
    toks = (np.arange(2 * steps).reshape(2, steps) * 7 % 200).astype(np.int32)
    starts = np.asarray([0, 3], np.int32)
    cache = init_cache(2, 32)
    outs = []
    for i in range(steps):
        logits, cache = decode(params, to_dev(toks[:, i:i + 1]), to_dev(starts + i), cache)
        outs.append(np.asarray(logits, np.float32))
    return np.stack(outs)


@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_decode_steps_match(arch):
    """12 ternary-PTQ decode steps at per-slot positions (past gemma3's
    window), flash decode on both sides."""
    params, qparams, plan = _models(arch)
    qapi = _jax_api(arch, plan, flash=True)
    want = _decode_logits(jax.jit(qapi.decode), qapi.init_cache, qparams, jnp.asarray)
    tq, tapi = _port(arch, params, flash=True)
    with torch.inference_mode():
        got = _decode_logits(tapi.decode, tapi.init_cache, tq, torch.from_numpy)
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flash", [False, True], ids=["oracle", "flash"])
def test_staged_tokens_match_reference_staged_engine(arch, flash):
    params, qparams, plan = _models(arch)
    want = _run(_jax_api(arch, plan, flash), qparams, JStaged, JRequest, PROMPTS,
                sched=JSchedulerConfig(prefill_chunk=4))
    tq, tapi = _port(arch, params, flash)
    got = _run(tapi, tq, StagedEngine, Request, PROMPTS, sched=SchedulerConfig(prefill_chunk=4))
    assert got == want and len(got) == len(PROMPTS)


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_tokens_match_reference(arch):
    params, qparams, plan = _models(arch)
    want = _run(_jax_api(arch, plan), qparams, JServing, JRequest, PROMPTS)
    tq, tapi = _port(arch, params)
    got = _run(tapi, tq, ServingEngine, Request, PROMPTS)
    assert got == want and len(got) == len(PROMPTS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_reference_artifact_loads_bit_exact(arch, bits, tmp_path):
    """The reference's ``save_servable`` at each width, read by the port:
    every leaf bit for bit, the plan and the config as written."""
    jcfg = jconfigs.get_smoke(arch, JQuantConfig(w_bits=bits, group_size=16, mode="ptq", backend="ref"))
    japi = jbuild(jcfg)
    qparams, plan, qapi = jquantize_and_plan(japi, _jax_params(arch))
    jsave_servable(str(tmp_path), qapi, qparams, plan)
    api, loaded, art = load_servable(str(tmp_path), device="cpu")
    _assert_bit_exact(loaded, params_from_jax(qparams, device="cpu"))
    assert art.plan.to_json() == plan.to_json()
    assert tconfigs.config_to_dict(api.cfg) == jconfig_to_dict(jcfg)


@pytest.mark.parametrize("arch,family", [("grok-1-314b", None), ("arctic-480b", None), ("qwen2-vl-72b", None),
                                         ("zamba2-7b", None), ("falcon-mamba-7b", None), ("whisper-base", None),
                                         ("qwen3-8b", "speech")])
def test_build_model_refuses_other_families(arch, family):
    """Every family of the reference builds (``family`` None), the enc-dec
    whisper-base included; a family the reference does not have is refused
    by name, as the reference's ``build_model`` refuses it."""
    cfg = tconfigs.config_from_dict(jconfig_to_dict(jconfigs.get_smoke(arch)))
    if family is None:
        assert tbuild(cfg, device="cpu").cfg == cfg
        return
    with pytest.raises(ValueError, match=family):
        tbuild(dataclasses.replace(cfg, family=family), device="cpu")
