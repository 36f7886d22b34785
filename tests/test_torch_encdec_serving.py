"""Serving the enc-dec family (whisper-base smoke) under ternary PTQ
against the reference: decode steps, both engines' greedy tokens against
the reference engines' (against zero frames: ROADMAP Queue C14), the
``enc_out`` insert at batch axis 0, and the plan's precision and the
calibrated exponents per call path (``enc/attn/wq`` ... miss the plan's
``enc_blocks/...`` table and resolve by the policy's rules, as in the
reference).
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
from repro_torch.models import insert_prefix
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine
from test_torch_encdec import ARCH, _batch, _jb, _tb

PTQ = dict(w_bits=2, group_size=16, mode="ptq")
PROMPTS = [[5, 9, 2, 7, 11, 3], [3, 1], [2]]


@pytest.fixture(scope="module")
def params():
    return jbuild(jconfigs.get_smoke(ARCH)).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ptq(params):
    """(reference plan-bound api, its qparams, port api, port qparams) at
    ternary group 16 over kv_int8."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **PTQ)), kv_fmt="kv_int8")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH, TQuantConfig(backend="cuda", **PTQ)), kv_fmt="kv_int8")
    jq, plan, japi = jquantize_and_plan(jbuild(jcfg), params)
    tq, _, tapi = tquantize_and_plan(tbuild(tcfg, device="cpu"), params_from_jax(params, device="cpu"))
    return japi, jq, tapi, tq



def test_ptq_decode_steps_match(ptq):
    """8 ternary-PTQ decode steps at per-slot positions against a zero
    ``enc_out``: 5e-3, equal argmax."""
    japi, jq, tapi, tq = ptq
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


@pytest.mark.parametrize("staged", [False, True], ids=["lockstep", "staged"])
def test_engines_match_reference_engines(ptq, staged):
    """Both engines' greedy tokens equal the reference engines' on the same
    weights.  ROADMAP Queue C14: neither engine carries audio -- requests
    hold a prompt only, the staged engine prefills a token at a time
    through ``decode`` (no ``prefill_chunk``), and every slot decodes
    against the zero ``enc_out`` of ``init_cache``."""
    japi, jq, tapi, tq = ptq
    assert tapi.prefill_chunk is None and tapi.prefill is not None
    outs, engines = [], []
    for api, params, request, eng_cls in ((japi, jq, JRequest, JStaged if staged else JServing),
                                          (tapi, tq, Request, StagedEngine if staged else ServingEngine)):
        sched = (JSchedulerConfig if eng_cls is JStaged else SchedulerConfig)(prefill_chunk=4)
        eng = eng_cls(api, params, n_slots=2, max_len=32, **({"sched": sched} if staged else {}))
        for i, p in enumerate(PROMPTS):
            eng.submit(request(uid=i, prompt=list(p), max_new_tokens=4))
        outs.append({r.uid: r.output for r in eng.run(max_ticks=4000)})
        engines.append(eng)
    assert outs[1] == outs[0] and len(outs[1]) == len(PROMPTS)
    assert not bool(engines[1].cache["enc_out"].any())  # C14: no frames reached the engine
    if staged:
        assert engines[1].counts == engines[0].counts


def test_insert_prefix_enc_out_batch_axis_0(ptq):
    """A B=1 prefix cache lands in slot 1: KV leaves on axis 1, enc_out on
    axis 0; the other slot is untouched (the reference's override)."""
    japi, jq, tapi, tq = ptq
    cfg = tapi.cfg
    rng = np.random.default_rng(4)
    cache = tapi.init_cache(2, 32)
    prefix = tapi.init_cache(1, 32)
    for name, leaf in prefix.items():
        leaf.copy_(torch.from_numpy(rng.integers(-50, 50, size=leaf.shape)).to(leaf.dtype))
    before = {n: v.clone() for n, v in cache.items()}
    jcache = japi.insert(jax.tree.map(jnp.asarray, {n: v.float().numpy() for n, v in cache.items()}),
                         jax.tree.map(jnp.asarray, {n: v.float().numpy() for n, v in prefix.items()}), 1)
    tapi.insert(cache, prefix, 1)
    assert cache["enc_out"].shape == (2, cfg.n_audio_frames, cfg.d_model)
    assert torch.equal(cache["enc_out"][1], prefix["enc_out"][0]) and torch.equal(cache["enc_out"][0],
                                                                                 before["enc_out"][0])
    assert torch.equal(cache["k"][:, 1], prefix["k"][:, 0]) and torch.equal(cache["k"][:, 0], before["k"][:, 0])
    for name in cache:
        np.testing.assert_array_equal(cache[name].float().numpy(), np.asarray(jcache[name]), err_msg=name)
    # the module-level function with the override, as build_model binds it
    again = tapi.init_cache(2, 32)
    insert_prefix(again, prefix, 0, batch_axis_overrides={"enc_out": 0})
    assert torch.equal(again["enc_out"][0], prefix["enc_out"][0])


def test_precision_and_exponents_per_call_path(params):
    """The plan is keyed by parameter paths (``enc_blocks/attn/wq``), the
    model calls ``dense`` with call paths (``enc/attn/wq``): those miss the
    table and resolve by the policy's rules, and calibration records the
    call paths.  The port's plan, resolutions and calibrated exponents
    equal the reference's, path for path."""
    cfg = jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **PTQ))
    japi = jbuild(cfg)
    batches = [_batch(cfg, seed=10 + i) for i in range(2)]
    _, jplan, _ = jquantize_and_plan(japi, params, calib_batches=[_jb(b) for b in batches])
    tapi = tbuild(tconfigs.get_smoke(ARCH, TQuantConfig(backend="cuda", **PTQ)), device="cpu")
    _, tplan, _ = tquantize_and_plan(tapi, params_from_jax(params, device="cpu"), calib_batches=[_tb(b) for b in batches])
    assert dataclasses.replace(tplan, backend="ref").to_json() == jplan.to_json()
    assert "enc_blocks/attn/wq" in tplan.site_paths and "enc/attn/wq" not in tplan.site_paths
    calls = [f"{side}/{site}" for side, sites in (("enc", ("attn/wq", "attn/wo", "mlp/up", "mlp/down")),
                                                  ("dec", ("self_attn/wq", "cross_attn/wk", "cross_attn/wv",
                                                           "mlp/down")))
             for site in sites] + ["lm_head"]
    for path in calls:
        assert dataclasses.asdict(tplan.resolve(path)) == dataclasses.asdict(jplan.resolve(path)), path
        assert tplan.act_exponent(path) == jplan.act_exponent(path) is not None, path
