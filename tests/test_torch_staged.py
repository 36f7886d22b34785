"""Port vs reference: chunked prefill, the scheduler and the staged engine
on the qwen3-8b smoke config (2 layers, d = 64, group 16).

Token gates pair like with like: the port's staged engine against the
port's lockstep engine, and the port's oracle paths against the
reference's oracle paths (flash kernels sum in another order and may flip
a near-tied argmax).  Logits of the port's flash path are held to the
reference's model-level tolerance, 5e-3 with equal argmax.
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
from repro.serving import chunk_plan as jchunk_plan
from repro.serving import next_action as jnext_action
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.serving import (
    LatencyStats, Request, SchedulerConfig, ServingEngine, StagedEngine, chunk_plan, degraded_chunk,
    next_action,
)

ARCH = "qwen3-8b"
PTQ = dict(w_bits=2, group_size=16, mode="ptq")


# ---------------------------------------------------------------------------
# scheduler units (the reference's cases, and the reference's answers)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,chunk", [(1, 8), (7, 8), (8, 8), (9, 8), (31, 8), (64, 8), (13, 32), (5, 1)])
def test_chunk_plan_boundaries(n, chunk):
    sizes = chunk_plan(n, chunk)
    assert sizes == jchunk_plan(n, chunk)
    assert sum(sizes) == n and all(1 <= s <= chunk for s in sizes)
    tail = [s for s in sizes if s != chunk]
    assert tail == sorted(tail, reverse=True) and all(s & (s - 1) == 0 for s in tail)


def test_chunk_plan_rejects_empty_and_config_validates():
    with pytest.raises(ValueError, match="at least one"):
        chunk_plan(0, 8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        SchedulerConfig(prefill_chunk=0)
    with pytest.raises(ValueError, match="policy"):
        SchedulerConfig(policy="fifo")
    assert SchedulerConfig().policy == "decode"
    assert [degraded_chunk(c) for c in (1, 2, 7, 8, 256)] == [1, 1, 2, 4, 128]


@pytest.mark.parametrize("policy", ["decode", "prefill"])
@pytest.mark.parametrize("prefill_ready", [False, True])
@pytest.mark.parametrize("decode_ready", [False, True])
@pytest.mark.parametrize("last", ["prefill", "generate"])
def test_next_action_matches_reference(policy, prefill_ready, decode_ready, last):
    kw = dict(prefill_ready=prefill_ready, decode_ready=decode_ready, last=last)
    assert next_action(policy, **kw) == jnext_action(policy, **kw)


def test_latency_stats_percentiles():
    stats = LatencyStats()
    for i in range(4):
        r = Request(uid=i, prompt=[1], output=[1, 2, 3])
        r.submit_t, r.prefill_start_t, r.first_token_t, r.finish_t = 0.0, 0.1 * i, 0.2 * i + 0.1, 0.2 * i + 0.5
        stats.record(r)
    s = stats.summary()
    assert s["ttft"]["n"] == 4 and s["tpot"]["p50"] == pytest.approx(0.2)
    assert s["queue_wait"]["p50"] <= s["queue_wait"]["p95"] <= s["queue_wait"]["p99"]


# ---------------------------------------------------------------------------
# staged vs lockstep in the port (greedy oracle)
# ---------------------------------------------------------------------------
def _run(api, params, cls, prompts, max_new=4, n_slots=2, max_len=32, **kw):
    eng = cls(api, params, n_slots=n_slots, max_len=max_len, **kw)
    for i, p in enumerate(prompts):
        eng.submit(cls_request(cls)(uid=i, prompt=list(p), max_new_tokens=max_new))
    done = eng.run(max_ticks=4000)
    left = eng.leftover()
    assert not left["in_flight"] and not left["queued"]
    return {r.uid: r.output for r in done}, eng


def cls_request(cls):
    return JRequest if cls in (JServing, JStaged) else Request


@pytest.fixture(scope="module")
def fp_port():
    api = tbuild(tconfigs.get_smoke(ARCH), device="cpu")
    return api, api.init(torch.Generator().manual_seed(0))


def test_staged_matches_lockstep(fp_port):
    """Boundary prompt lengths (1, chunk-1, chunk, chunk+1, max_len-1)
    through both policies give the same greedy tokens."""
    api, params = fp_port
    chunk, max_len = 8, 32
    lens = [1, chunk - 1, chunk, chunk + 1, max_len - 1]
    prompts = [[(3 * j + i) % 50 + 1 for j in range(n)] for i, n in enumerate(lens)]
    lock, _ = _run(api, params, ServingEngine, prompts, max_len=max_len)
    for policy in ("decode", "prefill"):
        stag, eng = _run(api, params, StagedEngine, prompts, max_len=max_len,
                         sched=SchedulerConfig(prefill_chunk=chunk, policy=policy))
        assert stag == lock, f"policy={policy}"
        assert eng.counts["inserts"] == len(prompts)
        assert eng.counts["prefill_chunks"] == sum(len(chunk_plan(n, chunk)) for n in lens)


def test_staged_stats_leftover_drain_and_slot_reset(fp_port):
    api, params = fp_port
    eng = StagedEngine(api, params, n_slots=1, max_len=32, sched=SchedulerConfig(prefill_chunk=4))
    for i in range(3):
        eng.submit(Request(uid=i, prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=8))
    done = eng.run(max_ticks=2)  # request 0 prefilled (4 + 2 tokens) and inserted
    left = eng.leftover()
    assert {r.uid for r in done} | {r.uid for r in left["in_flight"] + left["queued"]} == {0, 1, 2}
    eng.drain()
    assert eng.leftover() == {"in_flight": [], "queued": []}
    for i in range(2):
        eng.submit(Request(uid=10 + i, prompt=[5, 9, 2, 4, 4], max_new_tokens=3))
    redo = eng.run(max_ticks=200)
    assert [len(r.output) for r in redo] == [3, 3] and redo[0].output == redo[1].output
    assert eng.slot_req == [None] and eng.slot_pos.tolist() == [0] and eng.next_token.tolist() == [0]
    s = eng.stats()
    assert s["engine"] == "staged" and s["counts"]["inserts"] == 3 and s["counts"]["generate_ticks"] > 0
    for field in ("queue_wait", "ttft", "tpot"):
        lat = s["latency"][field]
        assert lat["n"] == 2 and lat["p50"] <= lat["p95"] <= lat["p99"]


def test_decode_policy_alternates_under_contention(fp_port):
    api, params = fp_port

    def trace(policy):
        eng = StagedEngine(api, params, n_slots=2, max_len=64,
                           sched=SchedulerConfig(prefill_chunk=4, policy=policy))
        eng.submit(Request(uid=0, prompt=[7, 7], max_new_tokens=30))
        for _ in range(3):
            eng.step()
        eng.submit(Request(uid=1, prompt=[1] * 16, max_new_tokens=2))
        acts = []
        for _ in range(8):
            eng.step()
            acts.append(eng._last_action)
        return acts

    acts = trace("decode")
    assert "prefill" in acts and not any(a == b == "prefill" for a, b in zip(acts, acts[1:]))
    assert trace("prefill")[:4] == ["prefill"] * 4


# ---------------------------------------------------------------------------
# port vs reference: prefill_chunk logits, staged tokens, slot reuse
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_ptq_base():
    """The reference's PTQ smoke model, quantized once (the cache format
    does not enter quantization)."""
    api = jbuild(jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **PTQ)))
    params = api.init(jax.random.PRNGKey(0))
    qparams, plan, _ = jquantize_and_plan(api, params)
    return params, qparams, plan


def _jax_ptq(base, kv_fmt):
    params, qparams, plan = base
    cfg = dataclasses.replace(jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **PTQ)), kv_fmt=kv_fmt)
    return params, qparams, jbuild(cfg).with_plan(plan)


def _port_ptq(params, kv_fmt, flash=False):
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH, TQuantConfig(backend="cuda", **PTQ)), kv_fmt=kv_fmt,
                              flash_prefill=flash, flash_decode=flash)
    tq, _, tapi = tquantize_and_plan(tbuild(cfg, device="cpu"), params_from_jax(params, device="cpu"))
    return tq, tapi


@pytest.fixture(scope="module", params=["kv_int8", "kv_mx"])
def jax_ptq(request, jax_ptq_base):
    return request.param, _jax_ptq(jax_ptq_base, request.param)


def _chunked_logits(prefill_chunk, decode, init_cache, params, to_dev, starts):
    """Two ragged prefill chunks per row-batch, then 2 decode steps."""
    toks = (np.arange(2 * 21).reshape(2, 21) * 7 % 200).astype(np.int32)
    cache = init_cache(2, 32)
    outs = []
    for a, b in zip(starts, starts[1:] + [21]):
        logits, cache = prefill_chunk(params, to_dev(toks[:, a:b]), a, cache)
        outs.append(np.asarray(logits, np.float32))
    for i in range(2):
        logits, cache = decode(params, to_dev(np.full((2, 1), 3 + i, np.int32)), 21 + i, cache)
        outs.append(np.asarray(logits, np.float32))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("flash", [False, True], ids=["oracle", "flash"])
def test_prefill_chunk_logits_match_reference(jax_ptq, flash):
    fmt, (params, qparams, qapi) = jax_ptq
    want = _chunked_logits(jax.jit(qapi.prefill_chunk), jax.jit(qapi.decode), qapi.init_cache, qparams,
                           jnp.asarray, [0, 5, 13])
    tq, tapi = _port_ptq(params, fmt, flash)
    with torch.inference_mode():
        got = _chunked_logits(tapi.prefill_chunk, tapi.decode, tapi.init_cache, tq, torch.from_numpy, [0, 5, 13])
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _prefill_then_decode(prefill, decode, init_cache, params, to_dev):
    """A whole-prompt prefill (13 tokens), then 2 decode steps off its cache."""
    toks = (np.arange(26).reshape(2, 13) * 5 % 97).astype(np.int32)
    logits, cache = prefill(params, {"tokens": to_dev(toks)}, init_cache(2, 32))
    outs = [np.asarray(logits, np.float32)]
    for i in range(2):
        logits, cache = decode(params, to_dev(np.full((2, 1), 3 + i, np.int32)), 13 + i, cache)
        outs.append(np.asarray(logits, np.float32))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("flash", [False, True], ids=["oracle", "flash"])
def test_prefill_self_tail_matches_reference(jax_ptq, flash):
    """``prefill`` (the in-chunk self-attention tail under flash_prefill)
    and decode steps off the cache it wrote, against the reference."""
    fmt, (params, qparams, qapi) = jax_ptq
    want = _prefill_then_decode(jax.jit(qapi.prefill), jax.jit(qapi.decode), qapi.init_cache, qparams,
                                jnp.asarray)
    tq, tapi = _port_ptq(params, fmt, flash)
    with torch.inference_mode():
        got = _prefill_then_decode(tapi.prefill, tapi.decode, tapi.init_cache, tq, torch.from_numpy)
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_staged_tokens_match_reference_staged_engine(jax_ptq_base):
    """kv_int8 PTQ smoke, both oracles: the port's StagedEngine and the
    reference's StagedEngine give the same greedy tokens."""
    params, qparams, qapi = _jax_ptq(jax_ptq_base, "kv_int8")
    prompts = [[5, 9, 2, 7, 11, 3, 3, 8, 1], [3, 1], [8] * 13, [2]]
    kw = dict(max_len=32, max_new=4)
    want, _ = _run(qapi, qparams, JStaged, prompts, sched=JSchedulerConfig(prefill_chunk=4), **kw)
    tq, tapi = _port_ptq(params, "kv_int8")
    got, eng = _run(tapi, tq, StagedEngine, prompts, sched=SchedulerConfig(prefill_chunk=4), **kw)
    assert got == want and len(got) == 4 and eng.counts["inserts"] == 4


def test_kv_mx_slot_reuse_matches_reference(jax_ptq_base):
    """One kv_mx slot serves two requests in turn.  The slot is cleared by
    inserting a fresh cache (exponent planes back to -127): the port's
    tokens and its whole cache (codes and exponents) equal the reference's."""
    params, qparams, qapi = _jax_ptq(jax_ptq_base, "kv_mx")
    prompts = [[40, 41, 42, 43, 44, 45], [7, 3, 9]]
    want, jeng = _run(qapi, qparams, JServing, prompts, n_slots=1, max_new=5)
    tq, tapi = _port_ptq(params, "kv_mx")
    got, teng = _run(tapi, tq, ServingEngine, prompts, n_slots=1, max_new=5)
    assert got == want
    for name, leaf in jeng.cache.items():
        np.testing.assert_array_equal(teng.cache[name].numpy(), np.asarray(leaf), err_msg=name)
    assert (teng.cache["ke"].numpy()[:, :, 1:] == -127).all()  # blocks the second request never reached


def _with_fused(plan, fused: bool):
    """``plan`` with every site's fused knob set to ``fused`` (as
    ``benchmarks/bench_decode.py`` builds its unfused plans)."""
    return dataclasses.replace(
        plan, site_precisions=tuple(dataclasses.replace(p, fused=fused) for p in plan.site_precisions))


PROMPTS = [[5, 9, 2, 7, 11, 3, 3, 8, 1], [3, 1], [8] * 13, [2]]


def _format_models(quant):
    """The reference's and the port's PTQ smoke models (kv_int8) from the
    same float weights: (jax cfg, jax qparams, jax plan, port qparams, port
    plan, port api)."""
    q = dict(quant, group_size=16, mode="ptq")
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH, JQuantConfig(backend="ref", **q)), kv_fmt="kv_int8")
    japi = jbuild(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    jq, jplan, _ = jquantize_and_plan(japi, params)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH, TQuantConfig(backend="cuda", **q)), kv_fmt="kv_int8")
    tq, tplan, tapi = tquantize_and_plan(tbuild(tcfg, device="cpu"), params_from_jax(params, device="cpu"))
    assert {p.fused for p in tplan.site_precisions} == {True}
    return jcfg, jq, jplan, tq, tplan, tapi


@pytest.mark.parametrize("quant,fused", [(dict(w_bits=4), True), (dict(fmt="mx"), True), (dict(w_bits=4), False)],
                         ids=["int4", "mx", "int4-unfused"])
def test_staged_tokens_match_reference_weight_formats(quant, fused):
    """int4 (the paper's 4-bit setting) and mx smoke models, and int4 with
    every site ``fused=False``: the port's StagedEngine (the cuda backend's
    plain versions) gives the reference StagedEngine's greedy tokens (ref
    backend) on the same plan."""
    jcfg, jq, jplan, tq, tplan, tapi = _format_models(quant)
    kw = dict(max_len=32, max_new=4)
    want, _ = _run(jbuild(jcfg).with_plan(_with_fused(jplan, fused)), jq, JStaged, PROMPTS,
                   sched=JSchedulerConfig(prefill_chunk=4), **kw)
    got, _ = _run(tapi.with_plan(_with_fused(tplan, fused)), tq, StagedEngine, PROMPTS,
                  sched=SchedulerConfig(prefill_chunk=4), **kw)
    assert got == want and len(got) == 4


def test_staged_nf4_matches_lockstep_and_reference_prefill():
    """nf4: the port's staged tokens equal its lockstep tokens, and a
    whole-prompt prefill (plus 2 decode steps) gives the reference's logits.
    Token equality with the reference's StagedEngine does not hold on these
    prompts: the 2-token chunk [3, 1] attends through the oracle's softmax,
    whose ``exp`` rounds 1 ulp apart in torch and XLA, and the next 8-bit
    DFP quantizer turns that into whole mantissa steps (logits 0.075 apart,
    first token 246 against 154; ROADMAP Queue C)."""
    jcfg, jq, jplan, tq, tplan, tapi = _format_models(dict(fmt="nf4"))
    kw = dict(max_len=32, max_new=4)
    stag, _ = _run(tapi, tq, StagedEngine, PROMPTS, sched=SchedulerConfig(prefill_chunk=4), **kw)
    lock, _ = _run(tapi, tq, ServingEngine, PROMPTS, **kw)
    assert stag == lock and len(stag) == 4
    qapi = jbuild(jcfg).with_plan(jplan)
    want = _prefill_then_decode(jax.jit(qapi.prefill), jax.jit(qapi.decode), qapi.init_cache, jq, jnp.asarray)
    with torch.inference_mode():
        got = _prefill_then_decode(tapi.prefill, tapi.decode, tapi.init_cache, tq, torch.from_numpy)
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
