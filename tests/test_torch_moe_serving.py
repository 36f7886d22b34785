"""Port vs reference on the MoE family's smoke configs served: grok-1-314b
(4 experts, top-2) and arctic-480b (8 experts, top-2, a dense residual
MLP), ternary PTQ at group 16 (``tests/test_torch_moe.py`` holds the layer
and its pieces).

``params_from_jax`` on float and PTQ trees; 8 PTQ decode steps (the int8
router site, the expert sites' ``quantize_rows`` and packed calls through
their plain versions) against the reference's within the families'
tolerance; the lockstep engine's greedy tokens against the reference's
(the reference's default capacity, so tokens may drop: the same dispatch on
both sides; the StagedEngine's are in ``tests/test_torch_moe_staged.py``);
staged == lockstep where nothing drops; the calibrated exponents of the
expert sites and the router equal to the reference's.
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
from repro.serving import ServingEngine as JServing
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.quantizer import QTensor
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine

ARCHS = ["grok-1-314b", "arctic-480b"]
PTQ = dict(w_bits=2, group_size=16, mode="ptq")
PROMPTS = [[5, 9, 2, 7, 11, 3, 3, 8, 1], [3, 1], [8] * 7, [2]]
DECODE_ATOL = 5e-3  # PTQ logits: the kernels' plain versions against the reference's ref oracle (families)
TOKENS = [np.random.default_rng(40 + i).integers(0, 256, size=(2, 12)).astype(np.int32) for i in range(2)]


def _jax_params(arch, seed=0):
    return jbuild(jconfigs.get_smoke(arch)).init(jax.random.PRNGKey(seed))


_CACHE = {}


def _models(arch):
    """(float params, the reference's ternary qparams and plan), once."""
    if arch not in _CACHE:
        params = _jax_params(arch)
        qparams, plan, _ = jquantize_and_plan(jbuild(jconfigs.get_smoke(arch, JQuantConfig(backend="ref", **PTQ))),
                                              params)
        _CACHE[arch] = params, qparams, plan
    return _CACHE[arch]


def _jax_api(arch, plan=None, **over):
    cfg = dataclasses.replace(jconfigs.get_smoke(arch, JQuantConfig(backend="ref", **PTQ)), kv_fmt="kv_int8", **over)
    api = jbuild(cfg)
    return api if plan is None else api.with_plan(plan)


def _port(arch, params, **over):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch, TQuantConfig(backend="cuda", **PTQ)), kv_fmt="kv_int8", **over)
    tq, _, tapi = tquantize_and_plan(tbuild(cfg, device="cpu"), params_from_jax(params, device="cpu"))
    return tq, tapi


def _run(api, params, engine, request, prompts, **kw):
    eng = engine(api, params, n_slots=2, max_len=32, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=4))
    return {r.uid: r.output for r in eng.run(max_ticks=4000)}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_the_expert_axis(arch):
    """Float (L, E, K, N) leaves become per-layer (E, K, N) tensors, PTQ
    (L, E, ...) QTensors per-layer (E, ...) ones with (E,) exponents, the
    same bytes; the plan has the reference's site paths."""
    params, qparams, plan = _models(arch)
    cfg = jconfigs.get_smoke(arch)
    tp = params_from_jax(params, device="cpu")
    tq = params_from_jax(qparams, device="cpu")
    assert len(tp["blocks"]) == len(tq["blocks"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        for name in ("gate", "up", "down"):
            w = np.asarray(params["blocks"]["moe"]["experts"][name]["w"])[i]
            np.testing.assert_array_equal(tp["blocks"][i]["moe"]["experts"][name]["w"].numpy(), w)
            qt, jqt = tq["blocks"][i]["moe"]["experts"][name]["w"], qparams["blocks"]["moe"]["experts"][name]["w"]
            assert isinstance(qt, QTensor) and qt.experts == cfg.n_experts
            np.testing.assert_array_equal(qt.packed.numpy().view(np.uint32), np.asarray(jqt.packed)[i])
            np.testing.assert_array_equal(qt.scale_e.numpy(), np.asarray(jqt.scale_e)[i])
    sites = {"blocks/moe/router", "blocks/moe/experts/gate", "blocks/moe/experts/up", "blocks/moe/experts/down"}
    if cfg.moe_dense_residual:
        sites |= {f"blocks/moe/residual_mlp/{s}" for s in ("gate", "up", "down")}
        assert "residual_mlp" in tq["blocks"][0]["moe"]
    assert sites <= set(plan.site_paths)




# ---------------------------------------------------------------------------
# The model and the engines.
# ---------------------------------------------------------------------------
def _decode_logits(decode, init_cache, params, to_dev, steps=8):
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
    """8 ternary-PTQ decode steps at per-slot positions, flash decode on
    both sides: the router site (int8, fused) and the expert sites (one
    quantize_rows and one packed call each, plain versions on the CPU)
    against the reference's ref oracle."""
    params, qparams, plan = _models(arch)
    qapi = _jax_api(arch, plan, flash_decode=True, flash_prefill=True)
    want = _decode_logits(jax.jit(qapi.decode), qapi.init_cache, qparams, jnp.asarray)
    tq, tapi = _port(arch, params, flash_decode=True, flash_prefill=True)
    with torch.inference_mode():
        got = _decode_logits(tapi.decode, tapi.init_cache, tq, torch.from_numpy)
    np.testing.assert_allclose(got, want, atol=DECODE_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_tokens_match_reference(arch):
    params, qparams, plan = _models(arch)
    want = _run(_jax_api(arch, plan), qparams, JServing, JRequest, PROMPTS)
    tq, tapi = _port(arch, params)
    got = _run(tapi, tq, ServingEngine, Request, PROMPTS)
    assert got == want and len(got) == len(PROMPTS)


def test_staged_matches_lockstep_without_drops():
    """The reference's own MoE parity contract (tests/test_staged_serving.py,
    docs/SERVING.md): with drop-free capacity (factor 8.0) the staged and
    the lockstep engine give the same tokens on the float model."""
    params = _jax_params("grok-1-314b")
    cfg = dataclasses.replace(tconfigs.get_smoke("grok-1-314b"), capacity_factor=8.0)
    api = tbuild(cfg, device="cpu")
    tp = params_from_jax(params, device="cpu")
    prompts = [[5, 9, 2, 7, 11], [3, 1], [8] * 9]
    lock = _run(api, tp, ServingEngine, Request, prompts)
    stag = _run(api, tp, StagedEngine, Request, prompts, sched=SchedulerConfig(prefill_chunk=4))
    assert stag == lock and len(stag) == 3


def test_calibrated_expert_sites_equal_reference():
    """The observing pass records the (E, C, d) buffers of the expert sites
    and the router like dense sites (tests/test_artifact.py's MoE case): the
    port's static exponents equal the reference's on the same batches."""
    params = _jax_params("grok-1-314b")
    q = dict(group_size=16, mode="ptq", backend="ref", w_bits=2)
    _, jplan, _ = jquantize_and_plan(jbuild(jconfigs.get_smoke("grok-1-314b", JQuantConfig(**q))), params,
                                     calib_batches=[{"tokens": jnp.asarray(t)} for t in TOKENS])
    _, tplan, tapi = tquantize_and_plan(tbuild(tconfigs.get_smoke("grok-1-314b", TQuantConfig(**q)), device="cpu"),
                                        params_from_jax(params, device="cpu"),
                                        calib_batches=[{"tokens": torch.from_numpy(t)} for t in TOKENS])
    sites = {p for p, _ in tplan.act_exponents}
    assert {"blocks/moe/experts/gate", "blocks/moe/experts/up", "blocks/moe/experts/down",
            "blocks/moe/router"} <= sites
    assert tplan.act_exponents == jplan.act_exponents
    assert tapi.ctx.act_exponent("blocks/moe/experts/down") == dict(jplan.act_exponents)["blocks/moe/experts/down"]
