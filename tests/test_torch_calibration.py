"""Calibration in the port against the reference: the host observer's
records, ``core/calibration.py``, the static activation exponents that
``quantize_and_plan`` profiles on the qwen3-8b smoke model (float32, 2
layers), the calibrated decode, and the paper's operation accounting
(``core/stats.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import calibration as jcal
from repro.core import stats as jstats
from repro.models import build_model as jbuild
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.quant.api import Observer as JObserver
from repro.quant.api import observe_site as jobserve_site
from repro.quant.plan import QuantCtx as JQuantCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import calibration as tcal
from repro_torch.core import stats as tstats
from repro_torch.models import build_model as tbuild
from repro_torch.models import init_quantized, quantize_and_plan
from repro_torch.quant import Observer, QuantCtx, QuantPlan, observe_site

ARCH = "qwen3-8b"
MSQ_RTOL = 1e-6  # float32 mean of squares summed in another order
SITE_RTOL = 1e-5  # a site's max|x| after the float forward (logits agree to 1e-5, test_torch_model.py)
FORMATS = {
    "ternary": dict(w_bits=2), "int4": dict(w_bits=4), "int8": dict(w_bits=8),
    "nf4": dict(w_bits=4, fmt="nf4"), "mx": dict(w_bits=8, fmt="mx"),
}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    sites = ["blocks/attn/wq", "blocks/mlp/down", "blocks/attn/wq", "lm_head", "blocks/attn/wq"]
    shapes = [(4, 16), (2, 3, 32), (4, 16), (1, 64), (7, 16)]
    scales = [1.0, 30.0, 0.01, 5.0, 1e3]
    return [(s, (rng.normal(size=shape) * sc).astype(np.float32)) for s, shape, sc in zip(sites, shapes, scales)]


def _assert_records_equal(got, want, max_rtol=0.0):
    assert list(got) == list(want)
    for site in want:
        g, w = got[site], want[site]
        assert g["count"] == w["count"], site
        np.testing.assert_allclose(g["max_abs"], w["max_abs"], rtol=max_rtol, atol=0, err_msg=site)
        np.testing.assert_allclose(g["msq"], w["msq"], rtol=max(MSQ_RTOL, max_rtol), atol=0, err_msg=site)


@pytest.mark.parametrize("seed", [0, 1])
def test_observer_records_equal_reference(seed):
    jobs, tobs = JObserver(), Observer()
    for site, x in _arrays(seed):
        jobserve_site(jobs, site, jnp.asarray(x))
        observe_site(tobs, site, torch.from_numpy(x))
    jax.effects_barrier()
    _assert_records_equal(tobs, jobs)
    assert tobs["blocks/attn/wq"]["count"] == 3.0
    bits_for = {"lm_head": 4}.get
    assert tobs.exponents() == jobs.exponents()
    assert tobs.exponents(8, lambda s: bits_for(s, 8)) == jobs.exponents(8, lambda s: bits_for(s, 8))


# ---------------------------------------------------------------------------
# core/calibration.py
# ---------------------------------------------------------------------------
def test_observe_finalize_and_rms_match_reference():
    jst, tst = jcal.init_observer(), tcal.init_observer()
    assert jst == tst == {}
    for site, x in _arrays(2):
        jst = jcal.observe(jst, site, jnp.asarray(x))
        tst = tcal.observe(tst, site, torch.from_numpy(x))
    for site in jst:
        assert float(tst[site]["max_abs"]) == float(jst[site]["max_abs"])
        assert float(tst[site]["count"]) == float(jst[site]["count"])
        np.testing.assert_allclose(float(tst[site]["msq"]), float(jst[site]["msq"]), rtol=MSQ_RTOL)
        np.testing.assert_allclose(float(tcal.rms_from_observer(tst, site)),
                                   float(jcal.rms_from_observer(jst, site)), rtol=MSQ_RTOL)
    for bits in (8, 4):
        got, want = tcal.finalize(tst, bits), jcal.finalize(jst, bits)
        assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_dynamic_and_fake_quantize_act_match_reference(per_row, bits):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(5, 3, 16)) * np.array([1e-3, 1.0, 40.0, 0.0, 7.0])[:, None, None]).astype(np.float32)
    jq, je = jcal.dynamic_quantize_act(jnp.asarray(x), bits, per_row)
    tq, te = tcal.dynamic_quantize_act(torch.from_numpy(x), bits, per_row)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tcal.fake_quantize_act(torch.from_numpy(x), bits, per_row).numpy(),
                                  np.asarray(jcal.fake_quantize_act(jnp.asarray(x), bits, per_row)))


@pytest.mark.parametrize("e", [-6, 0, 3])
def test_static_quantize_act_matches_reference(e):
    x = (np.random.default_rng(e + 10).normal(size=(6, 32)) * 50).astype(np.float32)
    want = np.asarray(jcal.quantize_act(jnp.asarray(x), jnp.int32(e)))
    np.testing.assert_array_equal(tcal.quantize_act(torch.from_numpy(x), e).numpy(), want)


def test_recalibrate_gamma_matches_reference():
    gamma = np.linspace(0.5, 2.0, 8).astype(np.float32)
    for rms_fp, rms_q, eps in [(4.0, 1.0, 1e-6), (0.3, 0.7, 0.0)]:
        want = np.asarray(jcal.recalibrate_gamma(jnp.asarray(gamma), jnp.float32(rms_fp), jnp.float32(rms_q), eps))
        got = tcal.recalibrate_gamma(torch.from_numpy(gamma), torch.tensor(rms_fp), torch.tensor(rms_q), eps)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# quantize_and_plan with calibration batches, on converted weights.
# ---------------------------------------------------------------------------
TOKENS = [np.random.default_rng(100 + i).integers(0, 256, size=(2, 16)).astype(np.int32) for i in range(2)]


@pytest.fixture(scope="module")
def jax_fp():
    cfg = jconfigs.get_smoke(ARCH, JQuantConfig(w_bits=2, group_size=16, mode="ptq", backend="ref"))
    api = jbuild(cfg)
    return api, api.init(jax.random.PRNGKey(0))


def _tapi(fmt="ternary", backend="ref"):
    q = TQuantConfig(group_size=16, mode="ptq", backend=backend, **FORMATS[fmt])
    return tbuild(tconfigs.get_smoke(ARCH, q), device="cpu")


def test_observed_site_ranges_match_reference(jax_fp):
    japi, jparams = jax_fp
    tparams = params_from_jax(jparams, device="cpu")
    jobs, tobs = JObserver(), Observer()
    jfwd = japi.with_ctx(JQuantCtx(mode="fp", policy=japi.ctx.policy, observer=jobs)).forward
    tfwd = _tapi().with_ctx(QuantCtx(mode="fp", policy=_tapi().ctx.policy, observer=tobs)).forward
    for toks in TOKENS:
        jfwd(jparams, {"tokens": jnp.asarray(toks)})
        tfwd(tparams, {"tokens": torch.from_numpy(toks)})
    jax.effects_barrier()
    assert sorted(tobs) == sorted(jobs) and len(tobs) == 8
    assert tobs["blocks/attn/wq"]["count"] == 4.0 and tobs["lm_head"]["count"] == 2.0  # a record a layer a batch
    _assert_records_equal(dict(sorted(tobs.items())), dict(sorted(jobs.items())), max_rtol=SITE_RTOL)


@pytest.mark.parametrize("fmt", ["ternary", "nf4"])
def test_calibrated_exponents_equal_reference(jax_fp, fmt):
    japi, jparams = jax_fp
    jcfg = dataclasses.replace(japi.cfg, quant=JQuantConfig(group_size=16, mode="ptq", backend="ref",
                                                            **FORMATS[fmt]))
    jbatches = [{"tokens": jnp.asarray(t)} for t in TOKENS]
    _, jplan, _ = jquantize_and_plan(jbuild(jcfg), jparams, calib_batches=jbatches)
    tbatches = [{"tokens": torch.from_numpy(t)} for t in TOKENS]
    _, tplan, tqapi = quantize_and_plan(_tapi(fmt), params_from_jax(jparams, device="cpu"), calib_batches=tbatches)
    assert jplan.calibrated and len(jplan.act_exponents) == 8
    assert tplan.act_exponents == jplan.act_exponents
    assert {p: dataclasses.asdict(prec) for p, prec in tplan.sites()} == {
        p: dataclasses.asdict(prec) for p, prec in jplan.sites()}
    assert tqapi.ctx.plan is tplan and tqapi.ctx.act_exponent("blocks/mlp/down") == dict(jplan.act_exponents)[
        "blocks/mlp/down"]


def test_calibrated_decode_matches_reference(jax_fp):
    """The static-exponent PTQ decode (the plan's act_exponent into every
    qdense site) against the reference's on the same weights and plan."""
    japi, jparams = jax_fp
    jbatches = [{"tokens": jnp.asarray(t)} for t in TOKENS]
    jq, jplan, jqapi = jquantize_and_plan(japi, jparams, calib_batches=jbatches)
    tapi = _tapi(backend="cuda").with_plan(QuantPlan.from_json(jplan.to_json()))
    tq = params_from_jax(jq, device="cpu")
    tok = np.asarray([[3], [77]], np.int32)
    want, cache = [], jqapi.init_cache(2, 8)
    got, tcache = [], tapi.init_cache(2, 8)
    with torch.inference_mode():
        for pos in range(3):
            lj, cache = jqapi.decode(jq, jnp.asarray(tok), jnp.int32(pos), cache)
            lt, tcache = tapi.decode(tq, torch.from_numpy(tok), pos, tcache)
            want.append(np.asarray(lj))
            got.append(lt.numpy())
            tok = np.asarray(lj).argmax(-1).astype(np.int32)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=5e-3)
    np.testing.assert_array_equal(np.stack(got).argmax(-1), np.stack(want).argmax(-1))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quantize_and_plan_of_init_equals_init_quantized(fmt):
    api = _tapi(fmt, backend="cuda")
    q1, plan1, _ = quantize_and_plan(api, api.init(torch.Generator().manual_seed(0)))
    q2, plan2, _ = init_quantized(api, torch.Generator().manual_seed(0))
    assert plan1 == plan2

    def walk(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:  # QTensor
            assert (a.bits, a.group_size, a.shape, a.fmt) == (b.bits, b.group_size, b.shape, b.fmt)
            for f in ("packed", "scale_m", "scale_e"):
                assert torch.equal(getattr(a, f), getattr(b, f))

    walk(q1, q2)


# ---------------------------------------------------------------------------
# core/stats.py
# ---------------------------------------------------------------------------
def test_operation_accounting_equals_reference():
    specs_t, specs_j = tstats.resnet101_specs(), jstats.resnet101_specs()
    assert [dataclasses.astuple(s) for s in specs_t] == [dataclasses.astuple(s) for s in specs_j]
    for n in (1, 4, 16, 64):
        assert tstats.network_replaced_fraction(specs_t, n) == jstats.network_replaced_fraction(specs_j, n)
        assert tstats.paper_approximation(n) == jstats.paper_approximation(n)
        assert tstats.gemm_replaced_fraction(n) == jstats.gemm_replaced_fraction(n)
    # the paper's Sec. 3.3: ~85% of multiplications replaced at N = 4, ~98% at N = 64
    assert 0.84 < tstats.network_replaced_fraction(specs_t, 4) < 0.90
    assert tstats.network_replaced_fraction(specs_t, 64) > 0.98
    gemms = [(name, k, n, calls, q) for name, k, n, calls, q in [
        ("wq", 4096, 4096, 1.0, True), ("wkv", 4096, 2048, 1.0, True), ("ffn", 4096, 36864, 1.0, True),
        ("attn", 128, 1024, 32.0, False), ("lm_head", 4096, 151936, 0.5, True)]]
    tg = [tstats.GemmSpec(*g) for g in gemms]
    jg = [jstats.GemmSpec(*g) for g in gemms]
    for group in (16, 64):
        assert tstats.network_gemm_stats(tg, group) == jstats.network_gemm_stats(jg, group)
        for bits in (2, 4, 8):
            assert tstats.weight_bytes(tg, bits, group) == jstats.weight_bytes(jg, bits, group)
