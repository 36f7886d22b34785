"""Port vs reference on the qwen3-8b smoke config (2 layers, d = 64,
group 16): fp forward logits, ternary-PTQ decode steps through the fused
site and flash decode, and the lockstep engine's greedy token lists."""
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
from repro.serving import ServingEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine

ARCH = "qwen3-8b"
PTQ = dict(w_bits=2, group_size=16, mode="ptq")


def _jax_ptq():
    cfg = dataclasses.replace(
        jconfigs.get_smoke(ARCH, JQuantConfig(backend="pallas", **PTQ)), flash_decode=True
    )
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    qparams, _, qapi = jquantize_and_plan(api, params)
    return params, qparams, qapi


def _port_api(backend="cuda"):
    cfg = dataclasses.replace(
        tconfigs.get_smoke(ARCH, TQuantConfig(backend=backend, **PTQ)), flash_decode=True
    )
    return tbuild(cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_ptq():
    return _jax_ptq()


TOKENS = np.random.default_rng(2).integers(0, 256, size=(2, 6)).astype(np.int32)
STARTS = [0, 3]  # per-slot positions, one row three tokens ahead


@pytest.fixture(scope="module")
def jax_decode_logits(jax_ptq):
    _, qparams, qapi = jax_ptq
    step = jax.jit(qapi.decode)
    return _decode_logits(step, qapi.init_cache, qparams, TOKENS, STARTS, jnp.asarray)


def test_fp_forward_logits_match():
    jcfg = jconfigs.get_smoke(ARCH)
    japi = jbuild(jcfg)
    params = japi.init(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    want = np.asarray(japi.forward(params, {"tokens": jnp.asarray(tokens)}))
    tapi = tbuild(tconfigs.get_smoke(ARCH), device="cpu")
    got = tapi.forward(params_from_jax(params, device="cpu"), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _decode_logits(decode, init_cache, params, tokens, starts, to_dev):
    cache = init_cache(tokens.shape[0], 16)
    outs = []
    for i in range(tokens.shape[1]):
        pos = to_dev(np.asarray(starts, np.int32) + i)
        logits, cache = decode(params, to_dev(tokens[:, i:i + 1]), pos, cache)
        outs.append(np.asarray(logits, np.float32))
    return np.stack(outs)


@pytest.mark.parametrize("route", ["port_quantizes", "reference_ptq_tree"])
def test_ptq_decode_steps_match(jax_ptq, jax_decode_logits, route):
    params, qparams, _ = jax_ptq
    want = jax_decode_logits
    tapi = _port_api()
    if route == "port_quantizes":
        tq, _, tqapi = tquantize_and_plan(tapi, params_from_jax(params, device="cpu"))
    else:
        tq = params_from_jax(qparams, device="cpu")
        _, plan, _ = tquantize_and_plan(tapi, params_from_jax(params, device="cpu"))
        tqapi = tapi.with_plan(plan)
    with torch.inference_mode():
        got = _decode_logits(tqapi.decode, tqapi.init_cache, tq, TOKENS, STARTS, torch.from_numpy)
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_port_quantization_equals_reference_tree(jax_ptq):
    """The port quantizing converted fp params builds the reference's PTQ
    tree byte for byte (every layer, every site)."""
    params, qparams, _ = jax_ptq
    tq, _, _ = tquantize_and_plan(_port_api(), params_from_jax(params, device="cpu"))
    ref = params_from_jax(qparams, device="cpu")
    for i in range(len(ref["blocks"])):
        for grp, site in [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                          ("mlp", "gate"), ("mlp", "up"), ("mlp", "down")]:
            a, b = tq["blocks"][i][grp][site]["w"], ref["blocks"][i][grp][site]["w"]
            assert torch.equal(a.packed, b.packed) and torch.equal(a.scale_m, b.scale_m)
            assert int(a.scale_e) == int(b.scale_e)
    assert torch.equal(tq["lm_head"]["w"].packed, ref["lm_head"]["w"].packed)
    assert torch.equal(tq["embed"]["table"], ref["embed"]["table"])


def test_lockstep_engine_greedy_tokens_match(jax_ptq):
    """The slice as a whole: 3 requests through 2 slots, same greedy lists."""
    params, qparams, qapi = jax_ptq
    prompts = [[5, 9, 2, 7], [3, 1], [11, 4, 8]]
    jeng = JEngine(qapi, qparams, n_slots=2, max_len=32)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=list(p), max_new_tokens=5))
    want = {r.uid: r.output for r in jeng.run()}

    tq, _, tqapi = tquantize_and_plan(_port_api(), params_from_jax(params, device="cpu"))
    teng = TEngine(tqapi, tq, n_slots=2, max_len=32)
    for i, p in enumerate(prompts):
        teng.submit(TRequest(uid=i, prompt=list(p), max_new_tokens=5))
    got = {r.uid: r.output for r in teng.run()}
    assert got == want and len(got) == 3
    assert teng.stats()["tokens"] == 15


def test_scalar_position_decode_equals_per_slot_positions():
    """decode_step with one scalar position (aligned cache write) equals
    per-slot positions that are all the same (masked write)."""
    tapi = tbuild(tconfigs.get_smoke(ARCH), device="cpu")
    params = tapi.init(torch.Generator().manual_seed(0))
    tok = torch.tensor([[3], [7]])
    with torch.inference_mode():
        outs = []
        for pos in (lambda i: i, lambda i: torch.full((2,), i, dtype=torch.int32)):
            cache = tapi.init_cache(2, 8)
            for i in range(3):
                logits, cache = tapi.decode(params, tok, pos(i), cache)
            outs.append(logits)
    assert torch.equal(outs[0], outs[1])


def test_sampler_greedy_and_top_k():
    from repro_torch.serving import SamplerConfig, sample

    logits = torch.tensor([[0.1, 3.0, 2.0, -1.0], [5.0, 0.0, 4.9, 0.2]])
    assert sample(None, logits, SamplerConfig()).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    drawn = {int(t) for _ in range(50) for t in sample(gen, logits, SamplerConfig(1.0, 2))[:1]}
    assert drawn <= {1, 2}


def test_build_model_without_device_needs_the_card():
    cfg = tconfigs.get_smoke(ARCH)
    if torch.cuda.is_available():
        assert tbuild(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tbuild(cfg)


@pytest.mark.parametrize("window", [None, 7], ids=["global", "window"])
@pytest.mark.parametrize("t", [32, 40], ids=["whole_chunks", "partial_chunk"])
def test_attend_chunked_matches_reference(window, t):
    """Online softmax over key chunks (prefill with T > chunk) against the
    reference's ``_attend_chunked`` and the port's dense attention."""
    from repro.models.attention import _attend_chunked as jchunked
    from repro_torch.models.attention import _attend_chunked, _attend_dense_mha, _mask_bias

    rng = np.random.default_rng(t)
    q, k, v = (rng.normal(size=(2, t, 3, 8)).astype(np.float32) for _ in range(3))
    pos = np.arange(t)
    want = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), True, window, 16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _attend_chunked(tq, tk, tv, torch.from_numpy(pos), True, window, 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    dense = _attend_dense_mha(tq, tk, tv, _mask_bias(torch.from_numpy(pos), torch.arange(t), True, window)[None])
    np.testing.assert_allclose(got, dense.numpy(), atol=1e-5)
