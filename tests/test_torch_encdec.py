"""Port vs reference on the enc-dec family (whisper-base smoke: 2 encoder +
2 decoder layers, d_model 64, 4 heads of 16, 16 audio frames): the config,
``layernorm``, ``attention`` with a cross-attention source and the
non-causal online-softmax chunks, ``encode`` / ``forward`` / ``prefill`` /
``decode_step`` at the reference's float tolerances (oracle and flash
routes), the decoder position table and the smoke batch.  Serving (PTQ
decode, both engines, the insert, per-call-path precision and exponents)
is in ``tests/test_torch_encdec_serving.py``.  Inputs come from numpy
seeds, parameters from the reference's init through ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import config_to_dict as jconfig_to_dict
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models.layers import QuantCtx as JQuantCtx
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import make_smoke_batch
from repro_torch.models import layers as tlayers
from repro_torch.quant.plan import QuantCtx

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def params():
    return jbuild(jconfigs.get_smoke(ARCH)).init(jax.random.PRNGKey(0))


def _batch(cfg, seed=0, b=2, s=6):
    rng = np.random.default_rng(seed)
    return {"frames": (rng.normal(size=(b, cfg.n_audio_frames, cfg.d_model)) * 0.1).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _apis(**over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), **over)
    return jbuild(jcfg), tbuild(tconfigs.config_from_dict(jconfig_to_dict(jcfg)), device="cpu")


def test_config_matches_reference():
    assert tconfigs.config_to_dict(tconfigs.get_config(ARCH)) == jconfig_to_dict(jconfigs.get_config(ARCH))
    assert tconfigs.config_to_dict(tconfigs.get_smoke(ARCH)) == jconfig_to_dict(jconfigs.get_smoke(ARCH))
    assert ARCH in tconfigs.ARCH_IDS and tconfigs.get_config(ARCH).padded_vocab == 51968


def test_layernorm_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 64)) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.normal(size=(64,)).astype(np.float32), "bias": rng.normal(size=(64,)).astype(np.float32)}
    want = np.asarray(jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, xb).dtype == torch.bfloat16


@pytest.mark.parametrize("chunk", [1024, 5], ids=["dense", "chunked"])
@pytest.mark.parametrize("kv_src", [False, True], ids=["self", "cross"])
def test_attention_non_causal_matches_reference(params, chunk, kv_src):
    """Non-causal, no RoPE, with and without a cross-attention source; at
    chunk 5 over 16 keys the online-softmax chunks (three of 5 and a
    partial one of 1) run on both sides."""
    cfg = jconfigs.get_smoke(ARCH)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7 if kv_src else 16, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    p = jax.tree.map(lambda a: a[0], params["dec_blocks"]["cross_attn"])
    pos = np.arange(x.shape[1], dtype=np.int32)
    want, _ = jattn.attention(p, jnp.asarray(x), jnp.asarray(pos), cfg, JQuantCtx(), "dec/cross_attn", causal=False,
                              rope=False, kv_src=jnp.asarray(src) if kv_src else None, chunk=chunk)
    got, _ = tattn.attention(params_from_jax({"blocks": params["dec_blocks"]}, device="cpu")["blocks"][0]["cross_attn"],
                             torch.from_numpy(x), torch.from_numpy(pos), tconfigs.get_smoke(ARCH), QuantCtx(),
                             "dec/cross_attn", causal=False, rope=False,
                             kv_src=torch.from_numpy(src) if kv_src else None, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_encode_and_forward_match(params):
    cfg = jconfigs.get_smoke(ARCH)
    japi, tapi = _apis()
    batch = _batch(cfg)
    tp = params_from_jax(params, device="cpu")
    from repro.models import encdec as jencdec
    from repro_torch.models import encdec as tencdec

    want = np.asarray(jencdec.encode(params, jnp.asarray(batch["frames"]), cfg, JQuantCtx()))
    got = tencdec.encode(tp, torch.from_numpy(batch["frames"]), tapi.cfg, QuantCtx())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    want = np.asarray(japi.forward(params, _jb(batch)))
    got = tapi.forward(tp, _tb(batch))
    assert got.shape == (2, 6, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kv_fmt,flash", [("kv_bf16", False), ("kv_int8", False), ("kv_int8", True),
                                          ("kv_mx", True)])
def test_prefill_and_decode_steps_match(params, kv_fmt, flash):
    """The audio path through the model API: prefill (frames + a 6-token
    prompt) then 4 greedy decode steps at per-slot positions; logits at
    1e-5, ``enc_out`` (bf16, the cache dtype) within 1e-5 and one bf16
    step of the reference's (the float32 encoder outputs differ in their
    last bits, which may round to neighbouring bf16 values), the quantized
    KV leaves equal; the decode steps then read the reference's cache
    through ``cache_from_jax``.  Flash: the reference's Pallas kernels in interpret
    mode, the port's plain versions."""
    cfg = jconfigs.get_smoke(ARCH)
    japi, tapi = _apis(kv_fmt=kv_fmt, flash_decode=flash, flash_prefill=flash)
    batch = _batch(cfg, seed=3)
    tp = params_from_jax(params, device="cpu")
    jl, jc = japi.prefill(params, _jb(batch), japi.init_cache(2, 32))
    tl, tc = tapi.prefill(tp, _tb(batch), tapi.init_cache(2, 32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    assert tc["enc_out"].dtype == torch.bfloat16
    want_enc = cache_from_jax({"e": np.asarray(jc["enc_out"])}, device="cpu")["e"]
    np.testing.assert_allclose(tc["enc_out"].float().numpy(), want_enc.float().numpy(), atol=1e-5, rtol=2**-7)
    want = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    for name in ("k", "v", "ke", "ve"):
        if name in want and want[name].dtype != torch.bfloat16:  # quantized leaves: equal bytes
            assert torch.equal(tc[name], want[name]), name
    # the steps read the reference's cache, ``enc_out`` included (cache_from_jax carries it)
    tc = want
    jdecode = jax.jit(japi.decode)
    starts = np.asarray([6, 6], np.int32)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(4):
        jl, jc = jdecode(params, jnp.asarray(tok), jnp.asarray(starts + i), jc)
        with torch.inference_mode():
            tl, tc = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(starts + i), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_pos_embed_wraps_and_takes_per_slot_starts(params):
    from repro.models import encdec as jencdec
    from repro_torch.models import encdec as tencdec

    table = np.asarray(params["dec_pos"])
    for start, length in ((0, 5), (446, 4), (np.asarray([0, 447, 900], np.int32), 3)):
        want = np.asarray(jencdec._pos_embed(jnp.asarray(table), jnp.asarray(start) if np.ndim(start) else start,
                                             length))
        got = tencdec._pos_embed(torch.from_numpy(table), torch.from_numpy(start) if np.ndim(start) else start, length)
        np.testing.assert_array_equal(got.numpy(), want)


def test_smoke_batch_carries_frames_and_labels():
    cfg = tconfigs.get_smoke(ARCH)
    b = make_smoke_batch(torch.Generator().manual_seed(0), cfg, 2, 5)
    assert b["frames"].shape == (2, cfg.n_audio_frames, cfg.d_model) and b["frames"].dtype == torch.float32
    assert b["tokens"].shape == b["labels"].shape == (2, 5)
    again = make_smoke_batch(torch.Generator().manual_seed(0), cfg, 2, 5)
    assert all(torch.equal(b[k], again[k]) for k in b)
