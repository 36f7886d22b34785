"""Port vs reference on the VLM family (qwen2-vl-72b smoke: 2 layers, 4
patch embeddings, head_dim 16): the config, ``apply_mrope`` and
``build_mrope_positions``, fp forward logits with prepended patch
embeddings, the vision prefill on each attention route against the same
route of the reference (ROADMAP Queue C13: the two routes differ, in both
packages, by the same amount) and the smoke batch.  Serving (ternary-PTQ
decode through the M-RoPE branch, both engines' text tokens) is in
``tests/test_torch_vlm_serving.py``.  Inputs come from numpy seeds,
parameters from the reference's init through ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import config_to_dict as jconfig_to_dict
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import vlm as jvlm
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models import make_smoke_batch
from repro_torch.models import vlm as tvlm

ARCH = "qwen2-vl-72b"
N_TEXT = 6


@pytest.fixture(scope="module")
def params():
    return jbuild(jconfigs.get_smoke(ARCH)).init(jax.random.PRNGKey(0))


def _batch(cfg, seed=0, b=1, n_text=N_TEXT):
    """A vision batch from numpy seeds: tokens, patch embeddings, M-RoPE
    positions (the reference's ``build_mrope_positions``)."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_frontend_tokens
    return {
        "tokens": rng.integers(0, cfg.vocab, size=(b, n_text)).astype(np.int32),
        "vision_embeds": (rng.normal(size=(b, nv, cfg.d_model)) * 0.1).astype(np.float32),
        "positions": np.asarray(jvlm.build_mrope_positions(b, nv, n_text)),
    }


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_config_matches_reference():
    assert tconfigs.config_to_dict(tconfigs.get_config(ARCH)) == jconfig_to_dict(jconfigs.get_config(ARCH))
    assert tconfigs.config_to_dict(tconfigs.get_smoke(ARCH)) == jconfig_to_dict(jconfigs.get_smoke(ARCH))
    assert ARCH in tconfigs.ARCH_IDS


@pytest.mark.parametrize("batch,n_vis,n_text,grid", [(2, 4, 6, 0), (1, 9, 3, 0), (1, 6, 2, 2), (3, 1024, 16, 0)])
def test_build_mrope_positions_matches_reference(batch, n_vis, n_text, grid):
    want = np.asarray(jvlm.build_mrope_positions(batch, n_vis, n_text, grid))
    got = tvlm.build_mrope_positions(batch, n_vis, n_text, grid)
    assert got.dtype == torch.int32 and got.shape == (3, batch, n_vis + n_text)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_reference_and_is_rope_on_text(hd):
    """Sections 1:1:2 over the hd / 2 lanes, as the reference computes
    them; with three equal components M-RoPE is RoPE."""
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 10, 4, hd)).astype(np.float32)
    pos = np.asarray(jvlm.build_mrope_positions(2, 4, 6))
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    text = np.broadcast_to(np.arange(10, dtype=np.int32), (3, 2, 10))
    np.testing.assert_allclose(tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text.copy()), 1e6).numpy(),
                               tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(text[0].copy()), 1e6).numpy(),
                               atol=1e-6)


def test_fp_forward_logits_match(params):
    cfg = jconfigs.get_smoke(ARCH)
    batch = _batch(cfg, b=2)
    want = np.asarray(jbuild(cfg).forward(params, _jb(batch)))
    got = tbuild(tconfigs.get_smoke(ARCH), device="cpu").forward(params_from_jax(params, device="cpu"), _tb(batch))
    assert got.shape == (2, cfg.n_frontend_tokens + N_TEXT, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _prefill(params, flash, kv_fmt="kv_int8", seed=0):
    """(reference logits, its cache, port logits, its cache) of one vision
    prefill (4 patch embeddings + 6 tokens), on the flash route (the
    reference's Pallas kernel in interpret mode, as its tests run it) or
    the oracle route."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), kv_fmt=kv_fmt, flash_decode=flash, flash_prefill=flash)
    batch = _batch(jcfg, seed)
    japi = jbuild(jcfg)
    jl, jc = japi.prefill(params, _jb(batch), japi.init_cache(1, 32))
    tapi = tbuild(tconfigs.config_from_dict(jconfig_to_dict(jcfg)), device="cpu")
    tl, tc = tapi.prefill(params_from_jax(params, device="cpu"), _tb(batch), tapi.init_cache(1, 32))
    return np.asarray(jl), jc, tl.numpy(), tc


@pytest.mark.parametrize("flash", [False, True], ids=["oracle", "flash"])
def test_vision_prefill_matches_reference_route(params, flash):
    """Each route against the same route of the reference: last-token
    logits 1e-5 and the written kv_int8 cache byte for byte."""
    jl, jc, tl, tc = _prefill(params, flash)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    want = cache_from_jax({n: np.asarray(v) for n, v in jc.items()}, device="cpu")
    for name in want:
        assert torch.equal(tc[name], want[name]), name


def test_c13_prefill_routes_differ_as_in_the_reference(params):
    """ROADMAP Queue C13: under M-RoPE the oracle masks causality by the
    temporal id (every patch sees key 0 only, text token j keys 0..1+j),
    the flash route by index.  The reference's two routes give different
    logits; the port mirrors both, so its routes differ the same way."""
    j_or, _, t_or, _ = _prefill(params, False, "kv_bf16", seed=3)
    j_fl, _, t_fl, _ = _prefill(params, True, "kv_bf16", seed=3)
    gap = np.abs(j_fl - j_or).max()
    assert gap > 1e-2, gap
    np.testing.assert_allclose(t_fl - t_or, j_fl - j_or, atol=2e-5)


def test_smoke_batch_carries_vision_inputs():
    cfg = tconfigs.get_smoke(ARCH)
    b = make_smoke_batch(torch.Generator().manual_seed(0), cfg, 2, 5)
    assert b["tokens"].shape == (2, 5) and b["vision_embeds"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    assert torch.equal(b["positions"], tvlm.build_mrope_positions(2, cfg.n_frontend_tokens, 5))
