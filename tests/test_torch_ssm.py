"""Port vs reference on the SSM family (falcon-mamba-7b smoke: 2 Mamba1
layers) and the hybrid (zamba2-7b smoke: 7 Mamba2 layers in 2 superblocks
of 3 plus a tail of 1, 2 shared attention blocks): the configs, Mamba1 and
Mamba2 ``_seq`` / ``_step`` against the reference's chunked scan, fp
forward logits, and the calibrated exponents.  Serving (ternary PTQ, both
engines, the staged engine's per-token prefill fallback, slot reuse) is
in ``tests/test_torch_ssm_serving.py``.  Inputs come from numpy seeds,
parameters from the reference's init through ``params_from_jax``.
"""
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
from repro.models import ssm as jssm
from repro.quant.plan import QuantCtx as JQuantCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.models import ssm as tssm
from repro_torch.quant.plan import QuantCtx

ARCHS = ["falcon-mamba-7b", "zamba2-7b"]
STEP = {1: (jssm.mamba1_step, tssm.mamba1_step), 2: (jssm.mamba2_step, tssm.mamba2_step)}
SEQ = {1: (jssm.mamba1_seq, tssm.mamba1_seq), 2: (jssm.mamba2_seq, tssm.mamba2_seq)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert tconfigs.config_to_dict(tconfigs.get_config(arch)) == jconfig_to_dict(jconfigs.get_config(arch))
    assert tconfigs.config_to_dict(tconfigs.get_smoke(arch)) == jconfig_to_dict(jconfigs.get_smoke(arch))
    assert arch in tconfigs.ARCH_IDS


def test_published_widths():
    """falcon-mamba: d_inner 8192, dt rank 256, x_proj N 288; zamba2: 112
    Mamba2 heads of 64, 13 superblocks of 6 plus a tail of 3, attention
    head_dim 112."""
    from repro_torch.models import hybrid

    fm, z = tconfigs.get_config("falcon-mamba-7b"), tconfigs.get_config("zamba2-7b")
    assert (tssm.d_inner(fm), tssm._dt_rank(fm), tssm._dt_rank(fm) + 2 * fm.ssm_state) == (8192, 256, 288)
    assert tssm._m2_heads(z) == (112, 64) and hybrid.plan(z) == (13, 6, 3) and z.hd() == 112


def _block(arch, seed):
    """(cfg, the reference's Mamba block params, the port's)."""
    cfg = jconfigs.get_smoke(arch)
    p = jssm.init_mamba(jax.random.PRNGKey(seed), cfg, jnp.float32)
    if cfg.ssm_version == 1:  # a non-zero conv bias (init gives zeros)
        p = dict(p, conv_b=jnp.asarray(np.random.default_rng(seed).normal(size=p["conv_b"].shape) * 0.1,
                                       jnp.float32))
    else:  # non-zero dt biases and decays
        rng = np.random.default_rng(seed)
        p = dict(p, dt_bias=jnp.asarray(rng.normal(size=p["dt_bias"].shape), jnp.float32),
                 A_log=jnp.asarray(rng.normal(size=p["A_log"].shape) * 0.5, jnp.float32))
    return cfg, p, params_from_jax({"m": p}, device="cpu")["m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_seq_and_step_match_reference(arch, monkeypatch):
    """The sequence form (both packages' scans in chunks of 8 over 24
    steps: the state carried across chunks) and 24 decode steps from a
    zero state: outputs and the float32 states at 1e-5."""
    monkeypatch.setattr(tssm, "SCAN_CHUNK", 8)
    cfg, jp, tp = _block(arch, 1)
    x = (np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)) * 0.5).astype(np.float32)
    jseq, tseq = SEQ[cfg.ssm_version]
    want = np.asarray(jseq(jp, jnp.asarray(x), cfg, JQuantCtx.fp(), "mamba", chunk=8))
    tcfg = tconfigs.get_smoke(arch)
    got = tseq(tp, torch.from_numpy(x), tcfg, QuantCtx.fp(), "mamba")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    jstep, tstep = STEP[cfg.ssm_version]
    jst, tst = jssm.init_ssm_state(cfg, 2), tssm.init_ssm_state(tcfg, 2)
    for t in range(24):
        jo, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), jst, cfg, JQuantCtx.fp(), "mamba")
        to, tst = tstep(tp, torch.from_numpy(x[:, t:t + 1]), tst, tcfg, QuantCtx.fp(), "mamba")
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(to.numpy()[:, 0], got.numpy()[:, t], atol=1e-5)  # step == sequence
    for name in ("h", "conv"):
        assert tst[name].dtype == torch.float32
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]), atol=1e-5)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    return arch, jbuild(jconfigs.get_smoke(arch)).init(jax.random.PRNGKey(0))


def _scale_atol(want):
    """1e-5 of the logit scale: the hybrid's 9 blocks (7 Mamba2, 2 shared
    attention) each land within a few float32 ulps of the reference's
    (``test_hybrid_blocks_match_reference``, 1e-5 absolute), and the
    residual stream grows to ~9, so the logits differ by ~30 ulps."""
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def test_fp_forward_logits_match(model):
    arch, params = model
    jcfg = jconfigs.get_smoke(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 12)).astype(np.int32)
    want = np.asarray(jbuild(jcfg).forward(params, {"tokens": jnp.asarray(tokens)}))
    got = tbuild(tconfigs.get_smoke(arch), device="cpu").forward(params_from_jax(params, device="cpu"),
                                                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, atol=_scale_atol(want))


def test_hybrid_blocks_match_reference():
    """Each of zamba2's blocks in order -- 3 Mamba2 blocks, a shared block
    (alternating), 3, a shared block, the tail -- on the reference's input
    to it: the port's output at 1e-5."""
    from repro.models import hybrid as jh
    from repro_torch.models import hybrid as th

    cfg, tcfg = jconfigs.get_smoke("zamba2-7b"), tconfigs.get_smoke("zamba2-7b")
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(params, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 12))
    x = jnp.asarray(np.asarray(params["embed"]["table"])[tokens])
    n_super, p, tail = jh.plan(cfg)
    layer = lambda stack, i: jax.tree.map(lambda leaf: leaf[i], params[stack])  # noqa: E731
    blocks = []
    for j in range(n_super):
        blocks += [(lambda h, i=i: jh._mamba_block(layer("mamba_stack", i), h, cfg, JQuantCtx.fp()),
                    lambda h, i=i: th._mamba_block(tp["mamba_stack"][i], h, tcfg, QuantCtx.fp()))
                   for i in range(j * p, (j + 1) * p)]
        blocks.append((lambda h, j=j: jh._shared_block(layer("shared", j % 2), h, jnp.arange(12), cfg,
                                                       JQuantCtx.fp())[0],
                       lambda h, j=j: th._shared_block(th._select_shared(tp["shared"], j), h, torch.arange(12), tcfg,
                                                       QuantCtx.fp())[0]))
    blocks += [(lambda h, i=i: jh._mamba_block(layer("tail_stack", i), h, cfg, JQuantCtx.fp()),
                lambda h, i=i: th._mamba_block(tp["tail_stack"][i], h, tcfg, QuantCtx.fp())) for i in range(tail)]
    assert len(blocks) == 9
    for jblock, tblock in blocks:
        want = jblock(x)
        got = tblock(torch.from_numpy(np.array(x)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        x = want


def test_fp_decode_steps_match_reference():
    """12 fp decode steps of falcon-mamba through its float32 recurrent
    state, at 1e-5 (the hybrid's shared blocks read a bf16 KV cache, where
    a one-ulp difference can round a cached value the other way: its decode
    is held under PTQ in ``tests/test_torch_ssm_serving.py``)."""
    arch = "falcon-mamba-7b"
    jcfg = jconfigs.get_smoke(arch)
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    japi, tapi = jbuild(jcfg), tbuild(tconfigs.get_smoke(arch), device="cpu")
    tp = params_from_jax(params, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, size=(2, 12)).astype(np.int32)
    jc, tc = japi.init_cache(2, 16), tapi.init_cache(2, 16)
    jdecode = jax.jit(japi.decode)
    for t in range(12):
        jl, jc = jdecode(params, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jc)
        tl, tc = tapi.decode(tp, torch.from_numpy(toks[:, t:t + 1]), t, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for name in ("h", "conv"):
        np.testing.assert_allclose(tc["ssm"][name].numpy(), np.asarray(jc["ssm"][name]), atol=1e-5)


def test_calibrated_exponents_match_reference(model):
    """A ternary plan calibrated on the same two token batches: the same
    sites and static exponents as the reference's."""
    arch, params = model
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 256, size=(2, 8)).astype(np.int32) for _ in range(2)]
    jcfg = jconfigs.get_smoke(arch, JQuantConfig(w_bits=2, group_size=16, mode="ptq", backend="ref"))
    _, jplan, _ = jquantize_and_plan(jbuild(jcfg), params, [{"tokens": jnp.asarray(b)} for b in batches])
    tcfg = tconfigs.get_smoke(arch, TQuantConfig(w_bits=2, group_size=16, mode="ptq", backend="cuda"))
    _, tplan, _ = tquantize_and_plan(tbuild(tcfg, device="cpu"), params_from_jax(params, device="cpu"),
                                     [{"tokens": torch.from_numpy(b)} for b in batches])
    assert tplan.act_exponents == jplan.act_exponents and len(tplan.act_exponents) >= 5
    assert sorted(tplan.site_paths) == sorted(jplan.site_paths)
