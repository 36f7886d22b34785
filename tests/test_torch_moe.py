"""Port vs reference on the MoE family's smoke configs, the layer: grok-1-314b
(4 experts, top-2) and arctic-480b (8 experts, top-2, a dense residual
MLP).  ``tests/test_torch_moe_quant.py`` holds the quantized expert sites
and their kernels' plain versions, ``tests/test_torch_moe_serving.py`` and
``tests/test_torch_moe_staged.py`` the model served.

The same seeded inputs go through the JAX package and the port: the
configs; the dispatch -- capacity, top-k ids and gates, ``dest``, the
dropped set -- at capacity factors 1.0 (drops) and 8.0, tied router logits
included; the float MoE layer with and without drops, the ternary-PTQ
layer with drops, and the float forward.
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
from repro.models import moe as jmoe
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.quant.plan import QuantCtx as JQuantCtx
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.quant import QuantCtx, QuantPlan

ARCHS = ["grok-1-314b", "arctic-480b"]
FP_ATOL = 1e-5  # float32 logits, summed in other orders (tests/test_torch_model.py)
PTQ_ATOL = 5e-3  # PTQ outputs: the kernels' plain versions against the reference's ref oracle (the families' decode)


def _jax_params(arch, seed=0):
    return jbuild(jconfigs.get_smoke(arch)).init(jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert tconfigs.config_to_dict(tconfigs.get_config(arch)) == jconfig_to_dict(jconfigs.get_config(arch))
    assert tconfigs.config_to_dict(tconfigs.get_smoke(arch)) == jconfig_to_dict(jconfigs.get_smoke(arch))
    assert arch in tconfigs.ARCH_IDS


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------
def _jax_route(logits, k, c):
    """The reference's dispatch arithmetic (``repro/models/moe.py``,
    ``_dispatch_chunk``) on router logits: (dest, sorted_src, gate)."""
    tc, e = logits.shape
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    top_vals, top_ids = jax.lax.top_k(probs, k)
    top_vals = top_vals / jnp.sum(top_vals, axis=-1, keepdims=True)
    flat_ids = top_ids.reshape(-1)
    flat_src = jnp.arange(tc * k, dtype=jnp.int32) // k
    order = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[order]
    rank = jnp.arange(tc * k, dtype=jnp.int32) - jnp.searchsorted(sorted_ids, sorted_ids, side="left").astype(jnp.int32)
    dest = jnp.where(rank < c, sorted_ids * c + rank, e * c)
    return np.asarray(dest), np.asarray(flat_src[order]), np.asarray(top_vals.reshape(-1)[order])


@pytest.mark.parametrize("n_tokens", [1, 4, 7, 64, 256, 1000])
@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
def test_capacity_matches_reference(n_tokens, factor):
    for e in (4, 8, 128):
        assert tmoe.capacity(n_tokens, 2, e, factor) == jmoe.capacity(n_tokens, 2, e, factor)


@pytest.mark.parametrize("factor", [1.0, 8.0])
@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_route_matches_reference(factor, tied):
    """ids, gates, dest and the dropped set of 40 tokens over 8 experts;
    tied logits (a few integer levels, equal within a row) must pick the
    lower expert index, as ``lax.top_k`` does."""
    rng = np.random.default_rng(3)
    logits = rng.integers(0, 3, size=(40, 8)).astype(np.float32) if tied else rng.normal(size=(40, 8)).astype(
        np.float32)
    logits[:, :2] += 1.5  # experts 0 and 1 draw more tokens than a capacity of 16 at factor 1.0
    c = tmoe.capacity(40, 2, 8, factor)
    want = _jax_route(logits, 2, c)
    got = [t.numpy() for t in tmoe.route(torch.from_numpy(logits), 2, c)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)  # the softmax's exp: a few ulps (ROADMAP Queue C7)
    dropped = want[0] == 8 * c
    assert dropped.any() == (factor == 1.0)  # drops happen only at the tight factor
    vals, ids = tmoe.top_k(torch.from_numpy(logits), 2)
    jvals, jids = jax.lax.top_k(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def _layer_case(arch, factor, quant=None):
    """(reference cfg, layer-0 MoE params, port cfg, port params, x, the
    port's dropped replicas) for 2 x 64 tokens; ``quant``: a QuantConfig
    dict for the PTQ layer (the reference's ternary qparams)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch, None if quant is None else JQuantConfig(**quant)),
                               capacity_factor=factor)
    params = _jax_params(arch)
    plan = None
    if quant is not None:
        params, plan, _ = jquantize_and_plan(jbuild(jcfg), params)
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["moe"])
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), capacity_factor=factor)
    tp = params_from_jax(params, device="cpu")["blocks"][0]["moe"]
    x = np.random.default_rng(5).normal(size=(2, 64, jcfg.d_model)).astype(np.float32)
    return jcfg, p, plan, tcfg, tp, x


def _dropped(tp, x, cfg, ctx):
    from repro_torch.models import layers

    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    c = tmoe.capacity(xt.shape[0], cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    dest, _, _ = tmoe.route(layers.dense(tp["router"], xt, "blocks/moe/router", ctx), cfg.top_k, c)
    return int((dest == cfg.n_experts * c).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_moe_layer_fp_matches_reference(arch, factor):
    """One float MoE layer (router, dispatch, experts, combine, arctic's
    residual MLP) on 2 x 64 tokens: replicas drop at factor 1.0, none at
    8.0."""
    jcfg, p, _, tcfg, tp, x = _layer_case(arch, factor)
    want = np.asarray(jmoe.moe_layer(p, jnp.asarray(x), "blocks/moe", jcfg, JQuantCtx()))
    got = tmoe.moe_layer(tp, torch.from_numpy(x), "blocks/moe", tcfg, QuantCtx())
    np.testing.assert_allclose(got.numpy(), want, atol=FP_ATOL)
    assert (_dropped(tp, x, tcfg, QuantCtx()) > 0) == (factor == 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_ptq_with_drops_matches_reference(arch):
    """The ternary-PTQ layer at factor 1.0 (replicas drop): the int8 router
    site and the expert qmatmuls (the kernels' plain versions) against the
    reference's ref oracle on the same qparams and plan -- the same ids,
    dest and drops, outputs within the decode tolerance."""
    q = dict(w_bits=2, group_size=16, mode="ptq", backend="ref")
    jcfg, p, plan, tcfg, tp, x = _layer_case(arch, 1.0, q)
    want = np.asarray(jmoe.moe_layer(p, jnp.asarray(x), "blocks/moe", jcfg, JQuantCtx.for_plan(plan)))
    ctx = QuantCtx.for_plan(dataclasses.replace(QuantPlan.from_json(plan.to_json()), backend="cuda"))
    got = tmoe.moe_layer(tp, torch.from_numpy(x), "blocks/moe", tcfg, ctx)
    np.testing.assert_allclose(got.numpy(), want, atol=PTQ_ATOL)
    assert _dropped(tp, x, tcfg, ctx) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_forward_logits_match(arch):
    params = _jax_params(arch)
    jcfg = jconfigs.get_smoke(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 20)).astype(np.int32)
    want = np.asarray(jbuild(jcfg).forward(params, {"tokens": jnp.asarray(tokens)}))
    got = tbuild(tconfigs.get_smoke(arch), device="cpu").forward(params_from_jax(params, device="cpu"),
                                                               {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, atol=FP_ATOL)
