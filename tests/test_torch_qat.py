"""Quantization-aware training's pieces against the reference: every
straight-through estimator's forward bit for bit and backward against
``jax.vjp`` at the reference's own tolerances (1e-6; 1e-5 for the INQ
scale gradient, ``tests/test_trained_quant.py``), ``dfp.fake_quantize``,
the ttq format (partition, codes, dequantize, integer oracle), every
format's ``scales=`` grid, ``fake_quantize_weights``, the trainable
quantization state (``init_quant_state`` / ``advance_inq`` for ttq and
inq, strip, schedule), the MoE auxiliary loss, and ttq / inq artifacts
deploying their learned grids.  The whole-model ``train_loss`` gradients
are in ``tests/test_torch_qat_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import dfp as jdfp
from repro.core import ste as jste
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.quant import advance_inq as jadvance_inq
from repro.quant import formats as jformats
from repro.quant import init_quant_state as jinit_quant_state
from repro.quant.state import QuantState as JQuantState
from repro.quant.state import inq_event_steps as jinq_event_steps
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import dfp as tdfp
from repro_torch.core import ste as tste
from repro_torch.core.quantizer import QTensor, dequantize_scales, quantize_scales
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.quant import formats as tformats
from repro_torch.quant import state as tstate
from repro_torch.quant.plan import QuantPlan
from repro_torch.serving import Request, ServingEngine

ARCH = "qwen3-8b"
FMTS = [("ternary", 2, 16), ("int4", 4, 16), ("int8", 8, 16), ("nf4", 4, 16), ("mx", 8, 32), ("ttq", 2, 16)]


def _rng(seed):
    return np.random.default_rng(seed)


def _w(seed, k=64, n=24, scale=0.1):
    return (_rng(seed).normal(size=(k, n)) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _bits_equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.detach().numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def _vjp(fn_j, fn_t, args, u, argnums):
    """(reference cotangents, port gradients) of sum(fn(*args) * u)."""
    out_j, pull = jax.vjp(jax.jit(fn_j), *[jnp.asarray(a) for a in args])
    want = pull(jnp.asarray(u))
    targs = [_t(a, i in argnums) for i, a in enumerate(args)]
    out_t = fn_t(*targs)
    torch.sum(out_t * _t(u)).backward()
    got = [np.zeros(np.shape(args[i]), np.float32) if targs[i].grad is None else targs[i].grad.numpy()
           for i in argnums]  # no gradient reached it: jax's zeros
    return out_j, out_t, [np.asarray(want[i]) for i in argnums], got


# ---------------------------------------------------------------------------
# dfp and the straight-through estimators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,axis", [(8, None), (4, None), (8, (1,)), (8, (0,))])
def test_fake_quantize_matches_reference(bits, axis):
    x = (_rng(0).normal(size=(6, 40)) * 3).astype(np.float32)
    _bits_equal(tdfp.fake_quantize(_t(x), bits, axis), jdfp.fake_quantize(jnp.asarray(x), bits, axis))


def test_ste_value_of_quantized_gradient_of_x():
    x, q, u = _w(1), _w(2), _w(3)
    out_j, out_t, (gj,), (gt,) = _vjp(jste.ste, lambda a, b: tste.ste(a, b), (x, q), u, (0,))
    _bits_equal(out_t, out_j)
    np.testing.assert_array_equal(gt, gj)


@pytest.mark.parametrize("fmt,bits,group", FMTS)
def test_weights_ste_forward_bits_and_identity_backward(fmt, bits, group):
    w, u = _w(4), _w(5)
    out_j, out_t, (gj,), (gt,) = _vjp(lambda a: jste.weights_ste(a, bits, group, 1, False, fmt=fmt),
                                      lambda a: tste.weights_ste(a, bits, group, 1, False, fmt=fmt), (w,), u, (0,))
    _bits_equal(out_t, out_j)
    np.testing.assert_allclose(gt, gj, atol=1e-6)
    np.testing.assert_array_equal(gt, u)  # straight through


def test_ternary_weights_ste_threads_fmt_and_passes_16_bits():
    """``fmt`` reaches the registry (ttq's threshold codes are not
    Algorithm 1's), as in the reference; 16 bits is the identity."""
    w = _w(6, 32, 8)
    default = tste.ternary_weights_ste(_t(w), 16)
    via = tste.ternary_weights_ste(_t(w), 16, fmt="ttq")
    assert not torch.equal(default, via)
    _bits_equal(via, jste.ternary_weights_ste(jnp.asarray(w), 16, fmt="ttq"))
    x = _t(w)
    assert tste.weights_ste(x, 16, 16) is x


def test_ttq_ste_forward_bits_and_backward():
    g = 8
    w = _w(7, 32, 6)
    wpn = (np.abs(_rng(8).normal(size=(2, 4, 6))) + 0.1).astype(np.float32)
    wpn[1, 0, 0] *= -1  # a scale trained across zero: the gradient goes through the sign
    u = _rng(9).normal(size=(32, 6)).astype(np.float32)
    out_j, out_t, (dwj, dsj), (dwt, dst) = _vjp(lambda a, s: jste.ttq_ste(a, s, g), lambda a, s: tste.ttq_ste(a, s, g),
                                                (w, wpn), u, (0, 1))
    _bits_equal(out_t, out_j)
    np.testing.assert_allclose(dwt, dwj, atol=1e-6)
    np.testing.assert_allclose(dst, dsj, atol=1e-6)


@pytest.mark.parametrize("fmt,bits,group", FMTS[:5])
def test_inq_ste_forward_bits_and_backward(fmt, bits, group):
    w = _w(10, 64, 8)
    qt = jformats.quantize_weights(jnp.asarray(w), bits, group, 1, False, fmt=fmt)
    s = np.asarray(jformats.dequantize_scales(qt.scale_m, qt.scale_e)) * (1.0 if fmt == "mx" else 1.07)
    s[0, 0] *= -1  # the grid folds through |s|
    mask = (np.abs(w) < 0.05).astype(np.float32)
    u = _rng(11).normal(size=w.shape).astype(np.float32)
    out_j, out_t, (dwj, dmj, dsj), (dwt, dmt, dst) = _vjp(
        lambda a, m, sc: jste.inq_ste(a, m, sc, bits, group, fmt=fmt),
        lambda a, m, sc: tste.inq_ste(a, m, sc, bits, group, fmt=fmt), (w, mask, s), u, (0, 1, 2))
    _bits_equal(out_t, out_j)
    np.testing.assert_allclose(dwt, dwj, atol=1e-6)
    np.testing.assert_array_equal(dmt, np.zeros_like(mask))
    # 1e-5 (the reference's, at ternary codes); the int4 / int8 / nf4 / mx codes reach 127, so their
    # code-weighted sums reach the hundreds and round in float32's last places: 1e-6 of their scale there
    np.testing.assert_allclose(dst, dsj, atol=max(1e-5, 1e-6 * float(np.abs(dsj).max())))
    np.testing.assert_array_equal(dwt * mask, np.zeros_like(mask))  # frozen coordinates get nothing


def test_inq_freeze_matches_reference():
    w, live, u = _w(12), _w(13), _w(14)
    mask = (np.abs(w) < 0.08).astype(np.float32)
    out_j, out_t, (gwj, glj), (gwt, glt) = _vjp(jste.inq_freeze, lambda a, m, b: tste.inq_freeze(a, m, b),
                                                (w, mask, live), u, (0, 2))
    _bits_equal(out_t, out_j)
    np.testing.assert_array_equal(gwt, gwj)
    np.testing.assert_array_equal(glt, glj)


@pytest.mark.parametrize("bits,per_row,exponent", [(8, False, None), (8, True, None), (4, False, None), (8, False, -8),
                                                   (16, False, None)])
def test_act_ste_forward_bits_and_clipped_backward(bits, per_row, exponent):
    x = (_rng(15).normal(size=(5, 48)) * 0.6).astype(np.float32)
    u = _rng(16).normal(size=x.shape).astype(np.float32)
    out_j, out_t, (gj,), (gt,) = _vjp(lambda a: jste.act_ste(a, bits, per_row, exponent),
                                      lambda a: tste.act_ste(a, bits, per_row, exponent), (x,), u, (0,))
    _bits_equal(out_t, out_j)
    np.testing.assert_allclose(gt, gj, atol=1e-6)
    if exponent is not None:  # the static range clips: zero gradient outside it
        r = 127 * 2.0**exponent
        assert np.any(np.abs(x) > r) and np.all(gt[np.abs(x) > r] == 0)


# ---------------------------------------------------------------------------
# Formats: ttq, trained grids, fake quantization
# ---------------------------------------------------------------------------
def test_ttq_format_matches_reference():
    w = _w(17, 64, 24)
    np.testing.assert_array_equal(tformats.ttq_partition(_t(w), 16).numpy(),
                                  np.asarray(jformats.ttq_partition(jnp.asarray(w), 16)))
    wpn = (np.abs(_rng(18).normal(size=(2, 4, 24))) * 0.05).astype(np.float32)
    for scales in (None, wpn):
        jq = jformats.quantize_weights(jnp.asarray(w), 2, 16, fmt="ttq",
                                       scales=None if scales is None else jnp.asarray(scales))
        tq = tformats.quantize_weights(_t(w), 2, 16, fmt="ttq", scales=None if scales is None else _t(scales))
        assert tq.fmt == "ttq" and tq.scale_m.shape == (8, 24)
        for f in ("packed", "scale_m", "scale_e"):
            np.testing.assert_array_equal(getattr(tq, f).numpy().view(np.int32 if f == "packed" else getattr(tq, f)
                                                                      .numpy().dtype),
                                          np.asarray(getattr(jq, f)).view(np.int32 if f == "packed" else
                                                                          np.asarray(getattr(jq, f)).dtype))
        _bits_equal(tformats.dequantize_weights(tq), jformats.dequantize_weights(jq))
    from repro.kernels.ref import qmatmul_ref as jref
    from repro_torch.kernels.ref import qmatmul_ref as tref

    xq = _rng(19).integers(-127, 128, size=(5, 64)).astype(np.int8)
    xe = np.full((5, 1), -6, np.int32)
    _bits_equal(tref(_t(xq), _t(xe), tq), jref(jnp.asarray(xq), jnp.asarray(xe), jq))


@pytest.mark.parametrize("fmt,bits,group", FMTS[:5])
def test_quantize_weights_on_a_given_grid_matches_reference(fmt, bits, group):
    w = _w(20, 64, 24)
    fit = jformats.quantize_weights(jnp.asarray(w), bits, group, fmt=fmt)
    s = np.asarray(jformats.dequantize_scales(fit.scale_m, fit.scale_e)) * (1.0 if fmt == "mx" else 1.1)
    jq = jformats.quantize_weights(jnp.asarray(w), bits, group, fmt=fmt, scales=jnp.asarray(s))
    tq = tformats.quantize_weights(_t(w), bits, group, fmt=fmt, scales=_t(s))
    for f in ("scale_m", "scale_e"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(), np.asarray(getattr(jq, f)))
    _bits_equal(tformats.dequantize_weights(tq), jformats.dequantize_weights(jq))


def test_weight_quantization_error_matches_reference():
    w = _w(21, 64, 24)
    for bits in (2, 4, 8):
        got = float(tformats.weight_quantization_error(_t(w), bits, 16))
        want = float(jformats.weight_quantization_error(jnp.asarray(w), bits, 16))
        assert got == pytest.approx(want, rel=1e-6)


def test_ttq_has_no_cuda_kernel_and_serves_on_ref():
    """As the reference: no kernel for ttq (its pallas backend raises), and
    both entry points refuse ``cuda`` before anything launches, fused or
    not; the ``ref`` backend runs the integer oracle."""
    from repro_torch.quant.backends import qdense, qmatmul

    qt = tformats.quantize_weights(_t(_w(22, 32, 8)), 2, 16, fmt="ttq")
    assert tformats.get_format("ttq").kernel is None and tformats.get_format("ttq").fused_kernel is None
    x = _t(_rng(23).normal(size=(3, 32)).astype(np.float32))
    for call in (lambda: qdense(x, qt, backend="cuda"), lambda: qdense(x, qt, backend="cuda", fused=False),
                 lambda: qmatmul(x, qt, backend="cuda")):
        with pytest.raises(ValueError, match="no CUDA kernel"):
            call()
    assert qdense(x, qt, backend="ref").shape == (3, 8)


# ---------------------------------------------------------------------------
# Trainable quantization state
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qat_models():
    """{method: (reference float params, reference api compiled in qat mode)}
    on qwen3-8b smoke at group 16 (ttq: the ttq format)."""
    out = {}
    params = jbuild(jconfigs.get_smoke(ARCH)).init(jax.random.PRNGKey(0))
    for method in ("ttq", "inq"):
        qc = JQuantConfig(w_bits=2, group_size=16, mode="qat", fmt="ttq" if method == "ttq" else None)
        api = jbuild(jconfigs.get_smoke(ARCH, qc)).compiled(params)
        out[method] = params, api
    return out


def _port_plan(plan):
    return QuantPlan.from_json(plan.to_json())


def _walk_pairs(t_tree, j_tree, path=""):
    """(path, port leaf, reference leaf) through the port's lists and the
    reference's stacked layers."""
    if isinstance(t_tree, dict):
        for k, v in t_tree.items():
            yield from _walk_pairs(v, j_tree[k], f"{path}/{k}")
    elif isinstance(t_tree, list):
        for i, v in enumerate(t_tree):
            yield from _walk_pairs(v, jax.tree.map(lambda a, i=i: a[i], j_tree), f"{path}/{i}")
    else:
        yield path, t_tree, j_tree


def _state_tree():
    """A small stacked tree as the reference lays one out: two layers of an
    attention site, an MoE expert site (L, E, K, N) and a head."""
    rng = _rng(30)
    f = lambda *shape: (rng.normal(size=shape) * 0.1).astype(np.float32)  # noqa: E731
    return {"blocks": {"attn": {"wq": {"w": f(2, 64, 32)}}, "moe": {"experts": {"gate": {"w": f(2, 3, 64, 32)}}}},
            "lm_head": {"w": f(64, 48)}}


@pytest.mark.parametrize("method", ["ttq", "inq"])
def test_init_quant_state_and_advance_inq_match_reference(method):
    """Every state leaf bit for bit, per layer and per expert (the
    reference vmaps over both stacked axes), after init and, for inq, an
    event at 0.5."""
    from repro.quant.plan import QuantCtx as JQuantCtx
    from repro.quant.plan import compile_policy as jcompile

    qc = JQuantConfig(w_bits=2, group_size=16, mode="qat", fmt="ttq" if method == "ttq" else None)
    jtree = jax.tree.map(jnp.asarray, _state_tree())
    plan = jcompile(JQuantCtx.from_config(qc).policy, jtree, mode="qat")
    jqs = jinit_quant_state({}, plan, method, total_steps=8)[1]
    jparams = jax.jit(lambda t: jinit_quant_state(t, plan, method, total_steps=8)[0])(jtree)
    tparams, tqs = tstate.init_quant_state(params_from_jax(_state_tree(), device="cpu"), _port_plan(plan), method,
                                           total_steps=8)
    assert tqs.to_meta() == jqs.to_meta() and tstate.QuantState.from_meta(jqs.to_meta()) == tqs
    if method == "inq":
        jparams = jax.jit(lambda t: jadvance_inq(t, plan, 0.5))(jparams)
        tparams = tstate.advance_inq(tparams, _port_plan(plan), 0.5)
    names = {p.rsplit("/", 1)[-1] for p, _, _ in _walk_pairs(tparams, jparams)}
    assert set(tstate.STATE_KEYS) & names == ({"ttq_scales"} if method == "ttq" else {"inq_mask", "inq_scales"})
    for path, got, want in _walk_pairs(tparams, jparams):
        _bits_equal(got, want)
    assert tstate.has_quant_state(tparams) and not tstate.has_quant_state(tstate.strip_quant_state(tparams))
    if method == "inq":
        frozen = tparams["blocks"][0]["moe"]["experts"]["gate"]["inq_mask"]
        assert frozen.shape == (3, 64, 32) and 0.4 < float(frozen.mean()) <= 0.6


def test_inq_event_steps_and_unknown_method():
    for steps, fr in ((120, (0.5, 0.75, 0.875, 1.0)), (8, (0.5, 1.0)), (0, (1.0,))):
        assert tstate.inq_event_steps(steps, fr) == jinq_event_steps(steps, fr)
    with pytest.raises(ValueError, match="unknown stateful quant method"):
        tstate.init_quant_state({}, QuantPlan(), "pact")
    assert JQuantState("inq").to_meta() == tstate.QuantState("inq").to_meta()


def _state_sites(tree, qtree, key, path=""):
    """(path, float site dict, quantized site dict) of every site carrying
    ``key``, walking the float tree and the quantized one together."""
    if isinstance(tree, list):
        for v, q in zip(tree, qtree):
            yield from _state_sites(v, q, key, path)
    elif isinstance(tree, dict):
        if key in tree:
            yield path, tree, qtree
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                yield from _state_sites(v, qtree[k], key, f"{path}/{k}" if path else k)


@pytest.mark.parametrize("method", ["ttq", "inq"])
def test_learned_grid_artifact_deploys_trained_scales(qat_models, method, tmp_path):
    """After the scales drift off their init, PTQ deploys the learned grid,
    never a re-fit: the port's QTensors equal the reference's bit for bit,
    their dequantized weights equal the training forward (ttq_ste /
    inq_ste), and an engine cold-started from the port's artifact (the
    ``ref`` backend: ttq has no kernel) serves the in-memory tree's tokens
    (the reference's ``test_ttq_artifact_deploys_learned_scales_never_refit``
    and ``test_inq_artifact_matches_training_forward``)."""
    params, japi = qat_models[method]
    key = "ttq_scales" if method == "ttq" else "inq_scales"
    from repro.quant.api import quantize_params as jquantize_params
    from repro.quant.plan import compile_policy as jcompile

    jparams = jax.jit(lambda p: jinit_quant_state(p, japi.ctx.plan, method, total_steps=4)[0])(params)
    if method == "inq":
        jparams = jax.jit(lambda p: jadvance_inq(p, japi.ctx.plan, 0.5))(jparams)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, v: v * (1.1 if method == "ttq" else 1.05) if p[-1].key == key else v, jparams)
    jplan = jcompile(japi.ctx.policy, jparams, mode="ptq", backend=japi.ctx.backend)
    jq = jax.jit(lambda p: jquantize_params(p, jplan))(jparams)
    tparams = params_from_jax(jparams, device="cpu")
    tcfg = tconfigs.get_smoke(ARCH, TQuantConfig(w_bits=2, group_size=16, mode="qat", backend="ref",
                                                 fmt="ttq" if method == "ttq" else None))
    tapi = tbuild(tcfg, device="cpu").compiled(tparams)
    tq, tplan, qapi = tquantize_and_plan(tapi, tparams)
    assert dataclasses.replace(tplan, backend=jplan.backend).to_json() == jplan.to_json()
    from test_torch_artifact import _assert_bit_exact

    _assert_bit_exact(tq, params_from_jax(jq, device="cpu"))
    sites = list(_state_sites(tparams, tq, key))
    assert sites
    for path, node, qnode in sites:
        prec, qt = tplan.resolve(path), qnode["w"]
        assert isinstance(qt, QTensor), path
        w = node["w"].to(torch.float32)
        if method == "ttq":
            fwd = tste.ttq_ste(w, node["ttq_scales"], prec.group_size)
            sm, _ = quantize_scales(torch.abs(node["ttq_scales"]).reshape(-1, w.shape[1]))
            assert torch.equal(qt.scale_m, sm), path  # the trained magnitudes, not a re-fit
        else:
            fwd = tste.inq_ste(w, torch.zeros_like(w), node["inq_scales"], prec.w_bits, prec.group_size)
        _bits_equal(tformats.dequantize_weights(qt), fwd.detach().numpy())
    from repro_torch.models import save_servable

    save_servable(str(tmp_path), qapi, tq, tplan)

    def tokens(eng):
        eng.submit(Request(uid=0, prompt=[5, 9, 2], max_new_tokens=4))
        return eng.run()[0].output

    warm = tokens(ServingEngine(qapi, tq, n_slots=2, max_len=16))
    cold = tokens(ServingEngine.from_artifact(str(tmp_path), device="cpu", n_slots=2, max_len=16))
    assert warm == cold and len(warm) == 4


def test_aux_load_balance_loss_matches_reference():
    logits = _rng(24).normal(size=(12, 8)).astype(np.float32)
    ids = _rng(25).integers(0, 8, size=(12, 2)).astype(np.int32)
    got = tmoe.aux_load_balance_loss(_t(logits), _t(ids).to(torch.int64), 8)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(ids), 8)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_dequantize_scales_round_trip():
    """Storing the f32 dequantized table is enough: quantize_scales
    round-trips its own dequantization (what deployment of a learned grid
    relies on)."""
    a = torch.from_numpy(np.abs(_w(26, 8, 16)))
    sm, se = quantize_scales(a)
    sq = dequantize_scales(sm, se)
    sm2, se2 = quantize_scales(sq)
    assert torch.equal(sm, sm2) and torch.equal(se, se2)


@pytest.mark.parametrize("chunk_tokens", [8192, 8], ids=["one-chunk", "three-chunks"])
def test_lm_losses_match_reference(chunk_tokens):
    """``lm_loss`` and ``lm_head_loss`` (the vocabulary's padding masked
    out) and their gradients; at 8 tokens a chunk the 24 tokens run as
    three recomputed chunks (``torch.utils.checkpoint``; the reference's
    ``jax.checkpoint`` scan), 1e-6."""
    from repro.models import layers as jlayers
    from repro.quant.plan import QuantCtx as JQuantCtx
    from repro_torch.models import layers as tlayers
    from repro_torch.quant.plan import QuantCtx

    rng = _rng(27)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 40)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 37, size=(2, 12)).astype(np.int32)
    want, (gxj, gwj) = jax.value_and_grad(
        lambda a, b: jlayers.lm_head_loss({"w": b}, a, jnp.asarray(labels), 37, "lm_head", JQuantCtx(),
                                          chunk_tokens=chunk_tokens), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    got = tlayers.lm_head_loss({"w": tw}, tx, _t(labels), 37, "lm_head", QuantCtx(), chunk_tokens=chunk_tokens)
    got.backward()
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gxj), atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gwj), atol=1e-6)
    logits = x @ w
    assert float(tlayers.lm_loss(_t(logits), _t(labels), 37)) == pytest.approx(
        float(jlayers.lm_loss(jnp.asarray(logits), jnp.asarray(labels), 37)), abs=1e-6)
