"""Port vs reference on the MoE family's quantized expert sites (grok-1-314b
smoke: 4 experts, top-2): the expert-stacked QTensors of all five weight
formats bit for bit (each expert quantized on its own, as the reference's
vmap does), the plain expert-batched ``packed_qmm`` against the per-expert
loop, and the expert ``qmatmul`` against the reference's vmapped one."""
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
from repro.quant.backends import qmatmul as jqmatmul
from repro.quant.formats import quantize_weights as jquantize_weights
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels.fused_qmm import cluster_sums
from repro_torch.kernels.packed_qmm import packed_qmm
from repro_torch.models import build_model as tbuild
from repro_torch.models import quantize_and_plan as tquantize_and_plan
from repro_torch.quant.backends import qmatmul
from repro_torch.quant.formats import quantize_weights
from test_torch_artifact import _assert_bit_exact

FORMATS = {
    "ternary": dict(w_bits=2), "int4": dict(w_bits=4), "int8": dict(w_bits=8),
    "nf4": dict(w_bits=4, fmt="nf4"), "mx": dict(w_bits=8, fmt="mx"),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_expert_qtensors_equal_reference_vmap(fmt):
    """Every site of the grok smoke model, the (E, ...) expert sites
    included, quantized by the port from the same float weights: bit for
    bit the reference's vmapped ``quantize_params`` (each expert its own
    shared exponent), and the same plan sites."""
    params = jbuild(jconfigs.get_smoke("grok-1-314b")).init(jax.random.PRNGKey(0))
    q = dict(group_size=16, mode="ptq", backend="ref", **FORMATS[fmt])
    jq, jplan, _ = jquantize_and_plan(jbuild(jconfigs.get_smoke("grok-1-314b", JQuantConfig(**q))), params)
    tq, tplan, _ = tquantize_and_plan(tbuild(tconfigs.get_smoke("grok-1-314b", TQuantConfig(**q)), device="cpu"),
                                      params_from_jax(params, device="cpu"))
    _assert_bit_exact(tq, params_from_jax(jq, device="cpu"))
    gate = tq["blocks"][0]["moe"]["experts"]["gate"]["w"]
    assert gate.experts == 4 and gate.scale_e.shape == (4,) and gate.shape == (64, 128)
    assert gate.fmt == (FORMATS[fmt].get("fmt") or {2: "ternary", 4: "int4", 8: "int8"}[FORMATS[fmt]["w_bits"]])
    assert tq["blocks"][0]["moe"]["router"]["w"].fmt == "int8"  # the policy pins the router
    assert {p: dataclasses.asdict(s) for p, s in tplan.sites()} == {p: dataclasses.asdict(s) for p, s in jplan.sites()}


# ---------------------------------------------------------------------------
# The expert-batched kernels' plain versions.
# ---------------------------------------------------------------------------
def _expert_site(fmt, e=4, k=128, n=64, seed=9):
    w = np.random.default_rng(seed).normal(size=(e, k, n)).astype(np.float32) * k**-0.5
    kw = dict(bits=FORMATS[fmt]["w_bits"], group_size=16, fmt=FORMATS[fmt].get("fmt"))
    return w, quantize_weights(torch.from_numpy(w), **kw)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_plain_expert_packed_qmm_is_the_per_expert_loop(fmt):
    """The expert-batched packed_qmm's plain version (what the CPU runs)
    equals ``cluster_sums`` expert by expert, at decode and prefill rows
    and with all-zero capacity rows."""
    from repro_torch.quant.formats import format_of

    _, qt = _expert_site(fmt)
    decode = {"ternary": "ternary", "int4": "int4", "int8": "int8", "nf4": "nf4", "mx": "int8"}[fmt]
    for c in (8, 24):
        xq = torch.from_numpy(np.random.default_rng(c).integers(-127, 128, size=(4, c, 128)).astype(np.int8))
        xq[:, c // 2:] = 0  # the capacity buffer's empty rows
        got = format_of(qt).kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
        want = torch.stack([cluster_sums(xq[i], qt.packed[i], qt.scale_m[i], decode=decode, group=qt.group_size)
                            for i in range(4)])
        assert got.shape == (4, c, 64) and torch.equal(got, want)
        assert torch.equal(packed_qmm(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size), want)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("static", [None, -5], ids=["dynamic", "static"])
def test_expert_qmatmul_matches_reference_vmap(fmt, static):
    """The expert qmatmul (one quantize over every E * C row, one packed
    call, per-expert exponents; and the ref backend's per-expert loop)
    against the reference's ``jax.vmap`` of ``qmatmul`` on the same (E, K,
    N) weights, with zero capacity rows."""
    w, qt = _expert_site(fmt)
    x = np.random.default_rng(11).normal(size=(4, 8, 128)).astype(np.float32)
    x[:, 5:] = 0.0
    kw = dict(bits=FORMATS[fmt]["w_bits"], group_size=16, fmt=FORMATS[fmt].get("fmt"))
    jqt = jax.vmap(lambda m: jquantize_weights(m, **kw))(jnp.asarray(w))
    want = np.asarray(jax.vmap(lambda qe, xe: jqmatmul(xe, qe, backend="ref", act_exponent=static))(
        jqt, jnp.asarray(x)))
    for backend in ("cuda", "ref"):
        got = qmatmul(torch.from_numpy(x), qt, backend=backend, act_exponent=static)
        assert got.shape == (4, 8, 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)  # cluster sums in other float orders


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("block_k", [512, 64])
def test_plain_packed_qmm_of_zero_rows_is_plus_zero(fmt, block_k):
    """An expert whose capacity rows are all zero gets +0 from the plain
    version (int32 bits 0, negative scale mantissas included: 0 x sm may
    be -0, but every tile sum starts at +0 and +0 + -0 = +0), in every
    decode: the expert GEMV on the card skips such an expert and writes +0,
    bit for bit."""
    _, qt = _expert_site(fmt)
    decode = {"ternary": "ternary", "int4": "int4", "int8": "int8", "nf4": "nf4", "mx": "int8"}[fmt]
    scale_m = qt.scale_m.clone()
    scale_m[..., ::2] = -scale_m[..., ::2]  # the kernels take any int8 scale mantissa
    xq = torch.from_numpy(np.random.default_rng(5).integers(-127, 128, size=(4, 8, 128)).astype(np.int8))
    xq[1] = 0
    xq[3] = 0
    xq[0, 3:] = 0  # a routed expert's empty capacity rows
    got = packed_qmm(xq, qt.packed, scale_m, decode=decode, group=qt.group_size, block_k=block_k)
    assert not got[[1, 3]].view(torch.int32).any()
    assert not got[0, 3:].view(torch.int32).any()
    assert got[[0, 2]].abs().sum() > 0
