"""Shared by ``tests/test_torch_qat_models.py`` and
``tests/test_torch_qat_families.py``: ``train_loss`` and its gradient under
QAT in both packages on one smoke config, from the reference's parameters
and a numpy-seeded batch."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.utils.checkpoint

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import ste as jste
from repro.models import build_model as jbuild
from repro.models import vlm as jvlm
from repro.quant.plan import QuantCtx as JQuantCtx
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core import dfp
from repro_torch.core import ste as tste
from repro_torch.models import build_model as tbuild
from repro_torch.quant.plan import QuantCtx

# falcon-mamba's smoke dt_proj has K = dt_rank = 4: the reference's QAT packs
# ternary and int4 codes 16 / 8 to a word and raises there (ROADMAP Queue C15),
# so that config trains int8 weights at group 4
QAT = {"falcon-mamba-7b": dict(w_bits=8, group_size=4)}
QAT_DEFAULT = dict(w_bits=2, group_size=16)
B, S = 2, 16
# where the port's and the reference's 8-bit activation quantizers first
# round apart, by one mantissa step (``check``): qwen3-8b at layer 1's ln1
# output (an RMSNorm), which wq, wk and wv all read; whisper-base at the
# output of decoder layer 0's self-attention, which its wo reads
FIRST_FLIP = {"qwen3-8b": "blocks/attn/wq", "whisper-base": "dec/self_attn/wo"}


def batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        nv = cfg.n_frontend_tokens
        out["vision_embeds"] = (rng.normal(size=(B, nv, cfg.d_model)) * 0.1).astype(np.float32)
        out["positions"] = np.asarray(jvlm.build_mrope_positions(B, nv, S))
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _reference(arch):
    qc = dict(QAT.get(arch, QAT_DEFAULT), mode="qat")
    jcfg = jconfigs.get_smoke(arch, JQuantConfig(**qc))
    japi = jbuild(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    japi = japi.with_ctx(JQuantCtx(mode="qat", policy=japi.ctx.policy))
    data = batch(jcfg)
    return japi, params, data, {k: jnp.asarray(v) for k, v in data.items()}


@contextlib.contextmanager
def _recorded(acts):
    """The reference's ``act_ste`` appending each fake-quantized activation
    it computes to ``acts``, from inside the jitted run."""
    orig = jste.act_ste

    def record(x, bits=8, *a, **k):
        y = orig(x, bits, *a, **k)
        if bits < 16:
            jax.debug.callback(lambda v: acts.append(torch.from_numpy(np.array(v, np.float32))), y)
        return y

    jste.act_ste = record
    try:
        yield
    finally:
        jste.act_ste = orig


@contextlib.contextmanager
def _forced(acts, flips):
    """The port's ``act_ste`` with the forward value of the reference's and
    its own backward; appends (site, number of mantissas that differ,
    largest difference in quantizer steps) to ``flips`` for every site where
    the port's own quantizer rounded otherwise.  The reference's value is
    the one of ``acts`` of the same shape nearest the port's own (XLA hoists
    the loop-invariant cross K / V out of the scan, so the order differs),
    and the lm_head chunk runs without its recompute."""
    orig_act, orig_resolve, orig_ckpt = tste.act_ste, QuantCtx.resolve, torch.utils.checkpoint.checkpoint
    site = [None]

    def resolve(self, path):
        site[0] = path
        return orig_resolve(self, path)

    def act(x, bits=8, *a, **k):
        y = orig_act(x, bits, *a, **k)
        if bits >= 16:
            return y
        ref = min((r for r in acts if r.shape == y.shape), key=lambda r: int((r != y.detach()).sum()))
        step = dfp.exp2i(dfp.choose_exponent(torch.max(torch.abs(x.detach())), bits))
        d = ((y.detach() - ref) / step).abs()
        if bool((d > 0).any()):
            flips.append((site[0], int((d > 0).sum()), float(d.max())))
        out = y + (ref - y).detach()
        assert torch.equal(out.detach(), ref), site[0]
        return out

    tste.act_ste, QuantCtx.resolve = act, resolve
    torch.utils.checkpoint.checkpoint = lambda fn, *args, **kw: fn(*args)
    try:
        yield
    finally:
        tste.act_ste, QuantCtx.resolve, torch.utils.checkpoint.checkpoint = orig_act, orig_resolve, orig_ckpt


def value_and_grad(arch, force=False):
    """(reference loss, port loss, [(path, port grad, reference grad)],
    flips) of ``train_loss`` under ``mode="qat"`` with the paper's policy.
    With ``force``, every activation the port fake-quantizes takes the
    reference's value (``_forced``) and ``flips`` lists where the two
    quantizers rounded apart."""
    japi, params, data, jdata = _reference(arch)
    acts = []
    with _recorded(acts) if force else contextlib.nullcontext():
        jloss, jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(japi.train_loss))(params, jdata))
    qc = dict(QAT.get(arch, QAT_DEFAULT), mode="qat")
    tapi = tbuild(tconfigs.config_from_dict(tconfigs.config_to_dict(tconfigs.get_smoke(arch))), device="cpu")
    tctx = QuantCtx.from_config(tconfigs.get_smoke(arch, tconfigs.QuantConfig(**qc)).quant)
    tapi = tapi.with_ctx(QuantCtx(mode="qat", policy=tctx.policy))
    tparams = params_from_jax(params, device="cpu")
    for _, leaf in _leaves(tparams):
        if leaf.is_floating_point():
            leaf.requires_grad_(True)
    flips = []
    with _forced(acts, flips) if force else contextlib.nullcontext():
        tloss = tapi.train_loss(tparams, {k: torch.from_numpy(v) for k, v in data.items()})
        tloss.backward()
    want = dict(_leaves(params_from_jax(jgrads, device="cpu")))
    grads = [(path, leaf.grad if leaf.grad is not None else torch.zeros_like(leaf), want[path])
             for path, leaf in _leaves(tparams) if leaf.is_floating_point()]
    return float(jloss), float(tloss.detach()), grads, flips


def check(arch, flips: bool) -> None:
    """The paper's QAT (ternary weights, 8-bit activations) against the
    reference: the loss within 1e-5 and every gradient leaf within 1e-4 of
    its own largest entry (float32 sums in other orders, an Algorithm-1
    backward that is the identity).

    With ``flips``, ``FIRST_FLIP`` names the site where a last-ulp
    difference of the activation (a reduction in XLA's order against
    torch's: an RMSNorm's, ROADMAP Queue C2 / C5, or an attention output's)
    lands on a rounding boundary of the 8-bit DFP quantizer.  One mantissa
    moves by one step there, and without a correction the difference
    reaches every leaf through the loss.  So in those models the port's
    activations take the reference's quantized values (``_forced``) and are
    held to the same bounds; the test also holds where the two quantizers
    rounded apart: first at that site, each time by one step, at no more
    than four elements of a site."""
    jloss, tloss, grads, rounded_apart = value_and_grad(arch, force=flips)
    assert np.isfinite(tloss) and any(float(g.abs().sum()) > 0 for p, g, _ in grads if p.endswith("/w"))
    if flips:
        assert rounded_apart and rounded_apart[0][0] == FIRST_FLIP[arch], rounded_apart
        assert all(n <= 4 and steps == 1.0 for _, n, steps in rounded_apart), rounded_apart
    assert abs(tloss - jloss) <= 1e-5, (tloss, jloss)
    for path, g, w in grads:
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * max(float(w.abs().max()), 1e-12),
                                   err_msg=f"{arch} {path}")


if __name__ == "__main__":  # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_qat_parity.py qwen3-8b whisper-base
    import sys

    for name in sys.argv[1:]:
        for forced in (False, True):
            jl, tl, gs, apart = value_and_grad(name, force=forced)
            rel = [(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12), p) for p, g, w in gs]
            l2 = (sum(float(((g - w) ** 2).sum()) for _, g, w in gs) / sum(float((w ** 2).sum()) for _, _, w in gs))
            print(f"{name} forced={forced}: loss gap {abs(tl - jl):.3e}; worst leaf {max(rel)[1]} at "
                  f"{max(rel)[0]:.3e} of its largest entry; {sum(r > 1e-4 for r, _ in rel)} of {len(rel)} leaves "
                  f"over 1e-4; whole-tree relative L2 {l2 ** 0.5:.3e}; rounded apart {apart}")
