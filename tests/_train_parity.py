"""Shared by ``tests/test_torch_trainer.py`` and
``tests/test_torch_train_resume.py``: one smoke config's QAT api in both
packages from the reference's parameters, numpy batches both see, the
per-step loss comparison of the two Trainers, and tree flatteners."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import build_model as jbuild
from repro.models import vlm as jvlm
from repro.quant import init_quant_state as jinit_quant_state
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import Trainer as JTrainer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.quant.state import init_quant_state
from repro_torch.training import OptConfig, TrainConfig, Trainer
from repro_torch.training import checkpoint as ck
from repro_torch.tree import tree_map

B, S = 2, 16
QAT = dict(w_bits=2, group_size=16, mode="qat")


def np_batch(cfg, step):
    """The batch of ``step``, drawn with numpy so both packages see it."""
    rng = np.random.default_rng(1000 + step)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        nv = cfg.n_frontend_tokens
        out["vision_embeds"] = (rng.normal(size=(B, nv, cfg.d_model)) * 0.1).astype(np.float32)
        out["positions"] = np.asarray(jvlm.build_mrope_positions(B, nv, S))
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def pair(arch, method=None, fractions=(0.5, 1.0), steps=8, **qc):
    """(reference api, params, quant state; port api) under QAT of one smoke
    config, the reference's params and plan on both sides."""
    q = dict(QAT, **qc)
    if method == "ttq":
        q["fmt"] = "ttq"
    jcfg = jconfigs.get_smoke(arch, JQuantConfig(**q))
    japi = jbuild(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    japi = japi.compiled(params)
    qs = None
    if method is not None:
        params, qs = jinit_quant_state(params, japi.ctx.plan, method, fractions=fractions, total_steps=steps)
    tcfg = tconfigs.get_smoke(arch, tconfigs.QuantConfig(**q))
    tapi = tbuild(tcfg, device="cpu").compiled(params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    assert q["mode"] == "fp" or _plan(tapi.ctx.plan) == _plan(japi.ctx.plan)
    return japi, params, qs, tapi


def _plan(plan):
    """A plan's JSON with its sites as a dict (the order follows the tree walked)."""
    d = json.loads(plan.to_json())
    return dict(d, sites=dict(map(tuple, d["sites"])))


def clone(tree):
    """A copy of every tensor: a Trainer updates the tree it is given in place."""
    return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


# -- losses per step against the reference's Trainer ---------------------------------------------------------
# Per step the port's loss is held within ``rtol`` of the reference's.  Step 0 sees the same params and batch:
# the gap is float32 sums in other orders (within 1e-5, as tests/_qat_parity.py holds it).  Later steps add the
# optimizer (its DFP-8 moments equal bit for bit, tests/test_torch_optimizer.py).  qwen3-8b under QAT and
# whisper-base in full precision agree within 1e-6 over six steps, so 1e-5 holds them.  whisper-base under QAT:
# at step 0 one activation of decoder layer 0's self-attention output lands on a rounding boundary of the 8-bit
# DFP quantizer and the two quantizers round one mantissa apart (ROADMAP Queue C2, tests/_qat_parity.py's
# FIRST_FLIP).  The gradients then differ by a few 1e-4 of their scale; AdamW's first steps divide each entry by
# its own magnitude, so near-zero entries move by up to lr = 1e-3 apart, and the losses drift: 6.6e-4 relative
# at step 1, 3.9e-4 at step 2 (2.2e-3 by step 4).  2e-3 over STEPS = 3 holds that drift with a 3x margin and is
# still 100x below a step's change of the loss.
STEPS = 3


def parity(arch, mode, rtol):
    japi, params, _, tapi = pair(arch, mode=mode)
    jt = JTrainer(japi.train_loss, params, JTrainConfig(opt=JOptConfig(lr=1e-3, warmup_steps=0, state_bits=8)))
    jh = jt.train(lambda i: {k: jnp.asarray(v) for k, v in np_batch(japi.cfg, i).items()}, STEPS)
    # a clone: on the CPU the converted leaves can share the reference's buffers, and the Trainer writes in place
    tt = Trainer(tapi.train_loss, clone(params_from_jax(jax.tree.map(np.asarray, params), device="cpu")),
                 TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0, state_bits=8)))
    th = tt.train(lambda i: to_torch(np_batch(tapi.cfg, i)), STEPS)
    assert th["step"] == jh["step"] == list(range(STEPS))
    assert abs(th["loss"][0] - jh["loss"][0]) <= 1e-5
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=rtol)
    assert len(set(th["loss"])) == STEPS  # the steps trained


def flat_reference(tree):
    """path -> numpy array of a reference tree (stacked layers, None moments
    dropped), under the checkpoint's path names."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in flat}


def flat_port(tree):
    """path -> numpy array of a port tree, per-layer lists stacked."""
    return {path: ck._to_numpy(ck._stack(leaf)) for path, leaf in ck._flat_with_paths(tree)}


def tiny(method=None, steps=8, fractions=(0.5, 1.0), arch="phi4-mini-3.8b"):
    cfg = tconfigs.get_smoke(arch, tconfigs.QuantConfig(**dict(QAT, fmt="ttq" if method == "ttq" else None)))
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    api = api.compiled(params)
    qs = None
    if method is not None:
        params, qs = init_quant_state(params, api.ctx.plan, method, fractions=fractions, total_steps=steps)
    return cfg, api, params, qs
