"""Resume in the port's Trainer: a training checkpoint the reference's
Trainer wrote restored bit for bit (INQ mid-schedule, DFP-8 moments), INQ
mid-schedule resume bit-identical to the uninterrupted run, resume
equivalence; and whisper-base's full-precision steps against the
reference's (the control for the QAT drift ``tests/_train_parity.py``
explains)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _train_parity import (
    JOptConfig, JTrainConfig, JTrainer, clone, flat_port, flat_reference, leaves, np_batch, pair, parity, tiny,
    to_torch,
)
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.quant.state import QuantState, init_quant_state
from repro_torch.training import OptConfig, TrainConfig, Trainer
from repro_torch.training.data import DataConfig, make_batch


def test_fp_trainer_losses_match_reference():
    parity("whisper-base", "fp", 1e-5)


def test_port_restores_reference_training_checkpoint(tmp_path):
    """Smoke float32, DFP-8 moments, INQ mid-schedule (checkpoint at step 4,
    before the second event): every leaf of params and optimizer state comes
    back bit for bit, the plan and the QuantState are equal, and the next
    step's loss agrees with the reference's resumed step."""
    steps, fr = 8, (0.25, 1.0)  # events at 2 and 7
    japi, params, qs, tapi = pair("qwen3-8b", method="inq", fractions=fr, steps=steps)
    jcfg = JTrainConfig(opt=JOptConfig(lr=1e-3, warmup_steps=0, state_bits=8), ckpt_dir=str(tmp_path), ckpt_every=4)
    batch_j = lambda i: {k: jnp.asarray(v) for k, v in np_batch(japi.cfg, i).items()}  # noqa: E731
    jt = JTrainer(japi.train_loss, params, jcfg, plan=japi.ctx.plan, quant_state=qs)
    jt.train(batch_j, 4)
    ref_params = jax.tree.map(np.asarray, jt.params)
    ref_opt = jax.tree.map(np.asarray, jt.opt_state)
    jh = jt.train(batch_j, 1)  # the reference's own next step

    # a clone: on the CPU the converted leaves can share the reference's buffers, and the Trainer writes in place
    tparams0 = clone(params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    tparams0, _ = init_quant_state(tparams0, tapi.ctx.plan, "inq", fractions=fr, total_steps=steps)
    tt = Trainer(tapi.train_loss, tparams0, TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0, state_bits=8),
                                                        ckpt_dir=str(tmp_path), ckpt_every=4))
    assert tt.maybe_restore() == 4
    assert tt.plan.to_json() == japi.ctx.plan.to_json()
    assert tt.quant_state == QuantState("inq", fr, 1, steps)
    want = flat_reference({"params": ref_params, "opt": ref_opt})
    got = flat_port({"params": tt.params, "opt": tt.opt_state})
    assert sorted(got) == sorted(want) and any(p.endswith("/w/q") for p in got)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and np.array_equal(got[path], arr), path
    th = tt.train(lambda i: to_torch(np_batch(tapi.cfg, i)), 1)
    assert th["step"] == jh["step"] == [4]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)


def test_inq_mid_schedule_resume_bit_identical(tmp_path):
    """Crash between INQ events, restore, finish == the uninterrupted run,
    bit for bit: params, masks, learned grid, optimizer state and the
    schedule cursor."""
    steps, fr = 8, (0.5, 1.0)  # events at 4 and 7
    cfg, api, params, qs = tiny(method="inq", steps=steps, fractions=fr)
    d = DataConfig(batch=2, seq=16)
    batch_fn = lambda i: make_batch(cfg, d, i)  # noqa: E731

    def tcfg(ckdir):
        return TrainConfig(opt=OptConfig(lr=1e-4, warmup_steps=0, state_bits=8), ckpt_dir=str(ckdir), ckpt_every=4)

    t_s = Trainer(api.train_loss, clone(params), tcfg(tmp_path / "straight"), plan=api.ctx.plan, quant_state=qs)
    h1 = t_s.train(batch_fn, steps)
    assert t_s.quant_state.pos == len(fr)
    t_a = Trainer(api.train_loss, clone(params), tcfg(tmp_path / "cut"), plan=api.ctx.plan, quant_state=qs)
    t_a.train(batch_fn, 4)  # the checkpoint lands at step 4, before event 1 fires
    t_b = Trainer(api.train_loss, params, tcfg(tmp_path / "cut"), plan=api.ctx.plan)
    assert t_b.maybe_restore() == 4
    assert t_b.quant_state == QuantState("inq", fr, 0, steps)
    h2 = t_b.train(batch_fn, 4)
    assert h1["loss"][4:] == h2["loss"]
    assert t_b.quant_state == t_s.quant_state
    for tree_a, tree_b in ((t_s.params, t_b.params), (t_s.opt_state, t_b.opt_state)):
        la, lb = dict(leaves(tree_a)), dict(leaves(tree_b))
        assert sorted(la) == sorted(lb)
        for path in la:
            assert torch.equal(la[path].detach(), lb[path].detach()), path


def test_resume_equivalence(tmp_path):
    """Train 6 steps straight == train 3, crash, resume, train 3."""
    cfg = tconfigs.get_smoke("phi4-mini-3.8b")
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    d = DataConfig(batch=2, seq=16)
    batch_fn = lambda i: make_batch(cfg, d, i)  # noqa: E731

    def fresh(ckdir):
        return TrainConfig(opt=OptConfig(lr=1e-4, warmup_steps=0), ckpt_dir=str(ckdir), ckpt_every=3)

    h1 = Trainer(api.train_loss, clone(params), fresh(tmp_path / "a")).train(batch_fn, 6)
    Trainer(api.train_loss, clone(params), fresh(tmp_path / "b")).train(batch_fn, 3)
    t_b = Trainer(api.train_loss, params, fresh(tmp_path / "b"))  # a new node
    assert t_b.maybe_restore() == 3
    h2 = t_b.train(batch_fn, 3)
    np.testing.assert_allclose(h1["loss"][3:], h2["loss"], rtol=1e-4)
