"""The port's Trainer (``repro_torch.training.trainer``) against the
reference's: QAT ternary steps of the qwen3-8b and whisper-base smoke
configs from the same parameters and numpy batches, per-step losses within
the tolerances ``tests/_train_parity.py`` states; deferred host syncs and
microbatch accumulation (the counterparts of ``tests/test_training.py``
and ``tests/test_trained_quant.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from _train_parity import clone, leaves, parity, tiny
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.training import OptConfig, TrainConfig, Trainer
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.trainer import make_train_step, mark_trainable


@pytest.mark.parametrize("arch,rtol", [("qwen3-8b", 1e-5), ("whisper-base", 2e-3)])
def test_qat_trainer_losses_match_reference(arch, rtol):
    parity(arch, "qat", rtol)


def test_train_defers_host_syncs(tmp_path):
    """One flush (one host transfer) for a run without checkpoints, one per
    checkpoint interval else."""
    cfg, api, params, _ = tiny()
    d = DataConfig(batch=2, seq=16)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-4, warmup_steps=0))
    tr = Trainer(api.train_loss, clone(params), tcfg)
    hist = tr.train(lambda i: make_batch(cfg, d, i), 5)
    assert tr.sync_count == 1
    assert len(hist["loss"]) == 5 and hist["step"] == list(range(5))
    tr2 = Trainer(api.train_loss, params, tcfg)
    tr2.tcfg = dataclasses.replace(tcfg, ckpt_dir=str(tmp_path), ckpt_every=2)
    hist2 = tr2.train(lambda i: make_batch(cfg, d, i), 4)
    assert tr2.sync_count == 2  # one per checkpoint; the final flush is empty
    assert len(hist2["loss"]) == 4


def test_trainer_refuses_a_mesh():
    cfg, api, params, _ = tiny()
    with pytest.raises(NotImplementedError, match=r"Queue A step 10\.2 \(A10\.2\)"):
        Trainer(api.train_loss, params, TrainConfig(), mesh=object())


def test_microbatch_equivalence(monkeypatch):
    """Accumulated microbatch gradients == the full batch's (compared at the
    gradient: the first Adam step normalizes by |g| + eps, which amplifies
    float32 round-off on near-zero entries); the step divides by the count."""
    cfg = tconfigs.get_smoke("qwen2-vl-72b")  # M-RoPE's (3, B, S) positions split on axis 1
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    mark_trainable(params)
    batch = make_batch(cfg, DataConfig(batch=4, seq=16), 0)
    grads = {}

    def capture(tag):
        def apply(p, g, s, c):
            grads[tag] = dict(leaves(g))
            return p, s, {"lr": torch.zeros(()), "grad_norm": torch.zeros(())}
        return apply

    losses = {}
    for mb in (1, 2):
        monkeypatch.setattr(opt_lib, "apply_updates", capture(mb))
        tcfg = TrainConfig(opt=OptConfig(), microbatches=mb)
        _, _, m = make_train_step(api.train_loss, tcfg)(params, opt_lib.init_state(params, tcfg.opt), batch)
        losses[mb] = float(m["loss"])
    assert losses[2] == pytest.approx(losses[1], rel=1e-5)
    assert sorted(grads[2]) == sorted(grads[1]) and len(grads[1]) > 20
    scale = max(float(g.abs().max()) for g in grads[1].values())
    for path, g in grads[1].items():
        np.testing.assert_allclose(grads[2][path].numpy(), g.numpy(), atol=1e-5 * max(scale, 1.0), rtol=1e-3,
                                   err_msg=path)
