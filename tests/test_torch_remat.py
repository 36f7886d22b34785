"""Block remat (``cfg.remat``) in every family on the CPU: with it each block
runs under ``torch.utils.checkpoint`` (counted here), without it none does;
the loss and every gradient are the same bit for bit, under QAT.  Serving
(no gradients recorded) never checkpoints.  The inner loops the reference
always recomputes -- attention's key chunks, the MoE token chunks, the SSM
scan chunks -- are checkpointed whatever the config says."""
import dataclasses

import pytest
import torch
import torch.utils.checkpoint

from repro_torch import configs
from repro_torch.models import attention, build_model, make_smoke_batch
from repro_torch.tree import tree_leaves

ARCHS = ["qwen3-8b", "grok-1-314b", "qwen2-vl-72b", "falcon-mamba-7b", "zamba2-7b", "whisper-base"]
# the block functions remat wraps
BLOCK_FNS = ("_block_x", "_block", "_mamba_block", "_enc_block", "_dec_block_x")
# the lists whose every block remat wraps (the hybrid's shared attention blocks are not, as in the reference)
WRAPPED = ("blocks", "mamba_stack", "tail_stack", "enc_blocks", "dec_blocks")
# falcon-mamba's smoke dt_proj has K = 4: it trains int8 weights at group 4 (ROADMAP Queue C15)
QAT = {"falcon-mamba-7b": dict(w_bits=8, group_size=4)}


def _leaves(tree):
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor) and t.is_floating_point())


def _counted(monkeypatch):
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(getattr(fn, "__name__", "?"))
        return orig(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    return calls


def _grads(arch, remat, seq=16):
    qc = configs.QuantConfig(mode="qat", **QAT.get(arch, dict(w_bits=2, group_size=16)))
    cfg = dataclasses.replace(configs.get_smoke(arch, qc), remat=remat)
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    api = api.compiled(params)
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    batch = make_smoke_batch(torch.Generator().manual_seed(1), cfg, 2, seq)
    loss = api.train_loss(params, batch)
    return api, params, batch, loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_same_loss_and_gradients(arch, monkeypatch):
    calls = _counted(monkeypatch)
    _, _, _, l0, g0 = _grads(arch, remat=False)
    assert not [c for c in calls if c in BLOCK_FNS]
    calls.clear()
    api, params, batch, l1, g1 = _grads(arch, remat=True)
    assert len([c for c in calls if c in BLOCK_FNS]) == sum(len(params.get(k, [])) for k in WRAPPED)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) and all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, g1))
    calls.clear()
    with torch.inference_mode():
        api.forward(params, batch)
    assert not calls  # serving never checkpoints


def test_inner_loops_are_checkpointed_whatever_the_config(monkeypatch):
    """Mamba's scan chunks recompute in the backward pass with remat off:
    80 steps are 2 chunks of 40 a block."""
    calls = _counted(monkeypatch)
    for arch, fn in (("falcon-mamba-7b", "_m1_chunk"), ("zamba2-7b", "_m2_chunk")):
        calls.clear()
        _, params, _, _, _ = _grads(arch, remat=False, seq=80)
        assert calls.count(fn) == 2 * sum(len(params.get(k, [])) for k in ("blocks", "mamba_stack", "tail_stack"))


def test_attention_key_chunks_checkpointed(monkeypatch):
    """The online softmax over key chunks: each whole chunk is checkpointed
    (the trailing partial chunk is not, as in the reference), and the output
    and gradients equal dense attention's within float32 sums."""
    calls = _counted(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 80, 4, 16), generator=gen).requires_grad_(True) for _ in range(3))
    pos = torch.arange(80)
    out = attention._attend_chunked(q, k, v, pos, True, None, 32)
    assert calls == ["_online_chunk"] * 2
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    dense = attention._attend_dense_mha(q, k, v, attention._mask_bias(pos, pos, True, None)[None])
    torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-5)
    for a, b in zip((gq, gk, gv), torch.autograd.grad(dense.square().sum(), (q, k, v))):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
