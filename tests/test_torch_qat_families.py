"""``train_loss`` and its gradient under QAT against
``jax.value_and_grad`` on the smoke configs of qwen2-vl-72b (the loss on
the text tail), falcon-mamba-7b (int8 weights at group 4: ROADMAP Queue
C15) and whisper-base (encoder, cross-attention, decoder).  The
tolerances and the mantissa-flip cases are in ``tests/_qat_parity.py``."""
import pytest
import torch

from _qat_parity import check
from repro_torch import configs as tconfigs
from repro_torch.models import build_model, make_smoke_batch


@pytest.mark.parametrize("arch,flips", [("qwen2-vl-72b", False), ("falcon-mamba-7b", False), ("whisper-base", True)])
def test_qat_train_loss_value_and_grad_match(arch, flips):
    check(arch, flips)


def test_falcon_mamba_ternary_qat_raises_as_the_reference():
    """ROADMAP Queue C15: dt_proj's K (dt_rank 4 in the smoke config) holds
    no whole word of 16 ternary codes; the reference's QAT raises there and
    so does the port's (no silent fallback to float weights)."""
    cfg = tconfigs.get_smoke("falcon-mamba-7b", tconfigs.QuantConfig(w_bits=2, group_size=4, mode="qat"))
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    with pytest.raises((AssertionError, ValueError)):
        api.train_loss(params, make_smoke_batch(torch.Generator().manual_seed(1), cfg, 2, 8))
