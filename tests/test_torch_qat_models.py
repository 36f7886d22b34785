"""``train_loss`` and its gradient under QAT (the paper's policy, ternary
weights at group 16, 8-bit activations) against ``jax.value_and_grad`` on
the smoke configs of qwen3-8b, grok-1-314b (the MoE layer's QAT branch)
and zamba2-7b, as the reference's ``tests/test_models_smoke.py`` trains
them.  The tolerances and the mantissa-flip cases are in
``tests/_qat_parity.py``; qwen2-vl-72b, falcon-mamba-7b and whisper-base
are in ``tests/test_torch_qat_families.py``."""
import pytest

from _qat_parity import check


@pytest.mark.parametrize("arch,flips", [("qwen3-8b", True), ("grok-1-314b", False), ("zamba2-7b", False)])
def test_qat_train_loss_value_and_grad_match(arch, flips):
    check(arch, flips)
