"""Serving the hybrid (zamba2-7b smoke: 7 Mamba2 layers, 2 superblocks of
3 and a tail of 1, two shared attention blocks over kv_int8) under ternary
PTQ against the reference, with flash off and on, like with like: decode
steps (flash decode in the shared blocks), the lockstep engine's tokens and
the staged engine's through its per-token prefill fallback, which carries
the per-slot position into the shared blocks' KV writes; the kv_corrupt
chaos NaN-fills the nested SSM state rows.
"""
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.serving import ServingEngine
from test_torch_ssm_serving import check_lockstep_tokens, check_ptq_decode_steps, check_staged_fallback_tokens

HYBRID = "zamba2-7b"
FLASH = pytest.mark.parametrize("flash", [False, True], ids=["oracle", "flash"])


def test_ptq_decode_steps_match():
    check_ptq_decode_steps(HYBRID, True)


@FLASH
def test_lockstep_tokens_match_reference(flash):
    check_lockstep_tokens(HYBRID, flash)


@FLASH
def test_staged_fallback_tokens_match_reference(flash):
    check_staged_fallback_tokens(HYBRID, flash)


def test_kv_corrupt_poisons_nested_ssm_state():
    """The chaos kv_corrupt row of a hybrid cache: NaN in every float leaf
    of the slot (SSM states, bf16 K/V) through the nested insert, the other
    slot untouched."""
    api = tbuild(tconfigs.get_smoke("zamba2-7b"), device="cpu")
    eng = ServingEngine(api, api.init(torch.Generator().manual_seed(0)), n_slots=2, max_len=16)
    eng._corrupt_slot_cache(1)
    for leaf in (eng.cache["ssm"]["h"], eng.cache["ssm"]["conv"], eng.cache["ssm_tail"]["h"], eng.cache["k"]):
        assert torch.isnan(leaf[:, 1].float()).all() and not torch.isnan(leaf[:, 0].float()).any()
    eng._clear_slot_cache(1)
    assert not any(torch.isnan(leaf.float()).any() for leaf in (eng.cache["ssm"]["h"], eng.cache["v"]))
