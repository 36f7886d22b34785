"""The port's seeded data pipeline (``repro_torch.training.data``): the
counterparts of the reference's data tests (``tests/test_training.py``),
the enc-dec and VLM leaves at the reference's shapes and dtypes, and the
statistics the reference's generator has (the two draw different bits:
``jax.random`` against a seeded ``torch.Generator``)."""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import make_batch as jmake_batch
from repro_torch import configs
from repro_torch.training.data import DataConfig, make_batch, shard_for_rank


def test_data_deterministic_and_resumable():
    cfg = configs.get_smoke("qwen3-8b")
    d = DataConfig(batch=4, seq=32, seed=7)
    b1, b2, b3 = make_batch(cfg, d, step=13), make_batch(cfg, d, step=13), make_batch(cfg, d, step=14)
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert not torch.equal(b1["tokens"], make_batch(cfg, DataConfig(batch=4, seq=32, seed=8), step=13)["tokens"])
    assert b1["tokens"].shape == (4, 32) and b1["labels"].shape == (4, 32)
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])  # labels are the next tokens


def test_data_rank_sharding_partitions():
    cfg = configs.get_smoke("qwen3-8b")
    b = make_batch(cfg, DataConfig(batch=8, seq=16), 0)
    shards = [shard_for_rank(b, r, 4) for r in range(4)]
    assert torch.equal(torch.cat([s["tokens"] for s in shards]), b["tokens"])


def test_data_has_learnable_structure():
    """Induced sequential structure: most next tokens follow the rule, as in
    the reference's batches."""
    cfg = configs.get_smoke("qwen3-8b")
    b = make_batch(cfg, DataConfig(batch=32, seq=64, structure=0.9), 0)
    pred = (b["tokens"] * 31 + 7) % cfg.vocab
    share = float((pred == b["labels"]).to(torch.float32).mean())
    jb = jmake_batch(jconfigs.get_smoke("qwen3-8b"), JDataConfig(batch=32, seq=64, structure=0.9), 0)
    jshare = float(((np.asarray(jb["tokens"]) * 31 + 7) % cfg.vocab == np.asarray(jb["labels"])).mean())
    assert share > 0.5 and abs(share - jshare) < 0.05


def test_data_zipf_marginal_matches_reference():
    """Without structure the marginal is the squared uniform's: the mean
    token (vocab / 3) and the low-token mass (P(tok < vocab / 4) = 1 / 2)
    agree with the reference's within sampling noise."""
    cfg = configs.get_smoke("qwen3-8b")
    t = make_batch(cfg, DataConfig(batch=64, seq=64, structure=0.0), 3)["tokens"].to(torch.float32)
    jt = np.asarray(jmake_batch(jconfigs.get_smoke("qwen3-8b"), JDataConfig(batch=64, seq=64, structure=0.0),
                                3)["tokens"], np.float32)
    for ours, ref in ((float(t.mean()), float(jt.mean())),
                      (float((t < cfg.vocab / 4).to(torch.float32).mean()), float((jt < cfg.vocab / 4).mean()))):
        assert ours == pytest.approx(ref, rel=0.05)
    assert float(t.mean()) == pytest.approx(cfg.vocab / 3, rel=0.05)


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b"])
def test_data_family_leaves_match_reference_shapes(arch):
    cfg = configs.get_smoke(arch)
    b = make_batch(cfg, DataConfig(batch=2, seq=16), 5)
    jb = jmake_batch(jconfigs.get_smoke(arch), JDataConfig(batch=2, seq=16), 5)
    assert sorted(b) == sorted(jb)
    for k, v in jb.items():
        assert tuple(b[k].shape) == tuple(v.shape), k
        assert str(b[k].dtype).split(".")[-1] == str(np.asarray(v).dtype), k
    if arch == "qwen2-vl-72b":
        assert np.array_equal(b["positions"].numpy(), np.asarray(jb["positions"]))
    else:
        assert float(b["frames"].std()) == pytest.approx(0.1, rel=0.1)


def test_batch_lands_on_the_device_asked():
    cfg = configs.get_smoke("whisper-base")
    b = make_batch(cfg, DataConfig(batch=2, seq=8), 0, device="cpu")
    assert all(v.device.type == "cpu" and v.is_contiguous() for v in b.values())
