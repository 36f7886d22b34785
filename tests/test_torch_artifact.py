"""Packed artifacts between the two packages (qwen3-8b smoke, group 16):
the reference writes, the port reads bit for bit in every weight format and
in bfloat16; the port writes the reference's files byte for byte and the
reference serves them; the port's cold start serves what it quantized; the
MoE family's (grok-1-314b smoke) stacked expert sites both ways, its
reference artifact cold-started by both engines; the VLM, SSM and hybrid
families' artifacts both ways (the hybrid's ``mamba_stack``, ``tail_stack``
and ``shared`` stacks) and their decode caches, nested SSM states
included; the enc-dec family's at 2, 4 and 8 bits, its cache's
``enc_out`` included; the tamper, corruption and IO-flake cases fall back or fail
closed as the reference's tests require."""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.base import config_to_dict as jconfig_to_dict
from repro.models import build_model as jbuild
from repro.models import load_servable as jload_servable
from repro.models import quantize_and_plan as jquantize_and_plan
from repro.models import save_servable as jsave_servable
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import StagedEngine as JStagedEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.configs.base import config_from_dict
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core.quantizer import QTensor
from repro_torch.models import build_model as tbuild
from repro_torch.models import load_servable, make_smoke_batch, quantize_and_plan, save_servable
from repro_torch.quant import QuantPlan, load_artifact, save_artifact
from repro_torch.quant.formats import format_of
from repro_torch.serving import FlakyIO, Request, ServingEngine, StagedEngine, corrupt_payload
from repro_torch.training import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-8b"
CPU = torch.device("cpu")
FORMATS = {
    "ternary": dict(w_bits=2), "int4": dict(w_bits=4), "int8": dict(w_bits=8),
    "nf4": dict(w_bits=4, fmt="nf4"), "mx": dict(w_bits=8, fmt="mx"),
}
STEP0 = "step_000000000"


def _quant(fmt, backend="ref"):
    return dict(group_size=16, mode="ptq", backend=backend, **FORMATS[fmt])


_JAX_MODELS = {}


def _jax_model(fmt, dtype="float32"):
    """(cfg, float params, qparams, plan, plan-bound api) of the reference."""
    key = (fmt, dtype)
    if key not in _JAX_MODELS:
        cfg = dataclasses.replace(jconfigs.get_smoke(ARCH, JQuantConfig(**_quant(fmt))), dtype=dtype)
        api = jbuild(cfg)
        params = api.init(jax.random.PRNGKey(0))
        qparams, plan, qapi = jquantize_and_plan(api, params)
        _JAX_MODELS[key] = (cfg, params, qparams, plan, qapi)
    return _JAX_MODELS[key]


def _flat(tree, path=""):
    """(path, tensor or QTensor metadata) of a port tree, layers by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif isinstance(tree, QTensor):
        yield f"{path}/meta", (tree.bits, tree.group_size, tuple(tree.shape), tree.fmt)
        for field in ("packed", "scale_m", "scale_e"):
            yield f"{path}/{field}", getattr(tree, field)
    else:
        yield path, tree


def _assert_bit_exact(a, b):
    fa, fb = list(_flat(a)), list(_flat(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), path
        else:
            assert x == y, path


def _files(d):
    """{file name: sha256} of one step directory."""
    return {f: hashlib.sha256((d / f).read_bytes()).hexdigest() for f in sorted(os.listdir(d))}


def _jax_decode(artifact_dir):
    api, params, _ = jload_servable(str(artifact_dir))
    logits, _ = api.decode(params, jnp.asarray([[3]], jnp.int32), jnp.int32(0), api.init_cache(1, 8))
    return np.asarray(logits)


# ---------------------------------------------------------------------------
# The reference writes, the port reads.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_reference_artifact_loads_bit_exact(fmt, tmp_path):
    cfg, _, qparams, plan, qapi = _jax_model(fmt)
    jsave_servable(str(tmp_path), qapi, qparams, plan)
    api, loaded, art = load_servable(str(tmp_path), device="cpu")
    _assert_bit_exact(loaded, params_from_jax(qparams, device="cpu"))
    assert fmt in {meta[3] for path, meta in _flat(loaded) if path.endswith("/meta")}  # default sites
    assert art.plan.to_json() == plan.to_json() and api.ctx.plan is art.plan
    assert api.cfg == tconfigs.get_smoke(ARCH, TQuantConfig(**_quant(fmt)))
    assert api.device == CPU and art.step == 0 and art.path == str(tmp_path / STEP0)


def test_reference_bf16_artifact_loads_bit_exact(tmp_path):
    """bfloat16 leaves (the full-width dtype) are '<V2' payloads named
    "bfloat16" in the manifest: the port reads them by that name."""
    cfg, _, qparams, plan, qapi = _jax_model("ternary", "bfloat16")
    jsave_servable(str(tmp_path), qapi, qparams, plan)
    man = json.loads((tmp_path / STEP0 / "manifest.json").read_text())
    assert man["arrays"]["embed/table"]["dtype"] == "bfloat16"
    _, loaded, _ = load_servable(str(tmp_path), device="cpu")
    assert loaded["embed"]["table"].dtype == torch.bfloat16
    assert loaded["blocks"][1]["ln1"]["scale"].dtype == torch.bfloat16
    _assert_bit_exact(loaded, params_from_jax(qparams, device="cpu"))


# ---------------------------------------------------------------------------
# The port writes the reference's bytes; the reference serves them.
# ---------------------------------------------------------------------------
def _port_save(fmt, dtype, d):
    cfg, _, qparams, plan, _ = _jax_model(fmt, dtype)
    api = tbuild(config_from_dict(jconfig_to_dict(cfg)), device="cpu")
    return save_servable(str(d), api, params_from_jax(qparams, device="cpu"), QuantPlan.from_json(plan.to_json()))


@pytest.mark.parametrize("fmt,dtype", [(f, "float32") for f in FORMATS] + [("ternary", "bfloat16")])
def test_port_artifact_is_byte_identical(fmt, dtype, tmp_path):
    cfg, _, qparams, plan, qapi = _jax_model(fmt, dtype)
    jsave_servable(str(tmp_path / "jax"), qapi, qparams, plan)
    out = _port_save(fmt, dtype, tmp_path / "port")
    assert out == str(tmp_path / "port" / STEP0)
    want, got = _files(tmp_path / "jax" / STEP0), _files(tmp_path / "port" / STEP0)
    assert len(got) == 3 * 8 + 6 + 2 and got == want  # 8 QTensor nodes, 6 arrays, plan and manifest


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_reference_serves_port_artifact(fmt, tmp_path):
    cfg, _, qparams, plan, qapi = _jax_model(fmt)
    jsave_servable(str(tmp_path / "jax"), qapi, qparams, plan)
    _port_save(fmt, "float32", tmp_path / "port")
    api, params, art = jload_servable(str(tmp_path / "port"))
    assert art.plan.to_json() == plan.to_json() and api.cfg == cfg
    np.testing.assert_array_equal(_jax_decode(tmp_path / "port"), _jax_decode(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# The port's own cold start.
# ---------------------------------------------------------------------------
def _port_calibrated(fmt="ternary", backend="cuda"):
    api = tbuild(tconfigs.get_smoke(ARCH, TQuantConfig(**_quant(fmt, backend))), device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batches = [make_smoke_batch(torch.Generator().manual_seed(100 + i), api.cfg, 2, 16) for i in range(2)]
    return quantize_and_plan(api, params, calib_batches=batches)


@pytest.fixture(scope="module")
def calibrated():
    return _port_calibrated()


def test_cold_start_decode_bit_exact(calibrated, tmp_path):
    qparams, plan, qapi = calibrated
    assert plan.calibrated and len(plan.act_exponents) == len(plan.site_paths) == 8
    save_servable(str(tmp_path), qapi, qparams, plan)
    cold_api, cold_params, art = load_servable(str(tmp_path), device="cpu")
    _assert_bit_exact(cold_params, qparams)
    for path, t in _flat(cold_params):  # what the kernels take on the card
        assert not isinstance(t, torch.Tensor) or (t.is_contiguous() and t.data_ptr() % 16 == 0), path
    assert art.plan == plan and cold_api.cfg == qapi.cfg
    tok = torch.tensor([[3], [7]])
    with torch.inference_mode():
        for pos in (0, 5):
            warm, _ = qapi.decode(qparams, tok, pos, qapi.init_cache(2, 8))
            cold, _ = cold_api.decode(cold_params, tok, pos, cold_api.init_cache(2, 8))
            assert torch.equal(warm, cold)


@pytest.mark.parametrize("engine", [ServingEngine, StagedEngine], ids=["lockstep", "staged"])
def test_engine_from_artifact_serves_same_tokens(calibrated, engine, tmp_path):
    qparams, plan, qapi = calibrated
    save_servable(str(tmp_path), qapi, qparams, plan)

    def tokens(eng):
        for i, p in enumerate([[5, 9, 2], [11, 4, 8, 1, 6]]):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
        return {r.uid: r.output for r in eng.run()}

    warm = tokens(engine(qapi, qparams, n_slots=2, max_len=16))
    cold = tokens(engine.from_artifact(str(tmp_path), device="cpu", n_slots=2, max_len=16))
    assert warm == cold and len(warm) == 2 and all(len(t) == 4 for t in warm.values())


def test_reference_launcher_backend_needs_a_port_backend(tmp_path):
    """An artifact of the reference's launcher names its ``xla`` backend:
    the load fails loud unless ``backend=`` names one of the port's."""
    cfg, _, qparams, plan, qapi = _jax_model("ternary")
    jsave_servable(str(tmp_path), qapi, qparams, dataclasses.replace(plan, backend="xla"))
    with pytest.raises(ValueError, match="'xla' is not one of the port's"):
        load_servable(str(tmp_path), device="cpu")
    api, _, _ = load_servable(str(tmp_path), device="cpu", backend="ref")
    assert api.ctx.backend == "ref" and api.ctx.plan.site_paths == plan.site_paths


# ---------------------------------------------------------------------------
# The MoE family: (L, E, ...) expert QTensors (the reference's
# tests/test_artifact.py family "moe").
# ---------------------------------------------------------------------------
MOE = "grok-1-314b"


@pytest.fixture(scope="module")
def moe_model():
    """(cfg, qparams, plan, plan-bound api) of the reference's ternary grok smoke model."""
    cfg = jconfigs.get_smoke(MOE, JQuantConfig(**_quant("ternary")))
    api = jbuild(cfg)
    qparams, plan, qapi = jquantize_and_plan(api, api.init(jax.random.PRNGKey(0)))
    return cfg, qparams, plan, qapi


def test_moe_port_artifact_is_byte_identical(moe_model, tmp_path):
    """The port writes the reference's files, manifest included, for a
    model whose expert sites stack (L, E, ...) QTensors; and reads them
    back per layer as (E, ...) ones, bit for bit."""
    cfg, qparams, plan, qapi = moe_model
    jsave_servable(str(tmp_path / "jax"), qapi, qparams, plan)
    api = tbuild(config_from_dict(jconfig_to_dict(cfg)), device="cpu")
    save_servable(str(tmp_path / "port"), api, params_from_jax(qparams, device="cpu"),
                  QuantPlan.from_json(plan.to_json()))
    want, got = _files(tmp_path / "jax" / STEP0), _files(tmp_path / "port" / STEP0)
    assert len(got) == 3 * 9 + 4 + 2 and got == want  # 9 QTensor nodes, 4 arrays, plan and manifest
    _, loaded, _ = load_servable(str(tmp_path / "port"), device="cpu")
    _assert_bit_exact(loaded, params_from_jax(qparams, device="cpu"))
    assert loaded["blocks"][1]["moe"]["experts"]["down"]["w"].scale_e.shape == (cfg.n_experts,)


@pytest.mark.parametrize("engine,jengine", [(ServingEngine, JEngine), (StagedEngine, JStagedEngine)],
                         ids=["lockstep", "staged"])
def test_moe_reference_artifact_cold_starts_both_engines(moe_model, engine, jengine, tmp_path):
    """The reference's grok artifact, cold-started by each of the port's
    engines: the tokens of the port's engine over the same weights in
    memory, and of the reference's engine."""
    cfg, qparams, plan, qapi = moe_model
    jsave_servable(str(tmp_path), qapi, qparams, plan)

    def tokens(eng):
        for i, p in enumerate([[5, 9, 2], [11, 4, 8, 1, 6]]):
            eng.submit((JRequest if isinstance(eng, jengine) else Request)(uid=i, prompt=p, max_new_tokens=4))
        return {r.uid: r.output for r in eng.run()}

    cold = tokens(engine.from_artifact(str(tmp_path), device="cpu", n_slots=2, max_len=16))
    api = tbuild(config_from_dict(jconfig_to_dict(cfg)), device="cpu").with_plan(QuantPlan.from_json(plan.to_json()))
    warm = tokens(engine(api, params_from_jax(qparams, device="cpu"), n_slots=2, max_len=16))
    assert cold == warm == tokens(jengine(qapi, qparams, n_slots=2, max_len=16)) and len(cold) == 2


# ---------------------------------------------------------------------------
# The VLM, SSM and hybrid families: their trees and caches both ways.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["qwen2-vl-72b", "falcon-mamba-7b", "zamba2-7b"])
def family_model(request):
    """(cfg, qparams, plan, plan-bound api) of the reference's ternary smoke model."""
    cfg = jconfigs.get_smoke(request.param, JQuantConfig(**_quant("ternary")))
    api = jbuild(cfg)
    qparams, plan, qapi = jquantize_and_plan(api, api.init(jax.random.PRNGKey(0)))
    return cfg, qparams, plan, qapi


def test_family_artifacts_both_ways(family_model, tmp_path):
    """The reference's artifact read by the port bit for bit, stacked
    layers split into lists of the reference's lengths; the port's artifact
    of the same tree is the reference's files byte for byte; and the
    reference's decode cache converts to the port's leaf for leaf."""
    cfg, qparams, plan, qapi = family_model
    jsave_servable(str(tmp_path / "jax"), qapi, qparams, plan)
    api, loaded, art = load_servable(str(tmp_path / "jax"), device="cpu")
    _assert_bit_exact(loaded, params_from_jax(qparams, device="cpu"))
    assert art.plan.to_json() == plan.to_json() and tconfigs.config_to_dict(api.cfg) == jconfig_to_dict(cfg)
    stacks = {k: len(v) for k, v in loaded.items() if isinstance(v, list)}
    want = {"ssm": {"blocks": 2}, "vlm": {"blocks": 2},
            "hybrid": {"mamba_stack": 6, "shared": 2, "tail_stack": 1}}[cfg.family]
    assert stacks == want
    save_servable(str(tmp_path / "port"), api, loaded, QuantPlan.from_json(plan.to_json()))
    assert _files(tmp_path / "port" / STEP0) == _files(tmp_path / "jax" / STEP0)

    jcache = qapi.init_cache(2, 16)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    fresh = api.init_cache(2, 16)
    assert list(_flat(tcache)) and [p for p, _ in _flat(tcache)] == [p for p, _ in _flat(fresh)]
    for (path, got), (_, want_leaf) in zip(_flat(tcache), _flat(fresh)):
        assert got.dtype == want_leaf.dtype and got.shape == want_leaf.shape and torch.equal(got, want_leaf), path


# ---------------------------------------------------------------------------
# The enc-dec family (whisper-base smoke): its tree and cache both ways.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[2, 4, 8], ids=["bits2", "bits4", "bits8"])
def whisper_model(request):
    """(cfg, qparams, plan, plan-bound api) of the reference's whisper-base smoke model at ``bits``."""
    cfg = jconfigs.get_smoke("whisper-base", JQuantConfig(w_bits=request.param, group_size=16, mode="ptq",
                                                          backend="ref"))
    api = jbuild(cfg)
    qparams, plan, qapi = jquantize_and_plan(api, api.init(jax.random.PRNGKey(0)))
    return cfg, qparams, plan, qapi


def test_whisper_artifacts_both_ways(whisper_model, tmp_path):
    """As the reference's ``test_artifact_roundtrip_family_x_format`` for
    its encdec family, across the packages: the reference's artifact read
    by the port bit for bit (``enc_blocks`` / ``dec_blocks`` split into
    lists), the port's artifact of the same tree the reference's files
    byte for byte and read back by the reference, and the decode cache
    (``enc_out`` included) converted leaf for leaf."""
    cfg, qparams, plan, qapi = whisper_model
    jsave_servable(str(tmp_path / "jax"), qapi, qparams, plan)
    api, loaded, art = load_servable(str(tmp_path / "jax"), device="cpu")
    _assert_bit_exact(loaded, params_from_jax(qparams, device="cpu"))
    assert art.plan.to_json() == plan.to_json() and tconfigs.config_to_dict(api.cfg) == jconfig_to_dict(cfg)
    assert {k: len(v) for k, v in loaded.items() if isinstance(v, list)} == {"enc_blocks": 2, "dec_blocks": 2}
    save_servable(str(tmp_path / "port"), api, loaded, QuantPlan.from_json(plan.to_json()))
    assert _files(tmp_path / "port" / STEP0) == _files(tmp_path / "jax" / STEP0)
    japi2, jloaded, _ = jload_servable(str(tmp_path / "port"))
    _assert_bit_exact(params_from_jax(jloaded, device="cpu"), loaded)

    jcache = qapi.init_cache(2, 16)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    fresh = api.init_cache(2, 16)
    assert "enc_out" in tcache and [p for p, _ in _flat(tcache)] == [p for p, _ in _flat(fresh)]
    for (path, got), (_, want_leaf) in zip(_flat(tcache), _flat(fresh)):
        assert got.dtype == want_leaf.dtype and got.shape == want_leaf.shape and torch.equal(got, want_leaf), path


# ---------------------------------------------------------------------------
# Plan persistence and corruption (the reference's tests/test_artifact.py).
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ternary():
    api = tbuild(tconfigs.get_smoke(ARCH, TQuantConfig(**_quant("ternary", "cuda"))), device="cpu")
    return quantize_and_plan(api, api.init(torch.Generator().manual_seed(0)))


def _extra(api):
    return {"arch_config": tconfigs.config_to_dict(api.cfg)}


def test_truncated_plan_fails_verification_and_falls_back(ternary, tmp_path):
    qparams, plan, qapi = ternary
    for step in (1, 2):
        save_artifact(str(tmp_path), qparams, plan, extra=_extra(qapi), step=step)
    plan_file = tmp_path / "step_000000002" / ck.PLAN_FILE
    blob = plan_file.read_text()
    plan_file.write_text(blob[: len(blob) // 2])  # truncate mid-JSON

    assert ck.latest_intact_step(str(tmp_path)) == 1
    art = load_artifact(str(tmp_path), device="cpu")
    assert art.step == 1 and art.plan is not None and art.plan.to_json() == plan.to_json()
    step, tree = ck.restore_latest(str(tmp_path), qparams, device="cpu")
    assert step == 1
    _assert_bit_exact(tree, qparams)


def test_corrupt_packed_payload_falls_back(ternary, tmp_path):
    qparams, plan, qapi = ternary
    save_servable(str(tmp_path), qapi, qparams, plan)
    d = tmp_path / STEP0
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    with open(d / victim, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\xff")
    with pytest.raises(IOError):
        load_artifact(str(tmp_path), device="cpu")


def test_plan_json_tamper_detected(ternary, tmp_path):
    qparams, plan, qapi = ternary
    save_servable(str(tmp_path), qapi, qparams, plan)
    plan_file = tmp_path / STEP0 / ck.PLAN_FILE
    tampered = json.loads(plan_file.read_text())
    tampered["mode"] = "qat"
    plan_file.write_text(json.dumps(tampered))
    with pytest.raises(IOError):
        load_artifact(str(tmp_path), device="cpu")


def test_type_corrupt_manifest_falls_back(tmp_path):
    tree = {"a": torch.arange(4.0)}
    ck.save(str(tmp_path), 1, tree)
    ck.save(str(tmp_path), 2, tree)
    mpath = tmp_path / "step_000000002" / "manifest.json"
    m = json.loads(mpath.read_text())
    m["arrays"] = {"a": None}
    mpath.write_text(json.dumps(m))
    assert ck.latest_intact_step(str(tmp_path)) == 1
    step, _ = ck.restore_latest(str(tmp_path), tree, device="cpu")
    assert step == 1


def test_legacy_empty_fmt_manifest_resolves_by_bits(tmp_path):
    """A manifest whose qtensor nodes carry fmt "" (a pre-fix writer) loads
    and decodes through the bits default, identically to the stamped one."""
    api = tbuild(tconfigs.get_smoke(ARCH, TQuantConfig(**_quant("int4", "cuda"))), device="cpu")
    qparams, plan, qapi = quantize_and_plan(api, api.init(torch.Generator().manual_seed(0)))
    save_servable(str(tmp_path), qapi, qparams, plan)
    mpath = tmp_path / STEP0 / "manifest.json"
    man = json.loads(mpath.read_text())
    blanked = 0
    for node in man["nodes"].values():
        if node["codec"] == "qtensor" and node["meta"].get("fmt"):
            node["meta"]["fmt"] = ""
            blanked += 1
    assert blanked == 8
    mpath.write_text(json.dumps(man))  # metadata is not payload-checksummed

    _, cold, _ = load_servable(str(tmp_path), device="cpu")
    pairs = [(cold["lm_head"]["w"], qparams["lm_head"]["w"])] + [
        (cold["blocks"][i][g][s]["w"], qparams["blocks"][i][g][s]["w"])
        for i in range(2) for g, s in [("attn", "wq"), ("attn", "wk"), ("mlp", "down")]]
    for qt, ref in pairs:
        assert qt.fmt == "" and format_of(qt).name == {2: "ternary", 4: "int4", 8: "int8"}[qt.bits]
        assert torch.equal(format_of(qt).decode(qt.packed, qt.k), format_of(ref).decode(ref.packed, ref.k))
        assert torch.equal(qt.scale_m, ref.scale_m)


def test_checkpoint_without_plan_still_restores(tmp_path):
    tree = {"a": torch.arange(4.0), "n": {"b": torch.ones((2, 2), dtype=torch.int32)}}
    ck.save(str(tmp_path), 3, tree)
    d = ck.step_dir(str(tmp_path), 3)
    assert ck.load_plan(d) is None
    _assert_bit_exact(ck.restore_tree(d, device="cpu"), tree)


# ---------------------------------------------------------------------------
# Artifact-load faults (the reference's tests/test_robustness.py).
# ---------------------------------------------------------------------------
def test_io_flake_retried_transparently(tmp_path, monkeypatch):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones((3,))}
    ck.save(str(tmp_path), 1, tree)
    monkeypatch.setattr(ck, "IO_BACKOFF_S", 0.001)
    flake = FlakyIO(n_failures=2)
    with ck.io_fault_hook(flake):
        step, got = ck.restore_latest(str(tmp_path), tree, device="cpu")
    assert step == 1 and flake.raised == 2
    assert torch.equal(got["w"], tree["w"])


def test_io_flake_exhausts_budget_and_raises(tmp_path, monkeypatch):
    ck.save(str(tmp_path), 1, {"w": torch.arange(4.0)})
    monkeypatch.setattr(ck, "IO_BACKOFF_S", 0.001)
    flake = FlakyIO(n_failures=10_000)
    with ck.io_fault_hook(flake):
        assert ck.latest_intact_step(str(tmp_path)) is None
    assert flake.raised == ck.IO_RETRIES + 1


def test_corrupt_shard_fails_closed_never_retried(tmp_path):
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ck.save(str(tmp_path), 1, tree)
    ck.save(str(tmp_path), 2, tree)
    victim = corrupt_payload(str(tmp_path / "step_000000002"), seed=3)
    assert os.path.exists(victim)
    assert ck.latest_intact_step(str(tmp_path)) == 1
    step, got = ck.restore_latest(str(tmp_path), tree, device="cpu")
    assert step == 1 and torch.equal(got["w"], tree["w"])


# ---------------------------------------------------------------------------
# Sharded payloads of the reference, joined without a mesh.
# ---------------------------------------------------------------------------
SHARDED_SCRIPT = r"""
import sys
import jax
from repro.launch.mesh import parse_mesh_spec
from repro.quant import quantize_weights, save_artifact

tree = {
    "blocks": {"attn": {"wq": {"w": quantize_weights(jax.random.normal(jax.random.PRNGKey(0), (64, 128)), 2, 16)}}},
    "embed": {"table": jax.random.normal(jax.random.PRNGKey(1), (128, 64))},
}
save_artifact(sys.argv[1], tree, None, mesh=parse_mesh_spec("dp=2,ep=2"))
save_artifact(sys.argv[2], tree, None)
print("SAVED")
"""


def test_reference_sharded_artifact_joins_without_a_mesh(tmp_path):
    sharded, whole = tmp_path / "sharded", tmp_path / "whole"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", SHARDED_SCRIPT, str(sharded), str(whole)], capture_output=True,
                       text=True, timeout=240, env=env, cwd=REPO)
    assert r.returncode == 0 and "SAVED" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]
    man = json.loads((sharded / STEP0 / "manifest.json").read_text())
    n_shards = [len(m["shards"]) for node in man["nodes"].values() for m in node["arrays"].values() if "shards" in m]
    n_shards += [len(m["shards"]) for m in man["arrays"].values() if "shards" in m]
    assert n_shards and max(n_shards) > 1  # the join really runs
    got, want = load_artifact(str(sharded), device="cpu"), load_artifact(str(whole), device="cpu")
    _assert_bit_exact(got.params, want.params)
    assert got.plan is None and got.params["blocks"]["attn"]["wq"]["w"].packed.dtype == torch.int32

    # shards that no longer tile the array fail verification
    for node in man["nodes"].values():
        for meta in node["arrays"].values():
            if "shards" in meta and len(meta["shards"]) > 1:
                meta["shards"] = meta["shards"][:-1]
    (sharded / STEP0 / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(IOError):
        load_artifact(str(sharded), device="cpu")


# ---------------------------------------------------------------------------
# What the port does not do fails loud.
# ---------------------------------------------------------------------------
def test_no_intact_step_raises(tmp_path):
    with pytest.raises(IOError, match="no intact quantized artifact"):
        load_artifact(str(tmp_path), device="cpu")


@pytest.mark.parametrize("dtype,match", [("bfloat8", "not one the port reads"), ("int8", "the manifest says")])
def test_unknown_or_wrong_payload_dtype_fails_loud(dtype, match, tmp_path):
    ck.save(str(tmp_path), 0, {"a": torch.arange(4.0)})
    mpath = tmp_path / STEP0 / "manifest.json"
    man = json.loads(mpath.read_text())
    man["arrays"]["a"]["dtype"] = dtype
    mpath.write_text(json.dumps(man))
    with pytest.raises(ValueError, match=match):
        ck.restore_tree(str(tmp_path / STEP0), device="cpu")


def test_retain_keeps_the_newest_and_dir_bytes_counts_them(tmp_path):
    for step in range(4):
        ck.save(str(tmp_path), step, {"a": torch.arange(8, dtype=torch.int32)})
    ck.retain(str(tmp_path), keep=2)
    assert ck.list_steps(str(tmp_path)) == [2, 3]
    d = ck.step_dir(str(tmp_path), 3)
    assert ck.dir_bytes(d) == sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    assert ck.load_manifest(d)["step"] == 3
