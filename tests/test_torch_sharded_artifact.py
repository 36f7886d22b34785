"""Sharded packed artifacts between the two packages (grok-1-314b smoke,
ternary group 16, and a mixed tree with a bfloat16 table).

The reference writes on a forced 4-device ``dp=2,ep=2`` mesh (one
subprocess: its device count is fixed before jax starts) and writes the
same trees unsharded.  The port reads the sharded artifact rank by rank on
the same mesh (each rank reading only its own shard files), elastically on
``dp=1,ep=4`` and without a mesh, bit for bit; its own single-process
sharded write is the reference's byte for byte, files and manifest; the
reference's mesh-free ``load_artifact`` reads it (not a sharded bfloat16
payload, which it cannot join even from its own write: ROADMAP Queue
C18); a corrupt or a missing shard fails closed."""
import hashlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.quant import load_artifact as jload_artifact
from repro_torch.core.quantizer import QTensor
from repro_torch.parallel import sharding as rules
from repro_torch.parallel.collectives import Mesh
from repro_torch.quant import load_artifact, save_artifact
from repro_torch.training import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP0 = "step_000000000"
DP2_EP2 = {"data": 2, "model": 2}

WRITE_SCRIPT = r"""
import sys
import jax
import jax.numpy as jnp
from repro import configs
from repro.configs.base import QuantConfig
from repro.launch.mesh import parse_mesh_spec
from repro.models import build_model, quantize_and_plan, save_servable
from repro.quant import quantize_weights, save_artifact

assert jax.device_count() == 4
mesh = parse_mesh_spec("dp=2,ep=2")
cfg = configs.get_smoke("grok-1-314b", QuantConfig(w_bits=2, group_size=16, mode="ptq", backend="auto"))
api = build_model(cfg)
qparams, plan, qapi = quantize_and_plan(api, api.init(jax.random.PRNGKey(0)))
save_servable(sys.argv[1] + "/model_sharded", qapi, qparams, plan, mesh=mesh)
save_servable(sys.argv[1] + "/model_whole", qapi, qparams, plan)
tree = {
    "blocks": {"attn": {"wq": {"w": quantize_weights(jax.random.normal(jax.random.PRNGKey(0), (64, 128)), 2, 16)}}},
    "embed": {"table": jax.random.normal(jax.random.PRNGKey(1), (128, 64)).astype(jnp.bfloat16)},
}
save_artifact(sys.argv[1] + "/mixed_sharded", tree, None, mesh=mesh)
save_artifact(sys.argv[1] + "/mixed_whole", tree, None)
print("SAVED")
"""


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", WRITE_SCRIPT, str(root)], capture_output=True, text=True, timeout=300,
                       env=env, cwd=REPO)
    assert r.returncode == 0 and "SAVED" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]
    return root


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _chunked(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """A rank's slice of ``x`` under ``spec``, by ``torch.chunk``."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        if axes:
            x = x.chunk(mesh.axis_size(axes), dim=dim)[mesh.index(axes)]
    return x


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                                                       b.reshape(-1).view(torch.uint8))


def _check_local(local, whole, specs, mesh: Mesh) -> int:
    """Every leaf of a rank's read equals the rank's slice of the whole
    read; returns how many leaves were split."""
    flat_specs = dict(_leaves(specs))
    split = 0
    for (path, got), (_, full) in zip(_leaves(local), _leaves(whole)):
        spec = flat_specs[path]
        if isinstance(full, QTensor):
            assert _same(got.packed, _chunked(full.packed, spec.packed, mesh)), path
            assert _same(got.scale_m, _chunked(full.scale_m, spec.scale_m, mesh)), path
            assert _same(got.scale_e, full.scale_e), path
            k_ax, n_ax = spec.packed[-2:]
            assert got.shape == (full.k // mesh.axis_size(k_ax or ()), full.n // mesh.axis_size(n_ax or ())), path
            split += got.packed.shape != full.packed.shape
        else:
            assert _same(got, _chunked(full, spec, mesh)), path
            split += got.shape != full.shape
    return split


@pytest.mark.parametrize("name", ["model", "mixed"])
def test_reference_sharded_artifact_read_rank_by_rank(written, name, monkeypatch):
    """On the writer's mesh each rank reads only its own shard files."""
    whole = load_artifact(str(written / f"{name}_whole"), device="cpu")
    loaded = []
    real = ck._np_load
    monkeypatch.setattr(ck, "_np_load", lambda f: loaded.append(os.path.basename(f)) or real(f))
    man = json.loads((written / f"{name}_sharded" / STEP0 / "manifest.json").read_text())
    shard_files = {s["file"] for m in list(man["arrays"].values()) + [a for n in man["nodes"].values()
                   for a in n["arrays"].values()] if "shards" in m for s in m["shards"]}
    assert shard_files
    seen = set()
    for rank in range(4):
        mesh = Mesh.local(DP2_EP2, rank)
        loaded.clear()
        art = load_artifact(str(written / f"{name}_sharded"), mesh=mesh, device="cpu")
        assert _check_local(art.params, whole.params, art.shardings, mesh) > 0
        mine = {f for f in loaded if ".shard" in f}
        assert mine and len(mine) < len(shard_files)  # its own shards, never the others'
        seen |= mine
    assert seen == shard_files


@pytest.mark.parametrize("name", ["model", "mixed"])
def test_reference_sharded_artifact_elastic_and_joined(written, name):
    whole = load_artifact(str(written / f"{name}_whole"), device="cpu")
    for rank in range(4):  # another mesh: the joined payloads sliced
        mesh = Mesh.local({"data": 1, "model": 4}, rank)
        art = load_artifact(str(written / f"{name}_sharded"), mesh=mesh, device="cpu")
        assert _check_local(art.params, whole.params, art.shardings, mesh) > 0
    joined = load_artifact(str(written / f"{name}_sharded"), device="cpu")
    for (path, a), (_, b) in zip(_leaves(joined.params), _leaves(whole.params)):
        if isinstance(a, QTensor):
            assert all(_same(getattr(a, f), getattr(b, f)) for f in ("packed", "scale_m", "scale_e")), path
        else:
            assert _same(a, b), path


def _files(d):
    return {f: hashlib.sha256((d / f).read_bytes()).hexdigest() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", ["model", "mixed"])
def test_port_sharded_write_is_the_reference_byte_for_byte(written, name, tmp_path):
    """The port writes the whole tree it read on one process under the
    same mesh's rules: the same shard files, bytes and manifest."""
    whole = load_artifact(str(written / f"{name}_whole"), device="cpu")
    save_artifact(str(tmp_path), whole.params, whole.plan, extra=whole.extra, mesh=DP2_EP2)
    got, want = _files(tmp_path / STEP0), _files(written / f"{name}_sharded" / STEP0)
    assert any(".shard" in f for f in got)
    assert got == want
    if name == "mixed":  # the reference's mesh-free join cannot cast its own '<V2' bfloat16 shards (Queue C18)
        for d in (tmp_path, written / "mixed_sharded"):
            with pytest.raises(ValueError, match="No cast function"):
                jload_artifact(str(d))
        return
    # the reference reads the port's write without a mesh
    jart = jload_artifact(str(tmp_path))
    jwhole = jload_artifact(str(written / f"{name}_whole"))
    la, lb = jax.tree_util.tree_leaves(jart.params), jax.tree_util.tree_leaves(jwhole.params)
    assert len(la) == len(lb) and all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(la, lb))


def test_sharded_write_of_a_per_layer_tree(written, tmp_path):
    """A per-layer (list) tree, as the port serves it, writes the stacked
    artifact's bytes: ``stacked_shapes`` gives the rules the stacked view."""
    from repro_torch.models import load_servable, save_servable

    api, qparams, art = load_servable(str(written / "model_whole"), device="cpu")
    assert isinstance(qparams["blocks"], list)
    shapes = ck.stacked_shapes(qparams)
    assert shapes["blocks"]["moe"]["experts"]["gate"]["w"].packed.shape[0] == len(qparams["blocks"])
    save_servable(str(tmp_path), api, qparams, art.plan, mesh=DP2_EP2)
    assert _files(tmp_path / STEP0) == _files(written / "model_sharded" / STEP0)
    specs = rules.qtensor_shardings(ck.tree_shapes(json.loads((tmp_path / STEP0 / "manifest.json").read_text())),
                                    DP2_EP2)
    assert specs["blocks"]["moe"]["experts"]["gate"]["w"].packed == (None, "model", None, None)  # EP


@pytest.mark.parametrize("fault", ["corrupt", "missing"])
def test_bad_shard_fails_closed(written, fault, tmp_path):
    import shutil

    d = tmp_path / "art"
    shutil.copytree(written / "model_sharded", d)
    victim = sorted(f for f in os.listdir(d / STEP0) if f.endswith(".shard1.npy"))[0]
    if fault == "corrupt":
        (d / STEP0 / victim).write_bytes(b"junk")
    else:
        os.remove(d / STEP0 / victim)
    with pytest.raises(IOError, match="no intact quantized artifact"):
        load_artifact(str(d), mesh=Mesh.local(DP2_EP2, 1), device="cpu")
    with pytest.raises(IOError, match="no intact quantized artifact"):
        load_artifact(str(d), device="cpu")
