"""The port's sharding rules against the reference's, spec for spec, on
shape-only meshes: ``jax.sharding.AbstractMesh(sizes, names)`` for the
reference, the same axis -> size mapping for the port.  Parameter trees
of every weight format (QTensors of ternary, int4, nf4, int8 and mx with
K / N / packed-row divisibility fallbacks, expert stacks under EP), float
trees in both modes, caches (kv_int8 / kv_mx exponent planes, the
sequence-sharded case), batches, optimizer trees, ``constrain``'s layout,
``mesh_spec_sizes`` and the EP divisibility rules."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.core.quantizer import QTensor as JQTensor
from repro.launch import mesh as jmesh
from repro.models import moe as jmoe
from repro.parallel import sharding as jrules
from repro.quant import backends as jbackends
from repro_torch.core.quantizer import QTensor
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.parallel import sharding as rules
from repro_torch.quant import backends as tbackends

MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["dp2_tp2", "dp1_tp4", "dp4_tp1", "pod2_dp2_tp2"]
PER_WORD = {"ternary": 16, "int4": 8, "nf4": 8, "int8": 1, "mx": 1}
BITS = {"ternary": 2, "int4": 4, "nf4": 4, "int8": 8, "mx": 8}
L = 3


def _meshes(sizes, names):
    return AbstractMesh(sizes, names), dict(zip(names, sizes))


def _norm(spec):
    """A spec as a tuple of (tuple of axis names | None) per dim."""
    return tuple(None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec)


class _Leaf:
    """A shape description both packages build their leaves from."""

    def __init__(self, shape, dtype="float32"):
        self.shape, self.dtype = tuple(shape), dtype

    def jax(self):
        return jax.ShapeDtypeStruct(self.shape, jnp.dtype(self.dtype))

    def torch(self):
        return torch.empty(self.shape, dtype=getattr(torch, self.dtype), device="meta")


class _QLeaf:
    def __init__(self, lead, k, n, fmt, group):
        self.lead, self.k, self.n, self.fmt, self.group = tuple(lead), k, n, fmt, group

    def _fields(self):
        rows = self.k // PER_WORD[self.fmt]
        packed_dtype = "uint32" if PER_WORD[self.fmt] > 1 else "int8"
        return (_Leaf(self.lead + (rows, self.n), packed_dtype), _Leaf(self.lead + (self.k // self.group, self.n), "int8"),
                _Leaf(self.lead, "int32"))

    def jax(self):
        p, s, e = self._fields()
        return JQTensor(p.jax(), s.jax(), e.jax(), bits=BITS[self.fmt], group_size=self.group,
                        shape=(self.k, self.n), fmt=self.fmt)

    def torch(self):
        p, s, e = self._fields()
        p = _Leaf(p.shape, "int32" if p.dtype == "uint32" else p.dtype)
        return QTensor(p.torch(), s.torch(), e.torch(), bits=BITS[self.fmt], group_size=self.group,
                       shape=(self.k, self.n), fmt=self.fmt)


def _param_tree(quantized: bool):
    """A stacked model tree with every rule's paths: projections of both
    roles at dims that divide and that do not (K 48: 3 ternary words; N 6;
    K 40 at group 8), expert stacks of 4, 6 and 8 experts, the router, the
    embedding, positional tables, vectors, the SSM projections and a scalar."""
    fmts = ("ternary", "int4", "nf4", "int8", "mx")

    def proj(k, n, i, lead=(L,)):
        fmt = fmts[i % len(fmts)]
        group = 32 if fmt == "mx" else (8 if k % 16 else 16)
        return _QLeaf(lead, k, n, fmt, group) if quantized else _Leaf(lead + (k, n))

    sites = {"wq": (64, 128), "wk": (64, 6), "wv": (48, 64), "wo": (128, 64)}
    attn = {name: {"w": proj(k, n, i)} for i, (name, (k, n)) in enumerate(sites.items())}
    attn["wq"]["b"] = _Leaf((L, 128))
    attn["q_norm"] = {"scale": _Leaf((L, 16))}
    mlp = {"gate": {"w": proj(64, 96, 1)}, "up": {"w": proj(64, 40, 2)}, "down": {"w": proj(96, 64, 3)}}
    experts = {"gate": {"w": proj(64, 96, 0, (L, 4))}, "up": {"w": proj(64, 96, 4, (L, 6))},
               "down": {"w": proj(96, 64, 2, (L, 8))}}
    mamba = {name: {"w": proj(k, n, i)} for i, (name, (k, n)) in enumerate(
        {"in_proj": (64, 256), "x_proj": (128, 40), "dt_proj": (8, 128), "out_proj": (128, 64),
         "bc_proj": (64, 32)}.items())}
    mamba["conv"] = _Leaf((L, 4, 128))
    mamba["A_log"] = _Leaf((L, 128, 16))
    return {
        "embed": {"table": _Leaf((256, 64))},
        "blocks": {"attn": attn, "mlp": mlp, "ln1": {"scale": _Leaf((L, 64))},
                   "moe": {"router": {"w": proj(64, 4, 3)}, "experts": experts}, "mamba": mamba},
        "final_norm": {"scale": _Leaf((64,))},
        "lm_head": {"w": proj(64, 256, 0, ())},
        "enc_pos": _Leaf((30, 64)), "dec_pos": _Leaf((12, 64)),
        "step_scale": _Leaf(()),
    }


def _build(tree, lib):
    if isinstance(tree, dict):
        return {k: _build(v, lib) for k, v in tree.items()}
    return getattr(tree, lib)()


def _flat_reference(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JQTensor))[0]:
        name = "/".join(str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", "")))) for e in path)
        if isinstance(leaf, JQTensor):
            out[name] = tuple(_norm(s.spec) for s in (leaf.packed, leaf.scale_m, leaf.scale_e))
        else:
            out[name] = _norm(leaf.spec)
    return out


def _flat_port(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, rules.FieldSpecs):
        return {path: tuple(_norm(s) for s in tree)}
    return {path: _norm(tree)}


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("quantized", [True, False], ids=["qtensors", "float"])
@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
def test_param_shardings_equal_reference(sizes, names, quantized, mode):
    jm, tm = _meshes(sizes, names)
    desc = _param_tree(quantized)
    want = _flat_reference(jrules.param_shardings(_build(desc, "jax"), jm, mode))
    got = _flat_port(rules.param_shardings(_build(desc, "torch"), tm, mode))
    assert got == want
    if mode == "serve":  # the serving face, as the artifact writer calls it
        assert _flat_port(rules.qtensor_shardings(_build(desc, "torch"), tm, None)) == _flat_reference(
            jrules.qtensor_shardings(_build(desc, "jax"), jm, None))
    if quantized and sizes[-1] > 1:  # the cases reach the rules' branches: EP, K / N on model, fallbacks
        packed = [v[0] for v in got.values() if len(v) == 3 and v[2] == ()]  # the QTensors' payload specs
        assert any(len(p) == 4 and p[1] == ("model",) for p in packed)  # an expert stack under EP
        if sizes[-1] == 4:
            assert any(len(p) == 4 and p[1] is None for p in packed)  # 6 experts over 4: not EP
        if mode == "serve":
            assert any(p[-2:] == (("model",), None) for p in packed) and any(p[-2:] == (None, ("model",)) for p in packed)
            assert any(p[-2:] == (None, None) for p in packed)  # a divisibility fallback


def test_per_layer_specs_drop_the_stack_axis():
    """A per-layer tree (the port's lists of blocks) takes the stacked
    tree's specs without their layer entry, as ``spmd.layer_specs``
    derives them from an artifact's stacked spec tree."""
    from repro_torch.models import spmd

    tm = {"data": 2, "model": 2}
    desc = _param_tree(True)
    stacked = rules.param_shardings(_build(desc, "torch"), tm, "serve")
    per_layer = rules.param_shardings({"blocks": [_build(_strip(desc["blocks"]), "torch")] * 2}, tm, "serve")
    assert isinstance(per_layer["blocks"], list) and len(per_layer["blocks"]) == 2
    got = _flat_port(per_layer["blocks"][1], "blocks")
    want = {path: spec for path, spec in _flat_port(spmd.layer_specs(stacked)).items() if path.startswith("blocks/")}
    assert got == want and len(got) > 20
    for path, spec in _flat_port(stacked).items():
        if path.startswith("blocks/"):
            qtensor = len(spec) == 3 and spec[2] == ()
            assert got[path] == ((spec[0][1:], spec[1][1:], ()) if qtensor else spec[1:])


def _strip(desc):
    """A stacked description without its layer axis."""
    if isinstance(desc, dict):
        return {k: _strip(v) for k, v in desc.items()}
    if isinstance(desc, _QLeaf):
        return _QLeaf(desc.lead[1:], desc.k, desc.n, desc.fmt, desc.group)
    return _Leaf(desc.shape[1:], desc.dtype)


def _cache_tree():
    return {
        "kv": {"k": _Leaf((L, 4, 64, 2, 16), "bfloat16"), "v": _Leaf((L, 4, 64, 2, 16), "bfloat16")},
        "kv_int8": {"k": _Leaf((L, 4, 64, 4, 16), "int8"), "ke": _Leaf((L, 4, 64, 4, 1), "int8"),
                    "ve": _Leaf((L, 4, 64, 4, 1), "int8")},
        "kv_mx": {"k": _Leaf((L, 2, 64, 8, 8), "int8"), "ke": _Leaf((L, 2, 2, 8, 1), "int8")},
        "one": {"k": _Leaf((L, 1, 64, 1, 16), "bfloat16"), "v": _Leaf((L, 1, 63, 1, 16), "bfloat16")},
        "gqa1": {"k": _Leaf((L, 4, 64, 1, 16), "bfloat16")},
        "odd": {"k": _Leaf((L, 3, 60, 3, 12), "bfloat16")},
        "ssm": {"conv": _Leaf((L, 4, 128, 3)), "ssm": _Leaf((L, 4, 128, 16)), "h": _Leaf((L, 4))},
        "enc_out": _Leaf((4, 30, 64)), "pos": _Leaf((7,)),
    }


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
def test_cache_shardings_equal_reference(sizes, names, seq_shard, monkeypatch):
    jm, tm = _meshes(sizes, names)
    monkeypatch.setattr(jrules, "KV_SEQ_SHARD", [seq_shard])
    monkeypatch.setattr(rules, "KV_SEQ_SHARD", [seq_shard])
    desc = _cache_tree()
    want = _flat_reference(jrules.cache_shardings(_build(desc, "jax"), jm))
    assert _flat_port(rules.cache_shardings(_build(desc, "torch"), tm)) == want
    if seq_shard and sizes[-1] > 1:  # a cache of 1 kv head shards its sequence over 'model'
        assert want["gqa1/k"][2] == ("model",)


@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
def test_batch_and_opt_shardings_equal_reference(sizes, names):
    jm, tm = _meshes(sizes, names)
    batch = {"tokens": _Leaf((8, 16), "int32"), "labels": _Leaf((6, 16), "int32"),
             "positions": _Leaf((3, 8, 16), "int32"), "frames": _Leaf((4, 30, 64)), "n": _Leaf((), "int32")}
    assert _flat_port(rules.batch_shardings(_build(batch, "torch"), tm)) == _flat_reference(
        jrules.batch_shardings(_build(batch, "jax"), jm))
    params = {"blocks/attn/wq/w": (L, 64, 128), "blocks/mlp/down/w": (L, 96, 64), "embed/table": (256, 64),
              "blocks/moe/experts/gate/w": (L, 4, 64, 96), "final_norm/scale": (64,)}
    opt = {"step": _Leaf((), "int32")}
    for moment in ("m", "v"):
        node = opt.setdefault(moment, {})
        for path, shape in params.items():
            leaf = node
            for part in path.split("/")[:-1]:
                leaf = leaf.setdefault(part, {})
            name = path.split("/")[-1]
            if moment == "m" and len(shape) >= 2:
                leaf[name] = {"q": _Leaf(shape, "int8"), "e": _Leaf(shape[:-1] + (1,), "int8")}
            else:
                leaf[name] = _Leaf(shape)
    assert _flat_port(rules.opt_shardings(_build(opt, "torch"), tm)) == _flat_reference(
        jrules.opt_shardings(_build(opt, "jax"), jm))


@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
def test_constrain_layout_equals_reference(sizes, names, monkeypatch):
    jm, tm = _meshes(sizes, names)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s.spec)
    monkeypatch.setattr(jrules, "_ACT_MESH", [jm])
    cases = [((8, 16, 64), ("batch", None, None)), ((4, 8, 64), ("expert", None, None)),
             ((6, 12, 3), (None, "batch", None)), ((8, 64), ("batch", "feat")), ((2, 5, 4, 16), ("batch", "seq", None)), ((2, 5, 4, 16), ("batch", None, "heads")),
             ((8, 16, 64), ("batch",))]
    for shape, axes in cases:
        want = jrules.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), axes)
        assert _norm(rules.constrain_spec(shape, axes, tm)) == _norm(want), (shape, axes)
    assert rules.constrain_spec((8, 4), ("batch", None)) is None  # no ambient mesh: no constraint


@pytest.mark.parametrize("spec", ["dp=2,ep=2", "tp=4", "pod=2,dp=2,ep=2", "data=1,model=8", " dp = 2 , tp=2"])
def test_mesh_spec_sizes_equal_reference(spec):
    assert tmesh.mesh_spec_sizes(spec) == jmesh.mesh_spec_sizes(spec)


@pytest.mark.parametrize("spec", ["dp2", "ep=2,tp=2", "dp=x"])
def test_mesh_spec_errors_equal_reference(spec):
    with pytest.raises(ValueError) as want:
        jmesh.mesh_spec_sizes(spec)
    with pytest.raises(ValueError) as got:
        tmesh.mesh_spec_sizes(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
def test_ep_rules_equal_reference(sizes, names):
    jm, tm = _meshes(sizes, names)
    for e in (4, 6, 8, 128):
        for c in (8, 16, 24, 80):
            cap = jmoe._ep_cap_axes(jm, c)
            assert tmoe._ep_cap_axes(tm, c) == cap
            assert tbackends.ep_divisible(e, c, tm, "model", cap) == jbackends.ep_divisible(e, c, jm, "model", cap)
    assert not tbackends.ep_divisible(8, 8, None)
