"""Sharding rules: path pattern -> partition spec over a mesh (counterpart
of ``repro/parallel/sharding.py``, both modes, rule for rule).

A spec is a tuple with one entry a dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (the batch axes ``("pod", "data")``),
as the reference's ``PartitionSpec`` holds them.  The rules are pure shape
logic over a mesh's ordered axis -> size mapping (``mesh_sizes``): a plain
dict (a shape-only mesh, all a single-process artifact writer needs), a
live ``collectives.Mesh`` or a torch ``DeviceMesh``.  Leaves are anything
with a ``shape`` (tensors, ``meta`` tensors from ``checkpoint.tree_shapes``)
and QTensors.

  * mode="train": 2-D FSDP x TP: projections shard their contraction dim
    over 'data' and their output dim over 'model' (qkv / up N-sharded,
    wo / down K-sharded); optimizer moments inherit the param's spec.
  * mode="serve": TP over 'model' only, weights replicated over 'data'.

Every assignment is divisibility-checked and falls back to replication.
An expert stack shards its expert axis over 'model' when it divides (EP),
and its inner dims then stay whole.  A QTensor is decided once on its
logical (stack..., K, N) shape: the packed payload and the scale table
take that spec, a K assignment must also divide the packed (K / words) and
scale-table (K / group) rows, and the shared exponent replicates
(``qtensor_field_shardings``: the reference's on-disk layout; an expert
site's (E,) exponents follow its experts only when the port places the
site on its ranks, ``models/spmd.py``).

The reference's model code is mesh-agnostic and XLA places its
collectives from ``constrain`` hints.  The port has no partitioner:
``constrain_spec`` keeps the hint's layout choice as a function returning
the spec, and the ambient mesh (``set_activation_mesh``, scoped by the
engines per dispatch) carries the live mesh and its site layouts to the
model code, which places its collectives itself (``models/spmd.py``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Optional, Tuple

from repro_torch.core.quantizer import QTensor

Spec = Tuple[Any, ...]

# projection name -> (contraction-dim role, output-dim role)
_N_SHARDED = ("wq", "wk", "wv", "up", "gate", "in_proj", "bc_proj", "dt_proj", "lm_head")
_K_SHARDED = ("wo", "down", "out_proj", "x_proj")


def mesh_sizes(mesh) -> Dict[str, int]:
    """Ordered axis -> size of ``mesh``: a mapping, an object whose
    ``shape`` is one (``collectives.Mesh``), or a torch ``DeviceMesh``."""
    if isinstance(mesh, dict):
        return mesh
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    raise TypeError(f"not a mesh: {mesh!r}")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def _fit(mesh, dim: int, axis: Optional[str]) -> Optional[str]:
    """``axis`` if it exists and divides ``dim``, else None (replicate)."""
    sizes = mesh_sizes(mesh)
    if axis is None or axis not in sizes:
        return None
    return axis if dim % sizes[axis] == 0 else None


def _fit_all(mesh, dims, axis: Optional[str]) -> Optional[str]:
    """``axis`` if it divides EVERY dim in ``dims`` (a logical dim plus its
    packed and scale-table projections), else None: the QTensor fields fall
    back to replication together."""
    sizes = mesh_sizes(mesh)
    if axis is None or axis not in sizes:
        return None
    a = sizes[axis]
    return axis if all(d % a == 0 for d in dims) else None


def _name_hit(path: str, names) -> bool:
    return any(re.search(rf"(^|/){n}(/|$)", path) for n in names)


def _proj_spec(path: str, shape, mesh, mode: str, k_dims=None) -> Spec:
    """Spec of a projection leaf (``w``, ``packed`` or ``scale_m``): the last
    two dims are (K-like, N), leading dims layer / expert stacks.
    ``k_dims``: extra dims that must also divide for a K assignment."""
    k_dim, n_dim = shape[-2], shape[-1]
    tp_on_k = _name_hit(path, _K_SHARDED)
    fsdp = None if mode == "serve" else "data"
    k_all = (k_dim,) + tuple(k_dims or ())
    if tp_on_k:
        k_ax, n_ax = _fit_all(mesh, k_all, "model"), _fit(mesh, n_dim, fsdp)
    else:
        k_ax, n_ax = _fit_all(mesh, k_all, fsdp), _fit(mesh, n_dim, "model")
    lead: list = [None] * (len(shape) - 2)
    if "experts" in path and len(shape) >= 3:  # EP: the expert axis over 'model'
        ep = _fit(mesh, shape[-3], "model")
        if ep is not None:
            lead[-1] = ep
            k_ax = None if k_ax == "model" else k_ax
            n_ax = None if n_ax == "model" else n_ax
    return (*lead, k_ax, n_ax)


def _qt_logical_shape(qt: QTensor) -> Tuple[int, ...]:
    """The stack dims of the packed payload + the logical (K, N)."""
    return tuple(qt.packed.shape[:-2]) + tuple(qt.shape)


def _qt_words_per_k(qt: QTensor) -> int:
    """K rows a packed row (16 ternary, 8 int4 / nf4, 1 int8 / mx)."""
    return max(1, qt.k // qt.packed.shape[-2])


def qtensor_spec(path: str, qt: QTensor, mesh, mode: str) -> Spec:
    """Spec of a QTensor's logical weight: decided on (stack..., K, N), a K
    assignment also dividing the packed and the scale-table rows."""
    k_dims = (qt.k // _qt_words_per_k(qt), qt.k // qt.group_size)
    return _proj_spec(path, _qt_logical_shape(qt), mesh, mode, k_dims=k_dims)


class FieldSpecs(NamedTuple):
    """Per-field specs of one QTensor (the reference's QTensor of
    NamedShardings): the payload and the scale table share the logical
    spec, the shared exponent replicates."""

    packed: Spec
    scale_m: Spec
    scale_e: Spec


def qtensor_field_shardings(path: str, qt: QTensor, mesh, mode: str) -> FieldSpecs:
    spec = qtensor_spec(path, qt, mesh, mode)
    return FieldSpecs(packed=spec, scale_m=spec, scale_e=())


def param_spec(path: str, leaf, mesh, mode: str) -> Spec:
    if isinstance(leaf, QTensor):
        return qtensor_spec(path, leaf, mesh, mode)
    shape = _shape(leaf)
    if re.search(r"(^|/)(table)$", path):  # the embedding (V, d): vocab over 'model'
        return (_fit(mesh, shape[0], "model"), _fit(mesh, shape[1], "data") if mode == "train" else None)
    if re.search(r"(^|/)(enc_pos|dec_pos)$", path):
        return (None, None)
    if path.endswith(("/w", "/packed", "/scale_m")) and len(shape) >= 2:
        return _proj_spec(path, shape, mesh, mode)
    if path.endswith("/scale_e") or len(shape) == 0:
        return ()
    return (None,) * len(shape)


def map_with_path(fn, tree, path: str = ""):
    """``tree`` with ``fn(path, leaf)`` at every leaf: dict keys joined by
    '/', a list's items (per-layer trees) under the list's own path, a
    QTensor one leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path) for v in tree)
    if tree is None:
        return None
    return fn(path, tree)


def flat_specs(spec_tree: Any, path: str = "", out=None) -> Dict[str, Any]:
    """path -> spec (or ``FieldSpecs``) of a spec tree; a list's items (per
    layer) share their list's path."""
    out = {} if out is None else out
    if isinstance(spec_tree, dict):
        for k, v in spec_tree.items():
            flat_specs(v, f"{path}/{k}" if path else str(k), out)
    elif isinstance(spec_tree, list):
        for v in spec_tree:
            flat_specs(v, path, out)
    else:
        out[path] = spec_tree
    return out


def param_shardings(params_shapes: Any, mesh, mode: str = "train"):
    """The spec tree of ``params_shapes``; a QTensor's is its ``FieldSpecs``."""
    def spec(path, leaf):
        if isinstance(leaf, QTensor):
            return qtensor_field_shardings(path, leaf, mesh, mode)
        return param_spec(path, leaf, mesh, mode)

    return map_with_path(spec, params_shapes)


def qtensor_shardings(qparams: Any, mesh, plan: Any = None, mode: str = "serve"):
    """The serving face of ``param_shardings`` (``plan`` is accepted for
    per-site overrides, as the reference's; the rules need none)."""
    del plan
    return param_shardings(qparams, mesh, mode)


class _ShapeOf:
    """A shape stand-in for the rules (the reference's ShapeDtypeStruct)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def opt_shardings(opt_shapes: Any, mesh, mode: str = "train"):
    """Optimizer state: moments inherit their param's spec (paths
    ``m/<param>/q``, ``m/<param>/e`` or ``m/<param>``), a per-row exponent
    drops the last axis, the step counter replicates."""
    def spec(path, leaf):
        if path == "step":
            return ()
        core = "/".join(path.split("/")[1:])
        if core.endswith("/q"):
            return param_spec(core[:-2], leaf, mesh, mode)
        if core.endswith("/e"):
            nd = len(_shape(leaf))
            base = param_spec(core[:-2], _ShapeOf(_shape(leaf)[:-1] + (1,)), mesh, mode)
            return tuple(list(base)[: nd - 1] + [None])
        return param_spec(core, leaf, mesh, mode)

    return map_with_path(spec, opt_shapes)


# ---------------------------------------------------------------------------
# The ambient mesh and activation layouts
# ---------------------------------------------------------------------------
_ACT_MESH: list = [None]

# flash-decoding-style sequence sharding of GQA caches whose kv-head count
# does not divide the TP width (the reference's Perf iteration C4 toggle)
KV_SEQ_SHARD: list = [True]


def set_activation_mesh(mesh) -> None:
    """Install (or clear, ``None``) the ambient mesh the model code reads."""
    _ACT_MESH[0] = mesh


def activation_mesh():
    return _ACT_MESH[0]


def constrain_spec(shape, logical_axes, mesh=None) -> Optional[Spec]:
    """The layout the reference's ``constrain`` pins for an activation of
    ``shape`` under ``logical_axes`` ("batch" -> pod + data; "seq" /
    "feat" / "expert" / "heads" -> model; axes that do not divide
    replicate), or None without a mesh (no constraint)."""
    mesh = _ACT_MESH[0] if mesh is None else mesh
    if mesh is None:
        return None
    sizes = mesh_sizes(mesh)
    names = []
    for dim, ax in zip(shape, logical_axes):
        if ax == "batch":
            cand = batch_axes(mesh)
            if cand is not None and dim % _product(sizes, cand):
                cand = None
            names.append(cand)
        elif ax in ("seq", "feat", "expert", "heads"):
            names.append(_fit(mesh, dim, "model"))
        else:
            names.append(None)
    names += [None] * (len(shape) - len(names))
    return tuple(names)


# ---------------------------------------------------------------------------
# Data and cache layouts
# ---------------------------------------------------------------------------
def _product(sizes, axes) -> int:
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def batch_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The logical batch axis: every data-parallel mesh axis."""
    sizes = mesh_sizes(mesh)
    names = [n for n in ("pod", "data") if n in sizes]
    return tuple(names) if names else None


def batch_shardings(batch_shapes: Any, mesh):
    """The leading (batch) axis of every input over pod + data."""
    baxes, sizes = batch_axes(mesh), mesh_sizes(mesh)

    def spec(path, leaf):
        shape = _shape(leaf)
        if path.endswith("positions") and len(shape) == 3:  # (3, B, S)
            return (None, baxes, None)
        if not shape:
            return ()
        ax = baxes if baxes is not None and shape[0] % _product(sizes, baxes) == 0 else None
        return (ax, *([None] * (len(shape) - 1)))

    return map_with_path(spec, batch_shapes)


def cache_shardings(cache_shapes: Any, mesh):
    """KV caches (L, B, S, Kh, hd) and SSM states (L, B, ...): batch over pod
    + data, kv heads over 'model' when they divide; a GQA cache whose heads
    do not divide shards its sequence over 'model' (``KV_SEQ_SHARD``)."""
    baxes, sizes = batch_axes(mesh), mesh_sizes(mesh)

    def divisible(dim):
        return baxes is not None and dim % _product(sizes, baxes) == 0

    def spec(path, leaf):
        shape = _shape(leaf)
        if path.endswith("enc_out") and len(shape) == 3:  # (B, T, d)
            return (baxes if divisible(shape[0]) else None, None, None)
        if path.endswith(("ke", "ve")) and len(shape) == 5:  # exponent planes follow batch + kv heads
            return (None, baxes if divisible(shape[1]) else None, None, _fit(mesh, shape[3], "model"), None)
        if len(shape) == 5:  # (L, B, S, Kh, hd)
            bax = baxes if divisible(shape[1]) else None
            sax = None if bax else (baxes if divisible(shape[2]) else None)  # batch 1: the sequence over data
            kh = _fit(mesh, shape[3], "model")
            s_model = _fit(mesh, shape[2], "model") if KV_SEQ_SHARD[0] and kh is None and sax is None else None
            hd = None if (kh or s_model) else _fit(mesh, shape[4], "model")
            return (None, bax, s_model or sax, kh, hd)
        if len(shape) >= 2:  # stacked SSM states (L, B, ...): the feature axis over 'model'
            rest = [None] * (len(shape) - 2)
            if len(shape) >= 3:
                rest[0] = _fit(mesh, shape[2], "model")
            return (None, baxes if divisible(shape[1]) else None, *rest)
        return (None,) * len(shape)

    return map_with_path(spec, cache_shapes)
