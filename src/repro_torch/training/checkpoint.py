"""Step-atomic, sha256-checked checkpoints and packed artifacts, one host
(counterpart of ``repro/training/checkpoint.py``).

The on-disk format is the reference's manifest v2, file for file, so either
package reads what the other wrote:

  * step-atomic: a step is written to ``step_<N>.tmp/`` and published by
    one directory rename; readers never see a partial step.
  * integrity: every payload is one ``.npy`` file named
    ``sha1(path)[:16].npy`` whose sha256 the manifest records; the plan
    rides in ``quant_plan.json``, checksummed under ``quant_plan``.
    ``_verify`` checks everything the manifest references, and
    ``latest_intact`` / ``restore_latest`` fall back to the newest step
    that passes.
  * codecs: leaves that are not plain tensors serialize through a
    registered ``LeafCodec``; the built-in ``qtensor`` codec writes a
    QTensor as its packed words, scale table and exponent plus static
    metadata (bits, group size, logical shape, format tag).

What the port adds to keep the bytes the reference's:

  * layers: the port keeps per-layer blocks as a list of trees, the
    reference stacks them on a leading axis.  A list in a saved tree is
    written stacked -- one payload per leaf path, no layer index in the
    path -- and ``unstack`` (or a template with a list) splits it again.
    Dict keys are visited in sorted order, the reference's flatten order.
  * packed words: the port's int32 bit-views go to disk as uint32, and
    uint32 payloads load back as int32 views (the same bytes).
  * bfloat16: payloads are written as the reference's are (``'<V2'`` in
    the ``.npy`` header, ``"bfloat16"`` in the manifest) and read by the
    manifest's dtype name, without ``ml_dtypes``.  A dtype name the port
    does not know fails the load.

Payload reads retry ``OSError`` with exponential backoff (``_read_retry``;
``io_fault_hook`` injects flakes); integrity failures are never retried.
Training checkpoints: ``None`` leaves (an optimizer moment a leaf does not
have) are no leaves, as in the reference's trees, so ``{"params", "opt"}``
with its ``{"q", "e"}`` DFP-8 moments is written under the reference's
paths and either package restores the other's; ``quant_state`` (a TTQ /
INQ schedule record) rides in the manifest (``load_quant_state``).

Sharded payloads (the reference's manifest-v2 shard layout): ``save(...,
shardings=, mesh=)`` writes every payload a spec splits as one
``<payload>.shard{k}.npy`` a unique shard (replicated axes deduplicated,
in first-seen rank order, row-major over the mesh as jax orders its
devices), each entry with its ``file``, ``sha256`` and ``index`` (the
shard's ``[start, stop)`` per dimension), the payload with its ``shape`` and
``dtype``.  ``restore_tree(..., shardings=, mesh=)`` gives one rank its own
slice of every payload: the shard file whose index is its slice when the
layout matches, else (an elastic restore on another mesh) the shards joined
on the host and sliced.  Without a mesh the shards are joined.  A missing or
corrupt shard, or shards that do not tile their array, fail verification.
``tree_shapes`` describes a checkpoint from its manifest alone (``meta``
tensors), which is what the sharding rules run against before a restore;
``stacked_shapes`` is the same description of an in-memory tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantizer import QTensor
from repro_torch.device import resolve_device
from repro_torch.quant.plan import QuantPlan

PLAN_FILE = "quant_plan.json"

_BF16 = "bfloat16"
_V2 = np.dtype("V2")  # a bfloat16 payload as numpy holds it without ml_dtypes
# payload dtype names the port reads besides bfloat16 (str(numpy dtype))
_NP_DTYPES = ("bool", "int8", "uint8", "int16", "int32", "uint32", "int64", "float16", "float32", "float64")


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


# ---------------------------------------------------------------------------
# Host arrays <-> tensors.
# ---------------------------------------------------------------------------
def _to_numpy(t) -> np.ndarray:
    """A tensor (or array) as the host array the reference would save."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return _BF16 if arr.dtype == _V2 else str(arr.dtype)


def _np_dtype(name: str) -> np.dtype:
    if name == _BF16:
        return _V2
    if name not in _NP_DTYPES:
        raise ValueError(f"payload dtype {name!r} is not one the port reads ({(_BF16,) + _NP_DTYPES})")
    return np.dtype(name)


def _to_torch(arr: np.ndarray, name: str, device: torch.device) -> torch.Tensor:
    """A loaded payload as a tensor, by the manifest's dtype ``name``."""
    want = _np_dtype(name)
    if arr.dtype != want:
        raise ValueError(f"payload holds {arr.dtype}, the manifest says {name!r}")
    arr = np.require(arr, requirements="C")  # (np.ascontiguousarray would make a 0-d payload 1-d)
    if name == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if name == "uint32":  # packed words: the port's int32 bit-view
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


def _save_npy(fpath: str, arr: np.ndarray) -> None:
    arr = np.require(arr, requirements="C")
    with open(fpath, "wb") as f:
        if arr.dtype == _V2:  # the header ml_dtypes' bfloat16 gives np.save
            np.lib.format.write_array_header_1_0(f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
            f.write(arr.tobytes())
        else:
            np.save(f, arr)


# ---------------------------------------------------------------------------
# Stacked layers: a list of per-layer trees is one stacked leaf per path.
# ---------------------------------------------------------------------------
class Stacked(list):
    """The per-layer leaves of one path, saved stacked on a leading axis."""


def _stack(leaf) -> Any:
    if isinstance(leaf, Stacked):
        return torch.stack([torch.as_tensor(x) for x in leaf])
    return leaf


def _flat_with_paths(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the reference's flatten order (sorted dict keys).  A
    QTensor is one leaf; a list of per-layer trees becomes ``Stacked``
    leaves under its own path; ``None`` is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flat_with_paths(tree[key], f"{path}/{key}" if path else str(key))
        return out
    if isinstance(tree, (list, tuple)):
        per_layer = [_flat_with_paths(t, path) for t in tree]
        if not per_layer:
            raise ValueError(f"{path!r}: an empty list of layers")
        names = [n for n, _ in per_layer[0]]
        for layer in per_layer:
            if [n for n, _ in layer] != names or any(isinstance(x, Stacked) for _, x in layer):
                raise ValueError(f"{path!r}: layers must be trees of one structure, not nested lists")
        return [(n, Stacked(layer[i][1] for layer in per_layer)) for i, n in enumerate(names)]
    return [(path, tree)]


def _n_layers(node) -> int:
    if isinstance(node, dict):
        return _n_layers(next(iter(node.values())))
    if isinstance(node, QTensor):
        return node.scale_e.shape[0]
    return node.shape[0]


def _layer(node, i: int):
    """Layer i of a stacked tree, each tensor a copy of its own: a view
    into the stack (``scale_e[i]`` at byte 4 i) would break the kernels'
    16-byte operand alignment."""
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    if isinstance(node, QTensor):
        return dataclasses.replace(node, packed=node.packed[i].clone(), scale_m=node.scale_m[i].clone(),
                                   scale_e=node.scale_e[i].clone())
    return node[i].clone()


def unstack(node) -> List[Any]:
    """A stacked tree (a leading layer axis on every leaf, QTensors with a
    (L,) ``scale_e``) -> the port's list of per-layer trees."""
    return [_layer(node, i) for i in range(_n_layers(node))]


# ---------------------------------------------------------------------------
# Leaf codecs: serialization of leaves that are not plain tensors.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafCodec:
    """``matches(leaf)`` decides whether the codec owns a leaf (or a
    ``Stacked`` list of them); ``encode`` splits it into named host arrays
    (one sha256-checked payload each) plus JSON-safe metadata; ``decode``
    is the inverse, over tensors."""

    name: str
    matches: Callable[[Any], bool]
    encode: Callable[[Any], Tuple[Dict[str, np.ndarray], Dict[str, Any]]]
    decode: Callable[[Dict[str, torch.Tensor], Dict[str, Any]], Any]


_CODECS: Dict[str, LeafCodec] = {}


def register_codec(name: str, *, matches: Callable, encode: Callable, decode: Callable,
                   overwrite: bool = False) -> LeafCodec:
    if name in _CODECS and not overwrite:
        raise ValueError(f"codec {name!r} already registered")
    codec = LeafCodec(name, matches, encode, decode)
    _CODECS[name] = codec
    return codec


def get_codec(name: str) -> LeafCodec:
    try:
        return _CODECS[name]
    except KeyError:
        raise KeyError(f"unknown leaf codec {name!r}; registered: {sorted(_CODECS)}") from None


def _codec_for(leaf: Any) -> Optional[LeafCodec]:
    for codec in _CODECS.values():
        if codec.matches(leaf):
            return codec
    return None


def _is_qtensor(leaf) -> bool:
    if isinstance(leaf, Stacked):
        return all(isinstance(x, QTensor) for x in leaf)
    return isinstance(leaf, QTensor)


def _qt_meta(qt: QTensor) -> Dict[str, Any]:
    return {"bits": qt.bits, "group_size": qt.group_size, "shape": list(qt.shape), "fmt": qt.fmt}


def _qt_encode(leaf) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    qts = list(leaf) if isinstance(leaf, Stacked) else [leaf]
    meta = _qt_meta(qts[0])
    if any(_qt_meta(q) != meta for q in qts):
        raise ValueError(f"stacked QTensors disagree on their metadata: {[_qt_meta(q) for q in qts]}")

    def field(name):
        vals = [getattr(q, name) for q in qts]
        return _to_numpy(_stack(Stacked(vals)) if isinstance(leaf, Stacked) else vals[0])

    packed = field("packed")
    if packed.dtype == np.int32:  # the reference's uint32 words
        packed = packed.view(np.uint32)
    return {"packed": packed, "scale_m": field("scale_m"), "scale_e": field("scale_e")}, meta


def _qt_decode(arrays: Dict[str, torch.Tensor], meta: Dict[str, Any]) -> QTensor:
    return QTensor(arrays["packed"], arrays["scale_m"], arrays["scale_e"], bits=int(meta["bits"]),
                   group_size=int(meta["group_size"]), shape=tuple(meta["shape"]), fmt=meta.get("fmt", ""))


register_codec("qtensor", matches=_is_qtensor, encode=_qt_encode, decode=_qt_decode)


def _payload_name(name: str) -> str:
    return hashlib.sha1(name.encode()).hexdigest()[:16] + ".npy"


# ---------------------------------------------------------------------------
# Transient-IO retry: payload reads (np.load, sha256) retry OSError with
# exponential backoff.  Integrity failures are not OSErrors and are never
# retried: corrupt data fails closed.  ``io_fault_hook`` is the chaos
# harness's injection point (``repro_torch.serving.faults.FlakyIO``).
# ---------------------------------------------------------------------------
IO_RETRIES = 3  # retry attempts after the first failure
IO_BACKOFF_S = 0.05  # first backoff; doubles per retry

_IO_FAULT_HOOK: List[Optional[Callable[[str], None]]] = [None]


def set_io_fault_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install a callable invoked with every payload path about to be read
    (``None`` uninstalls); an ``OSError`` from it models a transient read
    failure that the retry loop must absorb."""
    _IO_FAULT_HOOK[0] = hook


@contextlib.contextmanager
def io_fault_hook(hook: Callable[[str], None]):
    """Scoped ``set_io_fault_hook``."""
    set_io_fault_hook(hook)
    try:
        yield hook
    finally:
        set_io_fault_hook(None)


def _read_retry(read: Callable[[str], Any], fpath: str) -> Any:
    delay = IO_BACKOFF_S
    for attempt in range(IO_RETRIES + 1):
        try:
            if _IO_FAULT_HOOK[0] is not None:
                _IO_FAULT_HOOK[0](fpath)
            return read(fpath)
        except OSError:
            if attempt == IO_RETRIES:
                raise
            time.sleep(delay)
            delay *= 2


def _np_load(fpath: str) -> np.ndarray:
    return _read_retry(np.load, fpath)


def _sha256_once(fpath: str) -> str:
    h = hashlib.sha256()
    with open(fpath, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _file_sha256(fpath: str) -> str:
    return _read_retry(_sha256_once, fpath)


Box = Tuple[Tuple[int, int], ...]


def _shard_indices(spec, shape, sizes: Dict[str, int]) -> List[Box]:
    """The unique shard slices of ``shape`` under ``spec`` in first-seen
    rank order (ranks row-major over ``sizes``)."""
    from repro_torch.parallel.collectives import Mesh

    seen: List[Box] = []
    for rank in range(Mesh.local(sizes).size):
        box = Mesh.local(sizes, rank).box(spec, shape)
        if box not in seen:
            seen.append(box)
    return seen


def _write_payload(d: str, name: str, arr: np.ndarray, spec=None, sizes: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
    """One payload; with a ``spec`` that splits it over ``sizes``, one
    ``.shard{k}.npy`` a unique shard, each with its own sha256."""
    fname = _payload_name(name)
    indices = _shard_indices(spec, arr.shape, sizes) if spec is not None else []
    if len(indices) > 1:
        shards = []
        for k, index in enumerate(indices):
            sname = f"{fname[:-len('.npy')]}.shard{k}.npy"
            spath = os.path.join(d, sname)
            _save_npy(spath, arr[tuple(slice(a, b) for a, b in index)])
            shards.append({"file": sname, "sha256": _file_sha256(spath), "index": [list(p) for p in index]})
        return {"shards": shards, "shape": list(arr.shape), "dtype": _dtype_name(arr)}
    fpath = os.path.join(d, fname)
    _save_npy(fpath, arr)
    return {"file": fname, "sha256": _file_sha256(fpath), "shape": list(arr.shape), "dtype": _dtype_name(arr)}


def _plan_json(plan: Any) -> Optional[str]:
    if plan is None:
        return None
    return plan if isinstance(plan, str) else plan.to_json()


# ---------------------------------------------------------------------------
# Save.
# ---------------------------------------------------------------------------
def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None, plan: Any = None,
         quant_state: Optional[Dict] = None, shardings: Any = None, mesh: Any = None) -> str:
    """Atomically persist ``tree`` (tensors, QTensors, lists of per-layer
    trees) at ``step``; returns the step directory.  Plain leaves go to the
    manifest's ``arrays``, codec leaves to ``nodes``; ``plan`` (a
    ``QuantPlan`` or its JSON) to ``quant_plan.json``; ``quant_state`` (a
    JSON-safe schedule record, ``QuantState.to_meta()``) to the manifest's
    ``quant_state`` section.  ``shardings`` (a spec tree over the stacked
    tree, ``parallel.sharding.qtensor_shardings(stacked_shapes(tree), mesh)``)
    and ``mesh`` (any mesh the rules take) write split payloads as shard
    files."""
    from repro_torch.parallel.sharding import flat_specs, mesh_sizes

    specs = flat_specs(shardings) if shardings is not None else {}
    sizes = mesh_sizes(mesh) if mesh is not None else None
    os.makedirs(ckpt_dir, exist_ok=True)
    final = step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {
        "version": 2, "step": step, "arrays": {}, "nodes": {}, "quant_plan": None, "quant_state": quant_state,
        "extra": extra or {},
    }
    for name, leaf in _flat_with_paths(tree):
        codec = _codec_for(leaf)
        sh = specs.get(name)
        if codec is None:
            manifest["arrays"][name] = _write_payload(tmp, name, _to_numpy(_stack(leaf)), sh, sizes)
        else:
            payloads, meta = codec.encode(leaf)
            manifest["nodes"][name] = {
                "codec": codec.name,
                "meta": meta,
                "arrays": {field: _write_payload(tmp, f"{name}/{field}", arr, getattr(sh, field, None), sizes)
                           for field, arr in payloads.items()},
            }
    blob = _plan_json(plan)
    if blob is not None:
        with open(os.path.join(tmp, PLAN_FILE), "w") as f:
            f.write(blob)
        manifest["quant_plan"] = {"file": PLAN_FILE, "sha256": hashlib.sha256(blob.encode()).hexdigest()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


# ---------------------------------------------------------------------------
# Verification (the integrity gate of restore_latest's fallback).
# ---------------------------------------------------------------------------
def _shards_tile(meta: Dict[str, Any]) -> bool:
    """Do the shard indices tile the full array exactly once?  Per
    dimension the unique intervals must partition [0, dim), and every cell
    of their cross product must be present once: a step missing a host's
    shards fails verification."""
    shape = meta["shape"]
    boxes = {tuple(tuple(p) for p in s["index"]) for s in meta["shards"]}
    if len(boxes) != len(meta["shards"]):
        return False  # a duplicate index
    n_cells = 1
    for d, dim in enumerate(shape):
        ivals = sorted({box[d] for box in boxes})
        pos = 0
        for start, stop in ivals:
            if start != pos or stop <= start:
                return False
            pos = stop
        if pos != dim:
            return False
        n_cells *= len(ivals)
    return len(boxes) == n_cells


def _check_payload(d: str, meta: Dict[str, Any]) -> bool:
    if "shards" in meta:
        if not _shards_tile(meta):
            return False
        return all(_file_sha256(os.path.join(d, s["file"])) == s["sha256"] for s in meta["shards"])
    return _file_sha256(os.path.join(d, meta["file"])) == meta["sha256"]


def _verify(d: str) -> Optional[Dict]:
    """Full integrity check of one step directory -> its manifest, or None.
    Every payload and the plan (checksum and structure: a truncated plan
    must fail, not restore as unquantized) are checked."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        for meta in manifest["arrays"].values():
            if not _check_payload(d, meta):
                return None
        for node in manifest.get("nodes", {}).values():
            if node["codec"] not in _CODECS:
                return None
            for meta in node["arrays"].values():
                if not _check_payload(d, meta):
                    return None
        qp = manifest.get("quant_plan")
        if qp is not None:
            with open(os.path.join(d, qp["file"])) as fh:
                blob = fh.read()
            if hashlib.sha256(blob.encode()).hexdigest() != qp["sha256"]:
                return None
            plan = json.loads(blob)
            if not isinstance(plan, dict) or "sites" not in plan:
                return None
        return manifest
    except (OSError, ValueError, KeyError, TypeError):
        # TypeError: a structurally corrupt manifest (a null entry) falls back like any corruption
        return None


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def latest_intact(ckpt_dir: str) -> Tuple[Optional[int], Optional[Dict]]:
    """(step, verified manifest) of the newest intact step, or (None, None)."""
    for step in reversed(list_steps(ckpt_dir)):
        manifest = _verify(step_dir(ckpt_dir, step))
        if manifest is not None:
            return step, manifest
    return None, None


def latest_intact_step(ckpt_dir: str) -> Optional[int]:
    return latest_intact(ckpt_dir)[0]


# ---------------------------------------------------------------------------
# Restore.
# ---------------------------------------------------------------------------
def _load_payload(d: str, meta: Dict[str, Any], device: torch.device) -> torch.Tensor:
    """One payload as a tensor on ``device``; shard files are joined on the
    host by their ``index``."""
    if "shards" not in meta:
        arr = _np_load(os.path.join(d, meta["file"]))
    else:
        arr = np.empty(tuple(meta["shape"]), _np_dtype(meta["dtype"]))
        for s in meta["shards"]:
            arr[tuple(slice(a, b) for a, b in s["index"])] = _np_load(os.path.join(d, s["file"]))
    return _to_torch(arr, meta["dtype"], device)


def _decode_node(d: str, node: Dict[str, Any], device: torch.device) -> Any:
    codec = get_codec(node["codec"])
    return codec.decode({field: _load_payload(d, meta, device) for field, meta in node["arrays"].items()},
                        node["meta"])


def _insert_by_path(out: Dict[str, Any], name: str, val: Any) -> None:
    node = out
    parts = name.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = val


def _load_local(d: str, meta: Dict[str, Any], spec, mesh, device: torch.device) -> torch.Tensor:
    """This rank's slice of one payload under ``spec``: its own shard file
    when the saved layout has that slice, else the payload joined on the
    host (the elastic restore) and sliced."""
    shape = tuple(meta["shape"])
    box = mesh.box(spec, shape)
    if "shards" in meta:
        for s in meta["shards"]:
            if tuple(tuple(p) for p in s["index"]) == box:
                return _to_torch(_np_load(os.path.join(d, s["file"])), meta["dtype"], device)
    whole = _load_payload(d, meta, torch.device("cpu"))
    return whole[tuple(slice(a, b) for a, b in box)].contiguous().to(device)


def _decode_local(d: str, node: Dict[str, Any], specs, mesh, device: torch.device) -> Any:
    """A codec node's fields, each this rank's slice under ``specs`` (its
    per-field specs); a QTensor's logical shape becomes its slice's."""
    codec = get_codec(node["codec"])
    fields = {f: _load_local(d, meta, getattr(specs, f), mesh, device) for f, meta in node["arrays"].items()}
    val = codec.decode(fields, node["meta"])
    if isinstance(val, QTensor):
        k_ax, n_ax = specs.packed[-2:]
        val = dataclasses.replace(val, shape=(val.shape[0] // mesh.axis_size(k_ax), val.shape[1] // mesh.axis_size(n_ax)))
    return val


def restore_tree(d: str, manifest: Optional[Dict] = None, device=None, shardings: Any = None,
                 mesh: Any = None) -> Dict[str, Any]:
    """Template-free restore of one step directory: the nested dict of the
    manifest's paths, stacked layers as saved (``unstack`` splits them),
    QTensors still packed.  ``manifest``: an already-verified one (skips
    re-hashing).  ``shardings`` (a spec tree over ``tree_shapes``) and
    ``mesh`` (a ``collectives.Mesh``, live or ``Mesh.local``): every leaf
    is this rank's slice."""
    dev = resolve_device(device)
    if manifest is None:
        manifest = _verify(d)
    if manifest is None:
        raise IOError(f"checkpoint {d} missing or corrupt")
    from repro_torch.parallel.sharding import flat_specs

    specs = flat_specs(shardings) if shardings is not None else {}
    out: Dict[str, Any] = {}
    for name, meta in manifest["arrays"].items():
        sh = specs.get(name)
        _insert_by_path(out, name, _load_payload(d, meta, dev) if sh is None else _load_local(d, meta, sh, mesh, dev))
    for name, node in manifest.get("nodes", {}).items():
        sh = specs.get(name)
        _insert_by_path(out, name, _decode_node(d, node, dev) if sh is None else _decode_local(d, node, sh, mesh, dev))
    return out


def _meta_tensor(shape, dtype_name: str) -> torch.Tensor:
    """A shape-only tensor (``meta`` device) of a manifest dtype name."""
    arr = np.empty(0, _np_dtype(dtype_name))
    return torch.empty(tuple(shape), dtype=_to_torch(arr, dtype_name, torch.device("cpu")).dtype, device="meta")


def tree_shapes(manifest: Dict[str, Any]) -> Dict[str, Any]:
    """The abstract tree of one checkpoint from its manifest alone, no
    payload read: ``meta`` tensors for plain arrays, QTensors over ``meta``
    fields (stacked layers as saved).  What the sharding rules run against
    before a mesh-aware restore."""
    out: Dict[str, Any] = {}
    for name, meta in manifest["arrays"].items():
        _insert_by_path(out, name, _meta_tensor(meta["shape"], meta["dtype"]))
    for name, node in manifest.get("nodes", {}).items():
        fields = {f: _meta_tensor(m["shape"], m["dtype"]) for f, m in node["arrays"].items()}
        _insert_by_path(out, name, get_codec(node["codec"]).decode(fields, node["meta"]))
    return out


def _meta_like(t, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    return torch.empty(lead + tuple(t.shape), dtype=t.dtype, device="meta")


def stacked_shapes(tree: Any) -> Dict[str, Any]:
    """The abstract tree ``save`` writes for ``tree`` (lists of per-layer
    trees stacked on a leading axis), as ``tree_shapes`` reads it back."""
    out: Dict[str, Any] = {}
    for name, leaf in _flat_with_paths(tree):
        first = leaf[0] if isinstance(leaf, Stacked) else leaf
        lead = (len(leaf),) if isinstance(leaf, Stacked) else ()
        if isinstance(first, QTensor):
            val = dataclasses.replace(first, packed=_meta_like(first.packed, lead),
                                      scale_m=_meta_like(first.scale_m, lead), scale_e=_meta_like(first.scale_e, lead))
        else:
            val = _meta_like(torch.as_tensor(first), lead)
        _insert_by_path(out, name, val)
    return out


def _fill(node, path: str, flat: Dict[str, Any], index: Optional[int] = None):
    """``node``'s structure over the restored values of ``flat``; a list
    takes layer i of each stacked value."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _fill(v, f"{path}/{k}" if path else str(k), flat, index) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_fill(v, path, flat, i) for i, v in enumerate(node)]
    val = flat[path]
    return val if index is None else _layer(val, index)


def restore(ckpt_dir: str, step: int, template: Any, manifest: Optional[Dict] = None, device=None) -> Any:
    """Fill ``template`` (a tree of tensors, QTensors and per-layer lists)
    from disk: shapes are checked, plain tensors take the template's dtype."""
    dev = resolve_device(device)
    d = step_dir(ckpt_dir, step)
    if manifest is None:
        manifest = _verify(d)
    if manifest is None:
        raise IOError(f"checkpoint {d} missing or corrupt")
    nodes = manifest.get("nodes", {})
    flat: Dict[str, Any] = {}
    for name, leaf in _flat_with_paths(template):
        if name in nodes:
            flat[name] = _decode_node(d, nodes[name], dev)
            continue
        meta = manifest["arrays"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing array {name!r}")
        val = _load_payload(d, meta, dev)
        like = leaf[0] if isinstance(leaf, Stacked) else leaf
        want = ((len(leaf),) if isinstance(leaf, Stacked) else ()) + tuple(like.shape)
        if tuple(val.shape) != want:
            raise ValueError(f"{name}: shape {tuple(val.shape)} != template {want}")
        flat[name] = val.to(like.dtype)
    return _fill(template, "", flat)


def load_plan(d: str, manifest: Optional[Dict] = None) -> Optional[QuantPlan]:
    """The step's compiled ``QuantPlan``, or None if it carries none."""
    if manifest is None:
        manifest = _verify(d)
    if manifest is None:
        raise IOError(f"checkpoint {d} missing or corrupt")
    qp = manifest.get("quant_plan")
    if qp is None:
        return None
    with open(os.path.join(d, qp["file"])) as f:
        return QuantPlan.from_json(f.read())


def load_quant_state(d: str, manifest: Optional[Dict] = None) -> Optional[Dict]:
    """The step's quantization-schedule record (the manifest's
    ``quant_state``; None if it carries none), as the raw dict:
    ``QuantState.from_meta`` rebuilds it."""
    if manifest is None:
        manifest = _verify(d)
    if manifest is None:
        raise IOError(f"checkpoint {d} missing or corrupt")
    return manifest.get("quant_state")


def load_manifest(d: str) -> Dict[str, Any]:
    """Verified manifest of one step directory (raises if corrupt)."""
    manifest = _verify(d)
    if manifest is None:
        raise IOError(f"checkpoint {d} missing or corrupt")
    return manifest


def restore_latest(ckpt_dir: str, template: Any, device=None) -> Tuple[Optional[int], Any]:
    """The newest intact step (corruption falls back to older ones)."""
    step, manifest = latest_intact(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, template, manifest=manifest, device=device)


def dir_bytes(path: str) -> int:
    """Total on-disk size of a checkpoint or artifact directory."""
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files)


def retain(ckpt_dir: str, keep: int = 3) -> None:
    for step in list_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(step_dir(ckpt_dir, step), ignore_errors=True)
