"""Explicit SPMD serving of the dense and MoE families over a mesh.

The reference's model code does not know about its mesh: XLA's
partitioner places the collectives from sharding hints, and only its MoE
FFN is an explicit ``shard_map``.  PyTorch has no partitioner that sees
through the port's kernels, so the port runs one process a rank, each
holding only its own shards as ``parallel/sharding.py``'s serving rules
assign them, and the model places its collectives itself:

  * a site sharded on N (``wq``, ``wk``, ``wv``, ``gate``, ``up``,
    ``lm_head``, the router): the rank launches on its own columns (its
    bias slice in the epilogue) and all-gathers them along N.  A column's
    sum does not depend on N, so this is bit for bit the whole site.  A
    site whose columns would split below 4 a rank (the kernels take N % 4
    == 0: grok-1's router at 4 ranks) is gathered once, when the params
    are placed, and launched whole;
  * a site sharded on K (``wo``, ``down``): per-rank partial sums would
    reassociate the float32 accumulation, so the site's K shards (packed
    words and scale rows) are all-gathered and the whole site launches on
    the replicated input;
  * the embedding (vocab over 'model'): each rank looks its own rows up,
    the looked-up rows are all-gathered and every token takes its owner's
    row -- a selection, not a sum, so ``-0.0`` stays ``-0.0``;
  * attention: where the kv heads divide 'model' the cache holds the
    rank's heads, q / k / v stay local (their sites' columns are exactly
    the rank's heads), the flash kernel runs on them -- a decode planning
    its key splits for the whole call's (batch, kv head) pairs
    (``whole_pairs``), so each head is the single-device call's bit for
    bit -- and the head outputs are all-gathered before ``wo``.  A cache the rules shard on its
    sequence (``KV_SEQ_SHARD``: kv heads that do not divide) needs a merge
    of partial softmaxes across ranks: it raises, naming ROADMAP A10.2;
  * the MoE: tokens are all-gathered over the data axes so routing,
    capacity and drops are the whole batch's, as the reference's; under
    expert parallelism each rank runs its experts' slice of the capacity
    buffer (``quant.backends.expert_ffn_ep``) and the outputs are
    all-gathered over 'model' in the model dtype.

Activations are replicated within the model group.  The batch of a decode
call is sharded over the data axes where it divides (each data rank holds
its slots' cache rows; the logits are all-gathered before sampling); a
B = 1 prefill runs whole on every data rank over a cache that holds the
whole sequence (the reference's batch-1 sequence sharding over data is
A10.2's).  Every rank runs the same host loop and reaches the same tokens.

``install`` places a tree on a rank (a whole tree is sliced; a
``RankLocal`` one, read rank by rank from a sharded artifact, is taken as
it is); ``shard_api`` wraps a ``ModelApi``'s serving entry points so each
call runs under the ambient mesh (``sharding.set_activation_mesh``).  The
VLM, SSM, hybrid and enc-dec families raise under a mesh of more than one
rank (ROADMAP A10.2).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.quantizer import QTensor
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as rules

A10_2 = "ROADMAP Queue A step 10.2 (A10.2)"
SERVED_FAMILIES = ("dense", "moe")
MODEL = "model"


class RankLocal(dict):
    """A parameter tree that already holds one rank's shards (a read of a
    sharded artifact on a mesh); ``specs`` maps each leaf path to the spec
    it was sliced by (per layer: no layer axis)."""

    def __init__(self, tree: Dict[str, Any], specs: Dict[str, Any]):
        super().__init__(tree)
        self.specs = specs


@dataclasses.dataclass
class Spmd:
    """The ambient state of one rank's serving calls: the live mesh, the
    dim each sharded site splits over 'model' (-1 N, -2 K, -3 experts;
    ``layouts``), whether attention runs on the rank's kv heads, and
    whether the running call's batch is split over the data axes."""

    mesh: coll.Mesh
    layouts: Dict[str, int]
    heads_local: bool = False
    batch_sharded: bool = False

    @property
    def shape(self) -> Dict[str, int]:  # what the rules read of a mesh
        return self.mesh.shape

    @property
    def model(self) -> int:
        return self.mesh.shape.get(MODEL, 1)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return rules.batch_axes(self.mesh) or ()

    def layout(self, path: str) -> Optional[int]:
        return self.layouts.get(path)


def active() -> Optional[Spmd]:
    """The ambient SPMD state of the running call, or None (one device)."""
    state = rules.activation_mesh()
    return state if isinstance(state, Spmd) else None


@contextlib.contextmanager
def scope(state: Spmd, batch_sharded: bool = False):
    """Run a call under ``state`` as the ambient mesh (the engines' scope
    per dispatch: two engines with different meshes never see each
    other's)."""
    prev = rules.activation_mesh()
    rules.set_activation_mesh(dataclasses.replace(state, batch_sharded=batch_sharded))
    try:
        yield
    finally:
        rules.set_activation_mesh(prev)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def _model_dim(spec) -> Optional[int]:
    """The (negative) dim a spec splits over 'model', None if none."""
    for i, entry in enumerate(spec):
        axes = coll.axes_of(entry)
        if set(axes) - {MODEL}:
            raise NotImplementedError(f"serving places weights over 'model' only, got spec {spec}")
        if MODEL in axes:
            return i - len(spec)
    return None


def _slice(t: torch.Tensor, spec, mesh: coll.Mesh) -> torch.Tensor:
    return t[tuple(slice(a, b) for a, b in mesh.box(spec, tuple(t.shape)))].contiguous()


def layer_specs(stacked: Dict[str, Any]) -> Dict[str, Any]:
    """Per-layer specs from a spec tree over a stacked tree (an artifact's):
    a layer list's leaves lose their leading layer entry."""
    from repro_torch.convert import LAYER_LISTS

    def drop(spec):
        if isinstance(spec, rules.FieldSpecs):
            return rules.FieldSpecs(*(drop(s) for s in spec))
        return tuple(spec[1:])

    return {p: drop(s) if p.split("/")[0] in LAYER_LISTS else s for p, s in rules.flat_specs(stacked).items()}


def _place_leaf(leaf, spec, mesh: coll.Mesh, whole: bool):
    """One leaf on its rank: sliced from a whole leaf, or taken as it is
    (``whole`` False); an expert site's exponents follow its experts."""
    if isinstance(leaf, QTensor):
        qt = leaf
        if whole:
            k_ax, n_ax = spec.packed[-2:]
            qt = dataclasses.replace(qt, packed=_slice(qt.packed, spec.packed, mesh),
                                     scale_m=_slice(qt.scale_m, spec.scale_m, mesh),
                                     shape=(qt.k // mesh.axis_size(k_ax), qt.n // mesh.axis_size(n_ax)))
        if qt.experts and qt.scale_e.shape[0] != qt.packed.shape[0]:  # EP: this rank's experts' exponents
            qt = dataclasses.replace(qt, scale_e=_slice(qt.scale_e, spec.packed[-3:-2], mesh))
        return qt
    return _slice(leaf, spec, mesh) if whole else leaf


def _site(path: str) -> str:
    """The site path of a weight leaf (``blocks/attn/wq/w`` -> ``blocks/attn/wq``)."""
    return path[:-2] if path.endswith("/w") else path


def check_family(cfg, mesh: coll.Mesh) -> None:
    if mesh.size > 1 and cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(f"serving the {cfg.family} family on a mesh of {mesh.size} waits for {A10_2}")


def install(params, mesh: coll.Mesh, cfg) -> Tuple[Any, Spmd]:
    """(this rank's params, its ``Spmd`` state) from a whole tree (sliced by
    the serving rules) or a ``RankLocal`` one.  Sites sharded on N whose
    columns fall below 4 a rank are gathered whole here."""
    check_family(cfg, mesh)
    if isinstance(params, RankLocal):
        specs, whole = params.specs, False
    else:
        specs, whole = rules.flat_specs(rules.param_shardings(params, mesh, "serve")), True
    layouts: Dict[str, int] = {}

    def place(path, leaf):
        spec = specs[path]
        leaf = _place_leaf(leaf, spec, mesh, whole)
        dim = _model_dim(spec.packed if isinstance(spec, rules.FieldSpecs) else spec)
        if dim is None or mesh.shape.get(MODEL, 1) == 1:  # whole on every rank
            return leaf
        if dim == -1 and isinstance(leaf, QTensor) and leaf.n % 4:  # below the kernels' N % 4: launch it whole
            return gather_weight(leaf, mesh, -1)
        layouts[_site(path)] = dim
        return leaf

    local = rules.map_with_path(place, dict(params))
    return local, Spmd(mesh, layouts, heads_local=_heads_local(cfg, mesh))


def _heads_local(cfg, mesh: coll.Mesh) -> bool:
    """Does attention run on the rank's kv heads?  The cache rules decide:
    kv heads over 'model' (then q / k / v's columns, divisible too, are the
    rank's heads); a cache split on its sequence or head_dim over 'model'
    raises (A10.2)."""
    probe = {"k": torch.empty((cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.hd()), device="meta")}
    spec = rules.cache_shardings(probe, mesh)["k"]
    if MODEL in coll.axes_of(spec[2]) or MODEL in coll.axes_of(spec[4]):
        raise NotImplementedError(f"a cache of {cfg.n_kv_heads} kv heads over model={mesh.shape[MODEL]} is split on "
                                  f"its sequence or head_dim ({spec}); merging partial softmaxes across ranks waits "
                                  f"for {A10_2}")
    return MODEL in coll.axes_of(spec[3]) and mesh.shape.get(MODEL, 1) > 1


def whole_pairs(pairs: int, state: Spmd) -> int:
    """The (batch, kv head) pairs of the whole call a rank's ``pairs`` are
    part of: a flash decode plans its key splits for those, so every pair
    is computed as the single-device call computes it."""
    heads = state.model if state.heads_local else 1
    batch = state.mesh.axis_size(state.batch_axes) if state.batch_sharded else 1
    return pairs * heads * batch


def local_cfg(cfg, state: Spmd):
    """The config attention runs under on a rank: its share of the heads."""
    m = state.model
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m, head_dim=cfg.hd())


# ---------------------------------------------------------------------------
# Sites
# ---------------------------------------------------------------------------
def gather_weight(w, mesh: coll.Mesh, dim: int):
    """A site's weight gathered whole along ``dim`` over 'model' (a
    QTensor: its packed words and scale rows; a rank's shard of K is
    contiguous rows of both)."""
    m = mesh.shape[MODEL]
    if isinstance(w, QTensor):
        k, n = w.shape
        shape = (k * m, n) if dim == -2 else (k, n * m)
        return dataclasses.replace(w, packed=coll.all_gather(w.packed, mesh, MODEL, dim),
                                   scale_m=coll.all_gather(w.scale_m, mesh, MODEL, dim), shape=shape)
    return coll.all_gather(w, mesh, MODEL, dim)


def local_bias(b: Optional[torch.Tensor], n_local: int, state: Spmd) -> Optional[torch.Tensor]:
    """The rank's slice of a (replicated) bias of an N-sharded site."""
    if b is None:
        return None
    i = state.mesh.index(MODEL)
    return b[i * n_local:(i + 1) * n_local].contiguous()


def gather_model(y: torch.Tensor, state: Spmd, dim: int = -1) -> torch.Tensor:
    return coll.all_gather(y, state.mesh, MODEL, dim)


def embed(table: torch.Tensor, tokens: torch.Tensor, state: Spmd) -> torch.Tensor:
    """Rows of a vocab-sharded table: each rank looks up the tokens it owns
    (others clamp to a row of its own), the rows are all-gathered over
    'model' and each token selects its owner's."""
    v_local = table.shape[0]
    lo = state.mesh.index(MODEL) * v_local
    rows = table[torch.clamp(tokens.long() - lo, 0, v_local - 1)]
    every = coll.all_gather(rows[None], state.mesh, MODEL, 0)  # (model, ..., d)
    owner = (tokens.long() // v_local)[None, ..., None].expand(1, *rows.shape)
    return torch.take_along_dim(every, owner, dim=0)[0]


def gather_batch(x: torch.Tensor, state: Spmd) -> torch.Tensor:
    """Every data rank's rows of a batch-sharded tensor (dim 0)."""
    return coll.all_gather(x, state.mesh, state.batch_axes, 0)


def local_rows(x: torch.Tensor, state: Spmd, batch: int) -> torch.Tensor:
    """This data rank's rows of a whole batch of ``batch`` rows."""
    n = state.mesh.axis_size(state.batch_axes)
    i = state.mesh.index(state.batch_axes)
    per = batch // n
    return x[i * per:(i + 1) * per]


# ---------------------------------------------------------------------------
# The serving entry points on a rank
# ---------------------------------------------------------------------------
def local_cache(cache: Dict[str, Any], state: Spmd) -> Dict[str, Any]:
    """A whole cache's rank-local part under ``cache_shardings``: the batch
    over the data axes where it divides, the kv heads over 'model' where
    the rules put them there (checked at ``install``); a batch-1 cache
    keeps its whole sequence on every data rank."""
    specs = rules.flat_specs(rules.cache_shardings(cache, state.mesh))

    def place(path, leaf):
        spec = list(specs[path])
        if len(leaf.shape) == 5 and spec[2] is not None and MODEL not in coll.axes_of(spec[2]):
            spec[2] = None  # batch-1 sequence sharding over data: kept whole (A10.2)
        return _slice(leaf, tuple(spec), state.mesh)

    return rules.map_with_path(place, cache)


class LocalCache(dict):
    """One rank's part of a cache; ``split``: its batch is split over the
    data axes (this rank holds its slots' rows only)."""

    split = False


def shard_api(api, state: Spmd):
    """``api`` with its serving entry points (``init_cache``, ``decode``,
    ``prefill_chunk``, ``prefill``, ``insert``) running on this rank under
    ``state``: a decode over a batch-split cache takes this rank's rows and
    all-gathers the logits back; an insert into one lands on the slot's
    owner only."""
    n_data = state.mesh.axis_size(state.batch_axes)

    def init_cache(b, max_len):
        with scope(state):
            cache = LocalCache(local_cache(api.init_cache(b, max_len), state))
        cache.split = n_data > 1 and b % n_data == 0
        return cache

    def decode(p, tokens, pos, cache):
        split = getattr(cache, "split", False)
        b = tokens.shape[0]
        if split:
            tokens = local_rows(tokens, state, b)
            if torch.is_tensor(pos) and pos.ndim == 1:
                pos = local_rows(pos, state, b)
        with scope(state, batch_sharded=split):
            logits, cache = api.decode(p, tokens, pos, cache)
            return (gather_batch(logits, state) if split else logits), cache

    def prefill_chunk(p, tokens, start, cache):
        with scope(state):
            return api.prefill_chunk(p, tokens, start, cache)

    def prefill(p, batch, cache):
        if getattr(cache, "split", False):
            raise NotImplementedError(f"a batch-split whole-prompt prefill on a mesh waits for {A10_2}")
        with scope(state):
            return api.prefill(p, batch, cache)

    def insert(cache, prefix, slot):
        if getattr(cache, "split", False):
            owner, slot = divmod(int(slot), cache["k"].shape[1])
            if owner != state.mesh.index(state.batch_axes):
                return cache
        return api.insert(cache, prefix, slot)

    return dataclasses.replace(api, init_cache=init_cache, decode=decode, prefill_chunk=prefill_chunk,
                               prefill=None if api.prefill is None else prefill, insert=insert)
