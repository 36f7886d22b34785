"""The live mesh and the collectives the port's model code places itself
(the reference has no counterpart: XLA's partitioner places its
collectives).

``Mesh`` is one process's view of an SPMD mesh: the ordered axis sizes
(the reference's axis names, ``pod`` / ``data`` / ``model``), this
process's rank and coordinates (row-major over the axes, as jax orders
devices and ``init_device_mesh`` orders ranks), and one process group an
axis from ``torch.distributed.device_mesh.init_device_mesh``.  A mesh
built with ``Mesh.local(sizes, rank)`` has no groups: it places shards
(an artifact read as rank ``rank`` would) but runs no collective.

The collectives are plain functions on tensors over named mesh axes:
``all_gather``, ``all_to_all``, ``all_reduce`` (sum) and ``broadcast``.
An axis of size 1 moves nothing.  Each call adds the bytes this rank
receives to ``traffic()`` under the collective's name (``reset_traffic``
clears it), which is how a serving run logs its bytes a decode step.

Gloo takes all four on CUDA tensors (it moves them through host memory
itself; ``chip_smoke.py``'s mesh phase checks this on the card), so one
code path serves gloo on the CPU or the card and NCCL across cards.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

_TRAFFIC: Dict[str, int] = {}


class Mesh:
    """An SPMD mesh seen from one rank: ``shape`` (ordered axis -> size),
    ``rank``, ``coords`` (axis -> index) and, for a live mesh, a process
    group an axis (``groups``), the collectives' ``backend`` and the
    ``device`` the model runs on."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0, groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None, device: Optional[torch.device] = None):
        self.shape = dict(sizes)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        coords, rem = {}, rank
        for name in reversed(list(self.shape)):
            rem, coords[name] = divmod(rem, self.shape[name])
        self.coords: Dict[str, int] = {name: coords[name] for name in self.shape}
        self.groups = groups
        self.backend = backend
        self.device = device

    @classmethod
    def local(cls, sizes: Dict[str, int], rank: int = 0) -> "Mesh":
        """A mesh without process groups: shard placement only."""
        return cls(sizes, rank)

    def axis_size(self, axes: Optional[Axes]) -> int:
        """Ranks along ``axes`` (an axis, a tuple of axes, or a spec entry:
        None is 1)."""
        out = 1
        for a in axes_of(axes):
            out *= self.shape.get(a, 1)
        return out

    def box(self, spec, shape) -> Tuple[Tuple[int, int], ...]:
        """This rank's ``[start, stop)`` a dimension of ``shape`` under
        ``spec`` (a dimension past the spec's length is whole)."""
        out = []
        for i, dim in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            n, idx = self.axis_size(entry), self.index(entry)
            out.append((idx * dim // n, (idx + 1) * dim // n))
        return tuple(out)

    def index(self, axes: Optional[Axes]) -> int:
        """This rank's index along ``axes`` (row-major in their order)."""
        out = 0
        for a in axes_of(axes):
            if a in self.shape:
                out = out * self.shape[a] + self.coords[a]
        return out

    def group(self, axis: str):
        if self.groups is None:
            raise RuntimeError("a shape-only mesh (Mesh.local) runs no collective")
        return self.groups[axis]

    def comm_device(self) -> torch.device:
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def clock(self) -> float:
        """Rank 0's ``time.monotonic()`` on every rank: the engines' host
        loops decide deadlines, backoff and overload on one clock, so every
        rank takes the same branch and reaches the same collectives."""
        t = torch.tensor([time.monotonic()], dtype=torch.float64, device=self.comm_device())
        if self.size > 1:
            dist.broadcast(t, src=0)
        return float(t.item())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"


def axes_of(axes: Optional[Axes]) -> Tuple[str, ...]:
    """The axis names of an axis, a tuple of axes or a spec entry."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def init_mesh(sizes: Dict[str, int], device: torch.device) -> Mesh:
    """The live mesh over an initialized default process group whose world
    size is the mesh size: one group an axis from ``init_device_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs torch.distributed initialized (launch/mesh.py init_distributed)")
    n = 1
    for v in sizes.values():
        n *= v
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} ranks {dict(sizes)} over a world of {world}")
    backend = dist.get_backend()
    dm = init_device_mesh("cpu" if backend == "gloo" else "cuda", tuple(sizes.values()),
                          mesh_dim_names=tuple(sizes))
    groups = {name: dm.get_group(name) for name in sizes}
    return Mesh(sizes, dist.get_rank(), groups, backend, torch.device(device))


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------
def traffic() -> Dict[str, int]:
    """Bytes this rank received, by collective, since ``reset_traffic``."""
    return dict(_TRAFFIC)


def reset_traffic() -> None:
    _TRAFFIC.clear()


def _count(name: str, nbytes: int) -> None:
    _TRAFFIC[name] = _TRAFFIC.get(name, 0) + int(nbytes)


# ---------------------------------------------------------------------------
# Collectives over named axes
# ---------------------------------------------------------------------------
def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over ``axes`` in their
    row-major order (the last axis innermost): the inverse of sharding dim
    over those axes."""
    for axis in reversed(axes_of(axes)):
        n = mesh.shape.get(axis, 1)
        if n == 1:
            continue
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.group(axis))
        _count("all_gather", (n - 1) * src.numel() * src.element_size())
        x = torch.cat(parts, dim=dim)
    return x


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Split ``x`` into n pieces along ``split_dim``, send piece j to rank j
    of ``axis``, and concatenate what arrives along ``concat_dim`` in rank
    order (``lax.all_to_all(..., tiled=True)``)."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split {n} ways")
    src = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    _count("all_to_all", (n - 1) * out[0].numel() * out.element_size())
    return torch.cat(list(out.unbind(0)), dim=concat_dim)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes``."""
    x = x.clone()
    for axis in axes_of(axes):
        n = mesh.shape.get(axis, 1)
        if n == 1:
            continue
        dist.all_reduce(x, group=mesh.group(axis))
        _count("all_reduce", (n - 1) * x.numel() * x.element_size())
    return x


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int = 0) -> torch.Tensor:
    """Rank ``src`` of ``axis``'s ``x`` on every rank of that axis."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    g = mesh.group(axis)
    buf = x.contiguous().clone()
    dist.broadcast(buf, src=dist.get_global_rank(g, src), group=g)
    if mesh.index(axis) != src:
        _count("broadcast", buf.numel() * buf.element_size())
    return buf

