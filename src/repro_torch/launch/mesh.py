"""Mesh builders of the launchers (counterpart of ``repro/launch/mesh.py``).

``mesh_spec_sizes('dp=2,ep=2')`` parses a launcher's mesh spec (aliases
dp -> data, ep / tp -> model) without touching any process group, with
the reference's errors.  ``init_distributed`` starts the process group of
one rank (NCCL for a CUDA device, gloo for the CPU, from ``torchrun``'s
environment unless given an address); ``parse_mesh_spec`` and
``make_host_mesh`` then build the live ``collectives.Mesh`` over it.

The reference's ``make_production_mesh`` (a TPU pod layout),
``enable_compile_cache`` (XLA's persistent compilation cache) and
``preinit_mesh_flag`` (XLA's forced host device count) are XLA-specific
and have no counterpart: the port's kernels build once per checkout
(``kernels/_build.py``), and its ranks are processes, not forced devices.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import Mesh, init_mesh

# dp -> batch parallelism; ep / tp -> the 'model' axis (tensor and expert parallelism share it)
_MESH_AXIS_ALIASES = {"dp": "data", "ep": "model", "tp": "model"}


def mesh_spec_sizes(spec: str) -> Tuple[Tuple[str, int], ...]:
    """'dp=2,ep=2' -> (('data', 2), ('model', 2))."""
    out = []
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep:
            raise ValueError(f"bad mesh spec {spec!r}: expected name=size pairs")
        out.append((_MESH_AXIS_ALIASES.get(k.strip(), k.strip()), int(v)))
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"mesh spec {spec!r} maps two names onto one axis (aliases: {_MESH_AXIS_ALIASES})")
    return tuple(out)


def mesh_size(spec: str) -> int:
    n = 1
    for _, size in mesh_spec_sizes(spec):
        n *= size
    return n


def init_distributed(device: torch.device, init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Start this rank's default process group once: NCCL for a CUDA
    device, gloo for the CPU; rank, world size and address from
    ``torchrun``'s environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    unless given."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size)


def parse_mesh_spec(spec: str, device: torch.device) -> Mesh:
    """'dp=2,ep=2' -> the live mesh over the initialized process group."""
    return init_mesh(dict(mesh_spec_sizes(spec)), device)


def make_host_mesh(device: torch.device, model: int = 1) -> Mesh:
    """A (data, model) mesh over every rank of the process group."""
    n = dist.get_world_size()
    return init_mesh({"data": n // model, "model": model}, device)
