"""Parameters and caches of the JAX package -> those of the port.

``cache_from_jax(tree)`` turns the reference's decode cache (a dict of
stacked (L, B, ...) leaves: KV in bf16, int8 mantissas and exponents,
uint8 nibble pairs; float32 SSM states, nested as ``{"ssm": {"h",
"conv"}}``; the enc-dec family's (B, T, d) ``enc_out``) into the port's,
byte for byte.

``params_from_jax(tree)`` takes the reference's fp parameter tree or its
PTQ tree (numpy arrays or anything ``numpy.asarray`` accepts), with layers
stacked on a leading axis, and returns the port's tree: each of
``LAYER_LISTS`` (``blocks``; the hybrid's ``mamba_stack``, ``tail_stack``
and ``shared``; the enc-dec family's ``enc_blocks`` and ``dec_blocks``) as a list of per-layer dicts, QTensors rebuilt from ``packed`` / ``scale_m`` /
``scale_e`` (uint32 words viewed as int32 -- the same bytes).  MoE expert
leaves keep their expert axis: an (L, E, ...) QTensor becomes one (E, ...)
QTensor a layer, an (L, E, K, N) float leaf (E, K, N) ones.  The
reference's QTensor is read by its fields alone, so nothing of the JAX
package is imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quantizer import QTensor
from repro_torch.device import resolve_device

# top-level keys whose subtree the reference stacks on a layer axis and the port keeps as a list
LAYER_LISTS = ("blocks", "mamba_stack", "tail_stack", "shared", "enc_blocks", "dec_blocks")


def _is_qtensor(x) -> bool:
    return all(hasattr(x, a) for a in ("packed", "scale_m", "scale_e", "group_size", "shape"))


def _tensor(a, device) -> torch.Tensor:
    a = np.require(np.asarray(a), requirements="C")  # (np.ascontiguousarray would make a 0-d exponent 1-d)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _qtensor(q, device, index=None) -> QTensor:
    pick = (lambda a: np.asarray(a)) if index is None else (lambda a: np.asarray(a)[index])
    return QTensor(
        _tensor(pick(q.packed), device), _tensor(pick(q.scale_m), device),
        _tensor(pick(q.scale_e), device).to(torch.int32),  # 0-d, or (E,) for an expert site
        int(q.bits), int(q.group_size), tuple(int(d) for d in q.shape), str(q.fmt),
    )


def _convert(node, device, index=None) -> Any:
    if _is_qtensor(node):
        return _qtensor(node, device, index)
    if isinstance(node, dict):
        return {k: _convert(v, device, index) for k, v in node.items()}
    a = np.asarray(node)
    return _tensor(a if index is None else a[index], device)


def _n_layers(node) -> int:
    if _is_qtensor(node):
        return np.asarray(node.scale_e).shape[0]
    if isinstance(node, dict):
        return _n_layers(next(iter(node.values())))
    return np.asarray(node).shape[0]


def params_from_jax(tree, device=None):
    """Convert the reference's parameter tree; ``device`` defaults to the card."""
    dev = resolve_device(device)
    out = {}
    for key, val in tree.items():
        if key in LAYER_LISTS:
            out[key] = [_convert(val, dev, i) for i in range(_n_layers(val))]
        else:
            out[key] = _convert(val, dev)
    return out


def cache_from_jax(cache, device=None):
    """The reference's cache dict (numpy or array leaves) as the port's
    cache: the same leaf names, dtypes and bytes."""
    dev = resolve_device(device)
    # a copy: the port writes its cache in place, numpy views may be read-only
    return {name: cache_from_jax(leaf, dev) if isinstance(leaf, dict) else _tensor(np.array(leaf), dev)
            for name, leaf in cache.items()}
