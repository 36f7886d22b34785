"""AdamW with optional 8-bit dynamic-fixed-point moments (counterpart of
``repro/training/optimizer.py``).

``state_bits=8`` stores the first and second moments as int8 mantissas
with per-row exponents (shared over the last axis): the paper's DFP
applied to optimizer state, a 4x cut of m and v.  The second moment is
quantized in the SQRT domain (int8 mantissas of sqrt(v)): with a direct-v
encoding an element whose v rounds to 0 while its m does not explodes the
update; in the sqrt domain both mantissas are proportional to |g|.

Leaves are treated by name, as the reference's are: ``ttq_scales`` /
``inq_scales`` (trainable grids) keep float32 moments under
``state_bits=8`` and get no weight decay; ``inq_mask`` has no moments and
never moves; a ``w`` whose site carries an ``inq_mask`` has its masked
coordinates pinned.  QTensors and integer leaves are not trainable.

The port keeps per-layer blocks as lists; the state trees mirror the
params (``None`` for an untrained leaf, ``{"q", "e"}`` for a DFP-8 moment),
and the per-row exponent over the last axis is the same whether a layer's
leaf stands alone or in the reference's stacked leaf.

``apply_updates`` updates in place: each leaf of ``params`` and each
moment is overwritten (the reference's jitted step donates its inputs).
A leaf is worked through in chunks of whole rows, so no more than one
chunk's float32 temporaries exist at a time: the update of a row depends
on that row and the two global scalars (lr, clip) alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core import dfp
from repro_torch.tree import tree_leaves, tree_map_named


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_bits: int = 32  # 32 or 8 (DFP moments)


# Quantization-state leaf names (see repro_torch/quant/state.py), matched by key.
SCALE_KEYS = ("ttq_scales", "inq_scales")  # trainable grids: no decay, float32 moments
FROZEN_KEYS = ("inq_mask",)  # never updated
MASK_KEY = "inq_mask"  # pins its sibling "w"'s frozen coordinates

CHUNK_ELEMS = 1 << 24  # rows worked at once: ~64 MB a float32 temporary


def _f32(x: float) -> float:
    """``x`` rounded to float32 (as a Python float)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA:CPU contracts the
    reference's update; emulated in float64, where the product of two
    float32 values is exact (the sum's double rounding can differ from a
    true fma in about one case in 2**29)."""
    a, b, c = (x.to(torch.float64) if isinstance(x, torch.Tensor) else _f32(x) for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; float32 on
    ``step``'s device, in the reference's compiled arithmetic (division by a
    constant as a product with its float32 reciprocal, one fma)."""
    s = step.to(torch.float32)
    warm = s * _f32(1 / max(cfg.warmup_steps, 1))
    t = torch.clamp((s - cfg.warmup_steps) * _f32(1 / max(cfg.decay_steps, 1)), 0.0, 1.0)
    # cos rounded once from float64: XLA's float32 cos is correctly rounded where torch's may be an ulp off
    c = torch.cos((_f32(math.pi) * t).to(torch.float64)).to(torch.float32)
    cos = _fma((1 - cfg.min_lr_ratio) * 0.5, 1 + c, cfg.min_lr_ratio)
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(s < cfg.warmup_steps, torch.ones_like(cos), cos)


def trainable(leaf, name: str = "") -> bool:
    """Whether a leaf named ``name`` trains: a floating tensor not frozen by name."""
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and name not in FROZEN_KEYS


def _is_entry(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "e"}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a (rows, last axis) view; a 0-d leaf (and its 0-d exponent)
    is one row of one."""
    return x.reshape(1, 1) if x.ndim == 0 else x.reshape(-1, x.shape[-1])


def _row_chunks(n_rows: int, row_len: int) -> Iterator[slice]:
    step = max(1, CHUNK_ELEMS // max(row_len, 1))
    for r0 in range(0, n_rows, step):
        yield slice(r0, min(r0 + step, n_rows))


def _q8(x: torch.Tensor, axis: Optional[Tuple[int, ...]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row 8-bit DFP (exponent shared over the last axis)."""
    return dfp.quantize_tensor(x.to(torch.float32), 8, axis)


def _q8_sqrt(v: torch.Tensor, axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second moment: quantize sqrt(v) (module docstring)."""
    return _q8(torch.sqrt(torch.clamp(v, min=0.0)), axis)


def _dq8(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return dfp.dequantize(q, e)


def _walk(params, state_m, state_v, grads) -> Iterator[tuple]:
    """(name, param, grad, m, v, mask) for every leaf of ``params``,
    dict keys in sorted order (the reference's flatten order), lists layer
    by layer.  ``mask`` is the site's ``inq_mask`` for a ``w`` beside one."""
    if isinstance(params, dict):
        for key in sorted(params):
            sub = params[key]
            if isinstance(sub, (dict, list)):
                yield from _walk(sub, _child(state_m, key), _child(state_v, key), _child(grads, key))
            else:
                mask = params.get(MASK_KEY) if key == "w" else None
                yield key, sub, _child(grads, key), _child(state_m, key), _child(state_v, key), mask
    elif isinstance(params, list):
        for i, sub in enumerate(params):
            yield from _walk(sub, _child(state_m, i), _child(state_v, i), _child(grads, i))


def _child(node, key):
    if node is None:
        return None
    if isinstance(node, list):
        return node[key]
    return node.get(key)


def init_state(params: Any, cfg: OptConfig) -> Dict[str, Any]:
    """{"step": 0-d int32, "m": tree, "v": tree} on the params' device:
    ``None`` for a leaf that is not trained, a float32 moment, or (under
    ``state_bits=8``, scale leaves excepted) a DFP-8 ``{"q", "e"}`` entry."""

    def zero_moment(name, leaf):
        if not trainable(leaf, name):
            return None
        z = torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
        if cfg.state_bits == 8 and name not in SCALE_KEYS:
            axis = (z.ndim - 1,) if z.ndim else None
            q, e = _q8(z, axis)
            return {"q": q, "e": e}
        return z

    device = next((t.device for t in tree_leaves(params) if isinstance(t, torch.Tensor)), torch.device("cpu"))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map_named(zero_moment, params),
        "v": tree_map_named(zero_moment, params),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every floating leaf."""
    total = None
    for leaf in tree_leaves(tree):
        if not trainable(leaf):
            continue
        rows = _rows(leaf.detach())
        for sl in _row_chunks(rows.shape[0], rows.shape[1]):
            part = torch.sum(torch.square(rows[sl].to(torch.float32)))
            total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _update_rows(cfg: OptConfig, p, g, m, v, mask, wd: float, lr, clip, b1c, b2c, q8: bool):
    """One chunk of rows (all (r, n) views), written in place."""
    g = g.to(torch.float32) * clip
    if q8:
        mf = _dq8(m["q"], m["e"])
        u = _dq8(v["q"], v["e"])
        vf = u * u
    else:
        mf, vf = m, v
    # the reference's update as XLA compiles it: three fmas, (m / b1c) / den as m / (b1c * den)
    mf = _fma(cfg.b1, mf, (1 - cfg.b1) * g)
    vf = _fma(cfg.b2, vf, (1 - cfg.b2) * torch.square(g))
    pf = p.to(torch.float32)
    d = mf / (b1c * (torch.sqrt(vf / b2c) + cfg.eps))
    new_p = _fma(-lr, _fma(wd, pf, d), pf)
    if mask is not None:  # INQ: frozen coordinates do not move, ever
        new_p = torch.where(mask > 0, pf, new_p)
    p.copy_(new_p.to(p.dtype))
    if q8:
        mq, me = _q8(mf, (1,))
        vq, ve = _q8_sqrt(vf, (1,))
        m["q"].copy_(mq)
        m["e"].copy_(me)
        v["q"].copy_(vq)
        v["e"].copy_(ve)
    else:
        m.copy_(mf)
        v.copy_(vf)


def _chunked(x, sl):
    """Rows ``sl`` of a leaf, a moment or an ``{"q", "e"}`` entry."""
    if isinstance(x, dict):
        return {k: _chunked(t, sl) for k, t in x.items()}
    return None if x is None else _rows(x)[sl]


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict[str, Any],
                  cfg: OptConfig) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics) -- the
    same trees, updated -- with metrics {"lr", "grad_norm"} as 0-d tensors
    on the device (nothing is read back to the host)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads).to(step.device)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)
    for name, p, g, m, v, mask in _walk(params, state["m"], state["v"], grads):
        if not trainable(p, name) or g is None or m is None:
            continue
        q8 = _is_entry(m)
        wd = 0.0 if name in SCALE_KEYS else cfg.weight_decay
        if not p.is_contiguous():
            raise ValueError(f"{name}: apply_updates writes leaves in place and needs them contiguous")
        n_rows, n = _rows(p).shape
        for sl in _row_chunks(n_rows, n):
            _update_rows(cfg, _rows(p)[sl], _rows(g)[sl], _chunked(m, sl), _chunked(v, sl), _chunked(mask, sl),
                         wd, lr, clip, b1c, b2c, q8)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}

