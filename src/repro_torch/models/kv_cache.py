"""KV-cache formats (counterpart of ``repro/models/kv_cache.py``).

Only ``kv_bf16`` is ported (raw bf16, no exponents); kv_int8 and kv_mx come
with a later slice.  A cache is a dict of leaves with the sequence axis at
position 1 of each layer's (B, T, Kh, hd) view.  Unlike the reference's
pure functions, writes update the leaves in place: a decode step never
copies the cache.

  * aligned write -- scalar ``cache_index``: S tokens land at [idx, idx+S)
  * masked write  -- (B,) ``cache_index`` with S == 1: each slot at its
    own position (continuous batching)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class KVFormat:
    name: str
    init: Callable  # (lead, max_len, kh, hd, dtype, device) -> leaves
    write_aligned: Callable  # (cache, k, v, idx) -> cache
    write_masked: Callable  # (cache, k, v, pos (B,)) -> cache
    attend_view: Callable  # cache -> (k, v, kscale, vscale)


_KV_FORMATS: Dict[str, KVFormat] = {}


def register_kv_format(fmt: KVFormat) -> KVFormat:
    if fmt.name in _KV_FORMATS:
        raise ValueError(f"kv format {fmt.name!r} already registered")
    _KV_FORMATS[fmt.name] = fmt
    return fmt


def get_kv_format(name: str) -> KVFormat:
    try:
        return _KV_FORMATS[name]
    except KeyError:
        raise KeyError(
            f"kv cache format {name!r} is not ported; registered: {sorted(_KV_FORMATS)}"
        ) from None


def resolve_kv_fmt(cfg) -> str:
    name = getattr(cfg, "kv_fmt", None)
    if name is None:
        name = "kv_int8" if getattr(cfg, "kv_bits", 16) == 8 else "kv_bf16"
    get_kv_format(name)
    return name


def _bf16_init(lead, max_len, kh, hd, dtype, device):
    shape = (*lead, max_len, kh, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _bf16_write_aligned(cache, k, v, idx):
    s = k.shape[1]
    cache["k"][:, idx:idx + s] = k.to(cache["k"].dtype)
    cache["v"][:, idx:idx + s] = v.to(cache["v"].dtype)
    return cache


def _bf16_write_masked(cache, k, v, pos):
    rows = torch.arange(k.shape[0], device=k.device)
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    return cache


register_kv_format(KVFormat(
    name="kv_bf16", init=_bf16_init,
    write_aligned=_bf16_write_aligned, write_masked=_bf16_write_masked,
    attend_view=lambda cache: (cache["k"], cache["v"], None, None),
))


def init_cache(cfg, lead: Tuple[int, ...], max_len: int, dtype=torch.bfloat16,
               device="cpu") -> Dict[str, torch.Tensor]:
    """The kv leaves for one cache stack (``lead`` = (L, B) axes)."""
    fmt = get_kv_format(resolve_kv_fmt(cfg))
    return fmt.init(lead, max_len, cfg.n_kv_heads, cfg.hd(), dtype, device)


def write(fmt_name: str, cache: Dict[str, torch.Tensor], k: torch.Tensor,
          v: torch.Tensor, cache_index) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Write in place; returns (cache, valid lengths (B,) int32)."""
    fmt = get_kv_format(fmt_name)
    b, s = k.shape[0], k.shape[1]
    if not torch.is_tensor(cache_index) or cache_index.ndim == 0:
        idx = int(cache_index)
        fmt.write_aligned(cache, k, v, idx)
        valid = torch.full((b,), idx + s, dtype=torch.int32, device=k.device)
    else:  # per-slot positions (continuous batching): S == 1
        fmt.write_masked(cache, k, v, cache_index.long())
        valid = (cache_index + 1).to(torch.int32)
    return cache, valid


def attend_view(fmt_name: str, cache: Dict[str, torch.Tensor]):
    return get_kv_format(fmt_name).attend_view(cache)


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())
