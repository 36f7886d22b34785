"""KV-cache formats (counterpart of ``repro/models/kv_cache.py``).

Three registered block layouts, as in the reference:

  * ``kv_bf16``  raw bf16, no exponents.
  * ``kv_int8``  int8 mantissas + one int8 DFP exponent per (token, kv head).
  * ``kv_mx``    int4 mantissas packed two per byte along head_dim (low
                 nibble = even channel) + one int8 exponent shared by a
                 32-token block along the sequence axis; empty blocks hold
                 the sentinel exponent -127.

A cache is a dict of leaves with the sequence axis at position 1 of each
layer's (B, T, Kh, ...) view: ``{"k", "v"}`` plus ``{"ke", "ve"}`` exponent
planes for the quantized formats.  Unlike the reference's pure functions,
writes update the leaves in place: a decode step never copies the cache.

  * aligned write -- scalar ``cache_index``: S tokens land at [idx, idx+S)
  * masked write  -- (B,) ``cache_index`` with S == 1: each slot at its
    own position (continuous batching)

The bytes written are the reference's, bit for bit (integer arithmetic,
``torch.round`` rounds half to even like ``jnp.round``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import dfp

MX_KV_BLOCK = 32  # tokens sharing one exponent along the sequence axis
_MX_QMAX = 7  # int4 symmetric range [-7, 7]
# empty-block exponent sentinel: any real token's exponent wins the running
# max (0 would act as a floor -- tokens with |x| < qmax would round to 0)
_MX_E_EMPTY = -127
_I32_MIN = -(2**31)


@dataclasses.dataclass(frozen=True)
class KVFormat:
    """One registered cache layout.  ``bytes_per_token`` is k+v cache bytes
    per token per layer, exponent planes included."""

    name: str
    mant_bits: int  # stored mantissa bits per value (16 = unquantized bf16)
    seq_block: int  # tokens sharing one exponent (0 = none, 1 = per-token)
    init: Callable  # (lead, max_len, kh, hd, dtype, device) -> leaves
    write_aligned: Callable  # (cache, k, v, idx) -> cache
    write_masked: Callable  # (cache, k, v, pos (B,)) -> cache
    attend_view: Callable  # cache -> (k, v, kscale, vscale)
    bytes_per_token: Callable  # (kh, hd) -> float

    @property
    def quantized(self) -> bool:
        return self.seq_block > 0


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
            f"unknown kv cache format {name!r}; registered: {kv_format_names()}"
        ) from None


def kv_format_names() -> Tuple[str, ...]:
    return tuple(sorted(_KV_FORMATS))


def resolve_kv_fmt(cfg) -> str:
    name = getattr(cfg, "kv_fmt", None)
    if name is None:
        name = "kv_int8" if getattr(cfg, "kv_bits", 16) == 8 else "kv_bf16"
    get_kv_format(name)
    return name


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _slice_write(buf: torch.Tensor, val: torch.Tensor, idx: int) -> None:
    buf[:, idx:idx + val.shape[1]] = val.to(buf.dtype)


def _mask_write(buf: torch.Tensor, val: torch.Tensor, pos: torch.Tensor) -> None:
    rows = torch.arange(val.shape[0], device=val.device)
    buf[rows, pos] = val[:, 0].to(buf.dtype)


def _dfp_tokens(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,S,Kh,hd) -> (int8 mantissas, int32 per-(token, head) exponents)."""
    xf = x.to(torch.float32)
    e = dfp.choose_exponent(torch.amax(torch.abs(xf), dim=-1, keepdim=True), bits)
    return dfp.quantize(xf, e, bits), e


def pack_i4(codes: torch.Tensor) -> torch.Tensor:
    """(..., hd) int codes in [-8, 7] -> (..., hd//2) uint8 nibble pairs."""
    c = codes.to(torch.int32) & 0xF
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_i4(packed: torch.Tensor) -> torch.Tensor:
    """(..., hd//2) uint8 -> (..., hd) int8 codes in [-8, 7]."""
    b = packed.to(torch.int32)
    lo, hi = b & 0xF, (b >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    pair = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return pair.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


# ---------------------------------------------------------------------------
# kv_bf16
# ---------------------------------------------------------------------------
def _bf16_init(lead, max_len, kh, hd, dtype, device):
    shape = (*lead, max_len, kh, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _plain_write(write_fn):
    def write(cache, k, v, where):
        write_fn(cache["k"], k, where)
        write_fn(cache["v"], v, where)
        return cache
    return write


# ---------------------------------------------------------------------------
# kv_int8: per-(token, head) DFP exponents
# ---------------------------------------------------------------------------
def _int8_init(lead, max_len, kh, hd, dtype, device):
    shape = (*lead, max_len, kh, hd)
    eshape = shape[:-1] + (1,)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "ke": torch.zeros(eshape, dtype=torch.int8, device=device),
        "ve": torch.zeros(eshape, dtype=torch.int8, device=device),
    }


def _int8_write(write_fn):
    def write(cache, k, v, where):
        for name, x in (("k", k), ("v", v)):
            q, e = _dfp_tokens(x, 8)
            write_fn(cache[name], q, where)
            write_fn(cache[name + "e"], e.to(torch.int8), where)
        return cache
    return write


def _int8_view(cache):
    return cache["k"], cache["v"], dfp.exp2i(cache["ke"][..., 0]), dfp.exp2i(cache["ve"][..., 0])


# ---------------------------------------------------------------------------
# kv_mx: int4 mantissas, one exponent per 32-token block per head
# ---------------------------------------------------------------------------
# The reference re-quantizes the whole cache on every write: it rescales the
# codes of every block by its exponent rise, e_new - e_old.  A block the write
# does not touch keeps its exponent, its shift is 0 and round(c * 2**0) == c,
# so rescaling only the blocks the write touches writes the same bytes at
# O(block) cost instead of O(cache).
def _mx_init(lead, max_len, kh, hd, dtype, device):
    if max_len % MX_KV_BLOCK:
        raise ValueError(f"kv_mx needs max_len % {MX_KV_BLOCK} == 0, got {max_len}")
    if hd % 2:
        raise ValueError(f"kv_mx packs head_dim nibble pairs; hd={hd} is odd")
    shape = (*lead, max_len, kh, hd // 2)
    eshape = (*lead, max_len // MX_KV_BLOCK, kh, 1)
    return {
        "k": torch.zeros(shape, dtype=torch.uint8, device=device),
        "v": torch.zeros(shape, dtype=torch.uint8, device=device),
        "ke": torch.full(eshape, _MX_E_EMPTY, dtype=torch.int8, device=device),
        "ve": torch.full(eshape, _MX_E_EMPTY, dtype=torch.int8, device=device),
    }


def _mx_token_exponent(x: torch.Tensor) -> torch.Tensor:
    """Per-token int4 exponent (int32); all-zero tokens yield the empty
    sentinel so they never raise a block's shared exponent."""
    max_abs = torch.amax(torch.abs(x.to(torch.float32)), dim=-1, keepdim=True)
    e = dfp.choose_exponent(max_abs, 4)
    return torch.where(max_abs > 0, e, torch.full_like(e, _MX_E_EMPTY))


def _mx_rescale(packed: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Resident codes (float) shifted to the raised exponent; ``shift``
    broadcasts over the token axis of ``packed``'s unpacked codes."""
    codes = unpack_i4(packed).to(torch.float32) * dfp.exp2i(-shift)
    return torch.clamp(torch.round(codes), -_MX_QMAX, _MX_QMAX)


def _mx_quantize_at(x: torch.Tensor, e_use: torch.Tensor) -> torch.Tensor:
    scaled = x.to(torch.float32) * dfp.exp2i(-e_use)
    return torch.clamp(torch.round(scaled), -_MX_QMAX, _MX_QMAX)


def _mx_write_one_aligned(buf, ebuf, x, idx: int) -> None:
    b, s, kh = x.shape[0], x.shape[1], x.shape[2]
    blk0, blk1 = idx // MX_KV_BLOCK, (idx + s - 1) // MX_KV_BLOCK + 1
    t0, nb = blk0 * MX_KV_BLOCK, blk1 - blk0
    # per-block running max of the incoming token exponents; blocks the
    # write does not fill keep int32 min and lose to the stored exponent
    e_tok = torch.full((b, nb * MX_KV_BLOCK, kh), _I32_MIN, dtype=torch.int32, device=x.device)
    e_tok[:, idx - t0:idx - t0 + s] = _mx_token_exponent(x)[..., 0]
    e_in = e_tok.reshape(b, nb, MX_KV_BLOCK, kh).amax(dim=2)[..., None]  # (B, nb, Kh, 1)
    e_old = ebuf[:, blk0:blk1].to(torch.int32)
    e_new = torch.maximum(e_old, e_in)
    shift = torch.repeat_interleave(e_new - e_old, MX_KV_BLOCK, dim=1)  # (B, nb*32, Kh, 1)
    codes = _mx_rescale(buf[:, t0:t0 + nb * MX_KV_BLOCK], shift)
    e_use = torch.repeat_interleave(e_new, MX_KV_BLOCK, dim=1)[:, idx - t0:idx - t0 + s]
    codes[:, idx - t0:idx - t0 + s] = _mx_quantize_at(x, e_use)
    buf[:, t0:t0 + nb * MX_KV_BLOCK] = pack_i4(codes)
    ebuf[:, blk0:blk1] = e_new.to(torch.int8)


def _mx_write_one_masked(buf, ebuf, x, pos: torch.Tensor) -> None:
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    blk = torch.div(pos, MX_KV_BLOCK, rounding_mode="floor")  # (B,)
    e_old = ebuf[rows, blk].to(torch.int32)  # (B, Kh, 1)
    e_new = torch.maximum(e_old, _mx_token_exponent(x)[:, 0])
    toks = blk[:, None] * MX_KV_BLOCK + torch.arange(MX_KV_BLOCK, device=x.device)  # (B, 32)
    codes = _mx_rescale(buf[rows[:, None], toks], (e_new - e_old)[:, None])  # (B, 32, Kh, hd)
    codes[rows, pos - blk * MX_KV_BLOCK] = _mx_quantize_at(x[:, 0], e_new)
    buf[rows[:, None], toks] = pack_i4(codes)
    ebuf[rows, blk] = e_new.to(torch.int8)


def _mx_write(one):
    def write(cache, k, v, where):
        one(cache["k"], cache["ke"], k, where)
        one(cache["v"], cache["ve"], v, where)
        return cache
    return write


def _mx_view(cache):
    kscale = torch.repeat_interleave(dfp.exp2i(cache["ke"][..., 0]), MX_KV_BLOCK, dim=1)
    vscale = torch.repeat_interleave(dfp.exp2i(cache["ve"][..., 0]), MX_KV_BLOCK, dim=1)
    return unpack_i4(cache["k"]), unpack_i4(cache["v"]), kscale, vscale


register_kv_format(KVFormat(
    name="kv_bf16", mant_bits=16, seq_block=0, init=_bf16_init,
    write_aligned=_plain_write(_slice_write), write_masked=_plain_write(_mask_write),
    attend_view=lambda cache: (cache["k"], cache["v"], None, None),
    bytes_per_token=lambda kh, hd: 2 * kh * hd * 2.0,
))

register_kv_format(KVFormat(
    name="kv_int8", mant_bits=8, seq_block=1, init=_int8_init,
    write_aligned=_int8_write(_slice_write), write_masked=_int8_write(_mask_write),
    attend_view=_int8_view,
    bytes_per_token=lambda kh, hd: 2 * (kh * hd + kh) * 1.0,
))

register_kv_format(KVFormat(
    name="kv_mx", mant_bits=4, seq_block=MX_KV_BLOCK, init=_mx_init,
    write_aligned=_mx_write(_mx_write_one_aligned), write_masked=_mx_write(_mx_write_one_masked),
    attend_view=_mx_view,
    bytes_per_token=lambda kh, hd: 2 * (kh * hd / 2 + kh / MX_KV_BLOCK),
))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def init_cache(cfg, lead: Tuple[int, ...], max_len: int, dtype=torch.bfloat16,
               device="cpu") -> Dict[str, torch.Tensor]:
    """The kv leaves for one cache stack (``lead`` = (L, B) axes)."""
    fmt = get_kv_format(resolve_kv_fmt(cfg))
    return fmt.init(lead, max_len, cfg.n_kv_heads, cfg.hd(), dtype, device)


def write(fmt_name: str, cache: Dict[str, torch.Tensor], k: torch.Tensor,
          v: torch.Tensor, cache_index) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Quantize on write, in place; returns (cache, valid lengths (B,) int32)."""
    fmt = get_kv_format(fmt_name)
    b, s = k.shape[0], k.shape[1]
    if not torch.is_tensor(cache_index) or cache_index.ndim == 0:
        idx = int(cache_index)
        if idx + s > cache["k"].shape[1]:
            raise ValueError(f"write of {s} tokens at {idx} overruns a cache of {cache['k'].shape[1]}")
        fmt.write_aligned(cache, k, v, idx)
        valid = torch.full((b,), idx + s, dtype=torch.int32, device=k.device)
    else:  # per-slot positions (continuous batching): S == 1
        fmt.write_masked(cache, k, v, cache_index.long())
        valid = (cache_index + 1).to(torch.int32)
    return cache, valid


def attend_view(fmt_name: str, cache: Dict[str, torch.Tensor]):
    """(k codes, v codes, kscale, vscale) for the fold-the-scales oracle."""
    return get_kv_format(fmt_name).attend_view(cache)


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())
