"""The fused quantized dense site: one CUDA kernel for a whole PTQ
projection (``csrc/fused_qmm.cu``), its plain PyTorch version, and the
wrapper that picks between them by the device of its input.

Replaces the TPU kernel ``repro/kernels/_common.py::fused_qmm_call``
(body ``_fused_kernel``; decodes ``decode2_tile``, ``decode4_tile``,
``decode_nf4_tile`` and the int8 identity), reached through the ``*_fused``
entries of ``ternary_matmul.py``, ``int4_matmul.py``, ``int8_matmul.py``,
``nf4_matmul.py`` and ``mx_matmul.py`` (an alias of the int8 entry).  It
computes, for x (M, K):

  prologue : per-row DFP exponent over the FULL K row (or the plan's
             static exponent), x -> int8 mantissas (round half to even,
             clip to +-qmax, NaN -> 0; a row holding a NaN gets e = 0)
  matmul   : per cluster of ``group`` K-elements an exact int32 dot of
             int8 mantissas with decoded weights, times the cluster's int8
             scale mantissa -- one multiply per cluster.  Decodes:
             ternary, 16 2-bit codes per word, ((c+1)&3)-1; int8 raw;
             int4 and nf4, 8 4-bit fields per word through a 16-entry
             table (int4: c >= 8 -> c - 16; nf4: ``NF4_LUT_I8``)
  epilogue : x 2**(scale_e + e), + bias, silu | gelu | relu

Float sums follow the reference's order: clusters in order within each
k-tile of ``block_k`` (512) elements, starting from 0, then tiles in order
starting from 0.  K is any multiple of the cluster length: the k-tiles
start at 0 and the last one is ragged (gemma3's 3840 = 7 x 512 + 256).  No
product is contracted into an fma, so the kernel and the plain version
agree bit for bit.  ``kernels/packed_qmm.py`` runs the
same matmul over activations already quantized, with the same order.

What bounds it on the H100, and the two kernels:

- Decode, M <= 8 (``_build.GEMV_MAX_ROWS``): M is the slot count (4), so
  the site is a GEMV over the weight stream -- 2 bits per ternary
  weight, 4 per int4/nf4 weight, one byte per int8 weight, 3.35 TB/s --
  then the instructions per weight.  One launch of the GEMV of
  ``csrc/qmm_gemv.cuh``: a warp owns 32 output columns and walks k-tiles
  (or single clusters, on sites with few columns) in order; each lane
  keeps its next 16-byte weight loads in flight through a cp.async ring
  in shared memory; the decode writes mma A registers directly and
  ``mma.sync`` s8 takes the dot products (x's int8 rows as B, rows M..7
  zero), each cluster's C fragment started at the bits of 1.5 * 2^23 so
  one fma gives ``float(dot) * sm`` rounded once.  ``gemv_plan`` splits
  k-tiles over up to 4 blocks of one thread block cluster where the
  columns alone give fewer blocks than SMs; block 0 adds the splits' tile
  sums in tile order from distributed shared memory.  int8 sites with
  many 128-column items (every lm_head, mx's gate / up;
  ``uses_int8_loop``) take the int8 loop of ``csrc/qmm_gemv8.cuh``
  instead: a persistent grid whose warps each stream the weight rows of
  128 columns through their own cp.async ring, ``mma.sync`` s8 m16n8k32,
  and k-splits (``int8_loop_plan``, narrow sites only) folded in tile
  order by the warp that completes an item.
- Prefill, M > 8: int8 operations, 2 M K N (50 us a layer of qwen3-8b at
  M = 256 at the 1,979 TOP/s peak).  Two launches: a pre-pass quantizes
  each row of x once into int8 scratch (with its float exponent), then
  the tensor-core tile of ``csrc/qmm_mma.cuh`` -- 128 x 128 output
  blocks, ``mma.sync`` s8 over weights decoded into shared memory, the
  per-cluster rescale and the tile order in registers, bit-exact with
  the plain version (see that file).  ``tile_plan`` sizes the launch
  and splits the k-tiles of sites with few output blocks.  Both
  launches count as one launch of the fused entry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import dfp
from repro_torch.core.quantizer import NF4_LUT_I8, unpack4u
from repro_torch.kernels import _build
from repro_torch.kernels.ref import cluster_dots

TERNARY_PER_WORD = 16
# decode -> K elements per packed row, and the kernel's decode mode
PER_WORD = {"ternary": TERNARY_PER_WORD, "int8": 1, "int4": 8, "nf4": 8}
DECODES = tuple(PER_WORD)
_MODE = {"ternary": 0, "int8": 1, "int4": 2, "nf4": 2}  # 2: a 4-bit field through a 16-entry table
_GEMV_MODE = {"ternary": 0, "int8": 1, "nf4": 2, "int4": 3}  # 3: int4 fields as high nibbles, no table
LUTS = {"int4": tuple(c if c < 8 else c - 16 for c in range(16)), "nf4": NF4_LUT_I8}
_UNIT_K = {"ternary": 16, "int8": 4, "int4": 8, "nf4": 8}  # K elements per inner step of the kernel
_ACTS = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
_MAX_SMEM = 232_448 - 512  # a Hopper block's shared memory, less the kernel's static part
# The tensor-core tile (csrc/qmm_mma.cuh: kBM, kBN, kThreads, kOut): output
# block, threads, output sums a thread; the cluster lengths it takes (mma
# k16 at 16, k32 above; |cluster dot| <= 128 * 128 * group must stay
# under 2**22 for its float conversion); scratch of the k-splits at most
# TILE_SPLIT_BYTES.
TILE_M, TILE_N, TILE_THREADS, TILE_OUT = 128, 128, 256, 64
TILE_GROUPS = (16, 32, 64, 128)
TILE_SPLIT_BYTES = 4 * 2**20
# The GEMV (csrc/qmm_gemv.cuh, M <= 8): output columns a warp, warps a
# block, blocks the plan keeps resident on an SM (the kernel's
# __launch_bounds__), k-splits of an item (one portable cluster) and the
# dynamic shared memory a block may take at that residency; it takes the
# tile's cluster lengths.
GEMV_STRIP, GEMV_WARPS, GEMV_BLOCKS_PER_SM, GEMV_MAX_SPLITS = 32, 8, 2, 4
GEMV_SMEM = 110 * 1024
# The int8 loop (csrc/qmm_gemv8.cuh, M <= 8): output columns a warp,
# weight rows of a ring stage, ring stages a warp, x rows a block (the mma's
# n), warps a block (at least, and its __launch_bounds__), the dynamic
# shared memory a block may take beside its static part (under 1 KB); and
# the plan's model: one warp streams at most 1 / LOOP_WARP_SHARE of an SM's
# share of the weight stream, and a plan that splits the k-tiles costs
# LOOP_SPLIT_COST percent more (the card's SMs stream far-apart weight rows
# at once: the copies alone at qwen3-8b's lm_head ran at 2.79 TB/s unsplit
# and 1.92-2.12 TB/s at 2, 4 and 8 splits on the H100,
# tools/int8_loop_variants.py --splits).
LOOP_COLS, LOOP_STAGE_K, LOOP_RING, LOOP_MAX_ROWS = 128, 32, 4, 8
LOOP_MIN_WARPS, LOOP_MAX_WARPS = 4, 12
LOOP_SMEM = 232_448 - 1024
LOOP_WARP_SHARE, LOOP_SPLIT_COST = 4, 40

# ---------------------------------------------------------------------------
# Activations: the one table both the kernel epilogue and the plain path use
# (the formulas the reference's jax.nn functions lower to).
# ---------------------------------------------------------------------------
def _silu(y):
    return y * torch.sigmoid(y)


def _gelu(y):  # tanh approximation, jax.nn.gelu's default
    c = float(torch.tensor((2.0 / torch.pi) ** 0.5, dtype=torch.float32))
    cdf = 0.5 * (1.0 + torch.tanh(c * (y + 0.044715 * (y * y * y))))
    return y * cdf


ACTIVATIONS = {None: lambda y: y, "silu": _silu, "gelu": _gelu, "relu": torch.relu}


def activation_fn(name: Optional[str]):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; supported: {sorted(k for k in ACTIVATIONS if k)}"
        ) from None


def _decode(packed: torch.Tensor, decode: str, k: int) -> torch.Tensor:
    """Packed weights -> (K, N) int8 mantissas, as the kernel decodes them."""
    if decode == "int8":
        return packed
    if decode in LUTS:
        lut = torch.tensor(LUTS[decode], dtype=torch.int8, device=packed.device)
        return lut[unpack4u(packed, k).to(torch.int64)]
    lanes = [((((packed >> (2 * i)) & 3) + 1) & 3) - 1 for i in range(TERNARY_PER_WORD)]
    return torch.stack(lanes, dim=1).reshape(k, packed.shape[1]).to(torch.int8)


def lut_words(decode: str):
    """The 16 table bytes of a 4-bit decode as four little-endian 32-bit
    words (entry 4i + j is byte j of word i); zeros for other decodes."""
    table = LUTS.get(decode, (0,) * 16)
    return [int.from_bytes(bytes(v & 0xFF for v in table[4 * i:4 * i + 4]), "little") for i in range(4)]


def _row_exponents(x: torch.Tensor, act_bits: int, act_exponent: Optional[int]) -> torch.Tensor:
    """(M, 1) float32 exponents, as the reference kernel keeps them."""
    m = x.shape[0]
    if act_exponent is not None:
        return torch.full((m, 1), float(act_exponent), dtype=torch.float32, device=x.device)
    max_abs = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    e = dfp.log2_ceil(max_abs, float(dfp.qmax(act_bits)))
    return torch.where(max_abs >= torch.finfo(torch.float32).tiny, e, torch.zeros_like(e))


def quantize_prologue(x: torch.Tensor, act_bits: int, act_exponent: Optional[int]):
    """x (M, K) -> (int8 mantissas, (M, 1) float32 exponents), as the
    kernel's prologue and the ``quantize_rows`` kernel compute them."""
    xf = x.to(torch.float32)
    qmax = float(dfp.qmax(act_bits))
    e = _row_exponents(xf, act_bits, act_exponent)
    xq = torch.clamp(torch.round(xf * dfp.exp2i(-e)), -qmax, qmax)
    return torch.nan_to_num(xq, nan=0.0).to(torch.int8), e


def n_tiles(k: int, block_k: int = 512) -> int:
    """k-tiles of a K row: tiles of ``min(block_k, K)`` from 0, the last
    one ragged where K is not a multiple of ``block_k``."""
    return -(-k // min(block_k, k))


def cluster_sums(xq: torch.Tensor, packed: torch.Tensor, scale_m: torch.Tensor, *, decode: str,
                 group: int, block_k: int = 512) -> torch.Tensor:
    """int8 (M, K) x packed weights -> f32 (M, N): per cluster an exact dot
    times its scale mantissa, clusters added in order within each k-tile,
    then the tiles in order (the kernels' float order); a ragged last
    tile holds the clusters that are left."""
    m, k = xq.shape
    part = cluster_dots(xq, _decode(packed, decode, k), group)  # (K/g, M, N)
    sm = scale_m.to(torch.float32)
    out = torch.zeros((m, part.shape[-1]), dtype=torch.float32, device=xq.device)
    per_tile, clusters = min(block_k, k) // group, k // group
    for t in range(n_tiles(k, block_k)):
        acc = torch.zeros_like(out)
        for s in range(t * per_tile, min((t + 1) * per_tile, clusters)):
            acc = acc + part[s] * sm[s]
        out = out + acc
    return out


def fused_qmm_ref(
    x, packed, scale_m, scale_e, *, decode: str, group: int, bias=None,
    act: Optional[str] = None, act_bits: int = 8,
    act_exponent: Optional[int] = None, block_k: int = 512,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, operation for operation."""
    xq, e = quantize_prologue(x, act_bits, act_exponent)
    out = cluster_sums(xq, packed, scale_m, decode=decode, group=group, block_k=block_k)
    y = out * dfp.exp2i(scale_e.to(torch.float32) + e)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return activation_fn(act)(y)


@functools.cache
def _lib():
    lib = _build.load("fused_qmm")
    fn = lib.fused_qmm_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17
                   + [ctypes.c_uint] * 4 + [ctypes.c_size_t, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    int8 = lib.fused_qmm_int8_launch
    int8.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                     + [ctypes.c_size_t, ctypes.c_void_p])
    int8.restype = ctypes.c_int
    tile = lib.fused_qmm_tile_launch
    tile.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_uint] * 4
                     + [ctypes.c_size_t, ctypes.c_void_p])
    tile.restype = ctypes.c_int
    return fn, int8, tile


def loop_x_stride(k: int) -> int:
    """Bytes of one int8 row of x in the int8 loop's shared memory: K
    rounded up to 128, plus 16, so the rows' B loads fall on other banks."""
    return ((k + 127) & ~127) + 16


def smem_bytes(warps: int, rows: int, k: int, group: int) -> int:
    """Dynamic shared memory of a block of the int8 loop (``csrc/qmm_gemv8.cuh``):
    ``warps`` rings of LOOP_RING stages (32 weight rows x 128 columns and the
    scale rows of the clusters that close in a stage: at most
    ceil(32 / group)), then ``rows`` int8 rows of x.  The launch passes it;
    the kernel refuses another size."""
    closes = -(-LOOP_STAGE_K // group)
    return warps * LOOP_RING * (LOOP_STAGE_K + closes) * LOOP_COLS + rows * loop_x_stride(k)


def rows_per_block(m: int, k: int, group: int) -> int:
    """Rows of x a block of the int8 loop keeps: all M (up to 8), or fewer
    where they would not fit beside LOOP_MIN_WARPS rings (K = 49152 at
    M = 8 takes 3); the grid then repeats over row blocks."""
    for rows in range(min(m, LOOP_MAX_ROWS), 0, -1):
        if smem_bytes(LOOP_MIN_WARPS, rows, k, group) <= LOOP_SMEM:
            return rows
    raise ValueError(f"K={k} needs {smem_bytes(LOOP_MIN_WARPS, 1, k, group)} bytes of shared memory for one row "
                     f"of the int8 loop (max {LOOP_SMEM})")


def _sm_time(tiles, share: int) -> int:
    """Time of one SM whose warps stream ``tiles`` k-tiles each, in units of
    one tile at the SM's whole rate: the active warps share the SM's rate,
    a warp taking at most 1 / ``share`` of it."""
    left, done, elapsed = sorted(c for c in tiles if c), 0, 0
    while left:
        elapsed += (left[0] - done) * max(share, len(left))
        done = left[0]
        left = [c for c in left if c > done]
    return elapsed


@functools.cache
def int8_loop_plan(m: int, k: int, n: int, group: int, block_k: int = 512, sms: int = 132) -> dict:
    """The int8 loop's launch (M <= 8).  Work comes in units: one of an
    item's ``splits`` ranges of ``tps`` k-tiles x the item's 128 columns,
    numbered range-major.  The grid is persistent, ``grid_x`` blocks (one
    an SM; fewer where the rows of x take ``row_blocks`` passes) of
    ``warps`` warps, and warp r = warp * grid_x + block of the card walks
    units r, r + W, ... (W warps in all): the SMs take neighbouring units,
    so they stream the same weight rows at once.  Of the (splits, warps)
    that fit LOOP_SMEM, the plan takes those that give every SM a unit
    (where any does), then the one whose busiest SM (block 0) ends first by
    ``_sm_time`` (a split plan costing LOOP_SPLIT_COST percent more), then
    fewer splits, then more warps (more bytes in flight): qwen3-8b's
    lm_head, 1188 items of 8 tiles, takes no split and one item a warp;
    whisper-base's 406 one-tile items, no split; mx's gate, 96 items of 8
    tiles, 8 splits of one tile.  ``ws_floats`` /
    ``counters``: the split items' scratch (tile sums, one plane of rows x
    128 a tile) and arrival counters, 0 without splits."""
    if group % 4 or k % group or min(block_k, k) % group or n % 4:
        raise ValueError(f"the int8 loop takes clusters of whole 4-row units that tile K and k-tiles, and N % 4 == 0; "
                         f"got group={group} K={k} block_k={block_k} N={n}")
    nk, items = n_tiles(k, block_k), -(-n // LOOP_COLS)
    rows = rows_per_block(m, k, group)
    row_blocks = -(-m // rows)
    grid_x = max(1, sms // row_blocks)
    best = None
    for splits in range(1, nk + 1):
        tps = -(-nk // splits)
        if -(-nk // tps) != splits:
            continue
        units = items * splits
        for warps in range(LOOP_MIN_WARPS, LOOP_MAX_WARPS + 1):
            smem = smem_bytes(warps, rows, k, group)
            if smem > LOOP_SMEM:
                break
            stride = grid_x * warps
            tiles = [len(range(w * grid_x, units, stride)) * tps for w in range(warps)]  # block 0's warps
            cost = _sm_time(tiles, LOOP_WARP_SHARE) * (100 + LOOP_SPLIT_COST * (splits > 1))
            key = (units < grid_x, cost, splits, -warps)
            if best is None or key < best[0]:
                best = (key, dict(splits=splits, tps=tps, warps=warps, smem=smem, units=units))
    plan = best[1]
    split = plan["splits"] > 1
    return dict(plan, rows=rows, row_blocks=row_blocks, grid_x=grid_x, blocks=grid_x * row_blocks,
                ws_floats=row_blocks * items * nk * rows * LOOP_COLS if split else 0,
                counters=row_blocks * items if split else 0)


def loop_scratch(dev, plan: dict, stream: int):
    """(ws, counters) of a split int8 loop launch, (None, None) otherwise."""
    if plan["splits"] == 1:
        return None, None
    return (torch.empty(plan["ws_floats"], dtype=torch.float32, device=dev),
            _build.arrival_counters(dev, stream, plan["counters"]))


def loop_args(plan: dict) -> tuple:
    """The plan as the int8 loop's launchers take it (after N, group, bk)."""
    return tuple(plan[key] for key in ("rows", "splits", "tps", "warps", "grid_x"))


def gemv_step(decode: str, group: int):
    """(k a step, ring stages, weight bytes a lane copies a step) of the
    GEMV's lane map for this decode and cluster length (``qmm_gemv.cuh``'s
    Map): a step is 16 k at group 16, 64 k for ternary at groups 64 and
    128 (a lane's whole word), else 32 k; an int8 lane copies 4 bytes of
    each of its k-rows."""
    sk = 16 if group == 16 else (64 if decode == "ternary" and group >= 64 else 32)
    lane = sk if decode == "int8" else 16
    return sk, (4 if lane == 32 else 8), lane


def uses_int8_loop(decode: str, m: int, k: int, n: int, group: int, block_k: int = 512, sms: int = 132) -> bool:
    """Which kernel takes an int8 site at M <= 8: the int8 loop of
    ``csrc/qmm_gemv8.cuh`` where its items of 128 columns alone give at
    least half the SMs an item (ceil(N / 128) >= sms / 2) and all M rows of
    x fit a block, or where the GEMV does not take the cluster length (not
    in TILE_GROUPS); the GEMV of ``csrc/qmm_gemv.cuh`` otherwise.  The rows
    behind each choice (``chip_smoke.py``'s int8 route line; PERF.md, PR 27,
    NVIDIA H100 80GB HBM3, 700 W, M = 4): every family's lm_head (250 to
    2048 items) on the loop, 1.3-2.5x faster than the GEMV (qwen3-8b's
    0.238 vs 0.507 ms, whisper-base's 0.0316 vs 0.0392); the mx layer
    (group 32) of qwen3-8b: gate / up (96 items) on the loop, 0.062 vs
    0.070 ms; wq / wo, down (32 items: split 8 and 24 ways) and wk / wv (8)
    on the GEMV, 0.027 vs 0.054, 0.058 vs 0.106, 0.019 vs 0.053 ms; the
    MoE router (N 8: one item) on the GEMV; K = 49152 at M > 3 (x does not
    fit beside the rings) on the GEMV, which stages x."""
    if decode != "int8":
        return False
    if group not in TILE_GROUPS:
        return True
    try:
        rows = rows_per_block(m, k, group)
    except ValueError:
        return False
    return rows >= min(m, LOOP_MAX_ROWS) and 2 * -(-n // LOOP_COLS) >= sms


def gemv_smem_bytes(m: int, k: int, decode: str, group: int, bk: int, tps: int, cpp: int, wn: int,
                    tpc: Optional[int] = None, pull: bool = False) -> int:
    """Dynamic shared memory of a GEMV block: the warps' rings (weight
    bytes and scale words), the int8 rows of ``tpc`` k-tiles of its k range
    (all ``tps`` by default; 128-byte rounded rows plus 16 bytes, so the
    lanes' rows fall on other banks), the piece slots of one item and,
    with k-splits that push (not ``pull``), the item's k-tile sums of
    every split.  The launch passes it; the kernel refuses another."""
    _, ring, lane = gemv_step(decode, group)
    ppt, nk = bk // group // cpp, n_tiles(k, bk)
    stride = ((min((tps if tpc is None else tpc) * bk, k) + 127) & ~127) + 16
    tile_sums = nk if tps < nk and not pull else 0
    return GEMV_WARPS * ring * 32 * (lane + 4) + m * stride + (tps * ppt + tile_sums) * m * wn * GEMV_STRIP * 4


def gemv_plan(m: int, k: int, n: int, decode: str, group: int, block_k: int = 512, sms: int = 132) -> dict:
    """The GEMV's launch (M <= 8).  Work comes in strips of 32 columns x
    pieces of k: whole k-tiles (``cpp`` = the tile's clusters, folded in
    registers) or single clusters (``cpp`` = 1, on sites with few
    columns).  A block's 8 warps take ``wn`` strips (an item) x the
    pieces of ``tps`` k-tiles (its split), ``wn`` as small as keeps every
    warp busy; the splits of an item (at most GEMV_MAX_SPLITS) are one
    thread block cluster and combine through distributed shared memory.
    Of the shapes that fit ``GEMV_SMEM`` and give at least ``sms`` blocks,
    those whose blocks are all resident at once (no block loops over
    items) come first, then those that give every warp the same number of
    pieces, then whole tiles before single clusters and fewer splits
    before more; where no shape gives ``sms`` blocks (wk and wv: 32
    strips, so 128 blocks at 4 splits -- clusters of 8 measured slower,
    PERF.md) the one with the most blocks is taken.  The grid is (grid_x,
    splits), grid_x <= sms * GEMV_BLOCKS_PER_SM / splits; a block loops
    over the items grid_x apart (gate / up: 384 strips on 192 blocks), so
    its prologue runs once.

    A block keeps the int8 rows of x for its whole k range in shared
    memory (``tpc`` = ``tps``), and block 0 of a cluster a copy of every
    split's tile sums.  Only where no shape fits that way (K = 49152,
    qwen1.5-110b's down projection) does block 0 read the splits' sums
    from their own shared memory (``pull``), and where that is not enough
    either (M > 4 there) a block stages x ``tpc`` k-tiles at a time, the
    most that fit, as a multiple of the warps' pieces where one fits."""
    if group not in TILE_GROUPS:
        raise ValueError(f"the GEMV (M <= {_build.GEMV_MAX_ROWS}) takes group in {TILE_GROUPS} (its mma k is 16 or "
                         f"32 and |cluster dot| < 2**22); got group={group}")
    bk = min(block_k, k)
    nk, cpt = n_tiles(k, block_k), bk // group
    strips = -(-n // GEMV_STRIP)

    def chunk(tps, cpp, wn, pull, staged):
        """(tiles of x staged at a time, shared memory), or None if none fits."""
        if not staged:
            smem = gemv_smem_bytes(m, k, decode, group, bk, tps, cpp, wn, None, pull)
            return (tps, smem) if smem <= GEMV_SMEM else None
        fits = [t for t in range(tps - 1, 0, -1)
                if gemv_smem_bytes(m, k, decode, group, bk, tps, cpp, wn, t, pull) <= GEMV_SMEM]
        if not fits:
            return None
        even = [t for t in fits if t * (cpt // cpp) % (GEMV_WARPS // wn) == 0]
        tpc = (even or fits)[0]
        return tpc, gemv_smem_bytes(m, k, decode, group, bk, tps, cpp, wn, tpc, pull)

    for pull, staged in ((False, False), (True, False), (True, True)):
        options = []
        for cpp in (cpt, 1) if cpt > 1 else (1,):
            ppt = cpt // cpp
            for splits in range(1, min(nk, GEMV_MAX_SPLITS) + 1):
                tps = -(-nk // splits)
                if -(-nk // tps) != splits:
                    continue
                pps = tps * ppt  # pieces of a strip in a block
                wn = 1
                while wn < GEMV_WARPS and wn * pps < GEMV_WARPS:
                    wn *= 2
                fit = chunk(tps, cpp, wn, pull, staged)
                if fit is None:
                    continue
                items = -(-strips // wn)
                shape = dict(cpp=cpp, tps=tps, splits=splits, wn=wn, items=items, tpc=fit[0],
                             pull=int(pull and splits > 1), smem=fit[1])
                if items * splits >= sms:
                    options.append((items * splits > sms * GEMV_BLOCKS_PER_SM, wn * pps % GEMV_WARPS != 0, shape))
                else:
                    options.append((True, True, dict(shape, short=True)))
        if options:
            break
    full = [o for o in options if "short" not in o[2]]
    if full:
        plan = min(full, key=lambda o: o[:2])[2]  # stable: earlier shapes win ties
    elif options:
        plan = max((o[2] for o in options), key=lambda p: p["items"] * p["splits"])
    else:
        raise ValueError(f"no GEMV plan fits {GEMV_SMEM} bytes of shared memory at M={m} K={k} group={group}")
    plan.pop("short", None)
    cap = max(1, sms * GEMV_BLOCKS_PER_SM // plan["splits"])
    per = -(-plan["items"] // cap)
    grid_x = -(-plan["items"] // per)
    return dict(plan, grid_x=grid_x, blocks=grid_x * plan["splits"])


def gemv_args(plan: dict) -> tuple:
    """The plan as the GEMV launchers take it."""
    return tuple(plan[key] for key in ("tps", "splits", "wn", "cpp", "items", "grid_x", "tpc", "pull"))


def uses_tile(m: int) -> bool:
    """M > GEMV_MAX_ROWS rows go to the tensor-core tile, fewer to the GEMV kernel."""
    return m > _build.GEMV_MAX_ROWS


def tile_stage_k(group: int) -> int:
    """k elements of one stage of the tile: 128 (64 at group 16)."""
    return 64 if group == 16 else 128


def tile_smem_bytes(decode: str, group: int) -> int:
    """Dynamic shared memory of a tile block (``qmm_mma.cuh``'s Plan): a
    ring of stages (int8 rows of x, raw weight words, scale mantissas; 4
    stages of 64, 3 of 128), two decoded stages (weights [n][k],
    float scales) and the output sums.  Independent of K.  The launch
    passes it to the kernel, which refuses a size other than its Plan's."""
    ks = tile_stage_k(group)
    ring = 4 if ks == 64 else 3
    clusters = ks // group
    w = ks * TILE_N if decode == "int8" else ks // PER_WORD[decode] * TILE_N * 4
    return (ring * (TILE_M * ks + w + clusters * TILE_N) + 2 * (TILE_N * ks + 2 * clusters * TILE_N * 4)
            + TILE_OUT * TILE_THREADS * 4)


def tile_plan(m: int, k: int, n: int, decode: str, group: int, block_k: int = 512, sms: int = 132) -> dict:
    """Blocks, k-split, scratch and shared memory of one tile launch (one
    block an SM; the kernel's grid is (N / 128, M / 128, splits)).  A
    site whose output blocks fill at most half the SMs splits its k-tiles
    over grid.z, into up to sms // blocks splits (at most one k-tile
    each), as far as the scratch stays within TILE_SPLIT_BYTES: slot 0 for
    the first split's sum, one slot per later k-tile.  Splits pay for
    chunks of few rows; at M = 256 the scratch traffic and the combine
    cost what the fuller grid saves (PERF.md, the k-split log)."""
    nk = n_tiles(k, block_k)
    blocks = -(-m // TILE_M) * -(-n // TILE_N)
    splits, tps = 1, nk
    if 2 * blocks <= sms:
        for want in range(min(nk, sms // blocks), 1, -1):
            per = -(-nk // want)
            if (1 + nk - per) * m * n * 4 <= TILE_SPLIT_BYTES:
                splits, tps = -(-nk // per), per
                break
    return dict(blocks=blocks, splits=splits, tps=tps, ws_floats=(1 + nk - tps) * m * n if splits > 1 else 0,
                smem=tile_smem_bytes(decode, group))


def check_tile(k: int, group: int, block_k: int) -> None:
    """Raise on a tiling the tensor-core tile does not take: its cluster
    lengths, and k-tiles of whole stages (a ragged last tile may end inside
    a stage: the copies past K are zero-filled)."""
    ks = tile_stage_k(group)
    if group not in TILE_GROUPS or min(block_k, k) % ks:
        raise ValueError(f"the tensor-core tile (M > {_build.GEMV_MAX_ROWS}) takes group in {TILE_GROUPS} and "
                         f"k-tiles of whole {ks}-element stages; got group={group} K={k} block_k={block_k}")


def tile_scratch(dev, plan: dict, stream: int, experts: int = 1):
    """(ws, counters) of a split launch, (None, None) otherwise; an
    expert-stacked launch takes ``experts`` times both."""
    if plan["splits"] == 1:
        return None, None
    return (torch.empty(experts * plan["ws_floats"], dtype=torch.float32, device=dev),
            _build.arrival_counters(dev, stream, experts * plan["blocks"]))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def check_weights(m: int, k: int, packed, scale_m, *, decode: str, group: int, block_k: int, lead: tuple = ()):
    """Raise on weights or a tiling the kernels do not take; returns N.
    ``lead``: the weights' leading shape, (E,) for an expert site's stack."""
    if decode not in DECODES:
        raise ValueError(f"unknown decode {decode!r}; supported: {DECODES}")
    n, bk, lead = packed.shape[-1], min(block_k, k), tuple(lead)
    wdtype, wrows = (torch.int8, k) if decode == "int8" else (torch.int32, k // PER_WORD[decode])
    if packed.dtype != wdtype or packed.shape != lead + (wrows, n):
        raise ValueError(f"{decode} weights must be {wdtype} {lead + (wrows, n)}, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if scale_m.dtype != torch.int8 or scale_m.shape != lead + (k // group, n):
        raise ValueError(f"scale_m must be int8 {lead + (k // group, n)}, got {scale_m.dtype} {tuple(scale_m.shape)}")
    if k % group or bk % group or group % _UNIT_K[decode] or n % 4:
        raise ValueError(f"unsupported tiling K={k} block_k={bk} group={group} N={n} for {decode}")
    if uses_tile(m):
        check_tile(k, group, block_k)

    return n


def check_operands(x: torch.Tensor, *tensors) -> None:
    for t in (x,) + tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("all operands must lie on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("all operands must be contiguous and 16-byte aligned")


def fused_qmm(
    x, packed, scale_m, scale_e, *, decode: str, group: int, bias=None,
    act: Optional[str] = None, act_bits: int = 8,
    act_exponent: Optional[int] = None, block_k: int = 512,
) -> torch.Tensor:
    """x f32/bf16 (M, K) -> f32 (M, N).  CPU tensors take the plain
    version; CUDA tensors launch the GEMV kernel (M <= 8) or the tensor-
    core tile (M > 8), or raise.  The launch counts live on the format
    entries (``ternary_matmul_fused``, ...)."""
    if decode not in DECODES:
        raise ValueError(f"unknown decode {decode!r}; supported: {DECODES}")
    if act not in _ACTS:
        activation_fn(act)  # raises with the supported names
    if x.device.type == "cpu":
        return fused_qmm_ref(
            x, packed, scale_m, scale_e, decode=decode, group=group, bias=bias,
            act=act, act_bits=act_bits, act_exponent=act_exponent, block_k=block_k,
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    m, k = x.shape
    if k % (16 // x.element_size()):
        raise ValueError(f"K={k} does not split into 16-byte loads of {x.dtype}")
    n = check_weights(m, k, packed, scale_m, decode=decode, group=group, block_k=block_k)
    if scale_e.dtype != torch.int32 or scale_e.numel() != 1:
        raise ValueError("scale_e must be one int32")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        bias = bias.to(torch.float32).reshape(n)
    if not 1 <= act_bits <= 8:
        raise ValueError(f"act_bits={act_bits} outside the int8 mantissa range")
    check_operands(x, packed, scale_m, scale_e, *(() if bias is None else (bias,)))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    gemv, gemv8, tile = _lib()
    head = (x.data_ptr(), packed.data_ptr(), scale_m.data_ptr(), scale_e.data_ptr(), _ptr(bias), out.data_ptr())
    static = (int(act_exponent is not None), 0 if act_exponent is None else int(act_exponent))
    if uses_tile(m):
        plan = tile_plan(m, k, n, decode, group, block_k, _build.sm_count(x.device))
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        e = torch.empty((m,), dtype=torch.float32, device=x.device)
        ws, counters = tile_scratch(x.device, plan, stream)
        err = tile(int(x.dtype == torch.bfloat16), _MODE[decode], group, *head, xq.data_ptr(), e.data_ptr(),
                   _ptr(ws), _ptr(counters), m, k, n, min(block_k, k), plan["tps"], plan["splits"], _ACTS[act],
                   act_bits, *static, *lut_words(decode), plan["smem"], stream)
    elif uses_int8_loop(decode, m, k, n, group, block_k, _build.sm_count(x.device)):
        plan = int8_loop_plan(m, k, n, group, block_k, _build.sm_count(x.device))
        ws, counters = loop_scratch(x.device, plan, stream)
        err = gemv8(int(x.dtype == torch.bfloat16), *head, _ptr(ws), _ptr(counters), m, k, n, group,
                    min(block_k, k), *loop_args(plan), _ACTS[act], act_bits, *static, plan["smem"], stream)
    else:
        plan = gemv_plan(m, k, n, decode, group, block_k, _build.sm_count(x.device))
        err = gemv(int(x.dtype == torch.bfloat16), _GEMV_MODE[decode], *head, m, k, n, group, min(block_k, k),
                   _ACTS[act], act_bits, *static, *gemv_args(plan), *lut_words(decode), plan["smem"], stream)
    _build.check(err, "fused_qmm")
    return out
