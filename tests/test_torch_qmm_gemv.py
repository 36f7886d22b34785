"""The GEMV of the quantized dense kernels at M <= 8 (``csrc/qmm_gemv.cuh``),
emulated on the CPU (the kernel itself runs only on the card; lm_head's
int8 sites keep the int8 loop of ``qmm_gemv8.cuh``).

Torch rebuilds each part of the GEMV's data flow and holds it bit for bit
against the plain versions ``cluster_sums`` / ``fused_qmm_ref``:

- the lane -> (word row, columns) map of the 16-byte cp.async copies (int8:
  the lane's k-rows), and the decodes as the kernel's byte operations into
  A registers whose every byte meets the x byte of the same k in the
  lane's B registers (x rows in ``perm8`` order for ternary and int4);
- the ``m16n8k32`` / ``m16n8k16`` s8 fragment maps of the PTX ISA (the
  tile test's ``a_from_frags`` / ``b_from_frags`` / ``c_coords``): mma row
  g is column 4g + 2jp of the lane group's strip, row g + 8 the next one,
  C column 2t + e the x row;
- the float order: each cluster's dot from a fragment started at the bits
  of 1.5 * 2^23, ``fma(d, sm, -1.5 * 2^23 * sm)`` (int4: 16 x the dot and
  sm / 16), folded into a piece sum (a whole k-tile or one cluster), the
  pieces of a tile in order, the tiles in order; k-splits added slot by
  slot; inputs past 2^24 on which a reordered combine differs;
- the launch plan: at least one block an SM (or the documented cap: wk /
  wv, 32 strips x 4 splits) on every qwen3-8b site at M = 1..8, and a
  shared-memory plan that fits at K = 12288 (lm_head: the int8 loop's grid).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_qmm import (
    GEMV_BLOCKS_PER_SM, GEMV_MAX_SPLITS, GEMV_SMEM, GEMV_STRIP, GEMV_WARPS, TILE_GROUPS, check_weights, cluster_sums,
    fused_qmm_ref, gemv_plan, gemv_smem_bytes, gemv_step, lut_words, quantize_prologue, rows_per_block,
    uses_int8_loop, uses_tile,
)
from repro_torch.kernels.packed_qmm import expert_plan, expert_x_bytes, packed_qmm_ref
from repro_torch.quant.formats import quantize_weights
from test_torch_qmm_tile import (
    FMT_BITS, a_from_frags, as_words, b_from_frags, byte_perm, c_coords, lut4, magic_product, transpose4,
    words_to_bytes,
)

TABLE = 0xFF020100  # qmm_common.cuh::kTernaryTable
LANES = torch.arange(32)
G_OF, T_OF = LANES // 4, LANES % 4  # lane (g, t)
DECODES = ["ternary", "int4", "nf4", "int8"]
SMS = 132


# ---------------------------------------------------------------------------
# the lane map: copies, decodes, x order
# ---------------------------------------------------------------------------
def perm_pos(k):
    """Byte position of element k in a shared-memory x row of perm8 order."""
    k = torch.as_tensor(k)
    return (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1)


def uses_perm(decode):
    return decode in ("ternary", "int4")


def x_image(xq, decode):
    """(M, K) int8 rows -> the bytes the prologue stores (perm8 order for ternary and int4)."""
    if not uses_perm(decode):
        return xq.clone()
    out = torch.empty_like(xq)
    out[:, perm_pos(torch.arange(xq.shape[1]))] = xq
    return out


def lane_copy(packed, decode, group, k, col0):
    """The step at k of the strip at col0: each lane's cp.async bytes as uint32 words.
    2- and 4-bit: (32, 4) words of columns col0 + 4g + c at word row k / word_k + t / share;
    int8: (32, sk / 4) words, row k + (sk / 4) t + i of the lane's 4 columns."""
    sk = gemv_step(decode, group)[0]
    n = packed.shape[1]
    cols = col0 + 4 * G_OF
    ok = cols < n
    cols = torch.where(ok, cols, 0)
    if decode == "int8":
        raw = packed.view(torch.uint8).to(torch.int64)
        rows = k + (sk // 4) * T_OF[:, None] + torch.arange(sk // 4)[None]  # (32, sk/4)
        words = sum(raw[rows, cols[:, None] + c] << (8 * c) for c in range(4))
    else:
        word_k = 16 if decode == "ternary" else 8
        row = k // word_k + T_OF // (word_k * 4 // sk)
        words = as_words(packed)[row[:, None], cols[:, None] + torch.arange(4)[None]]
    return torch.where(ok[:, None], words, 0)


def decode_lanes(words, decode, group, lut):
    """qmm_gemv.cuh::decode: (32, ...) copied words -> A (32, 4 columns, regs) uint32."""
    sk = gemv_step(decode, group)[0]
    t = T_OF[:, None]
    if decode == "int8":  # 4 k-rows of the lane's 4 columns at a time, transposed
        out = torch.zeros(32, 4, sk // 16, dtype=torch.int64)
        for j in range(sk // 16):
            cols = transpose4([words[:, 4 * j + i] for i in range(4)])
            for c in range(4):
                out[:, c, j] = cols[c]
        return out
    w = words
    if decode == "ternary" and sk == 64:
        ev, od = w & 0x33333333, (w >> 2) & 0x33333333
        parts = [byte_perm(TABLE, 0, ev), byte_perm(TABLE, 0, od), byte_perm(TABLE, 0, ev >> 16),
                 byte_perm(TABLE, 0, od >> 16)]
    elif decode == "ternary" and sk == 32:
        h = w >> (16 * (t & 1))
        parts = [byte_perm(TABLE, 0, h & 0x3333), byte_perm(TABLE, 0, (h >> 2) & 0x3333)]
    elif decode == "ternary":
        parts = [byte_perm(TABLE, 0, (w >> (16 * (t >> 1) + 2 * (t & 1))) & 0x3333)]
    elif decode == "int4" and sk == 32:
        parts = [(w << 4) & 0xF0F0F0F0, w & 0xF0F0F0F0]
    elif decode == "int4":
        parts = [(w << (4 - 4 * (t & 1))) & 0xF0F0F0F0]
    elif sk == 32:
        parts = [lut4(w, lut), lut4(w >> 16, lut)]
    else:
        parts = [lut4(w >> (16 * (t & 1)), lut)]
    return torch.stack(parts, dim=-1) & 0xFFFFFFFF


def x_lanes(ximg, m, kl, regs):
    """B registers: lane (g, t) reads `regs` words of row g at kl + 4 regs t (rows >= M: zero)."""
    rows = torch.clamp(G_OF, max=m - 1)
    pos = kl + 4 * regs * T_OF[:, None] + torch.arange(4 * regs)[None]  # (32, 4 regs)
    b = ximg[rows[:, None], pos].to(torch.int64) & 0xFF
    b = torch.where((G_OF < m)[:, None], b, 0).reshape(32, regs, 4)
    return sum(b[..., i] << (8 * i) for i in range(4))


def reg_bytes(words):
    """(32,) uint32 words -> (32, 4) int8, the per-lane values a_from_frags / b_from_frags take."""
    return words_to_bytes([words])


def step_dots(a_regs, x_regs, sk):
    """The mma(s) of one step for column pair jp: {jp: (16, 8) int64 D} via the PTX fragment maps."""
    regs = sk // 16
    out = {}
    for jp in range(2):
        d = torch.zeros(16, 8, dtype=torch.int64)
        if sk == 16:
            a = a_from_frags([reg_bytes(a_regs[:, 2 * jp, 0]), reg_bytes(a_regs[:, 2 * jp + 1, 0])], k16=True)
            b = b_from_frags([reg_bytes(x_regs[:, 0])], k16=True)
            d += a.to(torch.int64) @ b.to(torch.int64)
        else:
            for s in range(regs // 2):
                a = a_from_frags([reg_bytes(a_regs[:, 2 * jp, 2 * s]), reg_bytes(a_regs[:, 2 * jp + 1, 2 * s]),
                                  reg_bytes(a_regs[:, 2 * jp, 2 * s + 1]), reg_bytes(a_regs[:, 2 * jp + 1, 2 * s + 1])])
                b = b_from_frags([reg_bytes(x_regs[:, 2 * s]), reg_bytes(x_regs[:, 2 * s + 1])])
                d += a.to(torch.int64) @ b.to(torch.int64)
        out[jp] = d
    return out


def mma_row_col(jp, col0):
    """Output column of mma row rho (0..15) for column pair jp: 4 (rho % 8) + 2 jp + rho // 8."""
    rho = torch.arange(16)
    return col0 + 4 * (rho % 8) + 2 * jp + rho // 8


def _lut(decode):
    return [torch.tensor(v, dtype=torch.int64) for v in lut_words(decode)]


def _qt(fmt, group, k, n, seed, biased=False):
    gen = np.random.default_rng(seed)
    w = gen.normal(size=(k, n)).astype(np.float32)
    if biased:
        w = np.abs(w) + 0.5
    return quantize_weights(torch.from_numpy(w), FMT_BITS[fmt], 32 if fmt == "mx" else group, fmt=fmt)


def _xq(m, k, seed, biased=False):
    x = np.random.default_rng(seed).integers(-127, 128, size=(m, k))
    if biased:
        x = np.abs(x) // 2 + 64
    return torch.from_numpy(x.astype(np.int8))


VARIANTS = [(d, g) for d in DECODES for g in TILE_GROUPS]


@pytest.mark.parametrize("decode,group", VARIANTS)
def test_every_a_byte_meets_the_x_byte_of_its_k(decode, group):
    """One-hot weights: each k of a step, set alone, lands in exactly one A
    byte of each lane group, the byte whose B byte holds x at that k."""
    sk = gemv_step(decode, group)[0]
    k_rows, n = 64, 32
    lut = _lut(decode)
    hot = 10 if decode == "nf4" else 1  # a weight value the decode holds (nf4: table entry 8)
    # x rows whose value encodes k (mod 127, no zeros) through the prologue's order
    xk = (torch.arange(k_rows) % 127 + 1).to(torch.int8)[None].repeat(8, 1)
    ximg = x_image(xk, decode)
    x_regs = x_lanes(ximg, 8, 0, sk // 16)
    xb = torch.stack([reg_bytes(x_regs[:, j]) for j in range(sk // 16)], dim=1)  # (32, regs, 4)
    for kk in range(sk):
        w = torch.zeros(k_rows, n, dtype=torch.int8)
        w[kk, :] = hot
        packed = _encode(w, decode)
        a = decode_lanes(lane_copy(packed, decode, group, 0, 0), decode, group, lut)  # (32, 4, regs)
        ab = torch.stack([torch.stack([reg_bytes(a[:, c, j]) for j in range(sk // 16)], dim=1) for c in range(4)],
                         dim=1)  # (32, 4 cols, regs, 4 bytes)
        hits = (ab == (16 * hot if decode == "int4" else hot)).nonzero().tolist()
        assert len(hits) == 8 * 4  # every lane group, every column, once
        for lane, c, j, i in hits:
            assert int(xb[lane, j, i]) == kk % 127 + 1
        assert int((ab != 0).sum()) == 8 * 4


def _encode(w, decode):
    """(K, N) int8 weights -> packed words of the decode (only values the decode can hold)."""
    k, n = w.shape
    if decode == "int8":
        return w.clone()
    if decode == "ternary":
        codes = w.to(torch.int64) & 3  # 0 -> 0, 1 -> 1, -1 -> 3
        codes = codes.reshape(k // 16, 16, n)
        return sum(codes[:, i] << (2 * i) for i in range(16)).to(torch.int64).to(torch.int32)
    table = torch.tensor([v for v in _LUT_VALUES[decode]], dtype=torch.int64)
    codes = torch.stack([(table == v).nonzero()[0, 0] for v in w.reshape(-1).tolist()]).reshape(k // 8, 8, n)
    words = sum(codes[:, i] << (4 * i) for i in range(8))
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


_LUT_VALUES = {"int4": [c if c < 8 else c - 16 for c in range(16)],
               "nf4": [-127, -88, -67, -50, -36, -23, -12, 0, 10, 20, 31, 43, 56, 71, 92, 127]}


@pytest.mark.parametrize("decode,group", VARIANTS)
def test_copies_cover_the_step_once(decode, group):
    """The 32 lanes' copies of a step hold every (column, k) of the strip's
    32 columns x sk k exactly once per lane group's share of it: the word
    rows are the step's, the columns the lane group's four."""
    sk = gemv_step(decode, group)[0]
    k, n = 256, 40  # the second strip is 8 columns: lanes past N copy zeros
    if decode == "int8":  # byte (row, column) holds 2 row, + 1 in columns 36..39
        packed = (torch.arange(k)[:, None] * 2 + (torch.arange(n)[None] >= 36)).to(torch.int8)
        words = lane_copy(packed, decode, group, sk, 32)
        assert bool((words[G_OF >= 2] == 0).all())  # columns 40.. do not exist
        rows = {(int(v) & 0xFF) // 2 for v in words[G_OF < 2].reshape(-1).tolist()}
        assert rows == set(range(sk, 2 * sk))  # the step's k-rows, each from one lane
        return
    packed = torch.arange((k // (16 if decode == "ternary" else 8)) * n).to(torch.int32).reshape(-1, n)
    words = lane_copy(packed, decode, group, sk, 32)  # the second step of the second strip
    assert bool((words[G_OF >= 2] == 0).all())  # columns 40.. do not exist
    word_k = 16 if decode == "ternary" else 8
    rows = {int(v) // n for v in words[G_OF < 2].reshape(-1).tolist()}
    assert rows == set(range(sk // word_k, 2 * sk // word_k))
    cols = {int(v) % n for v in words[G_OF < 2].reshape(-1).tolist()}
    assert cols == set(range(32, 40))


# ---------------------------------------------------------------------------
# fragment maps and the float order
# ---------------------------------------------------------------------------
def emulate_gemv(xq, packed, scale_m, *, decode, group, block_k=512, plan=None, slot_order=1):
    """The GEMV's sums for the whole (M, N) output, step by step as the
    kernel runs them: lane copies, decodes, B registers, mma through the
    PTX fragment maps, one magic-number product per cluster folded into
    its piece, pieces of a tile in order, tiles in order (the first split's
    tiles, then each later split's, as block 0 of the cluster reads them;
    ``slot_order=-1`` adds the later splits' tiles in reverse).  A ragged
    last k-tile has fewer pieces (single clusters) or a shorter piece
    (whole tiles), as the kernel's ``pps`` and ``piece_cl``."""
    m, k = xq.shape
    n = packed.shape[1]
    bk = min(block_k, k)
    nk, cpt = -(-k // bk), bk // group
    plan = plan or gemv_plan(m, k, n, decode, group, block_k)
    cpp, tps, splits = plan["cpp"], plan["tps"], plan["splits"]
    sk = gemv_step(decode, group)[0]
    scale = 1 / 16 if decode == "int4" else 1.0
    lut = _lut(decode)
    ximg = x_image(xq, decode)
    sm = scale_m.to(torch.float32) * scale
    strips = -(-n // GEMV_STRIP)
    out = torch.zeros(m, n, dtype=torch.float32)
    for s in range(strips):
        col0 = s * GEMV_STRIP
        tile_sums = []
        for t in range(nk):
            slots = []
            clusters = min(bk, k - t * bk) // group  # of this k-tile
            for p in range(-(-clusters // cpp)):
                acc = {jp: torch.zeros(16, 8, dtype=torch.float32) for jp in range(2)}
                for cl in range(min(cpp, clusters - p * cpp)):
                    kc = t * bk + (p * cpp + cl) * group
                    dots = {jp: torch.zeros(16, 8, dtype=torch.int64) for jp in range(2)}
                    for st in range(group // sk):
                        kk = kc + st * sk
                        a = decode_lanes(lane_copy(packed, decode, group, kk, col0), decode, group, lut)
                        d = step_dots(a, x_lanes(ximg, m, kk, sk // 16), sk)
                        for jp in range(2):
                            dots[jp] += d[jp]
                    for jp in range(2):
                        cols = mma_row_col(jp, col0)
                        s_col = torch.where(cols < n, sm[kc // group][torch.clamp(cols, max=n - 1)], 0.0)
                        assert int(dots[jp].abs().max()) < 2**22
                        acc[jp] = acc[jp] + magic_product(dots[jp], s_col[:, None].expand(16, 8))
                slots.append(acc)
            ts = {jp: torch.zeros(16, 8) for jp in range(2)}
            for acc in slots:  # the fold: the tile's slots in order
                for jp in range(2):
                    ts[jp] = ts[jp] + acc[jp]
            tile_sums.append(ts)
        run = {jp: torch.zeros(16, 8) for jp in range(2)}
        for ts in tile_sums[:tps]:
            for jp in range(2):
                run[jp] = run[jp] + ts[jp]
        for ts in (tile_sums[tps:] if splits > 1 else [])[::slot_order]:
            for jp in range(2):
                run[jp] = run[jp] + ts[jp]
        for jp in range(2):
            cols = mma_row_col(jp, col0)
            for rho in range(16):
                if cols[rho] < n:
                    out[:, cols[rho]] = run[jp][rho, :m]
    return out


def test_c_fragments_map_rows_to_columns_and_x_rows():
    """C element e of lane (g, t) is mma row g + 8 (e >> 1) -- column 4g +
    2jp + (e >> 1) of the strip -- and x row 2t + (e & 1): the kernel's
    slot writes (float2 of elements 0, 2 at row 2t, of 1, 3 at row 2t + 1)
    cover the strip's 32 columns x 8 rows once."""
    seen = torch.zeros(8, GEMV_STRIP, dtype=torch.int64)
    for jp in range(2):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for e in range(4):
                row, col = c_coords(lane, e)
                assert row == g + 8 * (e >> 1) and col == 2 * t + (e & 1)
                seen[col, int(mma_row_col(jp, 0)[row])] += 1
    assert torch.equal(seen, torch.ones_like(seen))


CASES = [(m, k, n) for m in (1, 3, 8) for k, n in ((512, 40), (1536, 32))]


@pytest.mark.parametrize("decode,group", VARIANTS)
@pytest.mark.parametrize("m,k,n", CASES)
def test_gemv_order_matches_cluster_sums(decode, group, m, k, n):
    qt = _qt(decode, group, k, n, m * 100 + k + group, biased=k > 512)
    xq = _xq(m, k, k + n + group, biased=k > 512)
    got = emulate_gemv(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("cpp_kind", ["tile", "cluster"])
@pytest.mark.parametrize("splits", [1, 3])
def test_pieces_and_splits_keep_the_order(cpp_kind, splits):
    """Whole-tile pieces or single clusters, unsplit or split 3 ways: the
    same bits as cluster_sums; the later splits' tiles added in reverse
    differ (the biased inputs pass 2^24, so the order shows)."""
    m, k, n, group = 4, 3072, 32, 64
    qt = _qt("int4", group, k, n, 11, biased=True)
    xq = _xq(m, k, 12, biased=True)
    nk, cpt = k // 512, 512 // group
    tps = -(-nk // splits)
    plan = dict(cpp=cpt if cpp_kind == "tile" else 1, tps=tps, splits=-(-nk // tps))
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode="int4", group=group)
    assert float(want.abs().max()) > 2**24
    got = emulate_gemv(xq, qt.packed, qt.scale_m, decode="int4", group=group, plan=plan)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if splits > 1:
        rev = emulate_gemv(xq, qt.packed, qt.scale_m, decode="int4", group=group, plan=plan, slot_order=-1)
        assert not torch.equal(rev.view(torch.int32), want.view(torch.int32))


def test_a_flat_fold_differs_on_biased_inputs():
    """One flat sum over all clusters (no k-tile sums) differs from the
    reference on these inputs: the order tests above can fail."""
    from repro_torch.kernels.fused_qmm import _decode

    m, k, n = 4, 3072, 32
    qt = _qt("int4", 64, k, n, 11, biased=True)
    xq = _xq(m, k, 12, biased=True)
    w = _decode(qt.packed, "int4", k).to(torch.int64)
    flat = torch.zeros(m, n)
    for c in range(k // 64):
        dot = xq[:, 64 * c:64 * c + 64].to(torch.int64) @ w[64 * c:64 * c + 64]
        flat = flat + dot.to(torch.float32) * qt.scale_m[c].to(torch.float32)
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode="int4", group=64)
    assert not torch.equal(flat.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("decode", DECODES)
def test_gemv_epilogue_matches_the_fused_site(decode):
    """Prologue (exponents over the full row, int8 mantissas) + GEMV sums +
    epilogue equal fused_qmm_ref, dynamic and static exponent."""
    from repro_torch.core import dfp
    from repro_torch.kernels.fused_qmm import activation_fn

    gen = np.random.default_rng(5)
    m, k, n, group = 4, 1024, 40, 64
    x = torch.from_numpy(gen.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    x[1, 9] = float("nan")
    qt = _qt(decode, group, k, n, 6)
    bias = torch.from_numpy(gen.normal(size=(n,)).astype(np.float32))
    for static_e, act in ((None, "silu"), (-3, "gelu"), (None, "relu")):
        xq, e = quantize_prologue(x, 8, static_e)
        o = emulate_gemv(xq, qt.packed, qt.scale_m, decode=decode, group=group)
        y = activation_fn(act)(o * dfp.exp2i(qt.scale_e.to(torch.float32) + e) + bias)
        want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, group=group, bias=bias, act=act,
                             act_exponent=static_e)
        assert torch.equal(y.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("group", TILE_GROUPS)
def test_int4_sixteenfold_product_is_exact(group):
    """int4 fields read as high nibbles give 16 x the dot; with sm / 16 the
    magic-number product is float(dot) * sm rounded once, and 16 |dot|
    stays under 2^22."""
    bound = 16 * 8 * 127 * group
    assert bound < 2**22
    dots = torch.tensor([-bound // 16, -1, 0, 1, 12345, bound // 16], dtype=torch.int64)
    for sm in (-128, -127, -3, 1, 7, 127):
        got = magic_product(16 * dots, torch.full((6,), sm / 16, dtype=torch.float32))
        want = dots.to(torch.float32) * torch.full((6,), float(sm))
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
QWEN_SITES = [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)]  # wq/wo, wk/wv, gate/up, down
QWEN_FORMATS = [("ternary", 64), ("int4", 64), ("nf4", 64), ("int8", 32)]  # the layers' formats (mx: int8 at 32)


@pytest.mark.parametrize("decode,group", QWEN_FORMATS)
@pytest.mark.parametrize("m", range(1, 9))
def test_plan_fills_the_card_on_every_site(decode, group, m):
    """At least one block an SM, or the documented cap: wk / wv have 32
    strips and at most GEMV_MAX_SPLITS (4) splits, 128 blocks."""
    for k, n in QWEN_SITES:
        plan = gemv_plan(m, k, n, decode, group, sms=SMS)
        cap = -(-n // GEMV_STRIP) * min(GEMV_MAX_SPLITS, k // 512)
        assert plan["blocks"] >= min(SMS, cap), (k, n, plan)
        assert plan["smem"] <= GEMV_SMEM
        assert plan["grid_x"] * plan["splits"] == plan["blocks"] <= SMS * 2  # resident at once: no tail wave
    assert gemv_plan(m, 4096, 1024, decode, group)["blocks"] == 128  # wk / wv: the cap


def test_plan_prefers_resident_blocks():
    """down (K = 12288, 128 strips): 2 splits put 256 blocks on the card at
    once; 3 would give every warp the same pieces but loop over items."""
    p = gemv_plan(4, 12288, 4096, "ternary", 64)
    assert (p["splits"], p["grid_x"], p["blocks"]) == (2, 128, 256)


@pytest.mark.parametrize("decode,group", VARIANTS)
def test_plan_caps_where_the_pieces_run_out(decode, group):
    """Below one block an SM only where the splits run out (wk / wv: 32
    strips x 4 splits) or every warp already has one cluster of one strip
    (wk / wv at group 128)."""
    for k, n in QWEN_SITES:
        plan = gemv_plan(4, k, n, decode, group, sms=SMS)
        strips = -(-n // GEMV_STRIP)
        assert plan["blocks"] >= min(SMS, strips * (k // group) // GEMV_WARPS, strips * GEMV_MAX_SPLITS)


@pytest.mark.parametrize("decode,group", VARIANTS)
def test_shared_memory_plan_fits_at_k_12288(decode, group):
    for m in (1, 4, 8):
        plan = gemv_plan(m, 12288, 4096, decode, group)
        assert plan["smem"] == gemv_smem_bytes(m, 12288, decode, group, 512, plan["tps"], plan["cpp"], plan["wn"])
        assert plan["smem"] <= GEMV_SMEM


@pytest.mark.parametrize("m", range(1, 9))
def test_lm_head_int8_loop_fills_the_card(m):
    """lm_head (int8, K = 4096, N = 152064) keeps the int8 loop: 128
    columns and up to 8 rows a block, 1188 blocks at every M <= 8; the mx
    layers' int8 sites run the GEMV."""
    rows = rows_per_block(m, 4096, "int8", 64)
    assert rows == 8 and -(-152064 // 128) * -(-m // rows) == 1188
    assert uses_int8_loop("int8", 152064) and not any(uses_int8_loop("int8", n) for _, n in QWEN_SITES)
    assert not uses_int8_loop("ternary", 152064)


def test_plan_splits_and_loops():
    p = gemv_plan(4, 4096, 1024, "ternary", 64)  # wk: single clusters, 4 splits of two tiles (a cluster of 4)
    assert (p["cpp"], p["tps"], p["splits"], p["items"]) == (1, 2, 4, 32)
    p = gemv_plan(4, 4096, 152064, "ternary", 64)  # lm_head-wide: whole tiles, no split, blocks loop over items
    assert (p["cpp"], p["splits"]) == (8, 1) and p["items"] > p["grid_x"]
    for k in (4096, 12288):  # the splits of an item form one thread block cluster of at most 4
        for n in (1024, 4096, 12288):
            for decode, group in VARIANTS:
                assert gemv_plan(4, k, n, decode, group)["splits"] <= GEMV_MAX_SPLITS == 4


@pytest.mark.parametrize("m", [1, 4, 8])
def test_gemv_takes_m_up_to_8_and_its_groups(m):
    assert not uses_tile(m) and _build.GEMV_MAX_ROWS == 8
    qt = quantize_weights(torch.randn(256, 16), 4, 8)
    assert check_weights(m, 256, qt.packed, qt.scale_m, decode="int4", group=8, block_k=512) == 16
    with pytest.raises(ValueError, match="GEMV"):  # group 8: no mma k takes it
        gemv_plan(m, 256, 16, "int4", 8)
    assert gemv_plan(m, 256, 16, "int4", 16)["blocks"] >= 1


# ---------------------------------------------------------------------------
# The expert-batched GEMV of an MoE site at decode (csrc/qmm_gemv_experts.cuh):
# its B registers from raw x bytes, its walk over the routed experts, its
# plan, its float order.
# ---------------------------------------------------------------------------
def x_raw_lanes(xq, m, kl, decode, group):
    """The expert kernel's B registers of the step at kl: lane (g, t) copies
    its raw bytes of row g (XLane: 4 regs bytes at 4 regs t, or for ternary
    and int4 at 16-k steps the 8 bytes at 8 (t >> 1); rows >= M zero) and
    permutes them into perm8 order (x_regs: one __byte_perm a register)."""
    regs = gemv_step(decode, group)[0] // 16
    xb = expert_x_bytes(decode, group)
    off = xb * T_OF if xb == 4 * regs else 8 * (T_OF >> 1)
    rows = torch.clamp(G_OF, max=m - 1)
    b = xq[rows[:, None], kl + off[:, None] + torch.arange(xb)[None]].to(torch.int64) & 0xFF
    b = torch.where((G_OF < m)[:, None], b, 0).reshape(32, xb // 4, 4)
    raw = sum(b[..., i] << (8 * i) for i in range(4))  # (32, xb / 4) words
    if not uses_perm(decode):
        return raw
    if regs == 1:
        return byte_perm(raw[:, 0], raw[:, 1], torch.where(T_OF & 1 == 1, 0x7531, 0x6420))[:, None]
    out = torch.empty_like(raw)
    for j in range(0, regs, 2):
        lo, hi = raw[:, j], raw[:, j + 1]
        out[:, j], out[:, j + 1] = byte_perm(lo, hi, 0x6420), byte_perm(lo, hi, 0x7531)
    return out


@pytest.mark.parametrize("decode,group", VARIANTS)
def test_expert_b_registers_from_raw_x_bytes(decode, group):
    """The raw bytes a lane copies and permutes in registers are the B
    registers the one-site GEMV reads from its perm8 rows in shared
    memory, at every step of a K with a ragged tile, M 3 and 8."""
    sk = gemv_step(decode, group)[0]
    for m in (3, 8):
        xq = _xq(m, 640, m + group)
        img = x_image(xq, decode)
        for kl in range(0, 640, sk):
            assert torch.equal(x_raw_lanes(xq, m, kl, decode, group), x_lanes(img, m, kl, sk // 16)), (m, kl)


def expert_units(routed, n, grid, warps=GEMV_WARPS):
    """Each warp's units of the walk, as the kernel assigns them: the
    routed experts (ascending) x ceil(N / 32) strips, unit u = (routed[u //
    strips], u % strips), warp w of W = grid x warps taking [w U / W, (w + 1)
    U / W).  Returns [(expert, strip), ...] a warp, warp-major."""
    strips = -(-n // GEMV_STRIP)
    units, total = len(routed) * strips, grid * warps
    return [[(routed[u // strips], u % strips) for u in range(w * units // total, (w + 1) * units // total)]
            for w in range(total)]


EXPERT_SITES = [(8, 6144, 32768), (8, 32768, 6144), (128, 7168, 4864), (128, 4864, 7168)]  # grok, arctic


def _routed_sets(e):
    return {"none": [], "one": [e - 1], "tick": sorted(np.random.default_rng(e).permutation(e)[:5 if e == 8 else 8]),
            "all": list(range(e))}


@pytest.mark.parametrize("e,k,n", EXPERT_SITES)
def test_expert_walk_covers_routed_units_and_skipped_blocks_once(e, k, n):
    """grok's and arctic's sites with 0, 1, a decode tick's and all experts
    routed: the warps' units are every routed expert's strips once and no
    skipped expert's, adjacent in a warp and balanced to one unit; the
    grid-strided +0 stores cover every skipped expert's (C, N) out block
    once, in 16-byte stores."""
    plan = expert_plan(e, 8, k, "ternary", 64, SMS)
    strips = -(-n // GEMV_STRIP)
    for name, routed in _routed_sets(e).items():
        walk = expert_units(routed, n, plan["grid"])
        units = [u for w in walk for u in w]
        assert sorted(units) == sorted((r, s) for r in routed for s in range(strips)), name
        sizes = [len(w) for w in walk]
        assert max(sizes) - min(sizes) <= 1
        for w in walk:  # a warp's units are consecutive strips (of one expert, or the next one's first)
            flat = [routed.index(r) * strips + s for r, s in w]
            assert flat == list(range(flat[0], flat[0] + len(flat))) if flat else True
        skipped = [i for i in range(e) if i not in routed]
        per4 = 8 * n // 4
        idx = np.arange(len(skipped) * per4)  # the zero loop's i, over grid x 256 threads strided
        blocks = np.asarray(skipped, dtype=np.int64)[idx // per4] * per4 + idx % per4
        assert len(np.unique(blocks)) == len(skipped) * per4
        assert set(np.asarray(skipped)[idx // per4].tolist()) == set(skipped)


@pytest.mark.parametrize("decode,group", VARIANTS + [("int8", 32)])
def test_expert_plan_fills_the_card_whatever_e_and_fits(decode, group):
    """The expert plan: GEMV_BLOCKS_PER_SM blocks an SM for E 8 and 128
    (the whole card, never sms / E), each warp's ring (weights, x and
    scale words) within GEMV_SMEM at that residency, and a scan of about
    two blocks an SM.  A unit walks the whole K of its strip once: each x
    byte of its expert's rows is copied once, in k order -- grok's down
    projection (K 32768) included, where the one-site plan stages x a
    k-tile at a time."""
    for e, k, n in EXPERT_SITES:
        plan = expert_plan(e, 8, k, decode, group, SMS)
        assert plan["grid"] == SMS * GEMV_BLOCKS_PER_SM
        assert plan["smem"] <= GEMV_SMEM
        assert 1 <= plan["slices"] <= 32 and e * plan["slices"] <= 4 * SMS
    sk = gemv_step(decode, group)[0]
    k = 32768
    copied = np.concatenate([np.arange(kl, kl + sk) for cl in range(k // group) for st in range(group // sk)
                             for kl in [cl * group + st * sk]])
    assert np.array_equal(copied, np.arange(k))


@pytest.mark.parametrize("decode", DECODES)
def test_expert_gemv_order_matches_plain_with_skipped_experts(decode):
    """Each routed expert's strips walked as the expert kernel walks them
    (the whole K, clusters in order into each k-tile's sum from 0, the
    tiles in order into the run from 0; a ragged last tile) and +0 for the
    skipped experts: the plain expert loop's bits."""
    e, m, k, n, group = 3, 8, 1280, 40, 32
    qt = quantize_weights(torch.from_numpy(np.random.default_rng(3).normal(size=(e, k, n)).astype(np.float32)),
                          FMT_BITS[decode], group, fmt=decode)
    xq = torch.stack([_xq(m, k, i) for i in range(e)])
    xq[1] = 0  # skipped
    xq[2, 5:] = 0  # a routed expert's empty capacity rows
    nk, cpt = -(-k // 512), 512 // group
    got = torch.zeros(e, m, n)
    for ex in (0, 2):
        got[ex] = emulate_gemv(xq[ex], qt.packed[ex], qt.scale_m[ex], decode=decode, group=group,
                               plan=dict(cpp=cpt, tps=nk, splits=1))
    want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=group)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not want[1].view(torch.int32).any()
