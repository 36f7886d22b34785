"""The int8 tensor-core tile of the quantized dense kernels at M > 8
(``csrc/qmm_mma.cuh``), emulated on the CPU (the kernel itself runs only
on the card).

Torch rebuilds each part of the tile's data flow and holds it bit for bit
against the plain versions ``cluster_sums`` / ``fused_qmm_ref``:

- the weight decodes as the kernel's byte operations (``__byte_perm``
  selects, the ternary table, ``lut4``, the 4 x 4 byte transpose) into the
  B operand's ``[n][k]`` rows;
- the shared-memory images (16-byte chunks XOR-swizzled by row), the
  lanes' ``ldmatrix`` addresses, and the ``m16n8k32`` / ``m16n8k16`` s8 A,
  B and C fragment maps of the PTX ISA: the matrices the tensor core sees
  must be the logical tiles, and the C fragments land where the epilogue
  writes them;
- the float order: each cluster's dot taken from a fragment that started
  at the bits of 1.5 * 2^23, ``fma(d, sm, -1.5 * 2^23 * sm)`` (exact in
  float64, rounded once to float32), added into the k-tile sum, k-tiles
  closed on stage boundaries, k-splits combined slot by slot;
- the wrapper's routing (M <= 8: GEMV, M > 8: the tile), the launch plan
  and its shared memory at K = 12288, and the exactness bound of the
  magic-number conversion for every cluster length the wrapper admits.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_qmm import (
    TILE_GROUPS, TILE_M, TILE_N, _decode, check_tile, cluster_sums, fused_qmm, fused_qmm_ref, lut_words, tile_plan,
    tile_stage_k, uses_tile,
)
from repro_torch.quant.formats import quantize_weights

MAGIC_BITS = 0x4B400000
MAGIC = 12582912.0
WARPS_M, WARPS_N, WM, WN = 2, 4, 64, 32  # qmm_mma.cuh: 8 warps of 64 x 32
FMT_BITS = {"ternary": 2, "int4": 4, "nf4": 4, "int8": 8, "mx": 8}


# ---------------------------------------------------------------------------
# byte operations (uint32 words held in int64 tensors)
# ---------------------------------------------------------------------------
def byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of {y, x}."""
    x, y, sel = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.int64) for v in (x, y, sel)))
    stacked = torch.stack([(x >> (8 * j)) & 0xFF for j in range(4)] + [(y >> (8 * j)) & 0xFF for j in range(4)])
    out = torch.zeros_like(x)
    for i in range(4):
        idx = (sel >> (4 * i)) & 7
        out = out | (torch.gather(stacked, 0, idx[None])[0] << (8 * i))
    return out


def decode_ternary16(w):
    """qmm_mma.cuh::decode_ternary16: 16 2-bit codes -> four words of int8 in k order."""
    table = torch.tensor(0xFF020100, dtype=torch.int64)
    ev, od = w & 0x33333333, (w >> 2) & 0x33333333
    e0, e1 = byte_perm(table, 0, ev), byte_perm(table, 0, ev >> 16)
    o0, o1 = byte_perm(table, 0, od), byte_perm(table, 0, od >> 16)
    return [byte_perm(e0, o0, 0x5140), byte_perm(e0, o0, 0x7362), byte_perm(e1, o1, 0x5140),
            byte_perm(e1, o1, 0x7362)]


def lut4(w, lut):
    """qmm_common.cuh::lut4: four 4-bit fields (low 16 bits) -> four table bytes."""
    sel = w & 0x7777
    lo, hi = byte_perm(lut[0], lut[1], sel), byte_perm(lut[2], lut[3], sel)
    return byte_perm(lo, hi, 0x3210 | ((w >> 1) & 0x4444))


def transpose4(r):
    """qmm_mma.cuh::transpose4: word q of the result holds byte q of each input word."""
    t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[2], r[3], 0x5140)
    t2, t3 = byte_perm(r[0], r[1], 0x7362), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632), byte_perm(t2, t3, 0x5410),
            byte_perm(t2, t3, 0x7632)]


def words_to_bytes(words):
    """[(...)] uint32 words -> (..., 4 * len) int8 bytes, little-endian."""
    parts = [torch.stack([(w >> (8 * j)) & 0xFF for j in range(4)], dim=-1) for w in words]
    return torch.cat(parts, dim=-1).to(torch.uint8).view(torch.int8)


def as_words(packed):
    return packed.to(torch.int64) & 0xFFFFFFFF


def decoded_b(packed, decode, k):
    """The decode's [n][k] int8 rows of the whole weight matrix, by the kernel's byte operations."""
    n = packed.shape[1]
    if decode == "ternary":
        w = as_words(packed).t()  # (N, K/16): word c of column n holds k 16c..16c+15
        return words_to_bytes(decode_ternary16(w)).reshape(n, k)
    if decode in ("int4", "nf4"):
        lut = [torch.tensor(v, dtype=torch.int64) for v in lut_words(decode)]
        w = as_words(packed).t()  # (N, K/8)
        b = words_to_bytes([lut4(w, lut), lut4(w >> 16, lut)])  # (N, K/8, 8)
        return b.reshape(n, k)
    raw = packed.view(torch.uint8).to(torch.int64)  # (K, N)
    rows = [raw[j::4] for j in range(4)]  # byte j of each 4-row group: (K/4, N)
    # four columns a word, as the kernel loads them: word = 4 bytes of one row
    words = [sum(rows[j][:, c::4] << (8 * c) for c in range(4)) for j in range(4)]  # (K/4, N/4)
    cols = transpose4(words)  # cols[q]: column 4nq + q, k 4kq..4kq+3
    out = torch.stack([words_to_bytes([cq.t()]) for cq in cols], dim=1)  # (N/4, 4, K/4, 4)
    return out.reshape(n, k)


# ---------------------------------------------------------------------------
# shared memory, ldmatrix, fragments
# ---------------------------------------------------------------------------
def tile_off(r, c, ks):
    swz = (r >> 1) & 3 if ks == 64 else r & 7
    return r * ks + ((c ^ swz) << 4)


def smem_image(tile, ks):
    """[rows][ks] int8 tile -> the swizzled bytes the kernel stores (one 16-byte chunk at a time)."""
    rows = tile.shape[0]
    img = torch.zeros(rows * ks, dtype=torch.int8)
    for c in range(ks // 16):
        r = torch.arange(rows)
        off = tile_off(r, c, ks)
        img[(off[:, None] + torch.arange(16)).reshape(-1)] = tile[:, 16 * c:16 * c + 16].reshape(-1)
    return img


def ldsm_x4(img, addr):
    """ldmatrix.x4 (b16): lane l supplies the row address addr[l] of matrix l // 8; register q of
    lane l gets 4 bytes (word l % 4) of row l // 4 of matrix q.  Returns int8 (4, 32, 4)."""
    rows = img[(addr[:, None] + torch.arange(16)).reshape(-1)].reshape(4, 8, 16)
    lane = torch.arange(32)
    return rows[:, lane // 4].reshape(4, 32, 4, 4)[:, lane, lane % 4]


def a_from_frags(regs, k16=False):
    """A (16 x 32 s8, row-major) from a warp's registers (PTX ISA m16n8k32 .s8: reg j of lane
    (g, t) holds row g + 8 (j & 1), columns 4t + 16 (j >> 1) .. + 3)."""
    a = torch.zeros(16, 16 if k16 else 32, dtype=torch.int8)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(2 if k16 else 4):
            a[g + 8 * (j & 1), 4 * t + 16 * (j >> 1):4 * t + 16 * (j >> 1) + 4] = regs[j][lane]
    return a


def b_from_frags(regs, k16=False):
    """B (32 x 8 s8, K-major) from registers (m16n8k32 .s8: reg j of lane (g, t) holds k = 4t +
    16 j .. + 3 of column g)."""
    b = torch.zeros(16 if k16 else 32, 8, dtype=torch.int8)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(1 if k16 else 2):
            b[4 * t + 16 * j:4 * t + 16 * j + 4, g] = regs[j][lane]
    return b


def c_coords(lane, e):
    """C/D element e of lane (g, t) in m16n8 (PTX ISA): row g + 8 (e >> 1), column 2t + (e & 1)."""
    return lane // 4 + 8 * (e >> 1), 2 * (lane % 4) + (e & 1)


# ---------------------------------------------------------------------------
# decodes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["ternary", "int4", "nf4", "int8", "mx"])
@pytest.mark.parametrize("group", [32, 64])
def test_decode_writes_the_b_operand_rows(fmt, group):
    gen = torch.Generator().manual_seed(group)
    k, n = 256, 48
    qt = quantize_weights(torch.randn((k, n), generator=gen), FMT_BITS[fmt], group, fmt=fmt)
    decode = "int8" if fmt == "mx" else fmt
    want = _decode(qt.packed, decode, k).t()  # (N, K)
    assert torch.equal(decoded_b(qt.packed, decode, k), want)


def test_ternary_table_covers_every_code():
    w = torch.tensor([int("".join(f"{c:02b}" for c in reversed([i % 4] * 16)), 2) for i in range(4)],
                     dtype=torch.int64)
    got = words_to_bytes(decode_ternary16(w))
    assert got.tolist() == [[v] * 16 for v in (0, 1, 2, -1)]  # ((c + 1) & 3) - 1, code 2 included


# ---------------------------------------------------------------------------
# swizzle, ldmatrix and the fragment maps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ks", [64, 128])
def test_swizzle_keeps_eight_ldmatrix_rows_on_distinct_banks(ks):
    for c in range(ks // 16):
        for r0 in range(0, 128, 8):
            units = {(tile_off(r, c, ks) // 16) % 8 for r in range(r0, r0 + 8)}
            assert len(units) == 8


@pytest.mark.parametrize("ks,k16", [(128, False), (64, False), (64, True)])
def test_ldmatrix_addresses_give_the_mma_fragments(ks, k16):
    """Every warp's A and B registers, loaded from the swizzled tiles at the
    kernel's lane addresses, are the PTX fragments of its logical tiles."""
    gen = torch.Generator().manual_seed(ks + k16)
    a_tile = torch.randint(-128, 128, (TILE_M, ks), generator=gen, dtype=torch.int8)
    b_tile = torch.randint(-128, 128, (TILE_N, ks), generator=gen, dtype=torch.int8)  # [n][k]
    a_img, b_img = smem_image(a_tile, ks), smem_image(b_tile, ks)
    lane = torch.arange(32)
    for q in range(ks // 32):  # a k32 step
        for wm in range(WARPS_M):
            for mi in range(WM // 16):
                row = wm * WM + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1)
                regs = ldsm_x4(a_img, tile_off(row, 2 * q + (lane >> 4), ks))
                r0, k0 = wm * WM + 16 * mi, 32 * q
                if k16:  # group 16: k16 mma on each half of the k32 registers
                    for j in range(2):
                        got = a_from_frags([regs[2 * j], regs[2 * j + 1]], k16=True)
                        assert torch.equal(got, a_tile[r0:r0 + 16, k0 + 16 * j:k0 + 16 * j + 16])
                else:
                    assert torch.equal(a_from_frags(regs), a_tile[r0:r0 + 16, k0:k0 + 32])
        for wn in range(WARPS_N):
            for np_ in range(WN // 16):
                row = wn * WN + 16 * np_ + (lane & 7) + 8 * (lane >> 4)
                regs = ldsm_x4(b_img, tile_off(row, 2 * q + ((lane >> 3) & 1), ks))
                for nn in range(2):  # the x4's two n8 fragments
                    n0, k0 = wn * WN + 16 * np_ + 8 * nn, 32 * q
                    frag = [regs[2 * nn], regs[2 * nn + 1]]
                    want = b_tile[n0:n0 + 8, k0:k0 + 32].t()
                    if k16:
                        for j in range(2):
                            assert torch.equal(b_from_frags([frag[j]], k16=True), want[16 * j:16 * j + 16])
                    else:
                        assert torch.equal(b_from_frags(frag), want)


def test_c_fragments_land_where_the_epilogue_writes():
    """The kernel's frag_rc (mma.sync path): element (mi, ni, e) of lane l in
    warp (wm, wn) is row wm*64 + 16 mi + g + 8 (e >> 1), column wn*32 + 8 ni +
    2t + (e & 1) -- the PTX C map placed at the fragment's corner, each
    block element written by exactly one (thread, element)."""
    seen = torch.zeros(TILE_M, TILE_N, dtype=torch.int64)
    for warp in range(WARPS_M * WARPS_N):
        wm, wn = warp // WARPS_N, warp % WARPS_N
        for lane in range(32):
            for i in range(64):
                mi, ni, e = (i >> 2) // 4, (i >> 2) % 4, i & 3
                r, c = c_coords(lane, e)
                seen[wm * WM + 16 * mi + r, wn * WN + 8 * ni + c] += 1
    assert torch.equal(seen, torch.ones_like(seen))


# ---------------------------------------------------------------------------
# the float order
# ---------------------------------------------------------------------------
def magic_product(dot, sm):
    """fma(float(1.5 * 2^23 + dot), sm, -1.5 * 2^23 * sm) rounded once to float32."""
    d = (torch.tensor(MAGIC_BITS, dtype=torch.int64) + dot.to(torch.int64)).to(torch.int32).view(torch.float32)
    nsm = (torch.tensor(-MAGIC, dtype=torch.float32) * sm).to(torch.float64)  # exact in float32
    return (d.to(torch.float64) * sm.to(torch.float64) + nsm).to(torch.float32)


def emulate_tile(xq, packed, scale_m, *, decode, group, block_k=512, splits_plan=None, slot_order=1):
    """The tile's sums for the whole (M, N) output: exact cluster dots (what
    the mma fragments hold), the magic-number product, clusters in order
    into a k-tile sum from 0, k-tiles closed on stage boundaries into the
    output (first split) or a scratch slot (later splits), the slots added
    in order by the last block.  A ragged last k-tile ends on the stage
    that holds K; that stage's clusters past K see the zero-filled copies
    (x, weights and scale mantissas 0)."""
    m, k = xq.shape
    bk = min(block_k, k)
    ks, nk = tile_stage_k(group), -(-k // bk)
    assert bk % ks == 0
    plan = splits_plan or tile_plan(m, k, packed.shape[1], decode, group, block_k)
    b = decoded_b(packed, decode, k).to(torch.int64)  # (N, K)
    x = xq.to(torch.int64)
    sm = scale_m.to(torch.float32)
    n = b.shape[0]
    tps, splits = plan["tps"], plan["splits"]
    slots = []
    out = None
    for z in range(splits):
        acc = torch.zeros(m, n, dtype=torch.float32)
        run = torch.zeros(m, n, dtype=torch.float32)
        for t in range(z * tps, min(nk, (z + 1) * tps)):
            for s in range(-(-min(bk, k - t * bk) // ks)):  # stages of the k-tile
                for cl in range(ks // group):
                    k0 = t * bk + s * ks + cl * group
                    if k0 >= k:  # zero-filled
                        acc = acc + magic_product(torch.zeros(m, n, dtype=torch.int64), torch.zeros(1, n))
                        continue
                    dot = x[:, k0:k0 + group] @ b[:, k0:k0 + group].t()
                    assert int(dot.abs().max()) < 2**22
                    acc = acc + magic_product(dot, sm[k0 // group][None, :])
            if z == 0:
                run = run + acc
            else:
                slots.append(acc)
            acc = torch.zeros_like(acc)
        if z == 0:
            out = run
    for slot in slots[::slot_order]:
        out = out + slot
    return out


CASES = [(m, k, n) for m in (9, 17, 31, 132, 256) for k, n in ((512, 136), (1536, 200))]


def _site(fmt, group, m, k, n, seed, biased=False):
    """(x_q, QTensor).  biased: positive weights and activations, so the
    cluster products and their sums pass 2**24 and float order shows."""
    gen = np.random.default_rng(seed)
    w = gen.normal(size=(k, n)).astype(np.float32)
    xq = gen.integers(-127, 128, size=(m, k))
    if biased:
        w, xq = np.abs(w) + 0.5, np.abs(xq) // 2 + 64
    qt = quantize_weights(torch.from_numpy(w), FMT_BITS[fmt], 32 if fmt == "mx" else group, fmt=fmt)
    return torch.from_numpy(xq.astype(np.int8)), qt


@pytest.mark.parametrize("fmt", ["ternary", "int4", "nf4", "int8", "mx"])
@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("m,k,n", CASES)
def test_tile_order_matches_cluster_sums(fmt, group, m, k, n):
    xq, qt = _site(fmt, group, m, k, n, m * 1000 + k + n + group, biased=k > 512)
    decode = "int8" if fmt == "mx" else fmt
    got = emulate_tile(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_biased_sites_see_the_float_order():
    """On the biased inputs one flat sum over all clusters (no k-tile sums)
    differs from the reference: the order tests above can fail."""
    xq, qt = _site("int8", 64, 31, 1536, 200, 7, biased=True)
    flat = torch.zeros(31, 200)
    for c in range(1536 // 64):
        dot = xq[:, 64 * c:64 * c + 64].to(torch.int64) @ qt.packed[64 * c:64 * c + 64].to(torch.int64)
        flat = flat + dot.to(torch.float32) * qt.scale_m[c].to(torch.float32)
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode="int8", group=64)
    assert float(want.abs().max()) > 2**24
    assert not torch.equal(flat.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("splits", [2, 3])
def test_split_slots_keep_the_tile_order(splits):
    """Later splits' k-tile sums added slot by slot after the first split's
    running sum equal the unsplit order; the same slots added in reverse
    do not (so the test sees the order)."""
    xq, qt = _site("int8", 64, 64, 3072, 64, splits, biased=True)
    nk = 3072 // 512
    tps = -(-nk // splits)
    plan = dict(splits=-(-nk // tps), tps=tps)
    want = cluster_sums(xq, qt.packed, qt.scale_m, decode="int8", group=64)
    got = emulate_tile(xq, qt.packed, qt.scale_m, decode="int8", group=64, splits_plan=plan)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    reversed_ = emulate_tile(xq, qt.packed, qt.scale_m, decode="int8", group=64, splits_plan=plan, slot_order=-1)
    assert not torch.equal(reversed_.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("decode", ["ternary", "int8"])
def test_tile_epilogue_matches_the_fused_site(decode):
    """Pre-pass (quantize once per row, float exponents) + tile sums +
    epilogue equal fused_qmm_ref, dynamic and static exponents."""
    from repro_torch.kernels.fused_qmm import activation_fn, quantize_prologue
    from repro_torch.core import dfp

    gen = np.random.default_rng(3)
    m, k, n, group = 31, 1024, 40, 64
    x = torch.from_numpy(gen.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    x[2, 5] = float("nan")
    qt = quantize_weights(torch.from_numpy(gen.normal(size=(k, n)).astype(np.float32)), FMT_BITS[decode], group)
    bias = torch.from_numpy(gen.normal(size=(n,)).astype(np.float32))
    for static_e, act in ((None, "silu"), (-3, "gelu")):
        xq, e = quantize_prologue(x, 8, static_e)
        o = emulate_tile(xq, qt.packed, qt.scale_m, decode=decode, group=group)
        y = activation_fn(act)(o * dfp.exp2i(qt.scale_e.to(torch.float32) + e) + bias)
        want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, group=group, bias=bias, act=act,
                             act_exponent=static_e)
        assert torch.equal(y.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("group", TILE_GROUPS)
def test_magic_conversion_is_exact_within_the_bound(group):
    """|dot| <= group * 128 * 128 < 2**22 for every admitted group, and the
    magic-number product equals float(dot) * sm at the extremes."""
    bound = group * 128 * 128
    assert bound < 2**22
    dots = torch.tensor([-bound, -bound + 1, -1, 0, 1, bound - 1, bound, 12345, -54321], dtype=torch.int64)
    for sm in (-128, -127, -3, 0, 1, 7, 127):
        smt = torch.full_like(dots, sm, dtype=torch.float32)
        got = magic_product(dots, smt)
        want = dots.to(torch.float32) * smt
        assert torch.equal(got, want)  # equal values (a zero's sign may differ; sums from +0 never see it)


# ---------------------------------------------------------------------------
# routing and the launch plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 4, 8, 9, 17, 256])
def test_routing_rule(m):
    assert uses_tile(m) == (m > _build.GEMV_MAX_ROWS)
    assert _build.GEMV_MAX_ROWS == 8


@pytest.mark.parametrize("m", [4, 9])
def test_launch_counts_split_at_the_routing_bound(m):
    from repro_torch.kernels.ternary_matmul import ternary_matmul_fused

    class FakeCuda:  # count_launch reads only is_cuda and the row count
        is_cuda = True
        shape = (m, 64)

    before = ternary_matmul_fused.mode_launches.copy()
    _build.count_launch(ternary_matmul_fused, FakeCuda())
    mode = "m<=8" if m <= 8 else "m>8"
    assert ternary_matmul_fused.mode_launches[mode] == before[mode] + 1
    ternary_matmul_fused.mode_launches = before
    ternary_matmul_fused.launches -= 1


@pytest.mark.parametrize("decode", ["ternary", "int4", "nf4", "int8"])
@pytest.mark.parametrize("group", TILE_GROUPS)
def test_shared_memory_plan_fits_at_k_12288(decode, group):
    """The plan the launch hands the kernel (which refuses any size but its
    own) fits a Hopper block at the longest rows and does not grow with K."""
    plan = tile_plan(256, 12288, 4096, decode, group)
    assert plan["smem"] <= 232_448 - 128  # the kernel's static part
    assert plan["smem"] == tile_plan(256, 512, 4096, decode, group)["smem"]
    assert plan["blocks"] == 2 * 4096 // TILE_N


def test_split_plan_only_for_small_grids():
    assert tile_plan(256, 4096, 12288, "ternary", 64)["splits"] == 1  # 192 blocks
    p = tile_plan(17, 4096, 4096, "ternary", 64)  # 32 blocks at a 17-row chunk
    assert p["splits"] > 1 and p["ws_floats"] == (1 + 8 - p["tps"]) * 17 * 4096


def test_check_tile_raises_on_tilings_the_tile_does_not_take():
    check_tile(4096, 64, 512)
    check_tile(1024, 16, 256)
    with pytest.raises(ValueError):
        check_tile(4096, 8, 512)  # a cluster the mma does not take
    with pytest.raises(ValueError):
        check_tile(4096, 64, 64)  # k-tiles not whole 128-wide stages
    with pytest.raises(ValueError):
        check_tile(4096, 256, 512)  # past the conversion's bound


def test_cpu_tensors_take_the_plain_version_at_any_m():
    gen = torch.Generator().manual_seed(0)
    qt = quantize_weights(torch.randn((256, 16), generator=gen), 2, 64)
    x = torch.randn((12, 256), generator=gen)
    got = fused_qmm(x, qt.packed, qt.scale_m, qt.scale_e, decode="ternary", group=64, act="relu")
    want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="ternary", group=64, act="relu")
    assert torch.equal(got, want)
