"""The int8 loop at M <= 8 (``csrc/qmm_gemv8.cuh``), emulated on the CPU (the
kernel itself runs only on the card).

Torch rebuilds the loop's data flow and holds it bit for bit against the
plain version ``cluster_sums``:

- the lane map: a warp copies a 32-row stage of its 128 columns four whole
  rows a copy instruction, 16-byte chunks swizzled by row; lane (g, t)
  reads chunk g of rows 4t..4t+3 and 16+4t..16+4t+3, on 8 bank groups a
  quarter warp; the 4 x 4 byte transposes give ``m16n8k16`` s8 A
  registers whose mma row g is column 16g + 2jp and row g + 8 column
  16g + 2jp + 1; B is x's row g at k + 4t; C element e is that column
  pair's x row 2t + (e & 1); the two 16-k steps of a stage are one
  ``m16n8k32``;
- the work split and the float order: units of a range of k-tiles x 128
  columns walked by warp r = warp * grid_x + block, each warp's ring of 4
  stages filled by its own cursor (the scale rows of the clusters that
  close in a stage ride along), clusters closed in order within a step
  (groups that 16 does not divide close mid-step: B masked to the
  cluster's lanes), RN(float(dot) * sm) added into the tile's sum, tiles in
  order; split items through scratch, folded in tile order by whichever
  warp arrives last; inputs past 2^24 on which a reordered fold differs;
- the launch plan at every family's lm_head and the mx layer's sites, and
  the route (``uses_int8_loop``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_qmm import (
    _MAX_SMEM, LOOP_COLS, LOOP_MAX_ROWS, LOOP_MIN_WARPS, LOOP_SMEM, LOOP_STAGE_K, TILE_GROUPS, cluster_sums,
    int8_loop_plan, loop_x_stride, n_tiles, rows_per_block, smem_bytes, uses_int8_loop,
)
from test_torch_qmm_tile import a_from_frags, b_from_frags, c_coords, transpose4

SMS = 132
LM_HEADS = {  # family -> (K, N) of its int8 lm_head at the published widths (vocab padded to 256)
    "qwen3-8b": (4096, 152064), "phi4-mini-3.8b": (3072, 200192), "gemma3-12b": (3840, 262144),
    "qwen1.5-110b": (8192, 152064), "qwen2-vl-72b": (8192, 152064), "grok-1-314b": (6144, 131072),
    "arctic-480b": (7168, 32000), "falcon-mamba-7b": (4096, 65024), "zamba2-7b": (3584, 32000),
    "whisper-base": (512, 51968),
}
MX_SITES = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
            "gate": (4096, 12288), "up": (4096, 12288), "down": (12288, 4096)}  # qwen3-8b, group 32
MX_ON_LOOP = {"gate", "up"}
ROUTERS = [(6144, 8), (7168, 128)]  # grok, arctic: the MoE router at N = E


def _words(b):
    """(..., 4) int8 bytes -> (...) int64 little-endian words."""
    b = b.to(torch.int64) & 0xFF
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _bytes(w):
    """(...) int64 words -> (..., 4) int8 bytes."""
    return torch.stack([(w >> (8 * j)) & 0xFF for j in range(4)], dim=-1).to(torch.uint8).view(torch.int8)


# ---------------------------------------------------------------------------
# the lane map
# ---------------------------------------------------------------------------
def _pos(row, c):
    """Byte offset of 16-byte chunk c of stage row ``row`` (qmm_gemv8.cuh's
    chunk_at): rows of 128 bytes, the chunk XOR 2 ((row >> 2) & 3)."""
    return row * LOOP_COLS + 16 * (c ^ (((row >> 2) & 3) << 1))


def stage_image(w, ks, col0):
    """A warp's stage as its lanes copy it: copy i of lane l takes chunk l % 8
    of row 4i + l // 8 (each copy instruction four whole 128-byte rows),
    columns col0 + 16 (l % 8); zero past w."""
    k, n = w.shape
    img = torch.zeros(LOOP_STAGE_K * LOOP_COLS, dtype=torch.int8)
    for i in range(8):
        for lane in range(32):
            row, c = 4 * i + lane // 8, lane % 8
            if ks + row < k:
                piece = w[ks + row, col0 + 16 * c:col0 + 16 * c + 16]
                img[_pos(row, c):][:piece.numel()] = piece
    return img


def a_registers(img, s):
    """Step s of a stage: the A registers A[jp][0 | 1] of every lane, as the
    kernel's reads (chunk g of rows 16s + 4t + j) and transposes make them."""
    lanes = torch.arange(32)
    g, t = lanes // 4, lanes % 4
    # v[j]: (32 lanes, 4 words) of the lane's 16 bytes of row 16s + 4t + j
    v = [_words(torch.stack([img[_pos(16 * s + 4 * int(tt) + j, int(gg)):][:16] for gg, tt in zip(g, t)])
                .reshape(32, 4, 4)) for j in range(4)]
    regs = {}
    for q in range(4):
        cw = transpose4([v[j][:, q] for j in range(4)])
        for c in range(4):
            regs[(2 * q + c // 2, c % 2)] = cw[c]
    return regs


def mma_column(jp, rho):
    """The item column of mma row rho in tile jp: 16g + 2jp, or + 1 for rows g + 8."""
    return 16 * (rho % 8) + 2 * jp + rho // 8


@pytest.mark.parametrize("s", [0, 1])
def test_a_registers_hold_each_column_at_its_k(s):
    """Every mma tile's A (a_from_frags, k16; step 0 and 1 are the k32
    tile's two halves) is the stage's 16 k-rows of step s at the columns
    the tile's rows name."""
    gen = torch.Generator().manual_seed(s)
    w = torch.randint(-128, 128, (40, 256), generator=gen, dtype=torch.int8)
    regs = a_registers(stage_image(w, 0, 128), s)
    for jp in range(8):
        a = a_from_frags([_bytes(regs[(jp, 0)]), _bytes(regs[(jp, 1)])], k16=True)
        cols = [128 + mma_column(jp, rho) for rho in range(16)]
        assert torch.equal(a, w[16 * s:16 * s + 16][:, cols].t())


def test_k32_fragments_are_the_two_steps():
    """m16n8k32 A registers {A0[jp][0], A0[jp][1], A1[jp][0], A1[jp][1]}
    (steps 0 and 1) and B {x at k + 4t, x at k + 16 + 4t} hold the stage's
    32 k-rows in the PTX ISA's fragment order."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randint(-128, 128, (32, 128), generator=gen, dtype=torch.int8)
    img = stage_image(w, 0, 0)
    r0, r1 = a_registers(img, 0), a_registers(img, 1)
    for jp in range(8):
        a = a_from_frags([_bytes(r0[(jp, 0)]), _bytes(r0[(jp, 1)]), _bytes(r1[(jp, 0)]), _bytes(r1[(jp, 1)])])
        assert torch.equal(a, w[:, [mma_column(jp, rho) for rho in range(16)]].t())
    x = torch.randint(-127, 128, (8, 32), generator=gen, dtype=torch.int8)
    b = [torch.stack([_words(x[lane // 4, 16 * j + 4 * (lane % 4):][:4]) for lane in range(32)]) for j in range(2)]
    assert torch.equal(b_from_frags([_bytes(b[0]), _bytes(b[1])]), x.t())


def test_b_registers_and_c_fragments_cover_the_item_once():
    """B (b_from_frags, k16) is x's rows at k..k+15 (rows past M zero); C
    element e of lane (g, t) in tile jp is column 16g + 2jp + (e >> 1) and x
    row 2t + (e & 1): the stores (float2 of elements 0, 2 at row 2t, of 1, 3
    at row 2t + 1) cover 128 columns x 8 rows once."""
    m, kk = 5, 16
    x = torch.randint(-127, 128, (m, 64), dtype=torch.int8)
    regs = torch.tensor([int(_words(x[lane // 4, kk + 4 * (lane % 4):][:4])) if lane // 4 < m else 0
                         for lane in range(32)])
    b = b_from_frags([_bytes(regs)], k16=True)
    want = torch.zeros(16, 8, dtype=torch.int8)
    want[:, :m] = x[:, kk:kk + 16].t()
    assert torch.equal(b, want)
    seen = torch.zeros(8, LOOP_COLS, dtype=torch.int64)
    for jp in range(8):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for e in range(4):
                rho, n = c_coords(lane, e)
                col = mma_column(jp, rho)
                assert (col, n) == (16 * g + 2 * jp + (e >> 1), 2 * t + (e & 1))
                seen[n, col] += 1
    assert bool((seen == 1).all())


def test_lane_chunks_and_x_rows_fall_on_distinct_banks():
    """The 16-byte chunk reads of each quarter warp (8 lanes, one LDS.128
    phase) hit 8 distinct 16-byte bank groups; the B loads of 32 lanes (x
    row g at + 4t, rows loop_x_stride(K) apart) 32 distinct banks, at every
    lm_head and mx K."""
    for s in range(2):
        for j in range(4):
            for quarter in range(4):
                pos = {_pos(16 * s + 4 * (lane % 4) + j, lane // 4) % 128 // 16
                       for lane in range(8 * quarter, 8 * quarter + 8)}
                assert len(pos) == 8
    for k in sorted({k for k, _ in LM_HEADS.values()} | {k for k, _ in MX_SITES.values()}):
        stride = loop_x_stride(k)
        assert stride % 16 == 0 and stride >= k + 16
        assert len({(g * stride + 4 * t) // 4 % 32 for g in range(8) for t in range(4)}) == 32


# ---------------------------------------------------------------------------
# the work split and the float order
# ---------------------------------------------------------------------------
def _stages(us, plan, k, group, bk, items):
    """A warp's cursor over its units ``us``: (item, tile, ks, ke, first closing cluster, clusters closing)."""
    nk = n_tiles(k, bk)
    for u in us:
        z, item = divmod(u, items)
        for tile in range(z * plan["tps"], min(nk, (z + 1) * plan["tps"])):
            kt1 = min(k, (tile + 1) * bk)
            for ks in range(tile * bk, kt1, LOOP_STAGE_K):
                ke = min(ks + LOOP_STAGE_K, kt1)
                yield item, tile, ks, ke, ks // group, ke // group - ks // group


def emulate_loop(xq, w, scale_m, *, group, plan, block_k=512, fold_order=1, arrival=1):
    """The loop's sums for the whole (M, N) output as its warps make them:
    warp r = warp * grid_x + block walks units r, r + W, ... (range-major:
    unit u is range u // items of item u % items); its cursor fills a ring
    of 4 stages (weights zero past the tile and N, the closing clusters'
    scale rows), the warp reads the slot in order and issues the next
    stage; groups that are multiples of 32 (up to 256) take a stage as one
    k32 step and close at its end; other groups take 16-k steps, the
    clusters that meet a step in order, B masked to each cluster's lanes;
    per closing cluster RN(float(dot) * sm) into the tile's sum; tiles in
    order (split items: scratch, folded in tile order by the warp that
    completes the item's count -- the warps run in ``arrival`` order;
    ``fold_order=-1`` folds the tiles in reverse)."""
    m, k = xq.shape
    n = w.shape[1]
    bk = min(block_k, k)
    nk, items = n_tiles(k, block_k), -(-n // LOOP_COLS)
    units, stride = items * plan["splits"], plan["warps"] * plan["grid_x"]
    whole = group % LOOP_STAGE_K == 0 and group <= 256
    x64 = xq.to(torch.int64)
    wp = torch.zeros(k, items * LOOP_COLS, dtype=torch.int64)
    wp[:, :n] = w.to(torch.int64)
    sp = torch.zeros(k // group, items * LOOP_COLS, dtype=torch.float32)
    sp[:, :n] = scale_m.to(torch.float32)
    out = torch.zeros(m, items * LOOP_COLS, dtype=torch.float32)
    scratch, counts = {}, [0] * items
    for rank in range(stride)[::arrival]:
        us = range(rank, units, stride)
        stages = list(_stages(us, plan, k, group, bk, items))
        ring, issued, consumed = [None] * 4, 0, 0

        def issue():
            nonlocal issued
            if issued < len(stages):
                ring[issued % 4] = stages[issued]
            issued += 1

        for _ in range(3):
            issue()
        for u in us:
            z, item = divmod(u, items)
            c0_col = item * LOOP_COLS
            tiles = range(z * plan["tps"], min(nk, (z + 1) * plan["tps"]))
            total = torch.zeros(m, LOOP_COLS, dtype=torch.float32)
            for tile in tiles:
                kt0, kt1 = tile * bk, min(k, (tile + 1) * bk)
                acc = torch.zeros(m, LOOP_COLS, dtype=torch.float32)
                dot = torch.zeros(m, LOOP_COLS, dtype=torch.int64)
                cl_end = kt0 + group
                for ks in range(kt0, kt1, LOOP_STAGE_K):
                    s_item, s_tile, s_ks, s_ke, s_c0, s_ncl = ring[consumed % 4]
                    consumed += 1
                    issue()
                    assert (s_item, s_tile, s_ks) == (item, tile, ks)  # the cursor and the consumer agree
                    wst = torch.zeros(LOOP_STAGE_K, LOOP_COLS, dtype=torch.int64)
                    wst[:s_ke - s_ks] = wp[s_ks:s_ke, c0_col:c0_col + LOOP_COLS]
                    srows = sp[s_c0:s_c0 + s_ncl, c0_col:c0_col + LOOP_COLS]
                    if whole:  # one k32 step; the cluster closes at the stage's end
                        assert s_ke - s_ks == LOOP_STAGE_K and ks + LOOP_STAGE_K <= cl_end
                        dot += x64[:, ks:ks + LOOP_STAGE_K] @ wst
                        if ks + LOOP_STAGE_K == cl_end:
                            assert s_ncl == 1 and s_c0 == cl_end // group - 1
                            acc = acc + dot.to(torch.float32) * srows[0]
                            dot = torch.zeros_like(dot)
                            cl_end += group
                        continue
                    for s in range(2):
                        kk = ks + 16 * s
                        if kk >= kt1:
                            break
                        k_hi = min(kk + 16, kt1)
                        while True:
                            lo, hi = cl_end - group, min(cl_end, k_hi)
                            lanes = [t for t in range(4) if lo <= kk + 4 * t < hi]
                            if len(lanes) == 4:  # the whole step in one cluster: the four lanes' k at once
                                dot += x64[:, kk:kk + 16] @ wst[kk - ks:kk - ks + 16]
                            for t in lanes if len(lanes) < 4 else ():
                                ku = kk + 4 * t
                                dot += x64[:, ku:ku + 4] @ wst[ku - ks:ku - ks + 4]
                            if cl_end > k_hi:
                                break
                            j = cl_end // group - 1 - ks // group
                            assert 0 <= j < s_ncl  # the stage carries the closing cluster's scale row
                            acc = acc + dot.to(torch.float32) * srows[j]
                            dot = torch.zeros_like(dot)
                            cl_end += group
                            if cl_end - group >= k_hi:
                                break
                if plan["splits"] == 1:
                    total = total + acc
                else:
                    scratch[(item, tile)] = acc
            if plan["splits"] == 1:
                out[:, c0_col:c0_col + LOOP_COLS] = total
                continue
            counts[item] += len(tiles)
            if counts[item] == nk:  # this warp completes the item: the tile sums in tile order
                for tile in range(nk)[::fold_order]:
                    total = total + scratch[(item, tile)]
                out[:, c0_col:c0_col + LOOP_COLS] = total
    assert all(c in (0, nk) for c in counts)
    return out[:, :n]


def _site(m, k, n, group, seed, biased=False):
    gen = np.random.default_rng(seed)
    if biased:  # every product positive and large: the sums pass 2**24, so the order shows
        w, x = gen.integers(64, 128, size=(k, n)), gen.integers(64, 128, size=(m, k))
        sm = gen.integers(96, 128, size=(k // group, n))
    else:
        w, x = gen.integers(-128, 128, size=(k, n)), gen.integers(-127, 128, size=(m, k))
        sm = gen.integers(-127, 128, size=(k // group, n))
    return (torch.from_numpy(x.astype(np.int8)), torch.from_numpy(w.astype(np.int8)),
            torch.from_numpy(sm.astype(np.int8)))


def _plan(splits, k, warps=2, grid_x=3, block_k=512):
    nk = n_tiles(k, block_k)
    tps = -(-nk // splits)
    return dict(splits=-(-nk // tps), tps=tps, warps=warps, grid_x=grid_x)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("k", [512, 3072, 3584, 3840, 6144, 7168])
def test_loop_equals_cluster_sums(m, k):
    """Each lm_head K (3840: a ragged last tile of 256) at M 1, 4, 8, two
    items (N 200: the second 72 wide), unsplit and split into single
    tiles, on a small grid whose warps walk several units: bit for bit."""
    x, w, sm = _site(m, k, 200, 64, m * 7 + k)
    want = cluster_sums(x, w, sm, decode="int8", group=64)
    for splits in sorted({1, n_tiles(k)}):
        got = emulate_loop(x, w, sm, group=64, plan=_plan(splits, k))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("group,k,block_k", [(4, 1200, 240), (12, 1200, 240), (16, 1200, 240), (20, 1200, 240),
                                             (48, 1200, 240), (32, 960, 480), (128, 1536, 512), (20, 100, 512)])
def test_any_group_of_whole_4_row_units(group, k, block_k):
    """Clusters that end inside a 16-k step (groups 4, 12, 20, 48) close
    mid-step with B masked to their lanes; more than one closes in a stage
    (4, 12, 16, 20); k-tiles of 240 rows end inside a 32-row stage; K = 100
    is not a multiple of 16: the last step holds one 4-row unit."""
    x, w, sm = _site(3, k, 136, group, group + k)
    want = cluster_sums(x, w, sm, decode="int8", group=group, block_k=block_k)
    for splits in (1, n_tiles(k, block_k)):
        got = emulate_loop(x, w, sm, group=group, plan=_plan(splits, k, block_k=block_k), block_k=block_k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("splits", [1, 3, 6])
def test_biased_inputs_see_the_fold_order(splits):
    """Inputs past 2**24: the loop's order equals cluster_sums whatever the
    split and the warps' arrival order; a fold of the tiles in reverse
    differs, so the emulation would see a wrong order."""
    m, k, n = 4, 3072, 136
    x, w, sm = _site(m, k, n, 64, 5, biased=True)
    want = cluster_sums(x, w, sm, decode="int8", group=64)
    assert float(want.abs().max()) > 2**24
    for arrival in (1, -1):
        got = emulate_loop(x, w, sm, group=64, plan=_plan(splits, k), arrival=arrival)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if splits > 1:
        rev = emulate_loop(x, w, sm, group=64, plan=_plan(splits, k), fold_order=-1)
        assert not torch.equal(rev.view(torch.int32), want.view(torch.int32))


def test_a_flat_cluster_sum_differs_on_biased_inputs():
    """Adding every cluster of K into one sum (no tile order) changes bits
    on the biased inputs: the per-tile chains are the contract."""
    m, k, n, group = 4, 3072, 136, 64
    x, w, sm = _site(m, k, n, group, 6, biased=True)
    want = cluster_sums(x, w, sm, decode="int8", group=group)
    flat = torch.zeros(m, n)
    for c in range(k // group):
        d = x[:, c * group:(c + 1) * group].to(torch.int64) @ w[c * group:(c + 1) * group].to(torch.int64)
        flat = flat + d.to(torch.float32) * sm[c].to(torch.float32)
    assert not torch.equal(flat.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the launch plan and the route
# ---------------------------------------------------------------------------
SHAPES = [(name, k, n, 64) for name, (k, n) in LM_HEADS.items()] + [(name, k, n, 32) for name, (k, n) in
                                                                   MX_SITES.items()]


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("name,k,n,group", SHAPES)
def test_plan_fills_the_card_and_tiles_k_once(name, k, n, group, m):
    """At every lm_head and mx shape: all M rows in a block, one block an SM,
    shared memory within the budget (and the kernel's smem_bytes), every SM
    given a unit where 128-column items x k-tiles allow, the splits'
    k-ranges covering each k-tile once, the scratch sized to the split
    items (a plane of rows x 128 a tile)."""
    p = int8_loop_plan(m, k, n, group, sms=SMS)
    nk, items = n_tiles(k), -(-n // LOOP_COLS)
    assert p["rows"] == min(m, LOOP_MAX_ROWS) and p["row_blocks"] == 1 and p["blocks"] == p["grid_x"] == SMS
    assert p["smem"] == smem_bytes(p["warps"], p["rows"], k, group) <= LOOP_SMEM < _MAX_SMEM
    assert LOOP_MIN_WARPS <= p["warps"] and p["units"] == items * p["splits"]
    if items * nk >= SMS:  # units of 128 columns x one k-tile could fill the card: the plan's do
        assert p["units"] >= SMS
    ranges = [range(z * p["tps"], min(nk, (z + 1) * p["tps"])) for z in range(p["splits"])]
    assert sorted(t for r in ranges for t in r) == list(range(nk)) and all(len(r) for r in ranges)
    split = p["splits"] > 1
    assert p["ws_floats"] == (items * nk * p["rows"] * LOOP_COLS if split else 0)
    assert p["counters"] == (items if split else 0)


def test_plan_balances_the_lm_heads():
    """qwen3-8b's lm_head: no split, one item a warp; whisper-base's (one
    k-tile) never split; arctic's and zamba2's (250 items of 14 / 7 tiles)
    split."""
    for m in (1, 4, 8):
        p = int8_loop_plan(m, 4096, 152064, 64, sms=SMS)
        assert p["splits"] == 1 and p["units"] == 1188 <= p["warps"] * p["grid_x"]
        assert int8_loop_plan(m, 512, 51968, 64, sms=SMS)["splits"] == 1
        assert int8_loop_plan(m, 7168, 32000, 64, sms=SMS)["splits"] > 1
        assert int8_loop_plan(m, 3584, 32000, 64, sms=SMS)["splits"] > 1


@pytest.mark.parametrize("m", [1, 4, 8])
def test_route_by_shape(m):
    """uses_int8_loop: every family's lm_head and the mx layer's gate / up
    (96 items of 128 columns) on the loop; mx wq / wo / down (32 items) and
    wk / wv (8), the MoE routers and every other decode on the GEMV; a
    cluster the GEMV does not take on the loop."""
    assert all(uses_int8_loop("int8", m, k, n, 64, sms=SMS) for k, n in LM_HEADS.values())
    for name, (k, n) in MX_SITES.items():
        assert uses_int8_loop("int8", m, k, n, 32, sms=SMS) == (name in MX_ON_LOOP)
    assert not any(uses_int8_loop("int8", m, k, n, 64, sms=SMS) for k, n in ROUTERS)
    assert not any(uses_int8_loop(d, m, 4096, 152064, 64, sms=SMS) for d in ("ternary", "int4", "nf4"))
    assert uses_int8_loop("int8", m, 1024, 256, 8, sms=SMS) and 8 not in TILE_GROUPS


def test_long_k_keeps_x_in_a_block_or_goes_to_the_gemv():
    """K = 49152: x's rows fit beside the rings up to M = 3, so an int8
    site as wide as lm_head takes the loop at M <= 3 and the GEMV (which
    stages x) above; rows_per_block never exceeds the budget."""
    for m in range(1, 9):
        rows = rows_per_block(m, 49152, 32)
        assert rows == min(m, 3)
        assert smem_bytes(LOOP_MIN_WARPS, rows, 49152, 32) <= LOOP_SMEM
        assert uses_int8_loop("int8", m, 49152, 152064, 32, sms=SMS) == (m <= 3)
    with pytest.raises(ValueError):
        int8_loop_plan(4, 4096, 4096, 6, sms=SMS)  # a cluster of 6 splits a 4-row unit
