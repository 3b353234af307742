"""The launch plans of the TMA + wgmma kernels, computed in Python and
passed to their C entry points as integers (csrc/dense.cu,
csrc/attention_std.cu, csrc/attention_octic.cu, csrc/lin_d8.cu): the grid,
the column boxes of a head, the shared memory, the persistent tile order,
the octic output scatter and K-lin-d8's grouped-column store; the
dispatch of K-attn-bwd's mma.sync core between its whole-head and streamed
forms; K-attn-bwd's TMA + wgmma plan (csrc/attention_bwd.cu: tiles, boxes,
shared memory, the gradient store tables, route (a)'s assembly tables);
K-lin-d8-bwd's plan (csrc/lin_d8_bwd.cu: the units of every CTA, slab by
slab, and the table the kernel reads); K-ln-d8's affine backward (csrc/ln_d8.cu:
the CTAs' row ranges, the warps' rings of bulk copies, the parameter-gradient
slots); held here without a card."""

import pytest
import torch

from octic_vits_tpu_torch.ops import attention as A
from octic_vits_tpu_torch.ops import dense as D
from octic_vits_tpu_torch.ops import linear as L
from octic_vits_tpu_torch.ops import ln_d8 as LN

SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on the H100
HEAD_DIMS = list(range(8, 129, 8))


# ---- the kernels' loops written out over a plan, as the C code walks them


def attention_bwd_rows(plan: dict) -> list:
    """(block, rows the block owns, rows of each streamed tile) of a
    K-attn-bwd plan, as csrc/attention_bwd_core.cuh walks them."""
    n = plan["n"]
    if not plan["streamed"]:
        return [(0, list(range(n)), [list(range(n))])]
    tiles = [list(range(t * A.BWD_TILE, min(n, (t + 1) * A.BWD_TILE)))
             for t in range(plan["tiles"])]
    return [(z, list(range(z * A.BWD_BLOCK, min(n, (z + 1) * A.BWD_BLOCK))), tiles)
            for z in range(plan["blocks"])]


def octic_scatter_map(plan: dict, head: int = 0) -> list:
    """For each (padded) column of head `head`, the output piece (0..3:
    o1..o4, 4, 5: oe0, oe1) and the column in the piece's head slice, or None
    for a padded column that is never stored (csrc/attention_std_core.cuh:
    scatter_entry)."""
    d1 = plan["d1"]
    de = 2 * d1
    if plan["route"] == "a":
        return [(c // d1, c % d1) if c < 4 * d1 else (4 + (c - 4 * d1) // de, (c - 4 * d1) % de)
                for c in range(plan["dh"])]
    out = []
    for j, (off, w, _, real) in enumerate(plan["boxes"]):
        o = plan["offsets"][j][head]
        out += [(j, c - o) if 0 <= c - o < real else None for c in range(w)]
    return out


def lin_d8_tiles(plan: dict) -> list:
    """Every (CTA, consumer warpgroup, token rows, channels) K-lin-d8
    computes, in each CTA's order (csrc/lin_d8_sm90.cuh): CTA x takes tiles
    x, x + grid, ...; a tile's warpgroup w takes channels [j0 + 32 w, j0 + 32
    w + 32) and computes all eight products of its rows and channels
    (clipped at m and f)."""
    out = []
    m, f, nt = plan["m"], plan["f"], plan["n_tiles"]
    for x in range(plan["grid"]):
        for t in range(x, plan["m_tiles"] * nt, plan["grid"]):
            m0, j0 = (t // nt) * L.LIN_BM, (t % nt) * L.LIN_BN
            for wg in range(2):
                jw = j0 + wg * L.LIN_BNW
                out.append((x, wg, range(m0, min(m, m0 + L.LIN_BM)),
                            range(jw, min(f, jw + L.LIN_BNW))))
    return out


def lin_d8_out_columns(f: int, groups: tuple) -> tuple:
    """K-lin-d8's grouped-column store maps (csrc/lin_d8.cu): for ``groups =
    (g1, s1, ge, se)`` the column of output channel j < f of a 1-d product,
    and of column J < 2f of an E row's ``[e_r1 | e_r2]``, relative to the
    product's base pointer."""
    g1, s1, ge, se = groups
    return ([(j // g1) * s1 + j % g1 for j in range(f)],
            [(j // ge) * se + j % ge for j in range(2 * f)])


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_std_boxes_cover_each_head_column_once(dh):
    boxes = A.std_attention_boxes(dh)
    cols = [c for off, w, _ in boxes for c in range(off, off + w)]
    assert cols == list(range(dh))
    for off, w, swizzle in boxes:
        inner = 2 * w  # bytes of one box row
        assert inner % 16 == 0
        # a swizzled box fills its swizzle span; the 8-column tail is unswizzled
        assert inner == swizzle if swizzle else (w == 8 and off + w == dh)
        assert swizzle in (0, 32, 64, 128)
    # every 16-column k step of q k^T lies inside one box
    for k0 in range(0, dh, 16):
        assert sum(off <= k0 < off + w for off, w, _ in boxes) == 1
        (off, w, _), = [bx for bx in boxes if bx[0] <= k0 < bx[0] + bx[1]]
        assert k0 + 16 <= off + w or (w == 8 and off + w == dh)


@pytest.mark.parametrize("dh", [16, 24, 32, 64, 80, 128])
def test_std_boxes_of_the_model_widths(dh):
    want = {16: [16], 24: [16, 8], 32: [32], 64: [64], 80: [64, 16], 128: [64, 64]}[dh]
    assert [w for _, w, _ in A.std_attention_boxes(dh)] == want


@pytest.mark.parametrize("n", [1, 37, 64, 65, 197, 257, 1000])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_std_plan_smem_and_key_tiles(n, dh):
    plan = A.std_attention_plan(3, n, 2, dh)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["grid"] == 3 * 2 * plan["q_tiles"]
    assert (plan["q_tiles"] - 1) * 64 < n <= plan["q_tiles"] * 64
    # key n - 1 is folded in as a rank-1 update exactly when the tiles then end on it
    assert plan["split"] == (n > 1 and (n - 1) % 64 == 0)
    keys = n - plan["split"]
    assert (plan["k_tiles"] - 1) * 64 < keys <= plan["k_tiles"] * 64


@pytest.mark.parametrize("b,n,heads", [(2, 257, 3), (3, 37, 2), (1, 130, 4), (4, 65, 3),
                                        (1, 1, 2), (2, 64, 2)])
def test_std_tiles_cover_each_query_row_once(b, n, heads):
    plan = A.std_attention_plan(b, n, heads, 80)
    rows = [r for x in range(plan["grid"]) for r in A.std_attention_rows(x, plan, heads)]
    assert sorted(rows) == [(bb, h, r) for bb in range(b) for h in range(heads)
                            for r in range(n)]
    assert plan["grid"] == b * heads * -(-n // 64)


DENSE_SHAPES = [(16448, 1280, 5120), (8224, 1280, 5120), (12608, 1024, 4096),
                (9472, 1024, 4096), (130, 64, 264), (300, 192, 8)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("m,k,f", DENSE_SHAPES)
def test_dense_tile_order_visits_every_tile_once(m, k, f, sms):
    plan = D.dense_plan(m, f, k, sms)
    order = D.dense_tile_order(plan)
    tiles = [(mt, ft) for _, _, mt, ft in order]
    assert sorted(tiles) == [(i, j) for i in range(-(-m // 128)) for j in range(-(-f // 128))]
    assert plan["grid"] == min(sms, len(tiles))
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["k_blocks"] == -(-k // 64)
    # each CTA's consumer warpgroups take its tiles in turns
    for c in range(plan["grid"]):
        assert [wg for cta, wg, _, _ in order if cta == c] == [
            i % 2 for i in range(sum(cta == c for cta, *_ in order))]


def test_dense_raster_walks_groups_of_m_tiles():
    plan = D.dense_plan(16448, 5120, 1280)
    first = [D.dense_tile(t, plan) for t in range(2 * plan["group_m"])]
    assert first[:8] == [(i, 0) for i in range(8)]
    assert first[8:] == [(i, 1) for i in range(8)]
    # the last group holds the one ragged M-tile (129 = 16 x 8 + 1)
    assert D.dense_tile(plan["m_tiles"] * plan["f_tiles"] - 1, plan) == (128, 39)


@pytest.mark.parametrize("dh", [12, 136, 0])
def test_std_shape_check_rejects_head_widths(dh):
    with pytest.raises(ValueError):
        A._check_std_attention_shape(257, dh)


@pytest.mark.parametrize("n,dh", [(257, 80), (4096, 128), (100000, 24)])
def test_std_shape_check_takes_any_token_count(n, dh):
    assert A._check_std_attention_shape(n, dh)["smem"] <= SMEM_LIMIT


def test_whole_head_check_speaks_for_the_octic_core_only():
    # the whole-head core (now the probes' kernel) holds a head in shared
    # memory: a long sequence it refuses is one the streamed forwards take,
    # the standard one and the octic one in both routes
    with pytest.raises(ValueError):
        A._check_attention_shape(1024, 128)
    A._check_attention_shape(257, 80)
    A._check_std_attention_shape(1024, 128)
    for route in ("a", "b"):
        assert A.octic_attention_plan(2, 1024, 3, 128 // 8, route)["smem"] <= SMEM_LIMIT



# ---- K-attn-bwd: the whole-head form where a head fits, the streamed form above


@pytest.mark.parametrize("n,dh,streamed", [(257, 80, False), (320, 80, False), (321, 80, True),
                                           (384, 64, False), (385, 64, True),
                                           (257, 128, True), (208, 128, False), (209, 128, True),
                                           (1025, 80, True), (37, 8, False)])
def test_bwd_dispatch_streams_only_where_a_head_does_not_fit(n, dh, streamed):
    plan = A.attention_bwd_plan(n, dh)
    assert plan["streamed"] == streamed
    assert plan["smem"] <= SMEM_LIMIT
    fits = True
    try:
        A._check_attention_bwd_shape(n, dh)
    except ValueError:
        fits = False
    assert fits == (not streamed)


@pytest.mark.parametrize("n", [1, 63, 64, 129, 257, 321, 385, 1025, 4097])
@pytest.mark.parametrize("dh", [8, 64, 80, 128])
def test_bwd_streamed_tiles_cover_every_key_and_query_once(n, dh):
    plan = A.attention_bwd_plan(n, dh)
    blocks = attention_bwd_rows(plan)
    owned = [r for _, rows, _ in blocks for r in rows]
    assert sorted(owned) == list(range(n))  # every row owned by one block
    for _, _, tiles in blocks:  # each block's sweep meets every row once
        assert sorted(r for t in tiles for r in t) == list(range(n))
    if plan["streamed"]:
        assert plan["blocks"] == -(-n // A.BWD_BLOCK) and plan["tiles"] == -(-n // A.BWD_TILE)


@pytest.mark.parametrize("dh", [20, 136, 0])
def test_bwd_plan_rejects_head_widths(dh):
    with pytest.raises(ValueError):
        A.attention_bwd_plan(257, dh)


# ---- the octic forward on the streamed kernel: routes (a) and (b)


def _octic_out(o, plan, heads):
    """Scatter a head-major output [N, H, dhp] into the six irrep arrays
    through the plan's column map of each head, as the kernel's store does."""
    n, d1 = o.shape[0], plan["d1"]
    widths = [d1] * 4 + [2 * d1] * 2
    outs = [torch.full((n, heads * w), float("nan")) for w in widths]
    for h in range(heads):
        for c, e in enumerate(octic_scatter_map(plan, h)):
            if e is not None:
                p, off = e
                outs[p][:, h * widths[p] + off] = o[:, h, c]
    return outs


def _real_columns(plan, head):
    """The real head column each padded column of route (b) carries."""
    d1 = plan["d1"]
    starts = [g * d1 for g in range(4)] + [4 * d1, 6 * d1]
    return [None if e is None else starts[e[0]] + e[1]
            for e in octic_scatter_map(plan, head)]


@pytest.mark.parametrize("route", ["a", "b"])
@pytest.mark.parametrize("d1,heads,layout", [(1, 8, "octic"), (2, 4, "octic"), (3, 8, "wide1d"),
                                             (8, 3, "octic"), (10, 16, "octic"),
                                             (10, 16, "wide1d"), (16, 2, "octic")])
def test_octic_scatter_map_is_octic_split(route, d1, heads, layout):
    n = 5
    plan = A.octic_attention_plan(2, n, heads, d1, route, layout)
    assert plan["fits"]
    o = torch.randn(n, heads, 8 * d1)
    if route == "a":
        op = o
    else:
        op = torch.full((n, heads, plan["dhp"]), 1e9)
        for h in range(heads):
            for i, c in enumerate(_real_columns(plan, h)):
                if c is not None:
                    op[:, h, i] = o[:, h, c]
    got = _octic_out(op, plan, heads)
    want = A._octic_split(o[None], d1)
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])


@pytest.mark.parametrize("d1,heads,layout", [(1, 8, "octic"), (2, 4, "octic"), (4, 2, "octic"),
                                             (8, 16, "octic"), (10, 16, "octic"),
                                             (10, 16, "wide1d"), (10, 4, "wide1d"),
                                             (12, 4, "octic"), (16, 2, "wide1d")])
def test_route_b_boxes_cover_each_head_column_once(d1, heads, layout):
    plan = A.octic_attention_plan(64, 257, heads, d1, "b", layout)
    assert plan["fits"] and plan["dhp"] in (96, 128)
    for h in range(heads):
        cols = _real_columns(plan, h)
        assert sorted(c for c in cols if c is not None) == list(range(8 * d1))
        # every other column is zeroed in q: they add 0 to q k^T
        assert len(cols) == plan["dhp"]
        assert sum(c is None for c in cols) == plan["dhp"] - 8 * d1
    for j, (off, w, swizzle, real) in enumerate(plan["boxes"]):
        assert 2 * w % 16 == 0 and 2 * w == swizzle
        assert off % 16 == 0  # each box starts on a k16 step of q k^T
        # TMA boxes start on 16-byte boundaries: the piece at offset o < 8
        assert all(o % (2 if d1 % 2 == 0 else 1) == 0 and o + real <= w
                   for o in plan["offsets"][j])
    assert plan["smem"] <= SMEM_LIMIT


def test_route_b_refuses_pieces_that_leave_their_box():
    # H/14 fits (d1 = 10: offsets 0, 2, 4, 6; de = 20: 0, 4); two heads of d1
    # = 10 start q, k and v at different offsets; d1 = 14 runs past 16 columns
    assert A.octic_attention_plan(64, 257, 16, 10, "b")["fits"]
    assert not A.octic_attention_plan(1, 257, 2, 10, "b")["fits"]
    assert not A.octic_attention_plan(1, 257, 16, 14, "b")["fits"]
    assert A.octic_attention_plan(1, 257, 16, 14, "a")["fits"]


@pytest.mark.parametrize("route", ["a", "b"])
@pytest.mark.parametrize("n", [1, 257, 449, 545, 1025, 100000])
def test_octic_plan_takes_any_token_count(route, n):
    plan = A.octic_attention_plan(4, n, 16, 10, route)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["grid"] == 4 * 16 * -(-n // 64)


# ---- K-lin-d8 on TMA + wgmma

# (m, c, f): the H/14 B=64 and B=32 qkv, fc1, fc2, proj; the L/16 SSL crops'
# qkv, fc1, fc2 and proj; ragged edges (both schedules, f of one 32-channel tile)
LIN_SHAPES = [(m, c, f) for m in (16448, 8224)
              for c, f in ((160, 480), (160, 640), (640, 160), (160, 160))] + [
    (m, c, f) for m in (12608, 9472) for c, f in ((128, 384), (128, 512), (512, 128), (128, 128))
] + [(148, 16, 24), (148, 24, 48), (300, 40, 120), (1, 8, 8), (65, 16, 72)]


@pytest.mark.parametrize("m,c,f", LIN_SHAPES)
def test_lin_d8_plan_covers_every_output_once(m, c, f):
    plan = L.lin_d8_plan(m, c, f)
    seen = torch.zeros(m, f, dtype=torch.int32)
    for _, _, rows, cols in lin_d8_tiles(plan):
        if len(rows) and len(cols):
            seen[rows.start:rows.stop, cols.start:cols.stop] += 1
    # each (m, j) once: the warpgroup that holds it computes all eight products
    assert bool((seen == 1).all())
    assert plan["grid"] == min(132, plan["m_tiles"] * plan["n_tiles"])
    assert plan["k1"] * 32 >= c > (plan["k1"] - 1) * 32
    assert plan["ke"] * 32 >= 2 * c > (plan["ke"] - 1) * 32


@pytest.mark.parametrize("mode", L.LIN_MODES)
def test_lin_d8_plan_boxes_smem_and_registers(mode):
    plan = L.lin_d8_plan(16448, 160, 480, mode)
    for _, box, inner, swizzle in plan["boxes"]:
        assert inner % 16 == 0 and inner == 2 * box[0] and inner <= swizzle
    assert any(name == "y" for name, *_ in plan["boxes"]) == (mode in ("tuple", "gelu", "ls"))
    assert plan["smem"] <= SMEM_LIMIT
    # the eight products of a 64 x 32 half: 128 f32 a thread, within the
    # consumers' setmaxnreg budget; two consumer warpgroups and the producer's
    # 40 fit the SM's 65536 registers
    assert plan["acc_regs"] == 128 <= plan["max_regs"] - 64
    assert 2 * 128 * plan["max_regs"] + 128 * 40 <= 65536
    # a stage past k = C carries only the E rows and the we boxes
    assert plan["e_stage_bytes"] < plan["stage_bytes"]


def test_lin_d8_plan_rejects_widths():
    for m, c, f in ((16, 12, 8), (16, 8, 20), (0, 8, 8)):
        with pytest.raises(ValueError):
            L.lin_d8_plan(m, c, f)
    with pytest.raises(ValueError):
        L.lin_d8_plan(16, 8, 8, "dense")


def _grouped(y: tuple, f: int, groups: tuple, bases: tuple, width: tuple) -> list:
    """Scatter a flat-E tuple through the grouped-column maps into buffers,
    as the kernel's store does: 1-d product g at base bases[g] of buffer
    width[0], E row r at bases[4 + r] of buffer width[1]."""
    m = y[0].shape[0]
    col1, cole = lin_d8_out_columns(f, groups)
    bufs = [torch.full((m, w), float("nan")) for w in width]
    for g in range(4):
        bufs[0][:, [bases[g] + c for c in col1]] = y[g]
    for r in range(2):
        bufs[1][:, [bases[4 + r] + c for c in cole]] = y[4][:, 2 * f * r:2 * f * (r + 1)]
    return bufs


@pytest.mark.parametrize("d1,heads", [(2, 4), (8, 2), (10, 16)])
def test_lin_d8_grouped_maps_are_the_wide_layouts(d1, heads):
    f, m = 3 * heads * d1, 5
    de = 2 * d1
    y = tuple(torch.randn(m, f) for _ in range(4)) + (torch.randn(m, 4 * f),)
    # the wide qkv of row 13b and of the fused qkv + attention's route (a):
    # one buffer, the 1-d and E products' columns interleaved in it
    bufs = _grouped(y, f, (d1, 8 * d1, de, 8 * d1),
                    tuple(g * d1 for g in range(4)) + (4 * d1, 4 * d1 + de), (8 * f, 8 * f))
    merged = torch.where(torch.isnan(bufs[0]), bufs[1], bufs[0])
    assert torch.equal(merged, L.interleave_wide(y, heads))
    # the wide-1d qkv: the 1-d products interleaved, the E rows plain
    bufs = _grouped(y, f, (d1, 4 * d1, 2 * f, 0), tuple(g * d1 for g in range(4)) + (0, 2 * f),
                    (4 * f, 4 * f))
    assert torch.equal(bufs[0], L.interleave_wide1d(y[:4], heads))
    assert torch.equal(bufs[1], y[4])


# ---- K-attn-bwd on TMA + wgmma (csrc/attention_bwd.cu on attention_bwd_sm90.cuh)

BWD_NS = [1, 37, 64, 65, 197, 257, 321, 385, 1025]
BWD_DHS = [16, 24, 40, 64, 80, 120, 128]


def bwd_sm90_rows(plan: dict, b: int) -> list:
    """The (batch row, head, row)s each CTA of either pass owns, and the rows
    each CTA's sweeps meet, as the kernels map blockIdx.x: tile x % tiles of
    (batch, head) x // tiles, 64 rows a tile, rows >= N masked."""
    n, heads, tiles = plan["n"], plan["heads"], plan["tiles"]
    owned, swept = [], []
    for x in range(plan["grid"]):
        t, bh = x % tiles, x // tiles
        bb, h = divmod(bh, heads)
        owned += [(bb, h, r) for r in range(64 * t, min(n, 64 * t + 64))]
        swept.append(sorted(r for u in range(tiles) for r in range(64 * u, 64 * u + 64) if r < n))
    return owned, swept


@pytest.mark.parametrize("n", BWD_NS)
def test_bwd_sm90_tiles_cover_every_row_once(n):
    b, heads = 2, 3
    plan = A.attention_bwd_sm90_plan(b, n, heads, 80)
    owned, swept = bwd_sm90_rows(plan, b)
    # each pass's CTAs own every (batch, head, row) once; each CTA's sweep
    # meets every key (query pass) or query (key pass) of its head once
    assert sorted(owned) == [(bb, h, r) for bb in range(b) for h in range(heads)
                             for r in range(n)]
    assert all(s == list(range(n)) for s in swept)
    assert plan["grid"] == b * heads * plan["tiles"]
    # the scratch rows: every query tile's 64 rows, 16-byte aligned bulk copies
    assert plan["np"] == 64 * plan["tiles"] >= n and (plan["np"] * 4) % 16 == 0


@pytest.mark.parametrize("dh", BWD_DHS)
@pytest.mark.parametrize("heads", [1, 2, 5])
def test_bwd_sm90_boxes_cover_each_head_column_once(dh, heads):
    plan = A.attention_bwd_sm90_plan(2, 257, heads, dh)
    c = heads * dh
    for op, base in (("q", 0), ("k", c), ("v", 2 * c), ("o", 0)):
        for h in range(heads):
            starts = plan["starts"][op][h]
            cols = [s + i for s, (_, w, _) in zip(starts, plan["boxes"]) for i in range(w)]
            assert cols == list(range(base + h * dh, base + (h + 1) * dh))
            assert all(s % 8 == 0 for s in starts)  # a TMA box starts on 16 bytes


@pytest.mark.parametrize("n", BWD_NS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_bwd_sm90_smem_at_every_stage_count(n, dh):
    plan = A.attention_bwd_sm90_plan(4, n, 2, dh)
    assert plan["stages"] == (2 if dh > 96 else 3)
    assert plan["smem_q"] <= SMEM_LIMIT and plan["smem_k"] <= SMEM_LIMIT
    # the query pass's 2-stage ring leaves room for three CTAs an SM (the SM's
    # 228 KB) up to 80 columns, the key pass's for two
    assert (3 if dh <= 80 else 2) * plan["smem_q"] <= 233472
    assert 2 * plan["smem_k"] <= 233472


@pytest.mark.parametrize("dh", [20, 136, 0, 4])
def test_bwd_sm90_plan_rejects_head_widths(dh):
    with pytest.raises(ValueError):
        A.attention_bwd_sm90_plan(2, 257, 2, dh)


def _stored(stores: list, segs: list, heads: int, grads: tuple) -> list:
    """Write each head column of dq, dk, dv (value 1000 s + 100 h + column)
    into copies of `grads` ([1, 1, width] each) through the store table, as
    the kernels' column table does; NaN where nothing is written."""
    outs = [torch.full(t.shape[-1:], float("nan"), dtype=torch.float64) for t in grads]
    for s, parts in enumerate(stores):
        for h in range(heads):
            d = 0
            for (t, ld, col, hs), sw in zip(parts, segs):
                k = next(i for i, u in enumerate(grads) if u is t)
                for o in range(sw):
                    assert torch.isnan(outs[k][col + h * hs + o]), "a column written twice"
                    outs[k][col + h * hs + o] = 1000 * s + 100 * h + d
                    d += 1
    return outs


@pytest.mark.parametrize("d1,heads", [(5, 2), (8, 4), (10, 16), (16, 2)])
def test_bwd_gradient_segments_cover_each_gradient_column_once(d1, heads):
    """The store tables of the octic layouts (the six gradients of row 5,
    the five of row 12) and the standard dqkv write every gradient column
    exactly once, head h's column d of q, k, v where its input came from."""
    c8, de = heads * d1, 2 * d1
    segs = [d1] * 4 + [de] * 2
    grads = tuple(torch.empty(1, 1, 3 * (c8 if i < 4 else 2 * c8)) for i in range(6))
    outs = _stored(A._octic_array_pieces(grads, [t.shape[-1] for t in grads], heads, d1), segs,
                   heads, grads)
    assert not any(torch.isnan(o).any() for o in outs)
    # value (s, h, d) lands in array j at column (s H + h) w + (d - start of j)
    starts = [0, d1, 2 * d1, 3 * d1, 4 * d1, 4 * d1 + de]
    for j, (o, w) in enumerate(zip(outs, segs)):
        want = [1000 * s + 100 * h + starts[j] + i for s in range(3) for h in range(heads)
                for i in range(w)]
        assert o.tolist() == want
    grads1d = tuple(torch.empty(1, 1, 4 * c8 if i < 3 else 6 * c8) for i in range(5))
    outs = _stored(A._wide1d_array_pieces(grads1d, [t.shape[-1] for t in grads1d], heads, d1),
                   segs, heads, grads1d)
    assert not any(torch.isnan(o).any() for o in outs)
    for s in range(3):
        assert outs[s].tolist() == [1000 * s + 100 * h + i for h in range(heads)
                                       for i in range(4 * d1)]


@pytest.mark.parametrize("d1,heads", [(5, 2), (8, 4), (10, 3), (16, 2)])
def test_route_a_assembly_is_the_wide_layout(d1, heads):
    """Route (a)'s assembly tables (ops/attention.py:_pack_heads, the same
    entries the card's pack_heads_kernel reads) give the wide qkv of the
    octic arrays and of the wide-1d ones, and the cotangents in head order,
    column views included."""
    b, n, c8 = 2, 3, heads * d1
    de = 2 * d1
    segs = [d1] * 4 + [de] * 2
    ef = torch.randn(b, n, 12 * c8)
    qs = tuple(torch.randn(b, n, 3 * c8) for _ in range(4)) + (ef[..., :6 * c8], ef[..., 6 * c8:])
    out = A._pack_heads(torch.empty(b, n, 24 * c8), A._octic_array_pieces(
        qs, [t.stride(-2) for t in qs], heads, d1), segs, heads)
    assert torch.equal(out, A._octic_to_wide(qs, heads))
    y1d = torch.randn(b, n, 12 * c8)
    w = 4 * c8
    q1d = (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], ef[..., :6 * c8], ef[..., 6 * c8:])
    out = A._pack_heads(torch.empty(b, n, 24 * c8), A._wide1d_array_pieces(
        q1d, [t.stride(-2) for t in q1d], heads, d1), segs, heads)
    assert torch.equal(out, A._wide1d_to_wide(q1d, heads))
    gs = tuple(torch.randn(b, n, c8) for _ in range(4)) + tuple(
        torch.randn(b, n, 2 * c8) for _ in range(2))
    out = A._pack_heads(torch.empty(b, n, 8 * c8),
                        [[(t, t.stride(-2), 0, w) for t, w in zip(gs, segs)]], segs, heads)
    want = torch.cat([t.reshape(b, n, heads, -1) for t in gs], dim=-1).reshape(b, n, -1)
    assert torch.equal(out, want)


# ---- K-lin-d8-bwd (csrc/lin_d8_bwd.cu): one persistent launch of dx and dW
# units, slab by slab, and the fixed-order reduction of the dW partials

def lin_d8_bwd_units(plan: dict) -> list:
    """(CTA, kind, slot, row tile, column tile, slab) of every unit, in each
    CTA's order, read from the table as csrc/lin_d8_bwd_sm90.cuh reads it:
    CTA x takes units table[x] .. table[x + 1] - 1 of the int4 units from
    index units_at."""
    t, at = plan["table"], plan["units_at"]
    out = []
    for x in range(plan["grid"]):
        for u in range(t[x], t[x + 1]):
            w = t[at + 4 * u:at + 4 * u + 4]
            out.append((x, L.BWD_KINDS[w[0] & 3], w[0] >> 2, w[1], w[2], w[3]))
    return out


# the L/16 global and local crops, H/14 B=32, the ragged shape and 17 tokens;
# the slot widths c = 8, 24, 40, 128, 160 (the qkv: f = 3c)
BWD_SHAPES = [(12608, 128, 384), (9472, 128, 384), (8224, 160, 480), (195, 8, 24),
              (34, 8, 24)] + [(1000, c, 3 * c) for c in (8, 24, 40, 128, 160)]


@pytest.mark.parametrize("m,c,f", BWD_SHAPES)
def test_lin_d8_bwd_plan_writes_every_dx_element_once(m, c, f):
    """Each dx unit writes its 128 tokens x 128 channels of one slot's dx,
    clipped at m and at the slot's width (c, or 2c for an E row): every
    element of dx_g and of each E row's half of dxef once, each unit's
    tokens inside its slab."""
    plan = L.lin_d8_bwd_plan(m, c, f)
    seen = [torch.zeros(m, c, dtype=torch.int32) for _ in range(4)] + [
        torch.zeros(m, 2 * c, dtype=torch.int32) for _ in range(2)]
    for _, kind, slot, rt, ct, slab in lin_d8_bwd_units(plan):
        if kind in ("dx1", "dxe"):
            out = seen[slot] if kind == "dx1" else seen[4 + slot]
            m0, n0 = rt * L.BWD_BM, ct * L.BWD_BN
            assert m0 < m and n0 < out.shape[1]
            assert m0 // plan["slab_tokens"] == slab
            out[m0:m0 + L.BWD_BM, n0:n0 + L.BWD_BN] += 1
    assert all(bool((s == 1).all()) for s in seen)


@pytest.mark.parametrize("m,c,f", BWD_SHAPES)
def test_lin_d8_bwd_plan_sums_every_weight_gradient_once_a_slab(m, c, f):
    """The slabs cut [0, m) into runs of whole 128-token tiles, in order;
    every element of each w1[g] gradient and of each E row's share of the we
    gradient is covered by exactly one dW unit in every slab, each unit
    writing its own partial (csrc/lin_d8_bwd_sm90.cuh:tile_of), so the
    reduction sums S partials (2S for we) in slab order."""
    plan = L.lin_d8_bwd_plan(m, c, f)
    s, st = plan["slabs"], plan["slab_tokens"]
    assert st % L.BWD_BM == 0 and (s - 1) * st < m <= s * st
    cover = {("dw1", g): torch.zeros(s, c, f, dtype=torch.int32) for g in range(4)}
    cover |= {("dwe", r): torch.zeros(s, 2 * c, 2 * f, dtype=torch.int32) for r in range(2)}
    partials = set()
    for _, kind, slot, rt, ct, slab in lin_d8_bwd_units(plan):
        if kind in ("dw1", "dwe"):
            i0, j0 = rt * L.BWD_BM, ct * L.BWD_BN
            cov = cover[kind, slot]
            assert i0 < cov.shape[1] and j0 < cov.shape[2]
            cov[slab, i0:i0 + L.BWD_BM, j0:j0 + L.BWD_BN] += 1
            tile = ((slot * plan["ni1"] + rt) * plan["nj1"] + ct if kind == "dw1" else
                    4 * plan["ni1"] * plan["nj1"] + (slot * plan["nie"] + rt) * plan["nje"] + ct)
            assert 0 <= tile < plan["tiles"]
            partials.add((slab, tile))
    assert all(bool((cov == 1).all()) for cov in cover.values())
    assert len(partials) == s * plan["tiles"]  # no partial written twice
    per_slab = plan["tiles"] * L.BWD_BM * L.BWD_BN + L.BWD_BIAS_PARTS * plan["nj1"] * L.BWD_BN
    assert plan["slab_stride"] == per_slab and plan["scratch_floats"] == s * per_slab


@pytest.mark.parametrize("m,c,f", BWD_SHAPES)
def test_lin_d8_bwd_plan_schedule_table_and_smem(m, c, f):
    """One CTA an SM (never more than units), each with work, taking its
    units slab by slab; the loads balanced; the table's offsets, padding and
    units as the kernel reads them; the ring, the staging and the barriers
    within the H100's 227 KB; the registers of two consumer warpgroups and
    the producer within the SM's."""
    plan = L.lin_d8_bwd_plan(m, c, f)
    units = lin_d8_bwd_units(plan)
    assert len(units) == plan["n_units"] == len(plan["units"])
    assert plan["grid"] == min(L.NUM_SMS, plan["n_units"])
    assert plan["units_at"] % 4 == 0 and plan["units_at"] >= plan["grid"] + 1
    assert len(plan["table"]) == plan["units_at"] + 4 * plan["n_units"]
    for x in range(plan["grid"]):
        slabs = [u[5] for u in units if u[0] == x]
        assert slabs and slabs == sorted(slabs)
    loads = plan["loads"]
    assert min(loads) > 0
    if m >= 8224:  # the main path's shapes: the longest CTA within 15% of the mean
        assert max(loads) <= 1.15 * sum(loads) / len(loads)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["smem"] == 1024 + L.BWD_STAGES * plan["stage_bytes"] + 2 * 16384 + 16 * L.BWD_STAGES
    assert 2 * 128 * 232 + 128 * 40 <= 65536
    for _, box, inner, swizzle in plan["boxes"]:
        assert inner == 2 * box[0] <= swizzle and max(box) <= 256


def test_lin_d8_bwd_plan_rejects_widths():
    for m, c, f in ((16, 12, 36), (16, 8, 20), (0, 8, 24), (16, 4, 8)):
        with pytest.raises(ValueError):
            L.lin_d8_bwd_plan(m, c, f)


# ---- K-ln-d8's affine backward (csrc/ln_d8.cu:ln_bwd_affine_kernel)

# (m, c): H/14 B=32, the L/16 global crop, P11's ragged shape, one range cut
# short, a ragged last range past the minimum, one row, every chunk count
LN_BWD_CASES = [(8224, 160), (12608, 128), (195, 8), (9, 160), (5000, 16), (1, 256),
                (4225, 64), (777, 40), (300, 96), (1000, 136), (2049, 256)]


def ln_bwd_rows(plan: dict) -> list:
    """(CTA, warp, rows in the warp's order) as ln_bwd_affine_kernel walks
    them: CTA b's range [b rows, (b + 1) rows) cut at m, its warp w taking
    rows w, w + warps, ... of the range."""
    out = []
    for b in range(plan["grid"]):
        end = min(plan["m"], (b + 1) * plan["rows"])
        for w in range(plan["warps"]):
            out.append((b, w, list(range(b * plan["rows"] + w, end, plan["warps"]))))
    return out


def ln_bwd_param_of(p: int, nv: int, c: int) -> int:
    """The parameter gradient of partial slot p (csrc/ln_d8.cu:bwd_param_of):
    dalpha 8k + j over [alpha | alpha_ef], dbeta 8c + 8k + j; -1 for none."""
    if p < 256 * nv:
        k = 32 * (p >> 8) + (p & 31)
        return 8 * k + ((p >> 5) & 7) if k < c else -1
    r = p - 256 * nv
    k = r & 31
    return 8 * c + 8 * k + (r >> 5) if k < c // 8 else -1


@pytest.mark.parametrize("m,c", LN_BWD_CASES)
def test_ln_bwd_plan_covers_every_row_once_in_contiguous_ranges(m, c):
    """Each CTA one non-empty contiguous range of ``rows`` rows (the last cut
    at m), the ranges in CTA order covering [0, m); every row taken by one
    warp of its CTA; at most one CTA an SM, each range at least a full ring
    a warp."""
    plan = LN.ln_bwd_plan(m, c)
    rows, grid = plan["rows"], plan["grid"]
    assert grid <= L.NUM_SMS
    assert rows >= plan["warps"] * plan["stages"]
    assert (grid - 1) * rows < m <= grid * rows
    seen = torch.zeros(m, dtype=torch.int32)
    for b, _, mine in ln_bwd_rows(plan):
        assert all(b * rows <= r < min(m, (b + 1) * rows) for r in mine)
        seen[mine] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("m,c", LN_BWD_CASES)
def test_ln_bwd_plan_depends_only_on_m_c_and_sms(m, c):
    """The plan is a function of (m, c, sms): recomputed, it is the same; on a
    card of other SM counts only the grid and the rows move."""
    plan = LN.ln_bwd_plan.__wrapped__(m, c)
    assert plan == LN.ln_bwd_plan(m, c) == LN.ln_bwd_plan.__wrapped__(m, c, L.NUM_SMS)
    for sms in (66, 114, 132):
        other = LN.ln_bwd_plan.__wrapped__(m, c, sms)
        assert {k: v for k, v in other.items() if k not in ("grid", "rows")} == \
            {k: v for k, v in plan.items() if k not in ("grid", "rows")}
        assert other["grid"] <= sms


@pytest.mark.parametrize("c", range(8, LN.MAX_C + 1, 8))
def test_ln_bwd_plan_smem_and_slots_at_every_width(c):
    """Shared memory within the H100's 227 KB a CTA; the rings and the
    warps' sums as the kernel lays them out; the partial's slots land on
    each of the 9c parameter gradients once, the rest on none."""
    plan = LN.ln_bwd_plan(8224, c)
    nv, warps, stages = plan["nv"], plan["warps"], plan["stages"]
    assert 32 * nv >= c and all(32 * v < c for v in LN.LN_NV if v < nv)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["smem"] == warps * stages * 8 + max(warps * stages * 32 * c,
                                                    warps * plan["partial_floats"] * 4)
    assert plan["partial_floats"] == 256 * (nv + 1)
    params = [ln_bwd_param_of(p, nv, c) for p in range(plan["partial_floats"])]
    assert sorted(e for e in params if e >= 0) == list(range(9 * c))


@pytest.mark.parametrize("c", range(8, LN.MAX_C + 1, 8))
def test_ln_bwd_plan_bulk_copies_are_16_byte_multiples(c):
    """A row of x (and of u) is five 1-D bulk copies: four slots of 2c bytes
    and the E row of 8c, each a multiple of 16 bytes, landing back to back
    in the stage (chunk k at 16 k) and read from 16-byte multiples of the
    arrays (row m at m 2c and m 8c bytes)."""
    plan = LN.ln_bwd_plan(1000, c)
    copies = plan["copies"]
    assert copies == (2 * c,) * 4 + (8 * c,) and sum(copies) == 16 * c
    at = 0
    for nbytes in copies:
        assert nbytes % 16 == 0 and at % 16 == 0
        at += nbytes
    for m in (1, 7, 999):
        assert (m * 2 * c) % 16 == 0 and (m * 8 * c) % 16 == 0
    assert (plan["warps"] * plan["stages"] * 8) % 16 == 0  # the rings start on 16 bytes


def test_ln_bwd_plan_rejects_widths():
    for m, c in ((16, 12), (16, 4), (16, 0), (16, 264), (0, 8), (16, 257)):
        with pytest.raises(ValueError):
            LN.ln_bwd_plan(m, c)
