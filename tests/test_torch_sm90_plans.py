"""The launch plans of the TMA + wgmma kernels, computed in Python and
passed to their C entry points as integers (csrc/dense.cu,
csrc/attention_std.cu): the grid, the column boxes of a head, the shared
memory and the persistent tile order, held here without a card."""

import pytest
import torch

from octic_vits_tpu_torch.ops import attention as A
from octic_vits_tpu_torch.ops import dense as D

SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on the H100
HEAD_DIMS = list(range(8, 129, 8))


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
    # the octic rows' whole-head core holds a head in shared memory: a long
    # sequence it refuses is one the standard forward streams
    with pytest.raises(ValueError):
        A._check_attention_shape(1024, 128)
    A._check_attention_shape(257, 80)
    A._check_std_attention_shape(1024, 128)

