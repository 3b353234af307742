"""Block-diagonal D8-equivariant linear maps on the flat-E 5-tuple
(counterpart of octic_vits_tpu/ops/pallas_linear.py):

* :func:`linear_d8_fused`, with its ``linear_d8_tuple`` wrapper: one LinearD8
  with an optional D8-GELU epilogue or LayerScale + residual epilogue
  (``y = r + ls * linear(x)``, row 6e), differentiable (the train path's
  octic fc1 and fc2; the proj and fc2 of ``fuse_block_epilogues``);
* :func:`mlp_d8_fused`: the octic MLP fc1 -> D8-GELU -> fc2 (the JAX
  mlp_d8_tuple wrapper, here taking the five tensors directly),
  differentiable (row 4; its backward :func:`mlp_d8_fused_bwd`), and
  :func:`mlp_d8_fused_packed` / :func:`mlp_d8_packed`, the same on the
  packed ``[..., C]`` container (row 11);
* :func:`lin_d8_bwd_launch`: K-lin-d8-bwd, the transpose and weight
  gradients of one LinearD8, which the backward of the fused octic qkv +
  attention (ops/attention.py) ends with;
* :func:`linear_d8_qkv_wide` (row 13b) and :func:`linear_d8_wide1d` (the
  qkv of ``AttentionD8(use_wide_qkv)``): the qkv LinearD8 stored in the wide
  layouts through K-lin-d8's grouped-column store, with
  :func:`uninterleave_wide`.

Layouts: ``xs = (a1, a2, b1, b2, ef)`` with ``a* [..., c]`` and
``ef [..., 4c] = [row0 | row1]``; weights ``w1 [4, c, f]`` (one per 1-d
irrep), ``we [2c, 2f]`` (applied to each E row separately) and an A1-only
bias ``[f]``. Outputs have the same layout at width f. K-lin-d8 and K-lin-d8-bwd read
their flat-E inputs, and write their outputs, through row strides, so the
five views may be column slices of one packed container
(d8/group.py:unpack_packed_5f).
"""

from __future__ import annotations

import functools
import heapq
from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.d8.group import pack_5_to_flat, unpack_packed_5f
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda, row_stride
from octic_vits_tpu_torch.ops.gelu_d8 import gelu_d8_eager, gelu_d8_vjp


def linear_d8(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
              bias: Optional[torch.Tensor]) -> tuple:
    """The LinearD8 map in the inputs' dtype with plain torch products (the
    octic attention's proj, and its qkv in train mode, run this; so
    do the plain versions, in f32)."""
    c = xs[0].shape[-1]
    outs = [torch.matmul(xs[g], w1[g]) for g in range(4)]
    if bias is not None:
        outs[0] = outs[0] + bias
    ef = xs[4]
    rows = torch.matmul(ef.reshape(*ef.shape[:-1], 2, 2 * c), we)
    return tuple(outs) + (rows.reshape(*ef.shape[:-1], 2 * we.shape[-1]),)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


def mlp_d8_fused_reference(xs: tuple, w1a, wea, b1, w1b, web, b2) -> tuple:
    """Plain version: f32 math and exact erf; the hidden is rounded to the
    input dtype between the GELU and fc2, where the kernel stores it."""
    dt = xs[0].dtype
    hid = linear_d8(tuple(x.float() for x in xs), w1a.float(), wea.float(), _f32(b1))
    hid = tuple(t.to(dt).float() for t in gelu_d8_eager(hid))
    out = linear_d8(hid, w1b.float(), web.float(), _f32(b2))
    return tuple(t.to(dt) for t in out)


def _check_tuple(xs: tuple, c: int) -> tuple:
    lead = tuple(xs[0].shape[:-1])
    for g in range(4):
        check_kernel_arg(xs[g], f"xs[{g}]", lead + (c,))
    check_kernel_arg(xs[4], "xs[4]", lead + (4 * c,))
    return lead


def _row_strides(xs: tuple, c: int, name: str) -> tuple:
    """The row strides of the four 1-d views and of the E view of a flat-E
    tuple, which may be column views of one packed container: 16-byte
    aligned starts and strides, else raises (never copied)."""
    lead = tuple(xs[0].shape[:-1])
    ld1 = {row_stride(xs[g], f"{name}[{g}]", lead + (c,), align=True) for g in range(4)}
    if len(ld1) != 1:
        raise ValueError(f"{name}: the four 1-d views need one row stride, got {sorted(ld1)}")
    return lead, ld1.pop(), row_stride(xs[4], f"{name}[4]", lead + (4 * c,), align=True)


# K-lin-d8's tiling (csrc/lin_d8_sm90.cuh): persistent CTAs walking tiles of
# 64 tokens x 64 channels across all eight slots, two consumer warpgroups of
# 32 channels each sharing the A boxes (all eight products of their half in
# registers), 32-wide k blocks of 6 A boxes and 12 B boxes through a ring of
# LIN_STAGES stages
LIN_BM, LIN_BN, LIN_BNW, LIN_BK, LIN_STAGES = 64, 64, 32, 32, 3
LIN_MODES = ("tuple", "gelu", "ls", "wide", "wide1d")
NUM_SMS = 132  # streaming multiprocessors of the H100 (SXM)


@functools.lru_cache(maxsize=256)
def lin_d8_plan(m: int, c: int, f: int, mode: str = "tuple", sms: int = NUM_SMS) -> dict:
    """The launch plan of K-lin-d8 (csrc/lin_d8.cu) for ``m`` tokens, input
    width ``c`` and output width ``f`` per slot: one persistent CTA an SM
    (never more than tiles), tile t at (M-tile t // n_tiles, channel tile t %
    n_tiles) so that one M-tile's channel tiles run together; ``k1`` and
    ``ke`` the 32-wide k blocks of the 1-d and the E products; ``boxes`` the
    TMA boxes (operand, box, inner bytes, swizzle bytes); ``smem`` the shared
    memory, which the C entry point checks: align slack, the ring, each
    warpgroup's output staging (8 products of 64 x 32 bf16), the barriers (a
    stage's full and empty, each warpgroup's residual full and free for the
    LayerScale epilogue, whose residual tile the producer loads into the
    staging). ``mode`` is the epilogue and store: the tuple store (TMA)
    with no epilogue, with the D8-GELU or with the LayerScale + residual, or
    the grouped-column stores of the wide and wide-1d qkv. Cached: read it,
    do not change it."""
    if mode not in LIN_MODES:
        raise ValueError(f"lin_d8: mode {mode!r} is not one of {LIN_MODES}")
    if c % 8 or f % 8 or c < 8 or f < 8 or m < 1:
        raise ValueError(f"lin_d8: widths c={c}, f={f} must be positive multiples of 8")
    m_tiles, n_tiles = -(-m // LIN_BM), -(-f // LIN_BN)
    a_box, b_box = LIN_BM * LIN_BK * 2, LIN_BK * LIN_BNW * 2
    stage = 6 * a_box + 12 * b_box
    staging = 8 * LIN_BM * LIN_BNW * 2
    boxes = [("x", (LIN_BK, LIN_BM), 2 * LIN_BK, 64), ("w1", (LIN_BNW, LIN_BK, 1), 2 * LIN_BNW, 64),
             ("we", (LIN_BNW, LIN_BK), 2 * LIN_BNW, 64)]
    if mode in ("tuple", "gelu", "ls"):
        boxes += [("y", (LIN_BNW, LIN_BM), 2 * LIN_BNW, 64),
                  ("ye", (LIN_BNW, 1, LIN_BM), 2 * LIN_BNW, 64)]
    if mode == "ls":
        boxes += [("r", (LIN_BNW, LIN_BM), 2 * LIN_BNW, 64),
                  ("ref", (LIN_BNW, 1, LIN_BM), 2 * LIN_BNW, 64)]
    return {"grid": min(m_tiles * n_tiles, sms), "m_tiles": m_tiles, "n_tiles": n_tiles,
            "k1": -(-c // LIN_BK), "ke": -(-2 * c // LIN_BK), "stage_bytes": stage,
            "e_stage_bytes": 2 * a_box + 4 * b_box, "boxes": tuple(boxes), "mode": mode,
            "smem": 1024 + LIN_STAGES * stage + 2 * staging + (2 * LIN_STAGES + 4) * 8,
            # f32 accumulators a consumer thread holds (8 m64n32 products) and
            # the registers setmaxnreg gives it
            "acc_regs": 8 * LIN_BM * LIN_BNW // 128, "max_regs": 232, "m": m, "f": f}


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lin_d8_launch(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                  bias: Optional[torch.Tensor], gelu: bool, layerscale: Optional[tuple] = None,
                  residual: Optional[tuple] = None, out: Optional[tuple] = None) -> tuple:
    """One launch of the K-lin-d8 kernel (csrc/lin_d8.cu) on CUDA bf16
    tensors, with the D8-GELU epilogue, the LayerScale + residual epilogue
    (`layerscale` = ``(ls1 [4, f], lse [2f])`` and the output-shaped 5-tuple
    `residual`) or neither. The input views may be column slices of one
    packed container (read in place through their row strides); `out`, a
    flat-E 5-tuple of such views at width f, receives the result in place
    (else it is allocated). Counts nothing: the public ops that use it count
    their own launches."""
    _, c, f = w1.shape
    if c % 8 or f % 8:
        raise ValueError(f"lin_d8: widths c={c}, f={f} must be multiples of 8")
    lead, ldx, ldxe = _row_strides(xs, c, "xs")
    check_kernel_arg(w1, "w1", (4, c, f))
    check_kernel_arg(we, "we", (2 * c, 2 * f))
    check_kernel_arg(bias, "bias", (f,))
    ls1 = lse = None
    rs = (None,) * 5
    if layerscale is not None:
        if gelu:
            raise ValueError("lin_d8: the LayerScale epilogue and the GELU epilogue exclude "
                             "each other")
        ls1, lse = layerscale
        check_kernel_arg(ls1, "ls1", (4, f))
        check_kernel_arg(lse, "lse", (2 * f,))
        rs = tuple(residual)
        _check_tuple(rs, f)
        if tuple(rs[0].shape[:-1]) != lead:
            raise ValueError("lin_d8: the residual must have the output's shape")
    if out is None:
        kw = dict(device=xs[0].device, dtype=xs[0].dtype)
        out = tuple(torch.empty(*lead, f, **kw) for _ in range(4)) + (
            torch.empty(*lead, 4 * f, **kw),)
    olead, ldy, ldye = _row_strides(out, f, "out")
    if olead != lead:
        raise ValueError("lin_d8: the output views must have the input's leading shape")
    mode = "gelu" if gelu else "tuple" if layerscale is None else "ls"
    _lin_d8_call(xs, (ldx, ldxe), w1, we, bias, out[:4], (out[4], out[4][..., 2 * f:]),
                 (ldy, ldye), (f, 0, 2 * f, 0), mode, ls1, lse, rs)
    return tuple(out)


def _lin_d8_call(xs: tuple, ldxs: tuple, w1, we, bias, ys: tuple, yes: tuple, ldys: tuple,
                 groups: tuple, mode: str, ls1=None, lse=None, rs: tuple = (None,) * 5) -> None:
    """One ``ovt_lin_d8`` launch on checked arguments: the inputs `xs` with
    the row strides ``ldxs`` of :func:`_row_strides`; the four 1-d outputs
    start at ``ys``, the E rows' outputs at ``yes`` (two starts), with the
    row strides ``ldys`` and the grouped-column maps ``groups = (g1, s1, ge,
    se)`` of csrc/lin_d8.cu (output column j of a 1-d irrep at ``(j // g1) *
    s1 + j % g1``, of an E row at ``(j // ge) * se + j % ge``); ``mode`` the
    plan's (:func:`lin_d8_plan`)."""
    _, c, f = w1.shape
    m = xs[0].numel() // c
    plan = lin_d8_plan(m, c, f, mode, _sms(xs[0].device))
    kernels.launch("ovt_lin_d8", *xs, w1, we, bias, *ys, *yes, ls1, lse, *rs, m, c, f,
                   int(mode == "gelu"), *ldxs, *ldys, *groups, plan["grid"], plan["smem"])


def lin_d8_wide_launch(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                       bias: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """One K-lin-d8 launch that stores the qkv LinearD8 as the wide qkv ``[...,
    8f]`` (each (s, head) slice ``[a1|a2|b1|b2|e0|e1]``, the layout of
    :func:`linear_d8_qkv_wide`) through the grouped-column store; the input
    views may be column slices of one packed container. Counts nothing: the
    fused qkv + attention ops feed it to the octic forward's route (a)."""
    _, c, f = w1.shape
    d1, de = _wide_dims(f, num_heads)
    lead, ldx, ldxe = _row_strides(xs, c, "xs")
    check_kernel_arg(w1, "w1", (4, c, f))
    check_kernel_arg(we, "we", (2 * c, 2 * f))
    check_kernel_arg(bias, "bias", (f,))
    y = torch.empty(*lead, 8 * f, device=xs[0].device, dtype=xs[0].dtype)
    _lin_d8_call(xs, (ldx, ldxe), w1, we, bias, tuple(y[..., g * d1:] for g in range(4)),
                 (y[..., 4 * d1:], y[..., 4 * d1 + de:]), (8 * f, 8 * f),
                 (d1, 8 * d1, de, 8 * d1), "wide")
    return y


def lin_d8_bwd_reference(xs: tuple, w1: torch.Tensor, we: torch.Tensor, dq: tuple, de: tuple,
                         bias: Optional[torch.Tensor]) -> tuple:
    """Plain version of K-lin-d8-bwd: the transpose and the weight gradients
    of the LinearD8 ``xs -> (q_1..q_4, [e_0 | e_1])`` for the cotangents
    ``dq`` (4 x ``[..., F]``) and ``de`` (2 x ``[..., 2F]``, one per E row).
    f32 math; dx in the input dtype, dW and dbias in the weights' dtype.

    Returns ``(dxs (5-tuple), dw1, dwe, dbias or None)``."""
    dt = xs[0].dtype
    c, f = w1.shape[1], w1.shape[2]
    w1f, wef = w1.float(), we.float()
    dqf = [t.float().reshape(-1, f) for t in dq]
    def_ = [t.float().reshape(-1, 2 * f) for t in de]
    x1 = [t.float().reshape(-1, c) for t in xs[:4]]
    rows = xs[4].float().reshape(-1, 2, 2 * c)
    lead = xs[0].shape[:-1]
    dxs = tuple(torch.matmul(dqf[g], w1f[g].t()).reshape(*lead, c).to(dt) for g in range(4))
    dxe = torch.cat([torch.matmul(def_[r], wef.t()) for r in range(2)], dim=-1)
    dw1 = torch.stack([torch.matmul(x1[g].t(), dqf[g]) for g in range(4)])
    dwe = sum(torch.matmul(rows[:, r].t(), def_[r]) for r in range(2))
    dbias = None if bias is None else dqf[0].sum(0).to(bias.dtype)
    return (dxs + (dxe.reshape(*lead, 4 * c).to(dt),), dw1.to(w1.dtype), dwe.to(we.dtype),
            dbias)


# K-lin-d8-bwd's tiling (csrc/lin_d8_bwd_sm90.cuh): units of one 128 x 128
# output tile (two consumer warpgroups of 64 rows sharing the B box), 64-wide
# k blocks of 32 KB through a ring of BWD_STAGES stages; dW tiles reduce the
# token axis slab by slab into f32 partials (BWD_BIAS_PARTS quarters of a
# k block's rows for dbias)
BWD_BM, BWD_BN, BWD_BK, BWD_STAGES, BWD_BIAS_PARTS = 128, 128, 64, 6, 4
BWD_KINDS = ("dx1", "dxe", "dw1", "dwe")  # a unit's kind, its code in the table
# a slab's dq (the eight bf16 cotangent slots of its tokens) is kept under
# this many bytes, so that it stays in the 50 MB L2 between its dx and dW units
BWD_SLAB_BYTES = 14 << 20
# the schedule's cost of a unit's epilogue, in k blocks: a dx tile's TMA
# store, a dW tile's 64 KB f32 partial
BWD_DX_EPI, BWD_DW_EPI = 2, 4


@functools.lru_cache(maxsize=64)
def lin_d8_bwd_plan(m: int, c: int, f: int, sms: int = NUM_SMS) -> dict:
    """The launch plan of K-lin-d8-bwd (csrc/lin_d8_bwd.cu) for ``m`` tokens,
    input width ``c`` and output width ``f`` per slot.

    The token axis is cut into ``slabs`` slabs of whole 128-token tiles,
    enough that each slab's cotangents take at most ``BWD_SLAB_BYTES``. The
    units: for each 128-token tile, one dx unit per
    128 input channels of each 1-d slot (``dx1``: K = f) and of each E row
    (``dxe``: K = 2f); for each slab, one dW unit per 128 x 128 tile of each
    w1[g] gradient (``dw1``) and of each E row's share of the we gradient
    (``dwe``), K = the slab's tokens. Each unit is ``(kind + 4 slot, row tile,
    column tile, slab)``. One persistent CTA an SM (never more than units)
    takes its units in slab order: within a slab the longest first, each to
    the CTA with the least work so far (``loads``, in k blocks plus each
    epilogue's ``BWD_*_EPI``). ``table`` is what the kernel reads: the grid +
    1 offsets of each CTA's units, padded to a multiple of 4, then the units
    from ``units_at``. ``scratch_floats``: the f32 partials, ``slab_stride``
    a slab (``tiles`` dW tiles of 128 x 128, then the dbias quarters).
    ``smem``: align slack, the ring, each warpgroup's dx staging, the
    barriers; the C entry point checks it. Cached: read it, do not change
    it."""
    if c % 8 or f % 8 or c < 8 or f < 8 or m < 1:
        raise ValueError(f"lin_d8_bwd: widths c={c}, f={f} must be positive multiples of 8")

    def cdiv(a, b):
        return -(-a // b)

    m_tiles = cdiv(m, BWD_BM)
    ni1, nj1, nie, nje = cdiv(c, BWD_BM), cdiv(f, BWD_BN), cdiv(2 * c, BWD_BM), cdiv(2 * f, BWD_BN)
    slab_tokens = cdiv(m_tiles, min(cdiv(m * 8 * f * 2, BWD_SLAB_BYTES), m_tiles)) * BWD_BM
    slabs = cdiv(m, slab_tokens)
    tiles = 4 * ni1 * nj1 + 2 * nie * nje
    k_dx1, k_dxe = cdiv(f, BWD_BK) + BWD_DX_EPI, cdiv(2 * f, BWD_BK) + BWD_DX_EPI
    per_slab = []
    for s in range(slabs):
        k_dw = cdiv(min(slab_tokens, m - s * slab_tokens), BWD_BK) + BWD_DW_EPI
        dw = [((2 + 4 * g, i, j, s), k_dw) for g in range(4) for i in range(ni1)
              for j in range(nj1)]
        dw += [((3 + 4 * r, i, j, s), k_dw) for r in range(2) for i in range(nie)
               for j in range(nje)]
        dx = []
        for mt in range(s * slab_tokens // BWD_BM, min(m_tiles, (s + 1) * slab_tokens // BWD_BM)):
            dx += [((1 + 4 * r, mt, n, s), k_dxe) for r in range(2) for n in range(nie)]
            dx += [((4 * g, mt, n, s), k_dx1) for g in range(4) for n in range(ni1)]
        per_slab.append(sorted(dw + dx, key=lambda uc: -uc[1]))
    n_units = sum(len(su) for su in per_slab)
    grid = min(sms, n_units)
    heap = [(0, cta) for cta in range(grid)]
    lists = [[] for _ in range(grid)]
    for su in per_slab:
        for unit, cost in su:
            load, cta = heapq.heappop(heap)
            lists[cta].append(unit)
            heapq.heappush(heap, (load + cost, cta))
    loads = [0] * grid
    for load, cta in heap:
        loads[cta] = load
    offsets = [0]
    for lst in lists:
        offsets.append(offsets[-1] + len(lst))
    units_at = cdiv(grid + 1, 4) * 4
    units = tuple(u for lst in lists for u in lst)
    table = tuple(offsets) + (0,) * (units_at - grid - 1) + tuple(v for u in units for v in u)
    slab_stride = tiles * BWD_BM * BWD_BN + BWD_BIAS_PARTS * nj1 * BWD_BN
    stage = 4 * 64 * 64 * 2
    return {"grid": grid, "slabs": slabs, "slab_tokens": slab_tokens,
            "ni1": ni1, "nj1": nj1, "nie": nie, "nje": nje, "tiles": tiles,
            "units": units, "n_units": n_units, "units_at": units_at, "table": table,
            "loads": tuple(loads), "slab_stride": slab_stride,
            "scratch_floats": slabs * slab_stride, "stage_bytes": stage,
            "boxes": (("dq", (64, 64), 128, 128), ("x", (64, 64), 128, 128),
                      ("w1", (64, BWD_BN, 1), 128, 128), ("we", (64, BWD_BN), 128, 128),
                      ("dx", (64, 64), 128, 128), ("dxe", (64, 1, 64), 128, 128)),
            "smem": 1024 + BWD_STAGES * stage + 2 * 2 * 64 * 64 * 2 + 2 * BWD_STAGES * 8}


@functools.lru_cache(maxsize=64)
def _bwd_table(m: int, c: int, f: int, sms: int, device: torch.device) -> torch.Tensor:
    """The plan's unit table on `device`, made once a shape."""
    return torch.tensor(lin_d8_bwd_plan(m, c, f, sms)["table"], dtype=torch.int32, device=device)


def lin_d8_bwd_launch(xs: tuple, w1: torch.Tensor, we: torch.Tensor, dq: tuple, de: tuple,
                      with_bias: bool, out: Optional[tuple] = None) -> tuple:
    """One launch of K-lin-d8-bwd (csrc/lin_d8_bwd.cu: one persistent TMA +
    wgmma kernel and its fixed-order reduction of the weight gradients, no
    atomics) on CUDA bf16 tensors; the same outputs as
    :func:`lin_d8_bwd_reference`. The inputs `xs` may be column views of one
    packed container, and `out` (a flat-E 5-tuple of such views) receives dx
    in place (else it is allocated). The weight gradients reduce the token
    axis slab by slab (:func:`lin_d8_bwd_plan`) through an f32 scratch.
    Counts nothing."""
    _, c, f = w1.shape
    if c % 8 or f % 8:
        raise ValueError(f"lin_d8_bwd: widths c={c}, f={f} must be multiples of 8")
    lead, ldx, ldxe = _row_strides(xs, c, "xs")
    check_kernel_arg(w1, "w1", (4, c, f))
    check_kernel_arg(we, "we", (2 * c, 2 * f))
    for g in range(4):
        check_kernel_arg(dq[g], f"dq[{g}]", lead + (f,))
    for r in range(2):
        check_kernel_arg(de[r], f"de[{r}]", lead + (2 * f,))
    if out is None:
        out = tuple(torch.empty(x.shape, device=x.device, dtype=x.dtype) for x in xs)
    olead, ldd, ldde = _row_strides(out, c, "out")
    if olead != lead:
        raise ValueError("lin_d8_bwd: dx must have the input's shape")
    m = xs[0].numel() // c
    sms = _sms(xs[0].device)
    plan = lin_d8_bwd_plan(m, c, f, sms)
    dw1, dwe = torch.empty_like(w1), torch.empty_like(we)
    dbias = torch.empty(f, device=w1.device, dtype=w1.dtype) if with_bias else None
    scratch = torch.empty(plan["scratch_floats"], device=w1.device, dtype=torch.float32)
    kernels.launch("ovt_lin_d8_bwd", *xs, w1, we, *dq, *de, *out, dw1, dwe, dbias, scratch,
                   _bwd_table(m, c, f, sms, xs[0].device), m, c, f, ldx, ldxe, ldd, ldde,
                   plan["grid"], plan["slabs"], plan["slab_tokens"], plan["n_units"],
                   plan["units_at"], plan["smem"])
    return tuple(out), dw1, dwe, dbias


def _lse_full(lse: torch.Tensor) -> torch.Tensor:
    """The E LayerScale over both rows of the flat-E output: ``[lse | lse]``."""
    return torch.cat((lse, lse))


def linear_d8_fused_reference(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                              bias: Optional[torch.Tensor], fuse_gelu: bool = False,
                              layerscale: Optional[tuple] = None,
                              residual: Optional[tuple] = None) -> tuple:
    """Plain version: f32 math and exact erf, with the LayerScale + residual
    epilogue ``r + ls * y`` in f32 where `layerscale` is given; results in
    the input dtype."""
    y = linear_d8(tuple(x.float() for x in xs), w1.float(), we.float(), _f32(bias))
    if fuse_gelu:
        y = gelu_d8_eager(y)
    if layerscale is not None:
        ls1, lse = (t.float() for t in layerscale)
        y = tuple(residual[g].float() + ls1[g] * y[g] for g in range(4)) + (
            residual[4].float() + _lse_full(lse) * y[4],)
    return tuple(t.to(xs[0].dtype) for t in y)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a ``[..., k]``, b ``[k, n]``) of the operands as they are,
    accumulated and returned in f32: on the card one bf16 tensor-core product
    with an f32 output, elsewhere the f32 product of the same operands."""
    if a.is_cuda and a.dtype == b.dtype != torch.float32:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def linear_d8_f32(xs: tuple, w1: torch.Tensor, we: torch.Tensor) -> tuple:
    """The LinearD8 map without bias, its products on the operands as they
    are with f32 results (pallas_linear.py:_eager_linear's products)."""
    c = xs[0].shape[-1]
    ef = xs[4]
    rows = _mm_f32(ef.reshape(*ef.shape[:-1], 2, 2 * c), we)
    return tuple(_mm_f32(xs[g], w1[g]) for g in range(4)) + (
        rows.reshape(*ef.shape[:-1], 2 * we.shape[-1]),)


def linear_d8_fused_bwd(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                        bias: Optional[torch.Tensor], gs: tuple, fuse_gelu: bool,
                        layerscale: Optional[tuple] = None, dx_f32: bool = False,
                        z_f32: bool = True) -> tuple:
    """The plain backward of :func:`linear_d8_fused`, as the JAX one is
    eager XLA (pallas_linear.py:_bwd_rule): with the LayerScale epilogue
    ``y = r + ls z`` it recomputes z and takes ``dls = sum_m g z``, ``dz = g
    ls`` (the residual's gradient is g itself, which the caller returns);
    with the GELU epilogue it recomputes the pre-activation z and pushes the
    cotangent through the D8-GELU as ``R(gelu'(S z) (S g))`` in f32; then it
    forms the input and weight products. Every product runs on the operands
    in their dtype, bf16 operands with f32 accumulation on the card (what
    XLA's default precision does with the f32-cast products on the TPU), f32
    on the CPU. The recomputed z keeps its f32 result, as in JAX
    (``z_f32=False`` rounds it to the operand dtype, the port's rule before
    row 4's repair, kept for the comparison in chip_smoke.py P15); dx comes
    back in the operand dtype, or in f32 with `dx_f32` (fc2's dx in row 4's
    backward, the hidden's cotangent that fc1's GELU VJP takes). The E-slot
    order is kept by working on the flat-E tuple throughout
    (``gelu_d8_vjp`` unpacks E11|E12|E21|E22 to the isotypic order and back).

    Returns ``(dxs (5-tuple), dw1, dwe, dbias or None, dls1 or None, dlse or
    None)``."""
    dt = xs[0].dtype
    c, f = w1.shape[1], w1.shape[2]
    g = tuple(t.float() for t in gs)
    w1d, wed = w1.to(dt), we.to(dt)
    dls1 = dlse = None
    if fuse_gelu or layerscale is not None:
        z = (linear_d8_f32(xs, w1d, wed) if z_f32 else
             tuple(t.float() for t in linear_d8(xs, w1d, wed, None)))
        if bias is not None:
            z = (z[0] + bias.float(),) + z[1:]
    if layerscale is not None:
        ls1, lse = layerscale
        dls1 = torch.stack([(g[i] * z[i]).reshape(-1, f).sum(0) for i in range(4)]).to(ls1.dtype)
        dfull = (g[4] * z[4]).reshape(-1, 4 * f).sum(0)
        dlse = (dfull[:2 * f] + dfull[2 * f:]).to(lse.dtype)
        g = tuple(g[i] * ls1[i].float() for i in range(4)) + (g[4] * _lse_full(lse.float()),)
    if fuse_gelu:
        g = gelu_d8_vjp(z, g)
    dbias = None if bias is None else g[0].reshape(-1, f).sum(0).to(bias.dtype)
    gd = tuple(t.to(dt) for t in g)
    mm = _mm_f32 if dx_f32 else torch.matmul
    dxs = [mm(gd[i], w1d[i].t()) for i in range(4)]
    dw1 = torch.stack([torch.matmul(xs[i].reshape(-1, c).t(), gd[i].reshape(-1, f))
                       for i in range(4)])
    grows = gd[4].reshape(-1, 2, 2 * f)
    xrows = xs[4].reshape(-1, 2, 2 * c)
    dxs.append(mm(grows, wed.t()).reshape(xs[4].shape))
    dwe = sum(torch.matmul(xrows[:, r].t(), grows[:, r]).float() for r in range(2))
    return tuple(dxs), dw1.to(w1.dtype), dwe.to(we.dtype), dbias, dls1, dlse


class _LinearD8Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w1, we, bias, ls1, lse, fuse_gelu, *tensors):
        xs, residual = tensors[:5], tensors[5:] or None
        layerscale = None if ls1 is None else (ls1, lse)
        # the JAX residuals (pallas_linear.py:215): not the block residual
        ctx.save_for_backward(w1, we, bias, ls1, lse, *xs)
        ctx.fuse_gelu = fuse_gelu
        ctx.res_dtypes = () if residual is None else tuple(r.dtype for r in residual)
        if not on_cuda(tensors + (w1, we, bias, ls1, lse)):
            return linear_d8_fused_reference(xs, w1, we, bias, fuse_gelu, layerscale, residual)
        linear_d8_fused.launches += 1
        if layerscale is not None:
            linear_d8_epilogue.launches += 1
        return lin_d8_launch(xs, w1, we, bias, fuse_gelu, layerscale, residual)

    @staticmethod
    def backward(ctx, *gs):
        w1, we, bias, ls1, lse, *xs = ctx.saved_tensors
        layerscale = None if ls1 is None else (ls1, lse)
        dxs, dw1, dwe, dbias, dls1, dlse = linear_d8_fused_bwd(tuple(xs), w1, we, bias, gs,
                                                               ctx.fuse_gelu, layerscale)
        drs = tuple(g.to(dt) for g, dt in zip(gs, ctx.res_dtypes))  # d(r + ls z)/dr = 1
        return (dw1, dwe, dbias, dls1, dlse, None) + dxs + drs


def linear_d8_fused(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                    bias: Optional[torch.Tensor], fuse_gelu: bool = False,
                    layerscale: Optional[tuple] = None,
                    residual: Optional[tuple] = None) -> tuple:
    """One block-diagonal LinearD8 on the flat-E 5-tuple ``xs`` (a* ``[..., c]``,
    ef ``[..., 4c]``), weights ``w1 [4, c, f]``, ``we [2c, 2f]``, A1 bias
    ``[f]``, optionally with the D8-GELU epilogue or, with `layerscale` =
    ``(ls1 [4, f], lse [2f])`` and the output-shaped flat-E 5-tuple
    `residual`, the LayerScale + residual epilogue ``y = residual + ls *
    linear(x)`` (the two exclude each other). CPU tensors take
    :func:`linear_d8_fused_reference`; CUDA tensors launch K-lin-d8
    (csrc/lin_d8.cu). The backward is :func:`linear_d8_fused_bwd` (plain
    torch); it saves the inputs, the weights and the LayerScale, not the
    residual."""
    if (layerscale is None) != (residual is None):
        raise ValueError("linear_d8_fused: layerscale and residual come together")
    if layerscale is not None and fuse_gelu:
        raise ValueError("linear_d8_fused: the LayerScale epilogue excludes fuse_gelu")
    ls1, lse = layerscale if layerscale is not None else (None, None)
    return _LinearD8Fused.apply(w1, we, bias, ls1, lse, fuse_gelu, *xs, *(residual or ()))


linear_d8_fused.launches = 0


def linear_d8_epilogue(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                       bias: Optional[torch.Tensor], layerscale: tuple, residual: tuple) -> tuple:
    """:func:`linear_d8_fused` with the LayerScale + residual epilogue (kernel
    row 6e). ``linear_d8_epilogue.launches`` counts the launches of
    ``linear_d8_fused`` that run the epilogue (they count there too)."""
    return linear_d8_fused(xs, w1, we, bias, layerscale=layerscale, residual=residual)


linear_d8_epilogue.launches = 0


def linear_d8_tuple(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                    bias: Optional[torch.Tensor], fuse_gelu: bool = False,
                    layerscale: Optional[tuple] = None,
                    residual: Optional[tuple] = None) -> tuple:
    """5-tuple wrapper (pallas_linear.py:linear_d8_tuple): E may be flat
    ``[..., 4c]`` or ``[..., 2, 2c]`` (in `xs` and in `residual` alike); the
    result comes back in the same container at width f."""
    flat_e = xs[4].ndim == xs[0].ndim

    def flat(t5):
        return t5 if t5 is None or flat_e else tuple(t5[:4]) + (t5[4].flatten(-2),)

    ys = linear_d8_fused(flat(xs), w1, we, bias, fuse_gelu, layerscale, flat(residual))
    return ys if flat_e else ys[:4] + (ys[4].unflatten(-1, (2, -1)),)


# ---------------------------------------------------------------------------
# the fused octic MLP (row 4) with its backward, and its packed-container
# variant (row 11)
# ---------------------------------------------------------------------------


def _mlp_bwd_from_hidden(xs: tuple, h: tuple, w1a, wea, b1, w1b, web, b2, gs: tuple,
                         dh_f32: bool = True, z_f32: bool = True) -> tuple:
    """fc2's backward at the rounded hidden `h`, then fc1's with the D8-GELU
    VJP, each as :func:`linear_d8_fused_bwd` (products on the operands in
    their dtype, the GELU VJP in f32): the JAX rule
    pallas_linear.py:_mlp_bwd_rule, the composition of the two linear
    kernels' backward rules. The hidden's cotangent dh reaches the GELU VJP
    in f32, as ``dh1`` / ``dhef`` do there (:589-604); ``dh_f32=False`` and
    ``z_f32=False`` give the earlier rule that rounded dh and the recomputed
    pre-activation to the operand dtype (chip_smoke.py P15 times both)."""
    dh, dw1b, dweb, db2 = linear_d8_fused_bwd(h, w1b, web, b2, gs, False, dx_f32=dh_f32)[:4]
    dxs, dw1a, dwea, db1 = linear_d8_fused_bwd(xs, w1a, wea, b1, dh, True, z_f32=z_f32)[:4]
    return dxs + (dw1a, dwea, db1, dw1b, dweb, db2)


def mlp_d8_fused_bwd_reference(xs: tuple, w1a, wea, b1, w1b, web, b2, gs: tuple) -> tuple:
    """Plain backward of :func:`mlp_d8_fused`: the hidden from the plain fc1 +
    GELU, rounded to the input dtype where the kernel stores it, then
    :func:`_mlp_bwd_from_hidden` in f32. dx in the input dtype, the weight
    and bias gradients in theirs.

    Returns ``(dx (5 tensors), dw1a, dwea, db1, dw1b, dweb, db2)``."""
    dt = xs[0].dtype
    h = linear_d8_fused_reference(xs, w1a, wea, b1, fuse_gelu=True)
    params = (w1a, wea, b1, w1b, web, b2)
    grads = _mlp_bwd_from_hidden(tuple(t.float() for t in xs), tuple(t.float() for t in h),
                                 *map(_f32, params), tuple(g.float() for g in gs))
    return tuple(t.to(dt) for t in grads[:5]) + tuple(
        None if g is None else g.to(p.dtype) for g, p in zip(grads[5:], params))


def mlp_d8_fused_bwd(xs: tuple, w1a, wea, b1, w1b, web, b2, gs: tuple) -> tuple:
    """Backward of :func:`mlp_d8_fused` from its residuals (the input tuple
    and the six weights, what the JAX custom VJP saves) and the output
    cotangent `gs`. CPU tensors take :func:`mlp_d8_fused_bwd_reference`.
    CUDA tensors recompute the rounded hidden through K-lin-d8 with the
    GELU epilogue (the JAX rule recomputes it through the fc1 + GELU kernel
    too), then run :func:`_mlp_bwd_from_hidden` in plain torch, as the JAX
    rule is eager XLA. The input views may be column slices of one packed
    container (the backward of :func:`mlp_d8_fused_packed`).

    Returns ``(dx (5 tensors), dw1a, dwea, db1, dw1b, dweb, db2)``."""
    params = (w1a, wea, b1, w1b, web, b2)
    if not on_cuda(tuple(xs) + params + tuple(gs)):
        return mlp_d8_fused_bwd_reference(xs, *params, gs)
    mlp_d8_fused_bwd.launches += 1
    h = lin_d8_launch(tuple(xs), w1a, wea, b1, gelu=True)
    return _mlp_bwd_from_hidden(tuple(xs), h, *params, tuple(gs))


def _mlp_launch(xs: tuple, w1a, wea, b1, w1b, web, b2, out: Optional[tuple] = None) -> tuple:
    """fc1 with the D8-GELU epilogue writes the bf16 hidden, fc2 reads it
    and writes `out` (or a new flat-E tuple): two K-lin-d8 launches."""
    if w1b.shape[1] != w1a.shape[2]:
        raise ValueError("mlp_d8_fused: fc2 input width must equal fc1 output width")
    hid = lin_d8_launch(xs, w1a, wea, b1, gelu=True)
    return lin_d8_launch(hid, w1b, web, b2, gelu=False, out=out)


class _MlpD8Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *tensors):
        xs, params = tensors[:5], tensors[5:]
        ctx.save_for_backward(*tensors)  # (xs, weights), as pallas_linear.py:_mlp_fwd_rule
        if not on_cuda(tensors):
            return mlp_d8_fused_reference(xs, *params)
        mlp_d8_fused.launches += 1
        return _mlp_launch(xs, *params)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        return mlp_d8_fused_bwd(saved[:5], *saved[5:], gs)


def mlp_d8_fused(xs: tuple, w1a, wea, b1, w1b, web, b2) -> tuple:
    """Octic MLP on the flat-E tuple: fc1 (c -> h) with the D8-GELU epilogue,
    fc2 (h -> c'); the JAX mlp_d8_tuple wrapper, here taking the five tensors
    directly. CPU tensors take :func:`mlp_d8_fused_reference`; CUDA tensors
    launch K-lin-d8 twice (fc1 writes the bf16 hidden, fc2 reads it).
    Differentiable: the backward is :func:`mlp_d8_fused_bwd`; only the
    inputs and the weights are saved, as in the JAX custom VJP."""
    return _MlpD8Fused.apply(*xs, w1a, wea, b1, w1b, web, b2)


mlp_d8_fused.launches = 0
mlp_d8_fused_bwd.launches = 0


def mlp_d8_fused_packed_reference(x: torch.Tensor, w1a, wea, b1, w1b, web, b2) -> torch.Tensor:
    """Plain version of :func:`mlp_d8_fused_packed`: the plain fused MLP on
    the container's flat-E views, packed again."""
    return pack_5_to_flat(mlp_d8_fused_reference(unpack_packed_5f(x), w1a, wea, b1, w1b, web,
                                                 b2))


class _MlpD8FusedPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1a, wea, b1, w1b, web, b2):
        params = (w1a, wea, b1, w1b, web, b2)
        ctx.save_for_backward(x, *params)  # as pallas_linear.py:_mlp_packed_fwd_rule
        if not on_cuda((x,) + params):
            return mlp_d8_fused_packed_reference(x, *params)
        mlp_d8_fused_packed.launches += 1
        y = torch.empty(*x.shape[:-1], 8 * w1b.shape[2], device=x.device, dtype=x.dtype)
        _mlp_launch(unpack_packed_5f(x), *params, out=unpack_packed_5f(y))
        return y

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        grads = mlp_d8_fused_bwd(unpack_packed_5f(x), *params, unpack_packed_5f(g))
        return (pack_5_to_flat(grads[:5]),) + grads[5:]


def mlp_d8_fused_packed(x: torch.Tensor, w1a, wea, b1, w1b, web, b2) -> torch.Tensor:
    """The fused octic MLP on the packed container ``[M, C]`` -> ``[M, C']``
    (pallas_linear.py:mlp_d8_fused_packed, kernel row 11). CPU tensors take
    :func:`mlp_d8_fused_packed_reference`; CUDA tensors launch K-lin-d8
    twice: fc1 + GELU reads the container's five slot views in place
    through their row strides, fc2 writes the packed ``[M, 8f]`` output in
    place. The backward is :func:`mlp_d8_fused_bwd` on the same views (its
    launches count there); dx is packed with one concatenate."""
    if x.ndim != 2:
        raise ValueError(f"mlp_d8_fused_packed: x must be [M, C], got {tuple(x.shape)}")
    return _MlpD8FusedPacked.apply(x, w1a, wea, b1, w1b, web, b2)


mlp_d8_fused_packed.launches = 0


def mlp_d8_packed(x: torch.Tensor, w1a, wea, b1, w1b, web, b2) -> torch.Tensor:
    """:func:`mlp_d8_fused_packed` for any leading dims: ``[..., C]`` ->
    ``[..., C']`` (pallas_linear.py:mlp_d8_packed)."""
    y = mlp_d8_fused_packed(x.reshape(-1, x.shape[-1]), w1a, wea, b1, w1b, web, b2)
    return y.reshape(*x.shape[:-1], y.shape[-1])


# ---------------------------------------------------------------------------
# the wide qkv stores: row 13b (one interleaved [M, 3C] qkv) and the wide-1d
# qkv of AttentionD8(use_wide_qkv)
# ---------------------------------------------------------------------------


def _wide_dims(f: int, num_heads: int) -> tuple:
    """(d1, de) of a qkv product of width f = 3C/8 per 1-d irrep."""
    if f % (3 * num_heads):
        raise ValueError(f"wide qkv: width {f} is not 3 x {num_heads} heads")
    d1 = f // (3 * num_heads)
    return d1, 2 * d1


def interleave_wide(y: tuple, num_heads: int) -> torch.Tensor:
    """The flat-E qkv 5-tuple (y_g ``[..., f]`` in (s, h, d1) column order,
    ``[..., 4f] = [e0 | e1]``) -> ``[..., 8f]`` with columns (s, h,
    [a1|a2|b1|b2|e0|e1]): the layout of :func:`linear_d8_qkv_wide`."""
    lead, f = y[0].shape[:-1], y[0].shape[-1]
    d1, de = _wide_dims(f, num_heads)
    sh = 3 * num_heads
    e = y[4].reshape(*lead, 2, sh, de).movedim(-3, -2).flatten(-2)
    return torch.cat([t.reshape(*lead, sh, d1) for t in y[:4]] + [e], dim=-1).flatten(-2)


def uninterleave_wide(y: torch.Tensor, num_heads: int) -> tuple:
    """Inverse of the wide store (pallas_linear.py:uninterleave_wide):
    ``[..., 3C]`` -> ``(y1 [4, ..., 3C/8], yef [..., 3C/2] = [e0 | e1])``."""
    lead, f = y.shape[:-1], y.shape[-1] // 8
    d1, de = _wide_dims(f, num_heads)
    blocks = y.reshape(*lead, 3 * num_heads, 8 * d1)
    ones = [blocks[..., g * d1:(g + 1) * d1].reshape(*lead, f) for g in range(4)]
    e0 = blocks[..., 4 * d1:4 * d1 + de].reshape(*lead, 2 * f)
    e1 = blocks[..., 4 * d1 + de:].reshape(*lead, 2 * f)
    return torch.stack(ones), torch.cat((e0, e1), dim=-1)


def linear_d8_qkv_wide_reference(x1, xef, w1, we, bias: Optional[torch.Tensor],
                                 num_heads: int) -> torch.Tensor:
    """Plain version: the LinearD8 in f32, interleaved, in the input dtype."""
    y = linear_d8_fused_reference(tuple(x1) + (xef,), w1, we, bias)
    return interleave_wide(y, num_heads)


class _LinearD8QKVWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, x1, xef, w1, we, bias):
        ctx.save_for_backward(x1, xef, w1, we, bias)  # pallas_linear.py:_qkv_wide_fwd_rule
        ctx.num_heads = num_heads
        if not on_cuda((x1, xef, w1, we, bias)):
            return linear_d8_qkv_wide_reference(x1, xef, w1, we, bias, num_heads)
        c = w1.shape[1]
        check_kernel_arg(x1, "x1", (4,) + tuple(x1.shape[1:-1]) + (c,))
        linear_d8_qkv_wide.launches += 1
        return lin_d8_wide_launch(tuple(x1) + (xef,), w1, we, bias, num_heads)

    @staticmethod
    def backward(ctx, g):
        x1, xef, w1, we, bias = ctx.saved_tensors
        g1, gef = uninterleave_wide(g, ctx.num_heads)
        dxs, dw1, dwe, dbias = linear_d8_fused_bwd(tuple(x1) + (xef,), w1, we, bias,
                                                   tuple(g1) + (gef,), False)[:4]
        return None, torch.stack(dxs[:4]), dxs[4], dw1, dwe, dbias


def linear_d8_qkv_wide(x1: torch.Tensor, xef: torch.Tensor, w1: torch.Tensor, we: torch.Tensor,
                       bias: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """The block-diagonal qkv LinearD8 stored as ONE interleaved qkv
    (pallas_linear.py:linear_d8_qkv_wide, kernel row 13b): x1 ``[4, M, c]``,
    xef ``[M, 4c]``, w1 ``[4, c, f]``, we ``[2c, 2f]``, A1 bias ``[f]`` ->
    ``[M, 8f]`` whose dh columns of each (s, head) are
    ``[a1|a2|b1|b2|e0|e1]``. CPU tensors take the reference; CUDA tensors
    launch K-lin-d8 with the grouped-column store (csrc/lin_d8.cu). The
    backward is plain torch, as the JAX rule is eager XLA: uninterleave the
    gradient, then :func:`linear_d8_fused_bwd`."""
    return _LinearD8QKVWide.apply(num_heads, x1, xef, w1, we, bias)


linear_d8_qkv_wide.launches = 0


def interleave_wide1d(y: tuple, num_heads: int) -> torch.Tensor:
    """The four 1-d qkv outputs (``[..., f]`` each, (s, h, d1) columns) ->
    ``[..., 4f]`` with columns (s, h, [a1|a2|b1|b2], d1): q1d, k1d, v1d side
    by side, the layout of :func:`linear_d8_wide1d`."""
    lead, f = y[0].shape[:-1], y[0].shape[-1]
    d1, _ = _wide_dims(f, num_heads)
    return torch.stack([t.reshape(*lead, 3 * num_heads, d1) for t in y[:4]], dim=-2).flatten(-3)


def uninterleave_wide1d(dq1d, dk1d, dv1d, num_heads: int) -> tuple:
    """The gradients of q1d, k1d, v1d (``[..., C/2]`` each) -> the four 1-d
    irreps' ``[..., 3C/8]`` gradients in (s, h, d1) order."""
    y = torch.stack((dq1d, dk1d, dv1d), dim=-2)  # [..., 3, C/2]
    lead, w = y.shape[:-2], y.shape[-1]
    d1 = w // (4 * num_heads)
    y = y.reshape(*lead, 3, num_heads, 4, d1)
    return tuple(y[..., g, :].reshape(*lead, 3 * w // 4) for g in range(4))


def linear_d8_wide1d_reference(xs: tuple, w1, we, bias: Optional[torch.Tensor],
                               num_heads: int) -> tuple:
    """Plain version: the LinearD8 in f32, in the input dtype, with the 1-d
    part interleaved."""
    y = linear_d8_fused_reference(xs, w1, we, bias)
    c4 = y[4].shape[-1] // 2
    y1d = interleave_wide1d(y[:4], num_heads)
    w = y1d.shape[-1] // 3
    return (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], y[4][..., :c4], y[4][..., c4:])


class _LinearD8Wide1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, w1, we, bias, *xs):
        ctx.save_for_backward(w1, we, bias, *xs)
        ctx.num_heads = num_heads
        if not on_cuda(xs + (w1, we, bias)):
            return linear_d8_wide1d_reference(xs, w1, we, bias, num_heads)
        _, c, f = w1.shape
        d1, _ = _wide_dims(f, num_heads)
        lead, ldx, ldxe = _row_strides(xs, c, "xs")
        check_kernel_arg(w1, "w1", (4, c, f))
        check_kernel_arg(we, "we", (2 * c, 2 * f))
        check_kernel_arg(bias, "bias", (f,))
        kw = dict(device=xs[0].device, dtype=xs[0].dtype)
        y1d, yef = torch.empty(*lead, 4 * f, **kw), torch.empty(*lead, 4 * f, **kw)
        linear_d8_wide1d.launches += 1
        _lin_d8_call(xs, (ldx, ldxe), w1, we, bias, tuple(y1d[..., g * d1:] for g in range(4)),
                     (yef, yef[..., 2 * f:]), (4 * f, 4 * f), (d1, 4 * d1, 2 * f, 0), "wide1d")
        w = 4 * f // 3
        return (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], yef[..., :2 * f],
                yef[..., 2 * f:])

    @staticmethod
    def backward(ctx, dq1d, dk1d, dv1d, de0, de1):
        w1, we, bias, *xs = ctx.saved_tensors
        g1 = uninterleave_wide1d(dq1d, dk1d, dv1d, ctx.num_heads)
        dxs, dw1, dwe, dbias = linear_d8_fused_bwd(tuple(xs), w1, we, bias,
                                                   g1 + (torch.cat((de0, de1), dim=-1),),
                                                   False)[:4]
        return (None, dw1, dwe, dbias) + tuple(dxs)


def linear_d8_wide1d(xs: tuple, w1: torch.Tensor, we: torch.Tensor,
                     bias: Optional[torch.Tensor], num_heads: int) -> tuple:
    """The qkv LinearD8 of ``AttentionD8(use_wide_qkv)`` (d8_layers.py:
    950-989): the flat-E tuple and the qkv weights -> ``(q1d, k1d, v1d, e0,
    e1)``, the inputs of :func:`~octic_vits_tpu_torch.ops.attention.
    octic_attention_wide1d`: q1d, k1d, v1d ``[..., C/2]`` with columns (h,
    [a1|a2|b1|b2], d1), e0, e1 ``[..., 3C/4]`` the E rows' outputs.

    The JAX layer computes the 1-d part as one dense product with a
    column-permuted block-diagonal weight (three quarters zeros) and the E
    rows as two products, in XLA. Here CUDA tensors launch K-lin-d8 once
    with the wide-1d grouped-column store (csrc/lin_d8.cu): the four 1-d
    outputs land in one ``[..., 3C/2]`` buffer in (s, h, g, d1) order, of
    which q1d, k1d and v1d are column views, and the E output in its usual
    ``[..., 3C/2]`` buffer, of which e0 and e1 are the halves. Half the
    FLOPs of the dense form, and no permuted weight is built. CPU tensors
    take :func:`linear_d8_wide1d_reference`. The backward is plain torch, as
    row 6's: uninterleave the 1-d gradients, then
    :func:`linear_d8_fused_bwd`; only the inputs and the weights are saved."""
    return _LinearD8Wide1d.apply(num_heads, w1, we, bias, *xs)


linear_d8_wide1d.launches = 0
