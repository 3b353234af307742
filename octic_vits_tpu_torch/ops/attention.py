"""Multi-head attention for ViT shapes, reading the producer's natural
layout (counterpart of octic_vits_tpu/ops/pallas_attention.py).

* :func:`standard_attention`: qkv ``[B, N, 3C]`` in (3, H, dh) column
  order -> ``[B, N, C]``; differentiable, its backward is the K-attn-bwd
  kernel (csrc/attention_bwd.cu) on the card.
* :func:`octic_attention`: the six irrep qkv arrays (a1..b2 ``[B, N, 3C/8]``
  in (3, H, d1) order, the E rows e0, e1 ``[B, N, 3C/4]`` in (3, H, de)
  order) -> ``(o1..o4 [B, N, C/8], oe0, oe1 [B, N, C/4])``; differentiable.
  Head h's dh = C/H channels are a1|a2|b1|b2 (d1 = C/(8H) each) and the two
  E rows (de = C/(4H) each); the scale is dh^-0.5, as in the standard case.
* :func:`octic_attention_fused_qkv`: the flat-E tuple after the norm plus
  the block-diagonal qkv weights -> the same outputs; differentiable, its
  backward recomputes the qkv and ends in the K-lin-d8-bwd kernel
  (csrc/lin_d8_bwd.cu) on the card.
* :func:`octic_attention_fused_qkv_packed`: the same op on the packed
  ``[B, N, C]`` container (kernel row 10); the kernels read the container's
  slot views in place and the backward writes one packed gradient.
* :func:`octic_attention_wide1d` (kernel row 12): the same attention with
  each head's 1-d q, k and v as one 4*d1 slice of q1d, k1d, v1d ``[B, N,
  C/2]`` (the wide-1d qkv of ``AttentionD8(use_wide_qkv)``); differentiable.
* :func:`octic_attention_wide` (kernel row 13a): the same attention over one
  interleaved qkv ``[B, N, 3C]`` (each head's q, k and v one dh slice, the
  output of ``linear_d8_qkv_wide``); differentiable.

The forwards run K-attn's streamed TMA + wgmma kernel: the standard layout
through csrc/attention_std.cu, the octic layouts through
csrc/attention_octic.cu (:func:`octic_attention_plan`: route (a) reads the
wide qkv and scatters the output into the six irrep arrays, route (b) loads
the caller's arrays as padded pieces); any N. K-attn-bwd
(csrc/attention_bwd.cu) serves every layout through a gather table (q, k, v),
a cotangent table and a gradient table, with a streamed form where a head
does not fit (:func:`attention_bwd_plan`). K-attn's whole-head core
(csrc/attention.cu) stays for the probes (ops/attention_probe.py).

As in the JAX custom VJPs, each backward saves only the op's inputs (the
qkv arrays; for the fused op the normed input and the qkv weights) and
recomputes the probabilities (and, for the fused op, the qkv).
"""

from __future__ import annotations

from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.d8.group import pack_5_to_flat, unpack_packed_5f
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda, row_stride
from octic_vits_tpu_torch.ops.linear import (
    lin_d8_bwd_launch,
    lin_d8_bwd_reference,
    lin_d8_launch,
    lin_d8_wide_launch,
    linear_d8,
)

MAX_HEAD_DIM = 128  # the kernels' widest instantiation (csrc/attention*.cu)
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on the H100


def _check_attention_shape(n: int, dh: int) -> None:
    """K-attn's whole-head core (csrc/attention.cu, the probes' kernel since
    the octic forwards stream their keys) keeps a whole head's q, k and v^T in
    shared memory (csrc/attention_core.cuh:smem_bytes)."""
    kpad, dhp = -(-n // 16) * 16, -(-dh // 16) * 16
    smem = (2 * kpad * (dhp + 8) + dhp * (kpad + 8)) * 2 + 2 * dhp + 6 * 8
    if dh % 8 or dh > MAX_HEAD_DIM or smem > SMEM_LIMIT:
        raise ValueError(f"attention kernel: N={n}, head dim {dh} unsupported "
                         f"(head dim a multiple of 8 up to {MAX_HEAD_DIM}; "
                         f"{smem} bytes of shared memory needed, {SMEM_LIMIT} available)")


# K-attn's standard forward (csrc/attention_std.cu): 64 query rows a CTA,
# 64-key tiles through a ring of STD_STAGES stages, a head's columns as
# boxes of 64, 32, 16 and 8 (swizzles of 128, 64 and 32 bytes; none for 8)
STD_ROWS, STD_STAGES = 64, 3
STD_BOX_WIDTHS = (64, 32, 16, 8)


def std_attention_boxes(dh: int) -> list:
    """A head's dh columns as TMA boxes, widest first: (offset, width,
    swizzle bytes) each, as csrc/attention_std.cu:box_w. Each k16 step of
    q k^T lies in one box; the 8-column tail is unswizzled."""
    boxes, off = [], 0
    while off < dh:
        w = next(b for b in STD_BOX_WIDTHS if b <= dh - off)
        boxes.append((off, w, 2 * w if w >= 16 else 0))
        off += w
    return boxes


def std_attention_plan(b: int, n: int, heads: int, dh: int) -> dict:
    """The launch plan of K-attn's standard forward: one CTA for each
    (batch, head, 64-query tile); the head's column boxes; the key tiles
    (key n - 1 folded in on the CUDA cores when n - 1 is a multiple of 64);
    and the shared-memory bytes, which the C entry point checks against the
    kernel's: align slack, the q tile and a k and a v tile a stage (64 rows
    x dh bf16 each), a 1 KB zero block beside an 8-column tail, 512 bytes for
    key and value n - 1, barriers."""
    split = n > 1 and (n - 1) % STD_ROWS == 0
    q_tiles, k_tiles = -(-n // STD_ROWS), -(-(n - split) // STD_ROWS)
    tile = STD_ROWS * dh * 2
    zero = STD_ROWS * 16 if dh % 16 else 0
    return {"grid": b * heads * q_tiles, "n": n, "q_tiles": q_tiles, "k_tiles": k_tiles,
            "split": split, "boxes": std_attention_boxes(dh),
            "smem": 1024 + tile * (1 + 2 * STD_STAGES) + zero + 512 + (2 + 3 * STD_STAGES) * 8}


def std_attention_rows(x: int, plan: dict, heads: int) -> list:
    """The (batch row, head, query row)s that CTA ``x`` of the plan writes, as
    csrc/attention_std.cu maps blockIdx.x: a head's query tiles adjacent, so
    they find its keys and values in L2."""
    n = plan["n"]
    bh, qt = divmod(x, plan["q_tiles"])
    b, h = divmod(bh, heads)
    return [(b, h, r) for r in range(qt * STD_ROWS, min(qt * STD_ROWS + STD_ROWS, n))]


OMAP_BYTES = 256  # the octic scatter's column table in shared memory


def _octic_pieces(heads: int, d1: int, layout: str) -> list:
    """(width, the column of head 0's piece in q, k and v, head stride) of
    the six pieces of a head in the caller's layout: ``"octic"`` (row 5, the
    six arrays) or ``"wide1d"`` (row 12, the 1-d part one 4 d1 slice of q1d,
    k1d, v1d); the E rows are in (3, H, de) order in both."""
    de = 2 * d1
    if layout == "octic":
        ones = [(d1, [s * heads * d1 for s in range(3)], d1)] * 4
    elif layout == "wide1d":
        ones = [(d1, [g * d1] * 3, 4 * d1) for g in range(4)]
    else:
        raise ValueError(f"octic attention: layout {layout!r} is not 'octic' or 'wide1d'")
    return ones + [(de, [s * heads * de for s in range(3)], de)] * 2


def octic_attention_plan(b: int, n: int, heads: int, d1: int, route: str,
                         layout: str = "octic") -> dict:
    """The launch plan of the octic forward on K-attn's streamed kernel
    (csrc/attention_octic.cu), any N:

    * route ``"a"`` (the wide qkv, every (s, head) slice ``[a1|a2|b1|b2|e0|
      e1]``): the standard plan at dh = 8 d1 (its boxes, grid and key tiles),
      the shared memory grown by the scatter's column table;
    * route ``"b"`` (the caller's octic arrays in `layout`, see
      :func:`_octic_pieces`): box j = 0..3 the 1-d piece j (d1 columns in a
      16-column box, 32-byte swizzle), j = 4, 5 the E rows (de = 2 d1 columns
      in a box of 16 or 32), so a head takes ``dhp`` = 96 or 128 padded
      columns. A TMA box starts on a 16-byte boundary: box j starts at the
      piece's column rounded down to a multiple of 8, and head h's piece sits
      at ``offsets[j][h]`` in it, which must be the same in q, k and v and
      leave the piece inside the box (``fits``; else the op takes route
      ``"a"``). The boxes' other columns are zeroed in q and in each k tile;
      a 2-stage ring at 128 columns.

    ``boxes`` are (offset, width, swizzle bytes, real columns) in the padded
    head; ``dh`` the real width, whose dh^-0.5 scales the scores."""
    if not 1 <= d1 <= MAX_HEAD_DIM // 8 or n < 1:
        raise ValueError(f"octic attention kernel: N={n}, d1={d1} unsupported "
                         f"(d1 from 1 to {MAX_HEAD_DIM // 8})")
    dh, de = 8 * d1, 2 * d1
    if route == "a":
        plan = std_attention_plan(b, n, heads, dh)
        plan["boxes"] = [(off, w, sw, w) for off, w, sw in plan["boxes"]]
        plan["smem"] += OMAP_BYTES
        plan.update(route="a", dh=dh, dhp=dh, d1=d1, stages=STD_STAGES, fits=True,
                    offsets=[[0] * heads for _ in plan["boxes"]])
        return plan
    if route != "b":
        raise ValueError(f"octic attention: route {route!r} is not 'a' or 'b'")
    pieces = _octic_pieces(heads, d1, layout)
    offsets = [[(cols[0] + h * hs) % 8 for h in range(heads)] for _, cols, hs in pieces]
    need = [max(o) + w for o, (w, _, _) in zip(offsets, pieces)]
    we = 16 if max(need[4:]) <= 16 else 32
    same = all((cols[s] - cols[0]) % 8 == 0 for _, cols, _ in pieces for s in range(3))
    dhp = 64 + 2 * we
    plan = std_attention_plan(b, n, heads, dhp)
    plan["boxes"] = [(16 * j, 16, 32, d1) for j in range(4)] + [
        (64 + r * we, we, 2 * we, de) for r in range(2)]
    # a 2-stage ring at 128 padded columns, so that two CTAs share an SM
    stages = 2 if dhp > 96 else STD_STAGES
    plan["smem"] = (1024 + STD_ROWS * dhp * 2 * (1 + 2 * stages) + 512 + OMAP_BYTES
                    + (2 + 3 * stages) * 8)
    plan.update(route="b", dh=dh, dhp=dhp, d1=d1, stages=stages, offsets=offsets,
                fits=same and max(need[:4]) <= 16 and max(need[4:]) <= we)
    return plan


def _check_std_attention_shape(n: int, dh: int) -> dict:
    """K-attn's standard forward streams the keys, so N is free; the head
    width is a multiple of 8 up to 128 (one instantiation each). Returns the
    plan's per-head part (boxes, shared memory)."""
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM or n < 1:
        raise ValueError(f"standard attention kernel: N={n}, head dim {dh} unsupported "
                         f"(head dim a multiple of 8 up to {MAX_HEAD_DIM})")
    plan = std_attention_plan(1, n, 1, dh)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"standard attention kernel: {plan['smem']} bytes of shared memory "
                         f"needed, {SMEM_LIMIT} available")
    return plan


def _check_attention_bwd_shape(n: int, dh: int) -> None:
    """K-attn-bwd's whole-head form keeps a whole head's q, k, v and dO rows
    and two f32 row statistics in shared memory
    (csrc/attention_bwd_core.cuh:smem_bytes): the guard of that form alone
    (the probes of row 14c run it); the ops go through
    :func:`attention_bwd_plan`, which streams where a head does not fit."""
    kpad, dhp = -(-n // 16) * 16, -(-dh // 16) * 16
    smem = 4 * kpad * (dhp + 8) * 2 + 2 * kpad * 4 + 2 * dhp
    if dh % 8 or dh > MAX_HEAD_DIM or smem > SMEM_LIMIT:
        raise ValueError(f"attention backward kernel: N={n}, head dim {dh} unsupported "
                         f"(head dim a multiple of 8 up to {MAX_HEAD_DIM}; "
                         f"{smem} bytes of shared memory needed, {SMEM_LIMIT} available)")


# K-attn-bwd's streamed form (csrc/attention_bwd_core.cuh): a CTA owns
# BWD_BLOCK query rows (query pass) or key rows (key pass) and streams
# BWD_TILE-row tiles of the other operands through shared memory
BWD_BLOCK, BWD_TILE = 128, 64


def attention_bwd_plan(n: int, dh: int) -> dict:
    """The launch plan of K-attn-bwd: the whole-head form (one CTA a (head,
    batch), every row of the head in shared memory) where it fits, else the
    streamed form (one CTA a (head, batch, block of BWD_BLOCK rows), tiles of
    BWD_TILE rows streamed). Any N; the head width a multiple of 8 up to 128.
    ``blocks`` is the number of row blocks a (head, batch), ``tiles`` the
    tiles a CTA streams in each sweep, ``smem`` the bytes of shared memory."""
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM or n < 1:
        raise ValueError(f"attention backward kernel: N={n}, head dim {dh} unsupported "
                         f"(head dim a multiple of 8 up to {MAX_HEAD_DIM})")
    try:
        _check_attention_bwd_shape(n, dh)
    except ValueError:
        dhp = -(-dh // 16) * 16
        smem = 2 * (BWD_BLOCK + BWD_TILE) * (dhp + 8) * 2 + 2 * BWD_TILE * 4 + 2 * dhp
        return {"streamed": True, "blocks": -(-n // BWD_BLOCK), "tiles": -(-n // BWD_TILE),
                "smem": smem, "n": n}
    kpad, dhp = -(-n // 16) * 16, -(-dh // 16) * 16
    return {"streamed": False, "blocks": 1, "tiles": -(-kpad // BWD_TILE),
            "smem": 4 * kpad * (dhp + 8) * 2 + 2 * kpad * 4 + 2 * dhp, "n": n}


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v ``[B, N, H, dh]`` (f32) -> ``[B, N, H, dh]``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _softmax_attention_bwd(q, k, v, g) -> tuple:
    """(dq, dk, dv) of :func:`_softmax_attention` for the output cotangent g,
    written out as the JAX kernel's `_attn_head_bwd` (f32):
    P = softmax(s Q K^T), dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dP P)) s, dQ = dS K, dK = dS^T Q."""
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k), torch.einsum("bhqk,bqhd->bkhd", ds, q), dv)


# ---------------------------------------------------------------------------
# standard head layout
# ---------------------------------------------------------------------------


def _std_dims(qkv: torch.Tensor, num_heads: int) -> tuple:
    b, n, w = qkv.shape
    c = w // 3
    dh = c // num_heads
    if w != 3 * c or c != num_heads * dh:
        raise ValueError(f"standard_attention: width {w} with {num_heads} heads unsupported")
    return b, n, c, dh


def standard_attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version: f32 math, result in ``qkv.dtype``."""
    b, n, c, dh = _std_dims(qkv, num_heads)
    q, k, v = qkv.float().reshape(b, n, 3, num_heads, dh).unbind(2)
    return _softmax_attention(q, k, v).reshape(b, n, c).to(qkv.dtype)


def standard_attention_bwd_reference(qkv: torch.Tensor, g: torch.Tensor,
                                     num_heads: int) -> torch.Tensor:
    """Plain backward: dqkv ``[B, N, 3C]`` from qkv and the output cotangent
    g ``[B, N, C]``, f32 math, result in ``qkv.dtype``."""
    b, n, c, dh = _std_dims(qkv, num_heads)
    q, k, v = qkv.float().reshape(b, n, 3, num_heads, dh).unbind(2)
    grads = _softmax_attention_bwd(q, k, v, g.float().reshape(b, n, num_heads, dh))
    return torch.stack(grads, dim=2).reshape(b, n, 3 * c).to(qkv.dtype)


def _standard_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if not on_cuda((qkv,)):
        return standard_attention_reference(qkv, num_heads)
    b, n, c, dh = _std_dims(qkv, num_heads)
    _check_std_attention_shape(n, dh)
    check_kernel_arg(qkv, "qkv", (b, n, 3 * c))
    plan = std_attention_plan(b, n, num_heads, dh)
    widths = [w for _, w, _ in plan["boxes"]]
    out = torch.empty(b, n, c, device=qkv.device, dtype=qkv.dtype)
    standard_attention.launches += 1
    kernels.launch("ovt_attention_std", qkv, out, b, n, num_heads, dh, plan["grid"],
                   plan["smem"], len(widths), *(widths + [0] * (4 - len(widths))))
    return out


def standard_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """dqkv from qkv and g. CPU tensors take
    :func:`standard_attention_bwd_reference`; CUDA tensors launch K-attn-bwd
    (csrc/attention_bwd.cu) in its standard head layout."""
    if not on_cuda((qkv, g)):
        return standard_attention_bwd_reference(qkv, g, num_heads)
    b, n, c, dh = _std_dims(qkv, num_heads)
    plan = attention_bwd_plan(n, dh)
    check_kernel_arg(qkv, "qkv", (b, n, 3 * c))
    ld_g = row_stride(g, "g", (b, n, c))
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(2, b, num_heads, n, device=qkv.device, dtype=torch.float32)
    standard_attention_bwd.launches += 1
    kernels.launch("ovt_attention_std_bwd", qkv, g, ld_g, dqkv, stats[0], stats[1],
                   b, n, num_heads, dh, int(plan["streamed"]))
    return dqkv


class _StandardAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _standard_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return standard_attention_bwd(qkv, g, ctx.num_heads), None


def standard_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(dh)) V per (batch, head). CPU tensors take
    :func:`standard_attention_reference`; CUDA tensors launch K-attn's
    standard forward (csrc/attention_std.cu, TMA + wgmma,
    :func:`std_attention_plan`). The gradient goes
    through :func:`standard_attention_bwd`; only qkv is saved."""
    return _StandardAttention.apply(qkv, num_heads)


standard_attention.launches = 0
standard_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# octic head layout
# ---------------------------------------------------------------------------


def _octic_dims(qs: tuple, num_heads: int) -> tuple:
    b, n, w1 = qs[0].shape
    c8 = w1 // 3
    d1 = c8 // num_heads
    if w1 != 3 * c8 or c8 != num_heads * d1:
        raise ValueError(f"octic_attention: qkv width {w1} with {num_heads} heads unsupported")
    return b, n, c8, d1, 2 * d1


def _octic_heads(qs: tuple, num_heads: int, s: int) -> torch.Tensor:
    """Head-assembled q (s=0), k (1) or v (2) ``[B, N, H, dh]`` in f32 from
    the six qkv arrays (a1..b2 ``[B, N, 3C/8]``, e0, e1 ``[B, N, 3C/4]``)."""
    b, n, _, d1, de = _octic_dims(qs, num_heads)
    parts = [t.float().reshape(b, n, 3, num_heads, d1 if i < 4 else de)[:, :, s]
             for i, t in enumerate(qs)]
    return torch.cat(parts, dim=-1)


def _octic_split(o: torch.Tensor, d1: int) -> tuple:
    """``[B, N, H, dh]`` -> the six irrep arrays (4 x ``[B, N, H*d1]``,
    2 x ``[B, N, H*2*d1]``)."""
    b, n = o.shape[:2]
    de = 2 * d1
    widths = [d1] * 4 + [de] * 2
    starts = [g * d1 for g in range(4)] + [4 * d1, 4 * d1 + de]
    return tuple(o[..., s0:s0 + w].reshape(b, n, -1) for s0, w in zip(starts, widths))


def octic_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    """Plain version: f32 math, results in the input dtype."""
    qs = (a1, a2, b1, b2, e0, e1)
    q, k, v = (_octic_heads(qs, num_heads, s) for s in range(3))
    o = _softmax_attention(q, k, v)
    return tuple(t.to(a1.dtype) for t in _octic_split(o, _octic_dims(qs, num_heads)[3]))


def octic_attention_bwd_reference(qs: tuple, gs: tuple, num_heads: int) -> tuple:
    """Plain backward: the gradients of the six qkv arrays `qs` from the six
    output cotangents `gs`, f32 math, results in the input dtype."""
    b, n, _, d1, _ = _octic_dims(qs, num_heads)
    q, k, v = (_octic_heads(qs, num_heads, s) for s in range(3))
    g = torch.cat([t.float().reshape(b, n, num_heads, -1) for t in gs], dim=-1)
    dq, dk, dv = (_octic_split(t, d1) for t in _softmax_attention_bwd(q, k, v, g))
    # gradient of array i: its (3, H, w) columns are (dq, dk, dv)'s pieces
    return tuple(
        torch.stack([t[i].reshape(b, n, num_heads, -1) for t in (dq, dk, dv)], dim=2)
        .reshape(b, n, -1).to(qs[0].dtype)
        for i in range(6)
    )


def _octic_outputs(ref: torch.Tensor, b: int, n: int, c8: int) -> tuple:
    kw = dict(device=ref.device, dtype=ref.dtype)
    return tuple(torch.empty(b, n, c8 if i < 4 else 2 * c8, **kw) for i in range(6))


def _plan_args(plan: dict) -> list:
    widths = [w for _, w, _, _ in plan["boxes"]]
    return [plan["grid"], plan["smem"], len(widths)] + widths + [0] * (4 - len(widths))


def _octic_wide_launch(qkv: torch.Tensor, num_heads: int) -> tuple:
    """Route (a): the octic forward over the wide qkv ``[B, N, 3C]`` (each
    (s, head) slice ``[a1|a2|b1|b2|e0|e1]``) on K-attn's streamed kernel with
    the octic output scatter (csrc/attention_octic.cu). Counts nothing."""
    b, n, c8, d1, de = _wide_qkv_dims(qkv, num_heads)
    check_kernel_arg(qkv, "qkv", (b, n, 24 * c8))
    plan = octic_attention_plan(b, n, num_heads, d1, "a")
    outs = _octic_outputs(qkv, b, n, c8)
    kernels.launch("ovt_attention_std_octic", qkv, *outs, b, n, num_heads, d1, de,
                   *_plan_args(plan))
    return outs


def _tma_ready(t: torch.Tensor, ld: int) -> bool:
    """A TMA map can address the view: 16-byte aligned start and row stride."""
    return t.data_ptr() % 16 == 0 and ld % 8 == 0


def _octic_to_wide(qs: tuple, num_heads: int) -> torch.Tensor:
    """The six octic qkv arrays -> the wide qkv ``[B, N, 3C]`` of route (a)."""
    b, n, c8, d1, de = _octic_dims(qs, num_heads)
    parts = [t.reshape(b, n, 3, num_heads, d1 if i < 4 else de) for i, t in enumerate(qs)]
    return torch.cat(parts, dim=-1).reshape(b, n, 24 * c8)


def _octic_rows_launch(qs: tuple, num_heads: int) -> tuple:
    """One launch of the octic forward over the six octic arrays; each may be
    a column slice of a larger tensor (the E rows of a flat-E qkv). Route (b)
    reads them in place where TMA can address them and the pieces fit their
    boxes (:func:`octic_attention_plan`); otherwise the wide qkv is assembled
    (one copy) and route (a) runs. Counts nothing."""
    b, n, c8, d1, de = _octic_dims(qs, num_heads)
    lds = [row_stride(t, f"qkv[{i}]", (b, n, 3 * (c8 if i < 4 else 2 * c8)))
           for i, t in enumerate(qs)]
    plan = octic_attention_plan(b, n, num_heads, d1, "b", "octic")
    if not (plan["fits"] and all(_tma_ready(t, ld) for t, ld in zip(qs, lds))):
        return _octic_wide_launch(_octic_to_wide(qs, num_heads), num_heads)
    outs = _octic_outputs(qs[0], b, n, c8)
    kernels.launch("ovt_attention_octic_pieces", *qs, *lds, *outs, b, n, num_heads, d1, de,
                   plan["dhp"], plan["grid"], plan["smem"])
    return outs


def _octic_out_row_strides(gs: tuple, b: int, n: int, c8: int) -> list:
    """The row strides of the six octic outputs' cotangents (g1..g4 ``[B, N,
    C/8]``, ge0, ge1 ``[B, N, C/4]``), which may be column slices."""
    return [row_stride(t, f"g[{i}]", (b, n, c8 if i < 4 else 2 * c8)) for i, t in enumerate(gs)]


def _octic_bwd_launch(qs: tuple, gs: tuple, num_heads: int) -> tuple:
    """One K-attn-bwd launch in the octic layout; the qkv arrays and the
    cotangents may be column slices of larger tensors. Counts nothing."""
    b, n, c8, d1, de = _octic_dims(qs, num_heads)
    plan = attention_bwd_plan(n, 8 * d1)
    lq = [row_stride(t, f"qkv[{i}]", (b, n, 3 * (c8 if i < 4 else 2 * c8)))
          for i, t in enumerate(qs)]
    lg = _octic_out_row_strides(gs, b, n, c8)
    kw = dict(device=qs[0].device, dtype=qs[0].dtype)
    grads = tuple(torch.empty(b, n, 3 * (c8 if i < 4 else 2 * c8), **kw) for i in range(6))
    stats = torch.empty(2, b, num_heads, n, device=qs[0].device, dtype=torch.float32)
    kernels.launch("ovt_attention_octic_bwd", *qs, *lq, *gs, *lg, *grads, stats[0], stats[1],
                   b, n, num_heads, d1, de, int(plan["streamed"]))
    return grads


def octic_attention_bwd(qs: tuple, gs: tuple, num_heads: int) -> tuple:
    """The six qkv gradients from the six qkv arrays and the six output
    cotangents. CPU tensors take :func:`octic_attention_bwd_reference`; CUDA
    tensors launch K-attn-bwd (csrc/attention_bwd.cu) in its octic layout."""
    if not on_cuda(tuple(qs) + tuple(gs)):
        return octic_attention_bwd_reference(qs, gs, num_heads)
    octic_attention_bwd.launches += 1
    return _octic_bwd_launch(qs, gs, num_heads)


class _OcticAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, *qs):
        ctx.save_for_backward(*qs)
        ctx.num_heads = num_heads
        if not on_cuda(qs):
            return octic_attention_reference(*qs, num_heads)
        octic_attention.launches += 1
        return _octic_rows_launch(qs, num_heads)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + octic_attention_bwd(ctx.saved_tensors, gs, ctx.num_heads)


def octic_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    """Attention over the LinearD8 qkv outputs in their natural layouts
    (signature of the JAX ``octic_attention``). CPU tensors take
    :func:`octic_attention_reference`; CUDA tensors launch K-attn's
    streamed octic forward (csrc/attention_octic.cu, route (b) of
    :func:`octic_attention_plan`), taking e0 and e1 as column slices of one
    flat-E qkv without a copy. The gradient goes through
    :func:`octic_attention_bwd`; only the six qkv arrays are saved."""
    return _OcticAttention.apply(num_heads, a1, a2, b1, b2, e0, e1)


octic_attention.launches = 0
octic_attention_bwd.launches = 0


def octic_attention_fused_qkv_reference(a1, a2, b1, b2, ef, w1, we,
                                        bias: Optional[torch.Tensor],
                                        num_heads: int) -> tuple:
    """Plain version: the qkv LinearD8 in f32, rounded to the input dtype
    where the kernel stores it, then f32 attention."""
    dt = a1.dtype
    xs = tuple(t.float() for t in (a1, a2, b1, b2, ef))
    qkv = linear_d8(xs, w1.float(), we.float(), None if bias is None else bias.float())
    return octic_attention_reference(*_qkv_rows(tuple(t.to(dt) for t in qkv)), num_heads)


def _fused_qkv_dims(xs: tuple, w1: torch.Tensor, num_heads: int) -> tuple:
    b, n, c8 = xs[0].shape
    if c8 % num_heads:
        raise ValueError(f"octic_attention_fused_qkv: C={8 * c8} with {num_heads} heads unsupported")
    if tuple(w1.shape) != (4, c8, 3 * c8):
        raise ValueError(f"octic_attention_fused_qkv: w1 {tuple(w1.shape)}, "
                         f"expected {(4, c8, 3 * c8)}")
    return b, n, c8


def _qkv_rows(qkv: tuple) -> tuple:
    """The attention kernel's six inputs from a flat-E qkv 5-tuple: e0, e1
    are the column halves of its E tensor (views, no copy)."""
    half = qkv[4].shape[-1] // 2
    return qkv[:4] + (qkv[4][..., :half], qkv[4][..., half:])


def octic_attention_fused_qkv_bwd_reference(xs: tuple, w1, we, bias: Optional[torch.Tensor],
                                            gs: tuple, num_heads: int) -> tuple:
    """Plain backward of the fused op, the eager rule of the JAX package
    (pallas_attention.py:_fused_bwd_rule_eager) in f32: recompute the qkv
    (rounded to the input dtype, where the kernel chain stores it), the
    attention backward (its dqkv rounded likewise), then the LinearD8
    transpose and weight products (:func:`lin_d8_bwd_reference`).

    Returns ``(da1, da2, db1, db2, def, dw1, dwe, dbias or None)``."""
    dt = xs[0].dtype
    qkv = linear_d8(tuple(t.float() for t in xs), w1.float(), we.float(),
                    None if bias is None else bias.float())
    dq = octic_attention_bwd_reference(_qkv_rows(tuple(t.to(dt) for t in qkv)), gs, num_heads)
    dxs, dw1, dwe, dbias = lin_d8_bwd_reference(xs, w1, we, dq[:4], dq[4:], bias)
    return dxs + (dw1, dwe, dbias)


def octic_attention_fused_qkv_bwd(xs: tuple, w1, we, bias: Optional[torch.Tensor], gs: tuple,
                                  num_heads: int) -> tuple:
    """Backward of :func:`octic_attention_fused_qkv` from its residuals (the
    flat-E input tuple `xs` and the qkv weights, what the JAX custom VJP
    saves) and the six output cotangents `gs`.

    CPU tensors take :func:`octic_attention_fused_qkv_bwd_reference`. CUDA
    tensors run the chain K-lin-d8 (recompute the flat-E qkv) -> K-attn-bwd
    in its octic layout (the E rows as column slices) -> K-lin-d8-bwd
    (csrc/lin_d8_bwd.cu: dx, dw1, dwe and dbias, no atomics); the qkv and
    its gradient live only between these launches.

    Returns ``(da1, da2, db1, db2, def, dw1, dwe, dbias or None)``."""
    if not on_cuda(tuple(xs) + (w1, we, bias) + tuple(gs)):
        return octic_attention_fused_qkv_bwd_reference(xs, w1, we, bias, gs, num_heads)
    _, n, c8 = _fused_qkv_dims(xs, w1, num_heads)
    attention_bwd_plan(n, c8 // num_heads * 8)
    octic_attention_fused_qkv_bwd.launches += 1
    qkv = lin_d8_launch(tuple(xs), w1, we, bias, gelu=False)
    dq = _octic_bwd_launch(_qkv_rows(qkv), tuple(gs), num_heads)
    dxs, dw1, dwe, dbias = lin_d8_bwd_launch(tuple(xs), w1, we, dq[:4], dq[4:], bias is not None)
    return dxs + (dw1, dwe, dbias)


class _OcticAttentionFusedQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, w1, we, bias, *xs):
        ctx.save_for_backward(w1, we, bias, *xs)
        ctx.num_heads = num_heads
        if not on_cuda(xs + (w1, we, bias)):
            return octic_attention_fused_qkv_reference(*xs, w1, we, bias, num_heads)
        _fused_qkv_dims(xs, w1, num_heads)
        octic_attention_fused_qkv.launches += 1
        return _octic_wide_launch(lin_d8_wide_launch(xs, w1, we, bias, num_heads), num_heads)

    @staticmethod
    def backward(ctx, *gs):
        w1, we, bias, *xs = ctx.saved_tensors
        grads = octic_attention_fused_qkv_bwd(tuple(xs), w1, we, bias, gs, ctx.num_heads)
        return (None,) + grads[5:] + grads[:5]


def octic_attention_fused_qkv(a1, a2, b1, b2, ef, w1, we, bias: Optional[torch.Tensor],
                              num_heads: int) -> tuple:
    """Flat-E tuple (a1..b2 ``[B, N, C/8]``, ef ``[B, N, C/2]``) and qkv
    weights (w1 ``[4, C/8, 3C/8]``, we ``[C/4, 3C/4]``, A1 bias ``[3C/8]``)
    -> ``(o1, o2, o3, o4 [B, N, C/8], oe0, oe1 [B, N, C/4])``.

    CPU tensors take the reference; CUDA tensors launch K-lin-d8 (the qkv,
    no epilogue, written by its grouped-column store as the wide qkv) and
    then K-attn's streamed octic forward on it (route (a) of
    :func:`octic_attention_plan`). The gradient goes through
    :func:`octic_attention_fused_qkv_bwd`, which recomputes the qkv in the
    tuple layout; only the inputs and the weights are saved, as in the JAX
    custom VJP."""
    return _OcticAttentionFusedQKV.apply(num_heads, w1, we, bias, a1, a2, b1, b2, ef)


octic_attention_fused_qkv.launches = 0
octic_attention_fused_qkv_bwd.launches = 0


# ---------------------------------------------------------------------------
# the packed container (packed_carry): x [B, N, C] = [A1|A2|B1|B2|E row0|E row1]
# ---------------------------------------------------------------------------


def octic_attention_fused_qkv_packed_reference(x, w1, we, bias: Optional[torch.Tensor],
                                               num_heads: int) -> tuple:
    """Plain version: :func:`octic_attention_fused_qkv_reference` on the
    container's flat-E views."""
    return octic_attention_fused_qkv_reference(*unpack_packed_5f(x), w1, we, bias, num_heads)


def octic_attention_fused_qkv_packed_bwd_reference(x, w1, we, bias: Optional[torch.Tensor],
                                                   gs: tuple, num_heads: int) -> tuple:
    """Plain backward of the packed op (pallas_attention.py:
    _fused_packed_bwd_rule): the flat-E rule on the container's views, dx
    packed. Returns ``(dx [B, N, C], dw1, dwe, dbias or None)``."""
    grads = octic_attention_fused_qkv_bwd_reference(unpack_packed_5f(x), w1, we, bias, gs,
                                                    num_heads)
    return (pack_5_to_flat(grads[:5]),) + grads[5:]


def _packed_dims(x: torch.Tensor, w1: torch.Tensor, num_heads: int) -> tuple:
    if x.ndim != 3 or x.shape[-1] % 8:
        raise ValueError(f"octic_attention_fused_qkv_packed: x must be [B, N, C] with C % 8 "
                         f"== 0, got {tuple(x.shape)}")
    return _fused_qkv_dims(unpack_packed_5f(x), w1, num_heads)


def octic_attention_fused_qkv_packed_bwd(x, w1, we, bias: Optional[torch.Tensor], gs: tuple,
                                         num_heads: int) -> tuple:
    """Backward of :func:`octic_attention_fused_qkv_packed` from its
    residuals (the packed input and the qkv weights) and the six output
    cotangents. CPU tensors take the plain version. CUDA tensors run the
    chain of row 2b on the container: K-lin-d8 recomputes the qkv from the
    five slot views in place, K-attn-bwd in the octic layout, and
    K-lin-d8-bwd writes the five dx pieces in place into one packed ``[B, N,
    C]`` gradient (no concatenate).

    Returns ``(dx [B, N, C], dw1, dwe, dbias or None)``."""
    if not on_cuda((x, w1, we, bias) + tuple(gs)):
        return octic_attention_fused_qkv_packed_bwd_reference(x, w1, we, bias, gs, num_heads)
    _, n, c8 = _packed_dims(x, w1, num_heads)
    attention_bwd_plan(n, c8 // num_heads * 8)
    octic_attention_fused_qkv_packed_bwd.launches += 1
    xs = unpack_packed_5f(x)
    qkv = lin_d8_launch(xs, w1, we, bias, gelu=False)
    dq = _octic_bwd_launch(_qkv_rows(qkv), tuple(gs), num_heads)
    dx = torch.empty_like(x)
    _, dw1, dwe, dbias = lin_d8_bwd_launch(xs, w1, we, dq[:4], dq[4:], bias is not None,
                                           out=unpack_packed_5f(dx))
    return dx, dw1, dwe, dbias


class _OcticAttentionFusedQKVPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, x, w1, we, bias):
        ctx.save_for_backward(x, w1, we, bias)  # pallas_attention.py:_fused_packed_fwd_rule
        ctx.num_heads = num_heads
        if not on_cuda((x, w1, we, bias)):
            return octic_attention_fused_qkv_packed_reference(x, w1, we, bias, num_heads)
        _packed_dims(x, w1, num_heads)
        octic_attention_fused_qkv_packed.launches += 1
        qkv = lin_d8_wide_launch(unpack_packed_5f(x), w1, we, bias, num_heads)
        return _octic_wide_launch(qkv, num_heads)

    @staticmethod
    def backward(ctx, *gs):
        x, w1, we, bias = ctx.saved_tensors
        return (None,) + octic_attention_fused_qkv_packed_bwd(x, w1, we, bias, gs, ctx.num_heads)


def octic_attention_fused_qkv_packed(x: torch.Tensor, w1, we, bias: Optional[torch.Tensor],
                                     num_heads: int) -> tuple:
    """Packed ``[B, N, C]`` input and qkv weights (w1 ``[4, C/8, 3C/8]``, we
    ``[C/4, 3C/4]``, A1 bias ``[3C/8]``) -> the six outputs of
    :func:`octic_attention_fused_qkv` (pallas_attention.py:
    octic_attention_fused_qkv_packed, kernel row 10).

    CPU tensors take the plain version; CUDA tensors launch K-lin-d8 on the
    container's slot views, read in place through their row strides, writing
    the wide qkv, then K-attn's streamed octic forward (route (a)). The gradient goes through
    :func:`octic_attention_fused_qkv_packed_bwd`; only the packed input and
    the weights are saved, as in the JAX custom VJP."""
    return _OcticAttentionFusedQKVPacked.apply(num_heads, x, w1, we, bias)


octic_attention_fused_qkv_packed.launches = 0
octic_attention_fused_qkv_packed_bwd.launches = 0


# ---------------------------------------------------------------------------
# the wide layouts: wide-1d (row 12, AttentionD8(use_wide_qkv)) and one
# interleaved qkv (row 13a, after linear_d8_qkv_wide)
# ---------------------------------------------------------------------------


def _wide1d_dims(q1d: torch.Tensor, num_heads: int) -> tuple:
    b, n, w = q1d.shape
    c8 = w // 4
    d1 = c8 // num_heads
    if w != 4 * c8 or c8 != num_heads * d1:
        raise ValueError(f"octic_attention_wide1d: width {w} with {num_heads} heads unsupported")
    return b, n, c8, d1, 2 * d1


def _wide1d_heads(qs: tuple, num_heads: int, s: int) -> torch.Tensor:
    """Head-assembled q (s=0), k (1) or v (2) ``[B, N, H, dh]`` in f32 from
    (q1d, k1d, v1d, e0, e1), as pallas_attention.py:_w1d_operand builds it:
    the head's 4*d1 slice of the s-th 1-d array, then its two E pieces."""
    b, n, _, d1, de = _wide1d_dims(qs[0], num_heads)
    one = qs[s].float().reshape(b, n, num_heads, 4 * d1)
    es = [t.float().reshape(b, n, 3, num_heads, de)[:, :, s] for t in qs[3:]]
    return torch.cat([one] + es, dim=-1)


def octic_attention_wide1d_reference(q1d, k1d, v1d, e0, e1, num_heads: int) -> tuple:
    """Plain version: f32 math, results in the input dtype."""
    qs = (q1d, k1d, v1d, e0, e1)
    d1 = _wide1d_dims(q1d, num_heads)[3]
    o = _softmax_attention(*(_wide1d_heads(qs, num_heads, s) for s in range(3)))
    return tuple(t.to(q1d.dtype) for t in _octic_split(o, d1))


def octic_attention_wide1d_bwd_reference(qs: tuple, gs: tuple, num_heads: int) -> tuple:
    """Plain backward: ``(dq1d, dk1d, dv1d, de0, de1)`` in the layouts of the
    inputs from the five inputs `qs` and the six output cotangents `gs`, f32
    math, results in the input dtype."""
    b, n, _, d1, de = _wide1d_dims(qs[0], num_heads)
    g = torch.cat([t.float().reshape(b, n, num_heads, -1) for t in gs], dim=-1)
    grads = _softmax_attention_bwd(*(_wide1d_heads(qs, num_heads, s) for s in range(3)), g)
    d1d = tuple(t[..., :4 * d1].reshape(b, n, -1) for t in grads)
    des = tuple(torch.stack([t[..., 4 * d1 + r * de:4 * d1 + (r + 1) * de] for t in grads],
                            dim=2).reshape(b, n, -1) for r in range(2))
    return tuple(t.to(qs[0].dtype) for t in d1d + des)


def _wide1d_to_wide(qs: tuple, num_heads: int) -> torch.Tensor:
    """(q1d, k1d, v1d, e0, e1) -> the wide qkv ``[B, N, 3C]`` of route (a)."""
    b, n, c8, d1, de = _wide1d_dims(qs[0], num_heads)
    heads = [torch.cat([qs[s].reshape(b, n, num_heads, 4 * d1)] + [
        t.reshape(b, n, 3, num_heads, de)[:, :, s] for t in qs[3:]], dim=-1) for s in range(3)]
    return torch.stack(heads, dim=2).reshape(b, n, 24 * c8)


def _wide1d_row_strides(qs: tuple, b: int, n: int, c8: int) -> list:
    return [row_stride(t, f"qkv[{i}]", (b, n, 4 * c8 if i < 3 else 6 * c8))
            for i, t in enumerate(qs)]


def octic_attention_wide1d_bwd(qs: tuple, gs: tuple, num_heads: int) -> tuple:
    """``(dq1d, dk1d, dv1d, de0, de1)`` from the five inputs and the six
    output cotangents. CPU tensors take
    :func:`octic_attention_wide1d_bwd_reference`; CUDA tensors launch
    K-attn-bwd (csrc/attention_bwd.cu) in its wide-1d layout, which writes
    the 1-d gradients in the wide layout (one 4*d1 slice per head)."""
    if not on_cuda(tuple(qs) + tuple(gs)):
        return octic_attention_wide1d_bwd_reference(qs, gs, num_heads)
    b, n, c8, d1, de = _wide1d_dims(qs[0], num_heads)
    plan = attention_bwd_plan(n, 8 * d1)
    lq = _wide1d_row_strides(qs, b, n, c8)
    lg = _octic_out_row_strides(gs, b, n, c8)
    kw = dict(device=qs[0].device, dtype=qs[0].dtype)
    grads = tuple(torch.empty(b, n, 4 * c8 if i < 3 else 6 * c8, **kw) for i in range(5))
    stats = torch.empty(2, b, num_heads, n, device=qs[0].device, dtype=torch.float32)
    octic_attention_wide1d_bwd.launches += 1
    kernels.launch("ovt_attention_wide1d_bwd", *qs, *lq, *gs, *lg, *grads, stats[0], stats[1],
                   b, n, num_heads, d1, de, int(plan["streamed"]))
    return grads


class _OcticAttentionWide1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, *qs):
        ctx.save_for_backward(*qs)  # pallas_attention.py:_w1d_fwd_rule
        ctx.num_heads = num_heads
        if not on_cuda(qs):
            return octic_attention_wide1d_reference(*qs, num_heads)
        b, n, c8, d1, de = _wide1d_dims(qs[0], num_heads)
        lds = _wide1d_row_strides(qs, b, n, c8)
        octic_attention_wide1d.launches += 1
        plan = octic_attention_plan(b, n, num_heads, d1, "b", "wide1d")
        if not (plan["fits"] and all(_tma_ready(t, ld) for t, ld in zip(qs, lds))):
            return _octic_wide_launch(_wide1d_to_wide(qs, num_heads), num_heads)
        outs = _octic_outputs(qs[0], b, n, c8)
        kernels.launch("ovt_attention_wide1d_pieces", *qs, *lds, *outs, b, n, num_heads, d1, de,
                       plan["dhp"], plan["grid"], plan["smem"])
        return outs

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + octic_attention_wide1d_bwd(ctx.saved_tensors, gs, ctx.num_heads)


def octic_attention_wide1d(q1d, k1d, v1d, e0, e1, num_heads: int) -> tuple:
    """Wide-1d octic attention (pallas_attention.py:octic_attention_wide1d,
    kernel row 12): q1d, k1d, v1d ``[B, N, C/2]`` with columns (h,
    [a1|a2|b1|b2], d1), e0, e1 ``[B, N, 3C/4]`` in (3, h, de) order, each
    with its own row stride (column views of the wide-1d qkv product) ->
    ``(o1..o4 [B, N, C/8], oe0, oe1 [B, N, C/4])``. CPU tensors take
    :func:`octic_attention_wide1d_reference`; CUDA tensors launch K-attn's
    streamed octic forward (csrc/attention_octic.cu, route (b)): each head's
    1-d part is one 4*d1 slice, loaded as four padded pieces. The gradient goes through :func:`octic_attention_wide1d_bwd`;
    only the five inputs are saved, as in the JAX custom VJP."""
    return _OcticAttentionWide1d.apply(num_heads, q1d, k1d, v1d, e0, e1)


octic_attention_wide1d.launches = 0
octic_attention_wide1d_bwd.launches = 0


def _wide_qkv_dims(qkv: torch.Tensor, num_heads: int) -> tuple:
    b, n, w = qkv.shape
    c8 = w // 24
    d1 = c8 // num_heads
    if w != 24 * c8 or c8 != num_heads * d1:
        raise ValueError(f"octic_attention_wide: width {w} with {num_heads} heads unsupported")
    return b, n, c8, d1, 2 * d1


def octic_attention_wide_reference(qkv: torch.Tensor, num_heads: int) -> tuple:
    """Plain version: f32 math, results in the input dtype."""
    b, n, c8, d1, _ = _wide_qkv_dims(qkv, num_heads)
    q, k, v = qkv.float().reshape(b, n, 3, num_heads, 8 * d1).unbind(2)
    return tuple(t.to(qkv.dtype) for t in _octic_split(_softmax_attention(q, k, v), d1))


def octic_attention_wide_bwd_reference(qkv: torch.Tensor, gs: tuple, num_heads: int):
    """Plain backward: dqkv ``[B, N, 3C]`` in the wide layout from qkv and
    the six output cotangents, f32 math, result in ``qkv.dtype``."""
    b, n, c8, d1, _ = _wide_qkv_dims(qkv, num_heads)
    q, k, v = qkv.float().reshape(b, n, 3, num_heads, 8 * d1).unbind(2)
    g = torch.cat([t.float().reshape(b, n, num_heads, -1) for t in gs], dim=-1)
    grads = _softmax_attention_bwd(q, k, v, g)
    return torch.stack(grads, dim=2).reshape(b, n, 24 * c8).to(qkv.dtype)


def octic_attention_wide_bwd(qkv: torch.Tensor, gs: tuple, num_heads: int) -> torch.Tensor:
    """dqkv from qkv and the six output cotangents. CPU tensors take
    :func:`octic_attention_wide_bwd_reference`; CUDA tensors launch
    K-attn-bwd (csrc/attention_bwd.cu) in its wide layout, which writes one
    dqkv."""
    if not on_cuda((qkv,) + tuple(gs)):
        return octic_attention_wide_bwd_reference(qkv, gs, num_heads)
    b, n, c8, d1, de = _wide_qkv_dims(qkv, num_heads)
    plan = attention_bwd_plan(n, 8 * d1)
    check_kernel_arg(qkv, "qkv", (b, n, 24 * c8))
    lg = _octic_out_row_strides(gs, b, n, c8)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(2, b, num_heads, n, device=qkv.device, dtype=torch.float32)
    octic_attention_wide_bwd.launches += 1
    kernels.launch("ovt_attention_wide_bwd", qkv, *gs, *lg, dqkv, stats[0], stats[1], b, n,
                   num_heads, d1, de, int(plan["streamed"]))
    return dqkv


class _OcticAttentionWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, qkv):
        ctx.save_for_backward(qkv)  # pallas_attention.py:_octic_wide_fwd_rule
        ctx.num_heads = num_heads
        if not on_cuda((qkv,)):
            return octic_attention_wide_reference(qkv, num_heads)
        octic_attention_wide.launches += 1
        return _octic_wide_launch(qkv, num_heads)

    @staticmethod
    def backward(ctx, *gs):
        (qkv,) = ctx.saved_tensors
        return None, octic_attention_wide_bwd(qkv, gs, ctx.num_heads)


def octic_attention_wide(qkv: torch.Tensor, num_heads: int) -> tuple:
    """Octic attention from one interleaved qkv ``[B, N, 3C]`` whose dh
    columns of each (s, head) are ``[a1|a2|b1|b2|e0|e1]``
    (pallas_attention.py:octic_attention_wide, kernel row 13a; the output of
    :func:`~octic_vits_tpu_torch.ops.linear.linear_d8_qkv_wide`) -> the six
    irrep outputs of :func:`octic_attention`. CPU tensors take the
    reference; CUDA tensors launch K-attn's streamed octic forward
    (csrc/attention_octic.cu, route (a): the standard layout's loads and the
    octic scatter). The gradient goes
    through :func:`octic_attention_wide_bwd`; only qkv is saved."""
    return _OcticAttentionWide.apply(num_heads, qkv)


octic_attention_wide.launches = 0
octic_attention_wide_bwd.launches = 0
