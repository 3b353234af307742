"""Probes of kernel row 14c: the attention-backward, head-group and fused-qkv
kernels of ``scripts/r3_attn_bwd_ablate.py``, each a variant of the shipped
attention that differs from it in one named part.

===================================  ==========================================
:func:`octic_attention_bwd_widestore`  ``k_octic_bwd_widestore`` (call :795)
:func:`octic_attention_bwd_wideg`      ``k_octic_bwd_wideg`` (call :812)
:func:`std_pack_attention`             ``k_std_pack_fwd``, P = 2, 4 (call :839)
:func:`std_pack_attention_bwd`         ``k_std_pack_bwd``, P = 2, 4 (call :865)
:func:`std_maskpair_attention`         ``k_std_maskpair_fwd`` (call :883)
:func:`std_maskpair_attention_bwd`     ``k_std_maskpair_bwd`` (call :895)
:func:`octic_group_attention`          ``k_octic_maskpair_fwd`` (G = 2),
                                       ``k_octic_maskquad_fwd`` (G = 4) (call :926)
:func:`octic_group_attention_bwd`      ``k_octic_maskpair_bwd`` (G = 2, call :926),
                                       ``k_octic_maskquad_bwd`` (G = 4, call :779)
:func:`octic_qkv_attention`            ``k_octic_qkvattn_fwd`` (call :735)
:func:`octic_qkv_attention_proj`       ``k_octic_qkvattnproj_fwd`` (call :693)
===================================  ==========================================

The script's other four sites run kernels the port already has:
``k_std_fwd_loop`` (:853) is :func:`~octic_vits_tpu_torch.ops.standard_attention`,
``_std_bwd_kernel`` (:823) :func:`~octic_vits_tpu_torch.ops.standard_attention_bwd`,
the default ``_octic_fwd_kernel`` (:926) and ``_octic_bwd_kernel`` (:779)
:func:`~octic_vits_tpu_torch.ops.octic_attention` and its backward.

:func:`attention_bwd_sync` is no probe of the script: it is the yardstick of
K-attn-bwd's TMA + wgmma redesign, the mma.sync core the model paths ran
before it, in the standard and octic layouts with its form forced.

The kernels: the wide-store and wide-g backwards are K-attn-bwd's mma.sync
core (csrc/attention_bwd_core.cuh) with their own tables (csrc/attention_bwd_probe.cu);
the group ops are K-attn-group (csrc/attention_group.cu): G heads a CTA, the
keys in 64-row tiles under an online softmax, each group's rows moved as one
G-wide slice; the fused ops are K-qkv-attn (csrc/qkv_attention.cu), one CTA a
(head, image) that forms its head's q, k, v from the block-diagonal weights
and runs K-attn's chain on them, the proj through a cluster of the image's H
CTAs. The group ops take every head count the script's kernels handle and
raise ``ValueError`` on the ones they get wrong: a head count that G does not
divide (the script's pair loops leave the last head of an odd count unwritten,
its quads read past the heads), and, for the fused ops, an odd count.

Each ``<op>_reference`` has the JAX kernel's numerics: p = exp(s - m) in the
input dtype (bf16: the exp of the bf16 difference), its f32 row sum folded
into the output, as ``pallas_attention.py:_probs_unnormalized``; the backward
as ``_attn_head_bwd``'s bf16 path (the normaliser folded into g and into
dS, dS rounded to the input dtype); in f32 the same formulas, which are the
exact softmax. The pack ops shift each row by ONE max over the group's P heads
(``k_std_pack_fwd`` :143-145, ``k_std_pack_bwd`` :204): a valid shift for
each head's softmax, but not the head's own, so in bf16 the unnormalised
probabilities differ from the per-head ones, and a head whose scores lie far
below its group's max can underflow. The references reproduce that max; the
kernels keep it too, in K-attn's f32 online softmax (P rounded to bf16 only
as the P.V operand). The script's pack backward fails whenever N < dh (it cuts
each head's normaliser to dh columns of an [N, N] broadcast); the port's does
not. The qkv and proj products are rounded to the input dtype before their
bias is added, as the script's ``mm`` does. CPU tensors take the reference;
CUDA tensors launch the kernel, and a launch that fails raises. The probes run
on no model path: their counters move only when a probe is called.
"""

from __future__ import annotations

from typing import Optional

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda, row_stride
from octic_vits_tpu_torch.ops.attention import (
    SMEM_LIMIT,
    _check_attention_bwd_shape,
    _octic_out_row_strides,
    _std_dims,
    attention_bwd_plan,
    octic_attention_bwd_reference,
    standard_attention_bwd_reference,
)
from octic_vits_tpu_torch.ops.attention_probe import (
    _attn_head_bwd,
    _attn_unnormalized,
    _merge,
    _octic_dims,
    _octic_heads,
    _octic_scatter,
    _std_heads,
)

GROUP_HEAD_DIMS = (80,)  # the head dim csrc/attention_group.cu and qkv_attention.cu build
GROUPS = (1, 2, 4)
WARPS, KEY_TILE = 8, 64  # csrc/attention_group.cu


def group_smem_bytes(group: int, dh: int = 80) -> int:
    """Shared memory of the largest K-attn-group kernel at G heads a CTA
    (csrc/attention_group.cu: the dq pass's q, dO rows and k, v tiles)."""
    sw, rows = group * dh + 8, 16 * WARPS // group
    return (2 * rows + 2 * KEY_TILE) * sw * 2 + WARPS * 16 * 4


def qkv_smem_bytes(n: int, c8: int, proj: bool) -> int:
    """Shared memory of one K-qkv-attn CTA (csrc/qkv_attention.cu:smem_bytes)."""
    kpad, dh = -(-n // 16) * 16, 80
    w = 64 * (2 * c8 + 8)
    if proj:
        w = max(w, 4 * 16 * (c8 + 8) + 32 * (2 * c8 + 8))
    return (2 * kpad * (dh + 8) + dh * (kpad + 8) + w) * 2


def _check_groups(num_heads: int, group: int, name: str) -> None:
    if group not in GROUPS:
        raise ValueError(f"{name}: group {group} is not one of {GROUPS}")
    if num_heads % group:
        raise ValueError(f"{name}: {num_heads} heads do not divide into groups of {group}")


def _check_group_kernel(dh: int, group: int, name: str) -> None:
    smem = group_smem_bytes(group, dh)
    if dh not in GROUP_HEAD_DIMS or smem > SMEM_LIMIT:
        raise ValueError(f"{name}: head dim {dh} unsupported (head dims {GROUP_HEAD_DIMS}; "
                         f"{smem} bytes of shared memory needed, {SMEM_LIMIT} available)")


# ---------------------------------------------------------------------------
# the JAX kernels' per-head arithmetic (ops/attention_probe.py), batched over
# [B, H, N, d]: the forward (p v) / sum p, the backward _attn_head_bwd's bf16
# path, each with the pack kernels' shared max where group > 1
# ---------------------------------------------------------------------------


def _attn(q, k, v, group=1):
    return _attn_unnormalized(q, k, v, q.shape[-1] ** -0.5, group)


def _std_grads(dq, dk, dv, dtype):
    """(dq, dk, dv) [B, H, N, dh] -> dqkv [B, N, 3C] in (3, H, dh) order."""
    b, h, n, d = dq.shape
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(b, n, 3 * h * d).to(
        dtype)


def _octic_grads(dq, dk, dv, d1, dtype):
    """(dq, dk, dv) [B, H, N, dh] -> the six octic qkv gradients, array i in
    (3, H, w_i) column order."""
    starts = [0, d1, 2 * d1, 3 * d1, 4 * d1, 6 * d1]
    widths = [d1] * 4 + [2 * d1] * 2
    b, h, n, _ = dq.shape
    return tuple(
        torch.stack([t[..., s0:s0 + w] for t in (dq, dk, dv)], dim=2).permute(0, 3, 2, 1, 4)
        .reshape(b, n, 3 * h * w).to(dtype) for s0, w in zip(starts, widths))


def _octic_g(gs, num_heads):
    """The six octic output cotangents -> g [B, H, N, dh]."""
    b, n = gs[0].shape[:2]
    return torch.cat([t.reshape(b, n, num_heads, -1) for t in gs], dim=-1).transpose(1, 2)


def _empty(t, *shape, dtype=None):
    return torch.empty(*shape, device=t.device, dtype=dtype or t.dtype)


# ---------------------------------------------------------------------------
# the wide-store and wide-g backwards (K-attn-bwd with its own tables)
# ---------------------------------------------------------------------------


def octic_attention_bwd_widestore_reference(qs: tuple, gs: tuple, num_heads: int):
    q, k, v = _octic_heads(qs, num_heads)
    dq, dk, dv = _attn_head_bwd(q, k, v, _octic_g(gs, num_heads))
    return _std_grads(dq, dk, dv, qs[0].dtype)


def octic_attention_bwd_wideg_reference(qs: tuple, gw, num_heads: int) -> tuple:
    b, n, c8, d1, _, dh = _octic_dims(qs, num_heads)
    q, k, v = _octic_heads(qs, num_heads)
    g = gw.reshape(b, n, num_heads, dh).transpose(1, 2)
    return _octic_grads(*_attn_head_bwd(q, k, v, g), d1, qs[0].dtype)


def _octic_bwd_rows(qs, num_heads):
    b, n, c8, d1, de, dh = _octic_dims(qs, num_heads)
    _check_attention_bwd_shape(n, dh)
    lq = [row_stride(t, f"qkv[{i}]", (b, n, 3 * (c8 if i < 4 else 2 * c8)))
          for i, t in enumerate(qs)]
    stats = torch.empty(2, b, num_heads, n, device=qs[0].device, dtype=torch.float32)
    return b, n, c8, d1, de, dh, lq, stats


def octic_attention_bwd_widestore(qs: tuple, gs: tuple, num_heads: int) -> torch.Tensor:
    """The octic attention's backward (the six qkv arrays `qs`, the six output
    cotangents `gs`) with dq, dk, dv stored per (s, head) contiguously into
    one dwide ``[B, N, 3C]`` (head h of s at column (s H + h) dh, its channels
    a1|a2|b1|b2|e0|e1: row 13's qkv layout) instead of being scattered into
    the six arrays: K-attn-bwd with a one-segment gradient table. Its time
    less row 5's backward is the scatter tax."""
    if not on_cuda(tuple(qs) + tuple(gs)):
        return octic_attention_bwd_widestore_reference(qs, gs, num_heads)
    b, n, c8, d1, de, dh, lq, stats = _octic_bwd_rows(qs, num_heads)
    lg = [row_stride(t, f"g[{i}]", (b, n, c8 if i < 4 else 2 * c8)) for i, t in enumerate(gs)]
    dwide = _empty(qs[0], b, n, 24 * c8)
    octic_attention_bwd_widestore.launches += 1
    kernels.launch("ovt_attention_octic_bwd_widestore", *qs, *lq, *gs, *lg, dwide, stats[0],
                   stats[1], b, n, num_heads, d1, de)
    return dwide


def octic_attention_bwd_wideg(qs: tuple, gw: torch.Tensor, num_heads: int) -> tuple:
    """The octic attention's backward with the cotangent pre-assembled: gw
    ``[B, N, C]``, head h's dh channels at column h dh in the order
    a1|a2|b1|b2|e0|e1 -> the six qkv gradients: K-attn-bwd with a
    one-segment cotangent table. Its time less row 5's backward is the
    g-assembly tax."""
    if not on_cuda(tuple(qs) + (gw,)):
        return octic_attention_bwd_wideg_reference(qs, gw, num_heads)
    b, n, c8, d1, de, dh, lq, stats = _octic_bwd_rows(qs, num_heads)
    ld_g = row_stride(gw, "gw", (b, n, 8 * c8))
    grads = tuple(_empty(qs[0], b, n, 3 * c8 if i < 4 else 6 * c8) for i in range(6))
    octic_attention_bwd_wideg.launches += 1
    kernels.launch("ovt_attention_octic_bwd_wideg", *qs, *lq, gw, ld_g, *grads, stats[0],
                   stats[1], b, n, num_heads, d1, de)
    return grads


# ---------------------------------------------------------------------------
# head groups (K-attn-group): the standard qkv [B, N, 3C] and the octic arrays
# ---------------------------------------------------------------------------


def _std_group_dims(qkv, num_heads, group, name):
    b, n, w = qkv.shape
    c = w // 3
    dh = c // num_heads
    if w != 3 * c or c != num_heads * dh:
        raise ValueError(f"{name}: width {w} with {num_heads} heads unsupported")
    _check_groups(num_heads, group, name)
    return b, n, c, dh


def _std_group(op, qkv, num_heads, group, masked, shared, *extra):
    b, n, c, dh = _std_group_dims(qkv, num_heads, group, op.__name__)
    if not on_cuda((qkv,)):
        return op.reference(qkv, num_heads, *extra)
    _check_group_kernel(dh, group, op.__name__)
    check_kernel_arg(qkv, "qkv", (b, n, 3 * c))
    out = _empty(qkv, b, n, c)
    op.launches += 1
    kernels.launch("ovt_attention_group_std", qkv, out, b, n, num_heads, group, int(masked),
                   int(shared))
    return out


def _std_group_bwd(op, qkv, g, num_heads, group, masked, shared, *extra):
    b, n, c, dh = _std_group_dims(qkv, num_heads, group, op.__name__)
    if not on_cuda((qkv, g)):
        return op.reference(qkv, g, num_heads, *extra)
    _check_group_kernel(dh, group, op.__name__)
    check_kernel_arg(qkv, "qkv", (b, n, 3 * c))
    check_kernel_arg(g, "g", (b, n, c))
    dqkv = torch.empty_like(qkv)
    stats = _empty(qkv, 2, b, num_heads, n, dtype=torch.float32)
    op.launches += 1
    kernels.launch("ovt_attention_group_std_bwd", qkv, g, dqkv, stats[0], stats[1], b, n,
                   num_heads, group, int(masked), int(shared))
    return dqkv


def _std_group_ref(qkv, num_heads, group, shift_group, name):
    _std_group_dims(qkv, num_heads, group, name)
    q, k, v = _std_heads(qkv, num_heads)
    return _merge(_attn(q, k, v, shift_group), qkv.dtype)


def _std_group_bwd_ref(qkv, g, num_heads, group, shift_group, name):
    b, n, _, dh = _std_group_dims(qkv, num_heads, group, name)
    q, k, v = _std_heads(qkv, num_heads)
    gh = g.reshape(b, n, num_heads, dh).transpose(1, 2)
    return _std_grads(*_attn_head_bwd(q, k, v, gh, shift_group), qkv.dtype)


def std_pack_attention_reference(qkv, num_heads: int, group: int = 2):
    return _std_group_ref(qkv, num_heads, group, group, "std_pack_attention")


def std_pack_attention_bwd_reference(qkv, g, num_heads: int, group: int = 2):
    return _std_group_bwd_ref(qkv, g, num_heads, group, group, "std_pack_attention_bwd")


def std_maskpair_attention_reference(qkv, num_heads: int):
    return _std_group_ref(qkv, num_heads, 2, 1, "std_maskpair_attention")


def std_maskpair_attention_bwd_reference(qkv, g, num_heads: int):
    return _std_group_bwd_ref(qkv, g, num_heads, 2, 1, "std_maskpair_attention_bwd")


def std_pack_attention(qkv: torch.Tensor, num_heads: int, group: int = 2) -> torch.Tensor:
    """Standard attention (qkv ``[B, N, 3C]`` in (3, H, dh) order -> ``[B, N,
    C]``) with `group` heads a CTA (k_std_pack_fwd, P = group), ONE row max
    shared by the group's heads, each group's rows loaded and stored as one
    group*dh-wide slice; each head's scores over its own dh channels (the pack
    kernels skip the off-diagonal blocks). group = 1 is K-attn-group's baseline,
    one head a CTA."""
    return _std_group(std_pack_attention, qkv, num_heads, group, False, True, group)


def std_pack_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                           group: int = 2) -> torch.Tensor:
    """dqkv ``[B, N, 3C]`` of :func:`std_pack_attention` for the cotangent g
    ``[B, N, C]`` (k_std_pack_bwd): the shared max in the query pass, any N."""
    return _std_group_bwd(std_pack_attention_bwd, qkv, g, num_heads, group, False, True, group)


def std_maskpair_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Standard attention with head pairs (k_std_maskpair_fwd): each pair's
    rows loaded and stored 2 dh wide, each head's scores q_pair . (k_pair o
    mask_h)^T and its P.V over the pair's whole 2 dh columns, the zero terms
    computed, as the TPU kernel does; each head's own row max. Even H."""
    return _std_group(std_maskpair_attention, qkv, num_heads, 2, True, False)


def std_maskpair_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """dqkv of :func:`std_maskpair_attention` (k_std_maskpair_bwd): every
    product of the backward over the pair's 2 dh channels, masked. Even H."""
    return _std_group_bwd(std_maskpair_attention_bwd, qkv, g, num_heads, 2, True, False)


def _octic_group_checks(arrs, num_heads, group, name):
    dims = _octic_dims(arrs, num_heads)
    _check_groups(num_heads, group, name)
    return dims


def octic_group_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int,
                                    group: int = 2) -> tuple:
    arrs = (a1, a2, b1, b2, e0, e1)
    d1 = _octic_group_checks(arrs, num_heads, group, "octic_group_attention")[3]
    q, k, v = _octic_heads(arrs, num_heads)
    return _octic_scatter(_attn(q, k, v), d1, a1.dtype)


def octic_group_attention_bwd_reference(qs: tuple, gs: tuple, num_heads: int,
                                        group: int = 2) -> tuple:
    d1 = _octic_group_checks(qs, num_heads, group, "octic_group_attention_bwd")[3]
    q, k, v = _octic_heads(qs, num_heads)
    return _octic_grads(*_attn_head_bwd(q, k, v, _octic_g(gs, num_heads)), d1, qs[0].dtype)


def octic_group_attention(a1, a2, b1, b2, e0, e1, num_heads: int, group: int = 2) -> tuple:
    """The octic attention (the six qkv arrays, contiguous) -> 4 x ``[B, N,
    C/8]``, 2 x ``[B, N, C/4]`` with `group` heads a CTA: each group's piece
    of each array loaded and stored as one group-wide slice (8-byte loads for
    a pair, 16-byte for a quad at ViT-H), each head's scores and P.V over the
    group's whole contraction with the other heads' channels masked
    (k_octic_maskpair_fwd at 2, k_octic_maskquad_fwd at 4; 1 is the
    family's baseline). H divisible by `group`."""
    arrs = (a1, a2, b1, b2, e0, e1)
    b, n, c8, d1, de, dh = _octic_group_checks(arrs, num_heads, group, "octic_group_attention")
    if not on_cuda(arrs):
        return octic_group_attention_reference(*arrs, num_heads, group)
    _check_group_kernel(dh, group, "octic_group_attention")
    for i, t in enumerate(arrs):
        check_kernel_arg(t, f"qkv[{i}]", (b, n, 3 * c8 if i < 4 else 6 * c8))
    outs = tuple(_empty(a1, b, n, c8 if i < 4 else 2 * c8) for i in range(6))
    octic_group_attention.launches += 1
    kernels.launch("ovt_attention_group_octic", *arrs, *outs, b, n, num_heads, d1, de, group,
                   int(group > 1), 0)
    return outs


def octic_group_attention_bwd(qs: tuple, gs: tuple, num_heads: int, group: int = 2) -> tuple:
    """The six qkv gradients of :func:`octic_group_attention` from the six
    output cotangents (k_octic_maskpair_bwd at 2, k_octic_maskquad_bwd at
    4): every product over the group's contraction, masked. H divisible by
    `group`."""
    b, n, c8, d1, de, dh = _octic_group_checks(qs, num_heads, group, "octic_group_attention_bwd")
    if not on_cuda(tuple(qs) + tuple(gs)):
        return octic_group_attention_bwd_reference(qs, gs, num_heads, group)
    _check_group_kernel(dh, group, "octic_group_attention_bwd")
    for i, t in enumerate(qs):
        check_kernel_arg(t, f"qkv[{i}]", (b, n, 3 * c8 if i < 4 else 6 * c8))
    for i, t in enumerate(gs):
        check_kernel_arg(t, f"g[{i}]", (b, n, c8 if i < 4 else 2 * c8))
    grads = tuple(torch.empty_like(t) for t in qs)
    stats = _empty(qs[0], 2, b, num_heads, n, dtype=torch.float32)
    octic_group_attention_bwd.launches += 1
    kernels.launch("ovt_attention_group_octic_bwd", *qs, *gs, *grads, stats[0], stats[1], b, n,
                   num_heads, d1, de, group, int(group > 1), 0)
    return grads


# ---------------------------------------------------------------------------
# the fused qkv + attention (+ proj): K-qkv-attn
# ---------------------------------------------------------------------------


def _qkv_dims(xs, w1, we, num_heads, name):
    b, n, c8 = xs[0].shape
    if (c8 % num_heads or num_heads % 2 or any(tuple(t.shape) != (b, n, c8) for t in xs[:4])
            or tuple(xs[4].shape) != (b, n, 4 * c8) or tuple(w1.shape) != (4, c8, 3 * c8)
            or tuple(we.shape) != (2 * c8, 6 * c8)):
        raise ValueError(f"{name}: inputs {[tuple(t.shape) for t in xs]}, w1 {tuple(w1.shape)}, "
                         f"we {tuple(we.shape)} with {num_heads} heads unsupported (the "
                         "script's pairs of heads: an even head count dividing C/8)")
    return b, n, c8


def _round_bias(y, bias, dt):
    """The script's ``mm(x, w) + bias``: the product rounded to `dt`, then
    the bias (rounded to `dt`) added in `dt`."""
    y = y.to(dt)
    return y if bias is None else (y.float() + bias.to(dt).float()).to(dt)


def _qkv(xs, w1, we, bias):
    """k_octic_qkvattn_fwd's qkv: the six arrays a1..b2 [B, N, 3C/8], e0, e1
    [B, N, 3C/4]."""
    dt, c8 = xs[0].dtype, xs[0].shape[-1]
    w1, we = w1.float(), we.float()
    ones = [_round_bias(x.float() @ w1[i], bias if i == 0 else None, dt)
            for i, x in enumerate(xs[:4])]
    ef = xs[4].float()
    return tuple(ones) + tuple((ef[..., r * 2 * c8:(r + 1) * 2 * c8] @ we).to(dt) for r in range(2))


def _check_qkv_kernel(n, c8, num_heads, proj, name):
    smem = qkv_smem_bytes(n, c8, proj)
    if c8 != 10 * num_heads or c8 % 16 or smem > SMEM_LIMIT or (proj and num_heads > 16):
        raise ValueError(f"{name}: C/8={c8}, N={n} with {num_heads} heads unsupported by the "
                         f"kernel (head dims {GROUP_HEAD_DIMS}, C/8 a multiple of 16, "
                         f"{'at most 16 heads, ' if proj else ''}{smem} bytes of shared memory "
                         f"needed, {SMEM_LIMIT} available)")


def octic_qkv_attention_reference(a1, a2, b1, b2, ef, w1, we, bias: Optional[torch.Tensor],
                                  num_heads: int) -> tuple:
    xs = (a1, a2, b1, b2, ef)
    _qkv_dims(xs, w1, we, num_heads, "octic_qkv_attention")
    qkv = _qkv(xs, w1, we, bias)
    q, k, v = _octic_heads(qkv, num_heads)
    return _octic_scatter(_attn(q, k, v), a1.shape[-1] // num_heads, a1.dtype)


def octic_qkv_attention_proj_reference(a1, a2, b1, b2, ef, w1, we,
                                       bias: Optional[torch.Tensor], w1p, wep,
                                       biasp: Optional[torch.Tensor], num_heads: int) -> tuple:
    dt = a1.dtype
    full = octic_qkv_attention_reference(a1, a2, b1, b2, ef, w1, we, bias, num_heads)
    w1p, wep = w1p.float(), wep.float()
    ones = [_round_bias(full[i].float() @ w1p[i], biasp if i == 0 else None, dt) for i in range(4)]
    e = [(full[4 + r].float() @ wep).to(dt) for r in range(2)]
    return tuple(ones) + (torch.cat(e, dim=-1),)


def _qkv_launch_args(xs, w1, we, bias, num_heads, proj, name):
    b, n, c8 = _qkv_dims(xs, w1, we, num_heads, name)
    _check_qkv_kernel(n, c8, num_heads, proj, name)
    for i, t in enumerate(xs):
        check_kernel_arg(t, f"x[{i}]", (b, n, c8 if i < 4 else 4 * c8))
    check_kernel_arg(w1, "w1", (4, c8, 3 * c8))
    check_kernel_arg(we, "we", (2 * c8, 6 * c8))
    check_kernel_arg(bias, "bias", (3 * c8,))
    return b, n, c8


def octic_qkv_attention(a1, a2, b1, b2, ef, w1, we, bias: Optional[torch.Tensor],
                        num_heads: int) -> tuple:
    """The block-diagonal qkv LinearD8 of the flat-E tuple (a1..b2 ``[B, N,
    C/8]``, ef ``[B, N, C/2]``; w1 ``[4, C/8, 3C/8]``, we ``[C/4, 3C/4]``,
    bias ``[3C/8]`` or None on the A1 output) and the octic attention of its
    result in one launch (k_octic_qkvattn_fwd: row 2's function, the qkv
    never in device memory) -> 4 x ``[B, N, C/8]``, 2 x ``[B, N, C/4]``.
    Even H (the script's pairs); the kernel takes d1 = C/(8H) = 10."""
    xs = (a1, a2, b1, b2, ef)
    if not on_cuda(xs + (w1, we, bias)):
        return octic_qkv_attention_reference(*xs, w1, we, bias, num_heads)
    b, n, c8 = _qkv_launch_args(xs, w1, we, bias, num_heads, False, "octic_qkv_attention")
    outs = tuple(_empty(a1, b, n, c8 if i < 4 else 2 * c8) for i in range(6))
    octic_qkv_attention.launches += 1
    kernels.launch("ovt_qkv_attention", *xs, w1, we, bias, *outs, b, n, num_heads, c8)
    return outs


def octic_qkv_attention_proj(a1, a2, b1, b2, ef, w1, we, bias: Optional[torch.Tensor], w1p, wep,
                             biasp: Optional[torch.Tensor], num_heads: int) -> tuple:
    """:func:`octic_qkv_attention` followed by the proj LinearD8 (w1p ``[4,
    C/8, C/8]``, wep ``[C/4, C/4]``, biasp ``[C/8]`` or None; the attention
    output rounded to the input dtype first) in one launch
    (k_octic_qkvattnproj_fwd: neither the qkv nor the attention output in
    device memory) -> 4 x ``[B, N, C/8]``, the flat-E ``[B, N, C/2]``. On the
    card each image's H CTAs form one cluster (H <= 16) and exchange the
    heads' outputs through distributed shared memory."""
    xs = (a1, a2, b1, b2, ef)
    if not on_cuda(xs + (w1, we, bias, w1p, wep, biasp)):
        return octic_qkv_attention_proj_reference(*xs, w1, we, bias, w1p, wep, biasp, num_heads)
    b, n, c8 = _qkv_launch_args(xs, w1, we, bias, num_heads, True, "octic_qkv_attention_proj")
    check_kernel_arg(w1p, "w1p", (4, c8, c8))
    check_kernel_arg(wep, "wep", (2 * c8, 2 * c8))
    check_kernel_arg(biasp, "biasp", (c8,))
    outs = tuple(_empty(a1, b, n, c8) for _ in range(4)) + (_empty(a1, b, n, 4 * c8),)
    octic_qkv_attention_proj.launches += 1
    kernels.launch("ovt_qkv_attention_proj", *xs, w1, we, bias, w1p, wep, biasp, *outs, b, n,
                   num_heads, c8)
    return outs


#: the probe ops of kernel row 14c (scripts/r3_attn_bwd_ablate.py), in order
PROBE_OPS_14C = (octic_attention_bwd_widestore, octic_attention_bwd_wideg, std_pack_attention,
                 std_pack_attention_bwd, std_maskpair_attention, std_maskpair_attention_bwd,
                 octic_group_attention, octic_group_attention_bwd, octic_qkv_attention,
                 octic_qkv_attention_proj)
for _op in PROBE_OPS_14C:
    _op.launches = 0
    _op.reference = globals()[f"{_op.__name__}_reference"]
del _op


# ---------------------------------------------------------------------------
# the yardstick of K-attn-bwd's redesign: the mma.sync core the model paths
# ran before it (csrc/attention_bwd_core.cuh, entries in attention_bwd_probe.cu)
# ---------------------------------------------------------------------------


def attention_bwd_sync_reference(qkv, g, num_heads: int, streamed: Optional[bool] = None):
    if isinstance(qkv, torch.Tensor):
        return standard_attention_bwd_reference(qkv, g, num_heads)
    return octic_attention_bwd_reference(qkv, g, num_heads)


def attention_bwd_sync(qkv, g, num_heads: int, streamed: Optional[bool] = None):
    """The attention backward on K-attn-bwd's ``mma.sync`` core, the kernel
    the model paths ran before the TMA + wgmma redesign: the standard layout
    (qkv ``[B, N, 3C]`` and g ``[B, N, C]`` -> dqkv, as
    :func:`~octic_vits_tpu_torch.ops.standard_attention_bwd`) or, for a qkv
    tuple, the octic layout (the six qkv arrays and the six cotangents -> the
    six gradients, as :func:`~octic_vits_tpu_torch.ops.octic_attention_bwd`).
    `streamed` forces the core's form (whole-head staging or the streamed
    tiles); None takes :func:`~octic_vits_tpu_torch.ops.attention.
    attention_bwd_plan`'s. CPU tensors take the reference; the op runs on no
    model path."""
    octic = not isinstance(qkv, torch.Tensor)
    if not on_cuda((tuple(qkv) + tuple(g)) if octic else (qkv, g)):
        return attention_bwd_sync_reference(qkv, g, num_heads)
    if octic:
        b, n, c8, d1, de, dh = _octic_dims(qkv, num_heads)
    else:
        b, n, c, dh = _std_dims(qkv, num_heads)
    if streamed is None:
        streamed = attention_bwd_plan(n, dh)["streamed"]
    elif not streamed:
        _check_attention_bwd_shape(n, dh)
    stats = torch.empty(2, b, num_heads, n, device=g[0].device if octic else g.device,
                        dtype=torch.float32)
    attention_bwd_sync.launches += 1
    if not octic:
        check_kernel_arg(qkv, "qkv", (b, n, 3 * c))
        dqkv = torch.empty_like(qkv)
        kernels.launch("ovt_attention_std_bwd_sync", qkv, g, row_stride(g, "g", (b, n, c)), dqkv,
                       stats[0], stats[1], b, n, num_heads, dh, int(streamed))
        return dqkv
    lq = [row_stride(t, f"qkv[{i}]", (b, n, 3 * (c8 if i < 4 else 2 * c8)))
          for i, t in enumerate(qkv)]
    lg = _octic_out_row_strides(g, b, n, c8)
    grads = tuple(torch.empty(b, n, 3 * (c8 if i < 4 else 2 * c8), device=qkv[0].device,
                              dtype=qkv[0].dtype) for i in range(6))
    kernels.launch("ovt_attention_octic_bwd_sync", *qkv, *lq, *g, *lg, *grads, stats[0],
                   stats[1], b, n, num_heads, d1, de, int(streamed))
    return grads


attention_bwd_sync.launches = 0
attention_bwd_sync.reference = attention_bwd_sync_reference
