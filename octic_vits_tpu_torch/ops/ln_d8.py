"""The shared-std D8 LayerNorm on the flat-E 5-tuple as kernel ops
(counterpart of octic_vits_tpu/ops/pallas_ln.py):

* :func:`ln_affine_d8_flat_tuple`: the statistics and the AffineD8 epilogue
  in one pass (the LN of ``LayerNormD8`` with its affine); the backward
  :func:`ln_affine_d8_bwd` recomputes the statistics from the saved input,
  as the JAX custom VJP does, and returns the parameter gradients;
* :func:`ln_d8_flat_tuple`: the statistics alone
  (``LayerNormD8(elementwise_affine=False)``); its backward
  :func:`ln_d8_bwd` reads the saved normalized output and variance.

Math (pallas_ln.py:_stats): per-irrep means (each E row its own), one shared
``std = sqrt(2)/4 * sqrt(sum_g var_g + 0.5 (var_e0 + var_e1) + eps)`` with
biased variances, f32 statistics. CPU tensors run the ``*_reference`` plain
versions; CUDA tensors launch K-ln-d8 (csrc/ln_d8.cu). Layouts: ``xs = (a1,
a2, b1, b2, ef)`` with a* ``[..., c]`` and ``ef [..., 4c] = [row0 | row1]``;
``alpha [4, c]``, ``alpha_ef [1, 4c]`` (alpha_e over both E rows), ``beta
[1, c]`` (the A1 bias; zeros without one).
"""

from __future__ import annotations

import functools

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.d8.group import SQRT2_OVER_4
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.ops.linear import NUM_SMS

_K2 = SQRT2_OVER_4 * SQRT2_OVER_4
MAX_C = 256  # the kernel holds a token row in the registers of one warp
# csrc/ln_d8.cu: the chunk registers a lane may hold (ceil(c / 32) rounded up
# to one of these), the warps of a CTA and the stages of a warp's ring in the
# affine backward
LN_NV = (1, 2, 4, 5, 8)
LN_WARPS = 8
LN_BWD_STAGES = 2


@functools.lru_cache(maxsize=None)
def ln_bwd_plan(m: int, c: int, sms: int = NUM_SMS) -> dict:
    """The launch plan of K-ln-d8's affine backward (csrc/ln_d8.cu) for
    ``m`` token rows of slot width ``c``.

    ``nv`` chunk registers a lane (8 bf16 each); ``grid`` persistent CTAs,
    one an SM (the kernel's launch bounds: a warp holds a row's out and ust
    in f32 beside its parameter-gradient sums), of ``rows`` contiguous rows
    each (the last range ragged); a range holds at least ``stages`` rows a
    warp, so a small ``m`` takes few CTAs. Each warp's ring holds
    ``stages`` rows of x and u, each row ten 1-D bulk copies of ``copies``
    bytes (the four slots and the E row) for each tensor.
    ``partial_floats``: one CTA's f32 parameter-gradient slots; ``smem``: the
    barriers and the larger of the rings and the warps' sums. The C entry
    point checks the plan. Cached: read it, do not change it."""
    if c % 8 or c < 8 or c > MAX_C or m < 1:
        raise ValueError(f"ln_d8_bwd: the slot width c={c} must be a multiple of 8 in "
                         f"[8, {MAX_C}], and m={m} at least 1")
    nv = next(v for v in LN_NV if 32 * v >= c)
    partial_floats = 256 * (nv + 1)
    ring = LN_WARPS * LN_BWD_STAGES * 32 * c
    smem = LN_WARPS * LN_BWD_STAGES * 8 + max(ring, LN_WARPS * partial_floats * 4)
    rows = max(-(-m // sms), LN_WARPS * LN_BWD_STAGES)
    return {"m": m, "c": c, "nv": nv, "warps": LN_WARPS, "stages": LN_BWD_STAGES,
            "rows": rows, "grid": -(-m // rows),
            "partial_floats": partial_floats, "smem": smem,
            "copies": (2 * c,) * 4 + (8 * c,)}


def _stats(xs: tuple, eps: float) -> tuple:
    """f32 centered tuple, var ``[..., 1]`` and inv ``1/(sqrt2/4 sqrt var)``."""
    c = xs[0].shape[-1]
    ones = [x.float() for x in xs[:4]]
    xcs = [x - x.mean(dim=-1, keepdim=True) for x in ones]
    e = xs[4].float()
    rows = e.unflatten(-1, (2, 2 * c))
    ec = (rows - rows.mean(dim=-1, keepdim=True)).flatten(-2)
    var = (sum((x * x).sum(-1, keepdim=True) for x in xcs) * (1.0 / c)
           + (ec * ec).sum(-1, keepdim=True) * (0.25 / c) + eps)
    return tuple(xcs) + (ec,), var, 1.0 / (SQRT2_OVER_4 * torch.sqrt(var))


def _remove_means(d: tuple) -> tuple:
    """Each 1-d slot and each E row minus its own mean (the projector P)."""
    c = d[0].shape[-1]
    ones = tuple(t - t.mean(dim=-1, keepdim=True) for t in d[:4])
    rows = d[4].unflatten(-1, (2, 2 * c))
    return ones + ((rows - rows.mean(dim=-1, keepdim=True)).flatten(-2),)


def _dx(outs: tuple, ust: tuple, inv: torch.Tensor) -> tuple:
    """The closed-form input gradient: P (inv ust - coef w out) with coef =
    inv (sqrt2/4)^2 (ust . out), w = 1/c on 1-d lanes, 0.25/c on E lanes."""
    c = outs[0].shape[-1]
    coef = inv * _K2 * sum((u * o).sum(-1, keepdim=True) for u, o in zip(ust, outs))
    d = tuple(inv * u - coef * (w / c) * o for u, o, w in zip(ust, outs, (1, 1, 1, 1, 0.25)))
    return _remove_means(d)


def ln_affine_d8_reference(xs: tuple, alpha, alpha_ef, beta, eps: float = 1e-5) -> tuple:
    """Plain version: f32 math, one rounding to the input dtype at the end."""
    dt = xs[0].dtype
    xcs, _, inv = _stats(xs, eps)
    al, ae, be = alpha.float(), alpha_ef.float().reshape(-1), beta.float().reshape(-1)
    ys = [xcs[g] * inv * al[g] for g in range(4)]
    ys[0] = ys[0] + be
    return tuple(t.to(dt) for t in ys + [xcs[4] * inv * ae])


def ln_affine_d8_bwd_reference(xs: tuple, alpha, alpha_ef, us: tuple,
                               eps: float = 1e-5) -> tuple:
    """Plain backward (pallas_ln.py:_bwd_affine_kernel): the statistics
    recomputed from `xs`, f32 math. Returns ``(dxs, dalpha [4, c], dalpha_ef
    [1, 4c], dbeta [1, c])``, dxs in the input dtype, the parameter
    gradients in f32 (the caller casts them to the parameters' dtype)."""
    dt = xs[0].dtype
    c = xs[0].shape[-1]
    xcs, _, inv = _stats(xs, eps)
    outs = tuple(x * inv for x in xcs)
    uf = tuple(u.float() for u in us)
    al, ae = alpha.float(), alpha_ef.float().reshape(-1)
    dal = torch.stack([(uf[g] * outs[g]).reshape(-1, c).sum(0) for g in range(4)])
    dae = (uf[4] * outs[4]).reshape(-1, 4 * c).sum(0, keepdim=True)
    dbe = uf[0].reshape(-1, c).sum(0, keepdim=True)
    ust = tuple(uf[g] * al[g] for g in range(4)) + (uf[4] * ae,)
    dxs = tuple(t.to(dt) for t in _dx(outs, ust, inv))
    return dxs, dal, dae, dbe


def ln_d8_reference(xs: tuple, eps: float = 1e-5) -> tuple:
    """Plain version of the statistics alone: ``(out 5-tuple in the input
    dtype, var [M, 1] f32)``, the JAX kernel's outputs."""
    dt = xs[0].dtype
    xcs, var, inv = _stats(xs, eps)
    return tuple((x * inv).to(dt) for x in xcs), var.reshape(-1, 1)


def ln_d8_bwd_reference(outs: tuple, var: torch.Tensor, us: tuple) -> tuple:
    """Plain backward of the statistics alone (pallas_ln.py:_bwd_kernel) from
    the saved normalized output and var ``[M, 1]``; f32 math, dxs in the
    cotangent's dtype."""
    dt = us[0].dtype
    inv = 1.0 / (SQRT2_OVER_4 * torch.sqrt(var.float().reshape(*outs[0].shape[:-1], 1)))
    return tuple(t.to(dt) for t in _dx(tuple(o.float() for o in outs),
                                       tuple(u.float() for u in us), inv))


def _check(xs: tuple, name: str) -> tuple:
    c = xs[0].shape[-1]
    if c % 8 or c > MAX_C:
        raise ValueError(f"{name}: the slot width c={c} must be a multiple of 8 and at most "
                         f"{MAX_C}")
    lead = tuple(xs[0].shape[:-1])
    for g in range(4):
        check_kernel_arg(xs[g], f"xs[{g}]", lead + (c,))
    check_kernel_arg(xs[4], "xs[4]", lead + (4 * c,))
    return lead, c


def _check_params(alpha, alpha_ef, beta, c: int) -> bool:
    """The parameters are f32 or bf16, all of one dtype, contiguous and
    aligned. Returns True for f32."""
    params = [p for p in (alpha, alpha_ef, beta) if p is not None]
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1 or dtypes - {torch.float32, torch.bfloat16}:
        raise TypeError(f"ln_d8: parameters must be all f32 or all bf16, got {dtypes}")
    for p, name, shape in ((alpha, "alpha", (4, c)), (alpha_ef, "alpha_ef", (1, 4 * c)),
                           (beta, "beta", (1, c))):
        if p is None:
            continue
        if tuple(p.shape) != shape or not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"ln_d8: {name} must be a contiguous, 16-byte aligned {shape}")
    return dtypes == {torch.float32}


def ln_fwd_launch(xs: tuple, alpha, alpha_ef, beta, eps: float, with_var: bool = False):
    """One launch of the K-ln-d8 forward on CUDA bf16 tensors: with the
    affine where `alpha` is given, else the statistics alone. Returns the
    5-tuple, and var ``[M, 1]`` f32 with `with_var`. Counts nothing: the
    public ops count their own launches."""
    lead, c = _check(xs, "ln_d8")
    affine = alpha is not None
    f32 = _check_params(alpha, alpha_ef, beta, c) if affine else False
    m = xs[0].numel() // c
    ys = tuple(torch.empty_like(x) for x in xs)
    var = torch.empty(m, 1, device=xs[0].device, dtype=torch.float32) if with_var else None
    kernels.launch("ovt_ln_d8_fwd", *xs, alpha, alpha_ef, beta, *ys, var, m, c, int(affine),
                   int(f32), float(eps))
    return (ys, var) if with_var else ys


def ln_bwd_launch(xs: tuple, alpha, alpha_ef, us: tuple, var, eps: float) -> tuple:
    """One launch of the K-ln-d8 backward (two kernels in stream order with
    the affine, on :func:`ln_bwd_plan`: the rows, then the fixed-order sum
    of the CTAs' parameter-gradient partials).
    With `alpha`: `xs` is the forward's input; returns ``(dxs, dalpha,
    dalpha_ef, dbeta)`` with the parameter gradients in f32. Without: `xs` is
    the normalized output and `var` its variance; returns dxs."""
    lead, c = _check(xs, "ln_d8_bwd")
    for g in range(5):
        check_kernel_arg(us[g], f"us[{g}]", tuple(xs[g].shape))
    affine = alpha is not None
    m = xs[0].numel() // c
    dxs = tuple(torch.empty_like(u) for u in us)
    dev = xs[0].device
    if not affine:
        if var is None or var.dtype != torch.float32 or var.numel() != m or not var.is_contiguous():
            raise ValueError("ln_d8_bwd: var must be a contiguous f32 [M, 1]")
        kernels.launch("ovt_ln_d8_bwd", *xs, None, None, *us, var, *dxs, None, None, m, c, 0, 0,
                       0, 0, 0, 0, 0, 0.0)
        return dxs
    f32 = _check_params(alpha, alpha_ef, None, c)
    plan = ln_bwd_plan(m, c)
    partial = torch.empty(plan["grid"], plan["partial_floats"], device=dev, dtype=torch.float32)
    dparams = torch.empty(9 * c, device=dev, dtype=torch.float32)
    kernels.launch("ovt_ln_d8_bwd", *xs, alpha, alpha_ef, *us, None, *dxs, partial, dparams, m, c,
                   1, int(f32), plan["grid"], plan["rows"], plan["stages"], plan["smem"],
                   plan["partial_floats"], float(eps))
    return (dxs, dparams[:4 * c].reshape(4, c), dparams[4 * c:8 * c].reshape(1, 4 * c),
            dparams[8 * c:].reshape(1, c))


def ln_affine_d8_bwd(xs: tuple, alpha, alpha_ef, us: tuple, eps: float = 1e-5) -> tuple:
    """Backward of :func:`ln_affine_d8_flat_tuple` from its residuals (the
    input and the two scales) and the cotangent. CPU tensors take
    :func:`ln_affine_d8_bwd_reference`; CUDA tensors launch the K-ln-d8
    backward. Returns ``(dxs, dalpha, dalpha_ef, dbeta)``, the parameter
    gradients in f32."""
    if not on_cuda(tuple(xs) + tuple(us) + (alpha, alpha_ef)):
        return ln_affine_d8_bwd_reference(xs, alpha, alpha_ef, us, eps)
    ln_affine_d8_bwd.launches += 1
    return ln_bwd_launch(tuple(xs), alpha, alpha_ef, tuple(us), None, eps)


ln_affine_d8_bwd.launches = 0


class _LnAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, alpha_ef, beta, eps, *xs):
        ctx.save_for_backward(alpha, alpha_ef, *xs)  # the JAX residuals (pallas_ln.py:380-382)
        ctx.eps = eps
        if not on_cuda(tuple(xs) + (alpha, alpha_ef, beta)):
            return ln_affine_d8_reference(xs, alpha, alpha_ef, beta, eps)
        ln_affine_d8_flat_tuple.launches += 1
        return ln_fwd_launch(xs, alpha, alpha_ef, beta, eps)

    @staticmethod
    def backward(ctx, *us):
        alpha, alpha_ef, *xs = ctx.saved_tensors
        us = tuple(u.contiguous() for u in us)
        dxs, dal, dae, dbe = ln_affine_d8_bwd(tuple(xs), alpha, alpha_ef, us, ctx.eps)
        return (dal.to(alpha.dtype), dae.to(alpha_ef.dtype), dbe.to(alpha.dtype), None) + dxs


def ln_affine_d8_flat_tuple(xs: tuple, alpha: torch.Tensor, alpha_ef: torch.Tensor,
                            beta: torch.Tensor, eps: float = 1e-5) -> tuple:
    """Shared-std D8 LayerNorm + AffineD8 on the flat-E tuple in one pass
    (pallas_ln.py:366). The backward (:func:`ln_affine_d8_bwd`) recomputes
    the statistics from the saved input; it saves no normalized output."""
    return _LnAffine.apply(alpha, alpha_ef, beta, eps, *xs)


ln_affine_d8_flat_tuple.launches = 0


def ln_d8_bwd(outs: tuple, var: torch.Tensor, us: tuple) -> tuple:
    """Backward of :func:`ln_d8_flat_tuple` from its residuals (the
    normalized output and var ``[M, 1]``). CPU tensors take
    :func:`ln_d8_bwd_reference`; CUDA tensors launch the K-ln-d8 backward."""
    if not on_cuda(tuple(outs) + tuple(us) + (var,)):
        return ln_d8_bwd_reference(outs, var, us)
    ln_d8_bwd.launches += 1
    return ln_bwd_launch(tuple(outs), None, None, tuple(us), var, 0.0)


ln_d8_bwd.launches = 0


class _LnStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eps, *xs):
        if not on_cuda(xs):
            outs, var = ln_d8_reference(xs, eps)
        else:
            ln_d8_flat_tuple.launches += 1
            outs, var = ln_fwd_launch(xs, None, None, None, eps, with_var=True)
        ctx.save_for_backward(var, *outs)  # the JAX residuals (pallas_ln.py:406-409)
        return outs

    @staticmethod
    def backward(ctx, *us):
        var, *outs = ctx.saved_tensors
        return (None,) + ln_d8_bwd(tuple(outs), var, tuple(u.contiguous() for u in us))


def ln_d8_flat_tuple(xs: tuple, eps: float = 1e-5) -> tuple:
    """Shared-std D8 LayerNorm statistics on the flat-E tuple (pallas_ln.py:397),
    no affine. The backward (:func:`ln_d8_bwd`) reads the saved normalized
    output and per-token var."""
    return _LnStats.apply(eps, *xs)


ln_d8_flat_tuple.launches = 0
