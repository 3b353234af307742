"""Probes of K-attn's time (kernel rows 14a and 14b): the forward-attention
probes of the TPU scripts, each a variant of K-attn that differs from it in
one named part, so that differences of their times split K-attn's time.

Each op mirrors one Pallas kernel of ``scripts/`` (at the script's layout,
scale dh^-0.5 and numerics) and runs K-attn's device code
(csrc/attention_core.cuh) through csrc/attention_probe.cu, or K-attn-bwd
(csrc/attention_bwd.cu) for the head-major backward:

==  ==============================  =========================================
a   :func:`aligned_loads_attention`  profile_attn_kernel.py:_aligned_loads_kernel
b   :func:`aligned_all_attention`    profile_attn_kernel.py:_aligned_all_kernel
c   :func:`aligned_nosm_attention`   ..._aligned_all_variant(_attn_head_nosm)
d   :func:`aligned_cheap_attention`  ..._aligned_all_variant(_attn_head_cheapsm)
f   :func:`scores_only_attention`    r3_attn_ablate.py:k_scores_only
g   :func:`scores_softmax_attention` r3_attn_ablate.py:k_scores_softmax
h   :func:`full_attention`           r3_attn_ablate.py:k_full
i   :func:`interleave2_attention`    r3_attn_ablate.py:k_interleave2
j   :func:`phased_attention`         r3_attn_ablate.py:k_phased
k   :func:`padded_attention`         r3_attn_ablate.py:k_padded_full, k_padded_scores
l   :func:`padded_octic_attention`   r3_attn_ablate.py:k_padded_octic_store
m   :func:`bh_std_attention`         r3_attn_bh.py:call_std_bh
n   :func:`bh_octic_attention`       r3_attn_bh.py:call_octic_bh
o   :func:`headmajor_attention`      r3_attn_headmajor.py:headmajor_attention
p   :func:`headmajor_attention_bwd`  r3_attn_headmajor.py:headmajor_attention_bwd
==  ==============================  =========================================

and those of ``scripts/r3_attn_experiments.py`` (row 14b):

=================================  ===========================================
:func:`cls_split_attention`        ``_std_split_kernel`` (main's run_std_split)
:func:`cls_split_octic_attention`  ``_octic_split_kernel`` (via _call_octic)
:func:`multi_image_attention`      ``_std_multib_kernel``, nb = 2
:func:`multi_image_octic_attention` ``_octic_multib_kernel``, nb = 2
:func:`hoist_assembly`             phase 1 of ``_octic_hoist_kernel``
:func:`hoist_octic_attention`      ``_octic_hoist_kernel`` (split False, True)
=================================  ===========================================

(Row e, the octic attention over one interleaved qkv, is
:func:`~octic_vits_tpu_torch.ops.attention.octic_attention_wide`.) And
:func:`whole_head_octic_attention`: row 5's forward on K-attn's whole-head
core, which every octic forward ran until they moved to the streamed TMA +
wgmma kernel (csrc/attention_octic.cu), kept as the yardstick that kernel is
timed against.

Each ``<op>_reference`` is the plain version with the JAX kernel's numerics:
in bf16 the unnormalised bf16 probabilities of
``pallas_attention.py:_probs_unnormalized`` (exp of the bf16 difference, f32
row sum, the normaliser folded into the output; the cls-split's last key
in f32), in f32 the exact softmax.
The kernels keep K-attn's f32 softmax (CHEAP takes its exp in bf16), so on
the card each is held against its reference with the bf16 bars of
``chip_smoke.py``. CPU tensors take the reference; CUDA tensors launch the
kernel, and a launch that fails raises. The probes run on no model path:
their launch counters move only when a probe is called.
"""

from __future__ import annotations

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda
from octic_vits_tpu_torch.ops import attention as _attention
from octic_vits_tpu_torch.ops.attention import (
    SMEM_LIMIT,
    _check_attention_bwd_shape,
    _check_attention_shape,
    _octic_outputs,
    octic_attention_reference,
)
from octic_vits_tpu_torch.ops._dispatch import row_stride

PROBE_HEAD_DIMS = (64, 80)  # the head dims csrc/attention_probe.cu instantiates
ALIGN = 128  # the TPU lane width: the aligned and padded probes' head slots
STAGES = {"full": 0, "scores": 1, "probs": 2, "nosm": 3, "cheap": 4, "loads": 5}
ONE_HEAD, TWO_HEADS, TWO_PASS, TWO_IMAGES = 0, 1, 2, 3


def probe_smem_bytes(n: int, dh: int, sched: int = ONE_HEAD) -> int:
    """Shared memory of one probe CTA (csrc/attention_core.cuh:smem_bytes)."""
    kpad, dhp = -(-n // 16) * 16, -(-dh // 16) * 16
    k_vt = kpad * (dhp + 8) + dhp * (kpad + 8)
    if sched in (TWO_HEADS, TWO_IMAGES):
        return 2 * k_vt * 2 + 2 * dhp + 2 * 6 * 8
    extra = 8 * 16 * (kpad + 8) * 2 if sched == TWO_PASS else 0
    return (k_vt + kpad * (dhp + 8)) * 2 + 2 * dhp + 6 * 8 + extra


def _check_probe(n: int, dh: int, sched: int = ONE_HEAD) -> None:
    smem = probe_smem_bytes(n, dh, sched)
    if dh not in PROBE_HEAD_DIMS or smem > SMEM_LIMIT:
        raise ValueError(f"attention probe: N={n}, head dim {dh} unsupported (head dims "
                         f"{PROBE_HEAD_DIMS}; {smem} bytes of shared memory needed, "
                         f"{SMEM_LIMIT} available)")


# ---------------------------------------------------------------------------
# the JAX kernels' per-head arithmetic, batched over [B, H, N, d]
# ---------------------------------------------------------------------------


def _scores(q, k, scale):
    return (q.float() @ k.float().transpose(-1, -2)) * scale


def _probs_unnormalized(s, dtype, group=1):
    """pallas_attention.py:_probs_unnormalized: p = exp(s - m) in `dtype`,
    and the f32 row normaliser, of scores s [B, H, N, N]; m is each row's
    max or, with group > 1, one max over the rows of `group` consecutive
    heads (the pack kernels of scripts/r3_attn_bwd_ablate.py)."""
    m = s.amax(-1, keepdim=True)
    if group > 1:
        b, h, n, _ = m.shape
        m = m.reshape(b, h // group, group, n, 1).amax(2, keepdim=True)
        m = m.expand(-1, -1, group, -1, -1).reshape(b, h, n, 1)
    p = torch.exp((s - m).to(dtype))
    return p, 1.0 / p.float().sum(-1, keepdim=True)


def _attn_head(q, k, v, scale):
    """pallas_attention.py:_attn_head: bf16 takes the unnormalised bf16
    probabilities, f32 the exact softmax."""
    s = _scores(q, k, scale)
    if q.dtype == torch.bfloat16:
        p, inv = _probs_unnormalized(s, q.dtype)
        return (p.float() @ v.float()) * inv
    return torch.softmax(s, dim=-1).to(q.dtype).float() @ v.float()


def _attn_head_split(q, k, v, scale):
    """r3_attn_experiments.py:_attn_head_split with the keys split [N-1 | 1]:
    the last key's score an f32 dot product, its probability kept in f32
    (bf16 takes the main keys' bf16 probabilities, f32 the exact softmax)."""
    s_main = _scores(q, k[..., :-1, :], scale)
    s_last = (q.float() * k[..., -1:, :].float()).sum(-1, keepdim=True) * scale
    m = torch.maximum(s_main.amax(-1, keepdim=True), s_last)
    vm, vl = v[..., :-1, :].float(), v[..., -1:, :].float()
    p_last = torch.exp(s_last - m)
    if q.dtype == torch.bfloat16:
        p_main = torch.exp((s_main - m).to(q.dtype))
        inv = 1.0 / (p_main.float().sum(-1, keepdim=True) + p_last)
        return (p_main.float() @ vm + p_last * vl) * inv
    p_main = torch.exp(s_main - m)
    inv = 1.0 / (p_main.sum(-1, keepdim=True) + p_last)
    return (p_main * inv).to(q.dtype).float() @ vm + (p_last * inv) * vl


def _attn_unnormalized(q, k, v, scale, group=1):
    """k_interleave2, k_phased, _attn_head_cheapsm and the head-group kernels
    of scripts/r3_attn_bwd_ablate.py in every dtype: (exp(s - m) in the input
    dtype) v / the f32 row sum."""
    p, inv = _probs_unnormalized(_scores(q, k, scale), q.dtype, group)
    return (p.float() @ v.float()) * inv


def _attn_head_bwd(q, k, v, g, group=1):
    """pallas_attention.py:_attn_head_bwd per head, in every dtype as its
    bf16 path (the unnormalised probabilities in the input dtype, the
    normaliser folded into g and into dS, dS rounded to the input dtype; in
    f32 the exact gradient): (dq, dk, dv) f32 [B, H, N, dh] of q, k, v [B, H,
    N, dh] for the output cotangent g. `group` as _probs_unnormalized."""
    dt, scale = q.dtype, q.shape[-1] ** -0.5
    ph, inv = _probs_unnormalized(_scores(q, k, scale), dt, group)
    ginv = (g.float() * inv).to(dt).float()
    dv = ph.float().transpose(-1, -2) @ ginv
    dp = g.float() @ v.float().transpose(-1, -2)
    p32 = ph.float() * inv
    row = (dp * p32).sum(-1, keepdim=True)
    ds = (p32 * (dp - row) * scale).to(dt).float()
    return ds @ k.float(), ds.transpose(-1, -2) @ q.float(), dv


def _stage(stage, q, k, v, scale):
    """The value each stage writes, [B, H, N, d] f32."""
    if stage == "loads":
        return v.float()
    s = _scores(q, k, scale)
    if stage == "scores":
        return s.amax(-1, keepdim=True) + v.float()
    if stage == "probs":
        p, inv = _probs_unnormalized(s, q.dtype)
        return (p.amax(-1, keepdim=True).float() + inv) + v.float()
    if stage == "nosm":
        return s.to(q.dtype).float() @ v.float()
    if stage == "cheap":
        return _attn_unnormalized(q, k, v, scale)
    return _attn_head(q, k, v, scale)


def _merge(o, dtype):
    """[B, H, N, d] -> [B, N, H*d] in `dtype`."""
    b, h, n, d = o.shape
    return o.permute(0, 2, 1, 3).reshape(b, n, h * d).to(dtype)


def _octic_scatter(o, d1, dtype):
    """[B, H, N, 8 d1] -> the six irrep outputs (4 x [B, N, H*d1], 2 x [B, N,
    H*2d1]), as the scripts' octic stores."""
    de = 2 * d1
    pieces = [o[..., g * d1:(g + 1) * d1] for g in range(4)]
    pieces += [o[..., 4 * d1 + r * de:4 * d1 + (r + 1) * de] for r in range(2)]
    return tuple(_merge(t, dtype) for t in pieces)


def _slot_store(o, width, dtype):
    """[B, H, N, d] -> [B, N, H*width], head h at column h*width (columns
    d..width of each head zero)."""
    b, h, n, d = o.shape
    out = torch.zeros(b, h, n, width, dtype=torch.float32, device=o.device)
    out[..., :d] = o
    return _merge(out, dtype)


# ---------------------------------------------------------------------------
# the launch of csrc/attention_probe.cu
# ---------------------------------------------------------------------------


def _probe_launch(q, k, v, ld_in, bs_in, hs_in, hcol, outs, ld_out, bs_out, hs_out, pad_to,
                  b, n, h, dh, stage="full", sched=ONE_HEAD, split=False) -> None:
    octic = len(outs) == 6
    table = None if hcol is None else torch.tensor(hcol, dtype=torch.int32)
    outs = tuple(outs) + (None,) * (6 - len(outs))
    kernels.launch("ovt_attention_probe", q, k, v, ld_in, bs_in, hs_in, table, *outs, ld_out,
                   bs_out, hs_out, pad_to, int(octic), b, n, h, dh, STAGES[stage], sched,
                   int(split))


def _check_split(n: int) -> None:
    if n < 2:
        raise ValueError(f"cls-split attention: needs N >= 2 tokens, got {n}")


def _check_pairs(b: int, name: str) -> None:
    if b % 2:
        raise ValueError(f"{name}: two images a CTA need an even batch, got B={b}")


def _empty(t, *shape):
    return torch.empty(*shape, device=t.device, dtype=t.dtype)


# ---------------------------------------------------------------------------
# a-d: scripts/profile_attn_kernel.py, aligned "fake" slices of a1, a2, b1
# ---------------------------------------------------------------------------


def _aligned_dims(arrs, num_heads):
    b, n, w1 = arrs[0].shape
    c8 = w1 // 3
    d1 = c8 // num_heads
    dh = 8 * d1
    if w1 != 3 * c8 or c8 != num_heads * d1 or ALIGN * min(num_heads - 1, 2) + dh > w1:
        raise ValueError(f"aligned probe: width {w1} with {num_heads} heads unsupported")
    return b, n, c8, d1, dh


def _aligned_heads(arrs, num_heads):
    """q, k, v [B, H, N, dh]: head h's 80 columns at 128 (h % 3) of a1, a2, b1."""
    _, _, _, _, dh = _aligned_dims(arrs, num_heads)
    cols = [ALIGN * (h % 3) for h in range(num_heads)]
    return tuple(torch.stack([a[..., c:c + dh] for c in cols], dim=1) for a in arrs[:3])


def _aligned_probe(op, arrs, num_heads, stage):
    if not on_cuda(arrs):
        return op.reference(*arrs, num_heads)
    b, n, c8, d1, dh = _aligned_dims(arrs, num_heads)
    _check_probe(n, dh)
    for i, t in enumerate(arrs):
        check_kernel_arg(t, f"qkv[{i}]", (b, n, 3 * c8 if i < 4 else 6 * c8))
    hcol = [ALIGN * (h % 3) for h in range(num_heads)]
    if op is aligned_loads_attention:
        outs = tuple(_empty(arrs[0], b, n, c8 if i < 4 else 2 * c8) for i in range(6))
        ld_out = hs_out = 0
    else:
        outs = (_empty(arrs[0], b, n, ALIGN * num_heads),)
        ld_out, hs_out = ALIGN * num_heads, ALIGN
    op.launches += 1
    _probe_launch(arrs[0], arrs[1], arrs[2], 3 * c8, 0, 0, hcol, outs, ld_out, 0, hs_out, dh,
                  b, n, num_heads, dh, stage)
    return outs if len(outs) == 6 else outs[0]


def aligned_loads_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    arrs = (a1, a2, b1, b2, e0, e1)
    d1 = _aligned_dims(arrs, num_heads)[3]
    q, k, v = _aligned_heads(arrs, num_heads)
    return _octic_scatter(_attn_head(q, k, v, (8 * d1) ** -0.5), d1, a1.dtype)


def _aligned_store_reference(stage, arrs, num_heads):
    dh = _aligned_dims(arrs, num_heads)[4]
    q, k, v = _aligned_heads(arrs, num_heads)
    return _slot_store(_stage(stage, q, k, v, dh ** -0.5), ALIGN, arrs[0].dtype)


def aligned_all_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int):
    return _aligned_store_reference("full", (a1, a2, b1, b2, e0, e1), num_heads)


def aligned_nosm_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int):
    return _aligned_store_reference("nosm", (a1, a2, b1, b2, e0, e1), num_heads)


def aligned_cheap_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int):
    return _aligned_store_reference("cheap", (a1, a2, b1, b2, e0, e1), num_heads)


def aligned_loads_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    """Probe a: the octic kernel's work with aligned loads. q, k, v of head h
    are the dh = C/H columns at 128 (h % 3) of a1, a2 and b1 (the octic qkv
    arrays a1..b2 ``[B, N, 3C/8]``, e0, e1 ``[B, N, 3C/4]``; b2, e0, e1 are not
    read); the output goes through the octic scatter (4 x ``[B, N, C/8]``,
    2 x ``[B, N, C/4]``). K-attn with a per-head column table."""
    return _aligned_probe(aligned_loads_attention, (a1, a2, b1, b2, e0, e1), num_heads, "full")


def aligned_all_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> torch.Tensor:
    """Probe b: the loads of probe a, one store of each head at column
    128 h of ``[B, N, 128 H]`` (columns dh..128 of each head are not
    written). K-attn with the column table and a padded scatter."""
    return _aligned_probe(aligned_all_attention, (a1, a2, b1, b2, e0, e1), num_heads, "full")


def aligned_nosm_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> torch.Tensor:
    """Probe c: probe b with no softmax, out = bf16(s) v (stage NOSM)."""
    return _aligned_probe(aligned_nosm_attention, (a1, a2, b1, b2, e0, e1), num_heads, "nosm")


def aligned_cheap_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> torch.Tensor:
    """Probe d: probe b with the exp of the bf16 difference taken in bf16,
    p = exp(bf16(s - m)), out = p v / sum p (stage CHEAP)."""
    return _aligned_probe(aligned_cheap_attention, (a1, a2, b1, b2, e0, e1), num_heads, "cheap")


# ---------------------------------------------------------------------------
# f-j: scripts/r3_attn_ablate.py on the standard qkv [B, N, 3C]
# ---------------------------------------------------------------------------


def _std_dims(qkv, num_heads):
    b, n, w = qkv.shape
    c = w // 3
    dh = c // num_heads
    if w != 3 * c or c != num_heads * dh:
        raise ValueError(f"attention probe: width {w} with {num_heads} heads unsupported")
    return b, n, c, dh


def _std_heads(qkv, num_heads):
    b, n, c, dh = _std_dims(qkv, num_heads)
    return qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4).unbind(0)


def _std_probe(op, qkv, num_heads, stage, sched=ONE_HEAD, split=False):
    b, n, c, dh = _std_dims(qkv, num_heads)
    if split:
        _check_split(n)
    if sched == TWO_IMAGES:
        _check_pairs(b, op.__name__)
    if not on_cuda((qkv,)):
        return op.reference(qkv, num_heads, *((stage,) if op is scores_only_attention else ()))
    _check_probe(n, dh, sched)
    if sched == TWO_HEADS and num_heads % 2:
        raise ValueError(f"{op.__name__}: needs an even number of heads, got {num_heads}")
    check_kernel_arg(qkv, "qkv", (b, n, 3 * c))
    out = _empty(qkv, b, n, c)
    op.launches += 1
    _probe_launch(qkv, qkv[..., c:], qkv[..., 2 * c:], 3 * c, 0, dh, None, (out,), c, 0, dh, dh,
                  b, n, num_heads, dh, stage, sched, split)
    return out


def _std_reference(stage, qkv, num_heads):
    q, k, v = _std_heads(qkv, num_heads)
    return _merge(_stage(stage, q, k, v, q.shape[-1] ** -0.5), qkv.dtype)


def scores_only_attention_reference(qkv, num_heads: int, stage: str = "scores"):
    return _std_reference(stage, qkv, num_heads)


def scores_softmax_attention_reference(qkv, num_heads: int):
    return _std_reference("probs", qkv, num_heads)


def full_attention_reference(qkv, num_heads: int):
    return _std_reference("full", qkv, num_heads)


def interleave2_attention_reference(qkv, num_heads: int):
    q, k, v = _std_heads(qkv, num_heads)
    return _merge(_attn_unnormalized(q, k, v, q.shape[-1] ** -0.5), qkv.dtype)


def phased_attention_reference(qkv, num_heads: int):
    return interleave2_attention_reference(qkv, num_heads)


def scores_only_attention(qkv: torch.Tensor, num_heads: int,
                          stage: str = "scores") -> torch.Tensor:
    """Probe f: out = rowmax(s) + v per head, s = q k^T dh^-0.5 (stage SCORES:
    K-attn's gather, scores and online row max, no exp, no P.V). With
    ``stage="loads"``, out = v: K-attn's gather and store alone (stage LOADS,
    the floor of the H100 split, which the TPU script has no kernel for)."""
    if stage not in ("scores", "loads"):
        raise ValueError(f"scores_only_attention: stage {stage!r} is not 'scores' or 'loads'")
    return _std_probe(scores_only_attention, qkv, num_heads, stage)


def scores_softmax_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Probe g: out = (rowmax(p) + 1 / sum p) + v with p = exp(s - m) (stage
    PROBS: K-attn without P.V; rowmax(p) = 1)."""
    return _std_probe(scores_softmax_attention, qkv, num_heads, "probs")


def full_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Probe h: standard attention (K-attn as it stands, built from the probe
    source: its time against :func:`~octic_vits_tpu_torch.ops.standard_attention`
    shows that the two builds are the same kernel)."""
    return _std_probe(full_attention, qkv, num_heads, "full")


def interleave2_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Probe i: standard attention with two heads a CTA, the two heads'
    chains advancing together in each warp (K and v^T of both in shared
    memory, the query rows straight into fragments). Even head counts."""
    return _std_probe(interleave2_attention, qkv, num_heads, "full", TWO_HEADS)


def phased_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Probe j: standard attention with a two-pass softmax: each warp's score
    rows to shared memory, their max, one exp-and-sum pass, then P.V from
    shared memory, with no online rescale."""
    return _std_probe(phased_attention, qkv, num_heads, "full", TWO_PASS)


# ---------------------------------------------------------------------------
# k-n: the 128-padded qkv [B, N, 3 H 128] (scripts/r3_attn_ablate.py mk_pad,
# scripts/r3_attn_bh.py); the kernels gather only the dh real channels
# ---------------------------------------------------------------------------


def _padded_dims(qkvp, num_heads, head_dim):
    b, n, w = qkvp.shape
    slot = w // (3 * num_heads)
    if w != 3 * num_heads * slot or not 0 < head_dim <= slot:
        raise ValueError(f"padded probe: width {w} with {num_heads} heads of {head_dim} "
                         "channels unsupported")
    return b, n, slot


def _padded_heads(qkvp, num_heads, head_dim):
    """q, k, v [B, H, N, slot] (the whole slots: their pad is zero)."""
    b, n, slot = _padded_dims(qkvp, num_heads, head_dim)
    return qkvp.reshape(b, n, 3, num_heads, slot).permute(2, 0, 3, 1, 4).unbind(0)


def _padded_probe(op, qkvp, num_heads, head_dim, stage, octic, split=False):
    if split:
        _check_split(qkvp.shape[1])
    if not on_cuda((qkvp,)):
        extra = (stage,) if op is padded_attention else (split,) if split else ()
        return op.reference(qkvp, num_heads, head_dim, *extra)
    b, n, slot = _padded_dims(qkvp, num_heads, head_dim)
    _check_probe(n, head_dim)
    check_kernel_arg(qkvp, "qkvp", (b, n, 3 * num_heads * slot))
    c8 = num_heads * head_dim // 8
    if octic:
        outs = tuple(_empty(qkvp, b, n, c8 if i < 4 else 2 * c8) for i in range(6))
    else:
        outs = (_empty(qkvp, b, n, num_heads * slot),)
    hw = num_heads * slot
    op.launches += 1
    _probe_launch(qkvp, qkvp[..., hw:], qkvp[..., 2 * hw:], 3 * hw, 0, slot, None, outs, hw, 0,
                  slot, slot, b, n, num_heads, head_dim, stage, split=split)
    return outs if octic else outs[0]


def padded_attention_reference(qkvp, num_heads: int, head_dim: int, stage: str = "full"):
    q, k, v = _padded_heads(qkvp, num_heads, head_dim)
    return _merge(_stage(stage, q, k, v, head_dim ** -0.5), qkvp.dtype)


def padded_octic_attention_reference(qkvp, num_heads: int, head_dim: int,
                                     split: bool = False) -> tuple:
    q, k, v = _padded_heads(qkvp, num_heads, head_dim)
    head = _attn_head_split if split else _attn_head
    o = head(q, k, v, head_dim ** -0.5)[..., :head_dim]
    return _octic_scatter(o, head_dim // 8, qkvp.dtype)


def bh_std_attention_reference(qkvp, num_heads: int, head_dim: int):
    return padded_attention_reference(qkvp, num_heads, head_dim)


def bh_octic_attention_reference(qkvp, num_heads: int, head_dim: int) -> tuple:
    return padded_octic_attention_reference(qkvp, num_heads, head_dim)


def padded_attention(qkvp: torch.Tensor, num_heads: int, head_dim: int,
                     stage: str = "full") -> torch.Tensor:
    """Probe k: attention (stage ``"full"``) or rowmax(s) + v (``"scores"``)
    on a padded qkv ``[B, N, 3 H slot]`` whose slots hold head_dim real
    channels and zeros (the scale stays head_dim^-0.5) -> ``[B, N, H slot]``,
    every column written: the pad is p 0 = 0 (full) or rowmax(s) (scores).
    The kernel gathers the real channels only."""
    if stage not in ("full", "scores"):
        raise ValueError(f"padded_attention: stage {stage!r} is not 'full' or 'scores'")
    return _padded_probe(padded_attention, qkvp, num_heads, head_dim, stage, False)


def padded_octic_attention(qkvp: torch.Tensor, num_heads: int, head_dim: int,
                           split: bool = False) -> tuple:
    """Probe l: attention on the padded qkv with the octic scatter (d1 =
    head_dim / 8) -> 4 x ``[B, N, C/8]``, 2 x ``[B, N, C/4]``. With `split`,
    the cls-split keys (phase 2 of :func:`hoist_octic_attention` with split)."""
    return _padded_probe(padded_octic_attention, qkvp, num_heads, head_dim, "full", True, split)


def bh_std_attention(qkvp: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """Probe m (scripts/r3_attn_bh.py:call_std_bh): the padded qkv on a grid
    of (batch, head) -> ``[B, N, H slot]``, pad 0. K-attn's grid is already
    (head, batch), so this is probe k's full stage, timed as its own case."""
    return _padded_probe(bh_std_attention, qkvp, num_heads, head_dim, "full", False)


def bh_octic_attention(qkvp: torch.Tensor, num_heads: int, head_dim: int) -> tuple:
    """Probe n (scripts/r3_attn_bh.py:call_octic_bh): probe l on the (head,
    batch) grid, timed as its own case."""
    return _padded_probe(bh_octic_attention, qkvp, num_heads, head_dim, "full", True)


# ---------------------------------------------------------------------------
# o, p: scripts/r3_attn_headmajor.py, qkv [B, 3, H, N, dh]
# ---------------------------------------------------------------------------


def _hm_dims(qkv_hm, num_heads):
    if qkv_hm.ndim != 5 or qkv_hm.shape[1] != 3 or qkv_hm.shape[2] != num_heads:
        raise ValueError(f"head-major probe: qkv {tuple(qkv_hm.shape)} is not [B, 3, "
                         f"{num_heads}, N, dh]")
    b, _, _, n, dh = qkv_hm.shape
    return b, n, dh


def headmajor_attention_reference(qkv_hm, num_heads: int):
    _hm_dims(qkv_hm, num_heads)
    q, k, v = qkv_hm.unbind(1)
    return _attn_head(q, k, v, q.shape[-1] ** -0.5).to(qkv_hm.dtype)


def headmajor_attention_bwd_reference(qkv_hm, g_hm, num_heads: int):
    _hm_dims(qkv_hm, num_heads)
    return torch.stack(_attn_head_bwd(*qkv_hm.unbind(1), g_hm), dim=1).to(qkv_hm.dtype)


def headmajor_attention(qkv_hm: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Probe o: attention on a head-major qkv ``[B, 3, H, N, dh]`` ->
    ``[B, H, N, dh]``: K-attn whose gather and scatter take each head as an
    [N, dh] block (head stride N dh, batch strides 3 H N dh and H N dh)."""
    if not on_cuda((qkv_hm,)):
        return headmajor_attention_reference(qkv_hm, num_heads)
    b, n, dh = _hm_dims(qkv_hm, num_heads)
    _check_probe(n, dh)
    check_kernel_arg(qkv_hm, "qkv_hm", (b, 3, num_heads, n, dh))
    out = _empty(qkv_hm, b, num_heads, n, dh)
    blk = n * dh
    headmajor_attention.launches += 1
    _probe_launch(qkv_hm[:, 0], qkv_hm[:, 1], qkv_hm[:, 2], dh, 3 * num_heads * blk, blk, None,
                  (out,), dh, num_heads * blk, blk, dh, b, n, num_heads, dh)
    return out


def headmajor_attention_bwd(qkv_hm: torch.Tensor, g_hm: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Probe p: dqkv ``[B, 3, H, N, dh]`` from the head-major qkv and the
    output cotangent ``[B, H, N, dh]``: K-attn-bwd (csrc/attention_bwd.cu)
    with the head-major batch strides."""
    if not on_cuda((qkv_hm, g_hm)):
        return headmajor_attention_bwd_reference(qkv_hm, g_hm, num_heads)
    b, n, dh = _hm_dims(qkv_hm, num_heads)
    _check_attention_bwd_shape(n, dh)
    check_kernel_arg(qkv_hm, "qkv_hm", (b, 3, num_heads, n, dh))
    check_kernel_arg(g_hm, "g_hm", (b, num_heads, n, dh))
    dqkv = torch.empty_like(qkv_hm)
    stats = torch.empty(2, b, num_heads, n, device=qkv_hm.device, dtype=torch.float32)
    headmajor_attention_bwd.launches += 1
    kernels.launch("ovt_attention_headmajor_bwd", qkv_hm, g_hm, dqkv, stats[0], stats[1], b, n,
                   num_heads, dh)
    return dqkv


# ---------------------------------------------------------------------------
# row 14b: scripts/r3_attn_experiments.py at the scripts' two layouts: the
# standard qkv [B, N, 3C] and the six octic arrays a1..b2 [B, N, 3C/8],
# e0, e1 [B, N, 3C/4] (head h of s at column (s H + h) d1, or de = 2 d1)
# ---------------------------------------------------------------------------


def _octic_dims(arrs, num_heads):
    """(b, n, c8, d1, de, dh) of the six octic qkv arrays."""
    if len(arrs) != 6:
        raise ValueError(f"octic probe: expected six qkv arrays, got {len(arrs)}")
    b, n, w = arrs[0].shape
    c8 = w // 3
    d1 = c8 // num_heads
    shapes = [tuple(a.shape) for a in arrs]
    if w != 3 * c8 or c8 != num_heads * d1 or d1 == 0 or shapes != [(b, n, 3 * c8)] * 4 + [
            (b, n, 6 * c8)] * 2:
        raise ValueError(f"octic probe: shapes {shapes} with {num_heads} heads unsupported")
    return b, n, c8, d1, 2 * d1, 8 * d1


def _octic_heads(arrs, num_heads):
    """q, k, v [B, H, N, dh]: each head's a1|a2|b1|b2|e0|e1 slices
    (pallas_attention.py:_octic_slices)."""
    b, n, c8, d1, de, _ = _octic_dims(arrs, num_heads)
    qkv = []
    for s in range(3):
        pieces = [a[..., s * c8:(s + 1) * c8].reshape(b, n, num_heads, d1) for a in arrs[:4]]
        pieces += [e[..., 2 * s * c8:2 * (s + 1) * c8].reshape(b, n, num_heads, de)
                   for e in arrs[4:]]
        qkv.append(torch.cat(pieces, dim=-1).transpose(1, 2))
    return qkv


def _octic_reference(arrs, num_heads, split):
    q, k, v = _octic_heads(arrs, num_heads)
    head = _attn_head_split if split else _attn_head
    return _octic_scatter(head(q, k, v, q.shape[-1] ** -0.5), q.shape[-1] // 8, arrs[0].dtype)


def _octic_outs(arrs, b, n, c8):
    return tuple(_empty(arrs[0], b, n, c8 if i < 4 else 2 * c8) for i in range(6))


def _octic_probe(op, arrs, num_heads, sched=ONE_HEAD, split=False):
    b, n, c8, d1, de, dh = _octic_dims(arrs, num_heads)
    if split:
        _check_split(n)
    if sched == TWO_IMAGES:
        _check_pairs(b, op.__name__)
    if not on_cuda(arrs):
        return op.reference(*arrs, num_heads)
    _check_probe(n, dh, sched)
    for i, t in enumerate(arrs):
        check_kernel_arg(t, f"qkv[{i}]", (b, n, 3 * c8 if i < 4 else 6 * c8))
    outs = _octic_outs(arrs, b, n, c8)
    op.launches += 1
    kernels.launch("ovt_attention_probe_octic", *arrs, *[3 * c8] * 4, *[6 * c8] * 2, *outs, b, n,
                   num_heads, d1, de, sched, int(split))
    return outs


def cls_split_attention_reference(qkv, num_heads: int):
    q, k, v = _std_heads(qkv, num_heads)
    return _merge(_attn_head_split(q, k, v, q.shape[-1] ** -0.5), qkv.dtype)


def multi_image_attention_reference(qkv, num_heads: int):
    return full_attention_reference(qkv, num_heads)


def cls_split_octic_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    return _octic_reference((a1, a2, b1, b2, e0, e1), num_heads, True)


def multi_image_octic_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    return _octic_reference((a1, a2, b1, b2, e0, e1), num_heads, False)


def cls_split_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Standard attention with the keys split [N-1 | 1]
    (r3_attn_experiments.py:_std_split_kernel): the 64-key blocks cover keys
    0..N-2 and key N-1 is a rank-1 update in f32, folded into the online
    softmax (template SPLIT of csrc/attention_core.cuh). N >= 2."""
    return _std_probe(cls_split_attention, qkv, num_heads, "full", split=True)


def cls_split_octic_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    """The octic attention (K-attn's octic gather and scatter, row 5's
    layout) with the cls-split keys (r3_attn_experiments.py:
    _octic_split_kernel) -> 4 x ``[B, N, C/8]``, 2 x ``[B, N, C/4]``."""
    return _octic_probe(cls_split_octic_attention, (a1, a2, b1, b2, e0, e1), num_heads,
                        split=True)


def multi_image_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Standard attention with two images a CTA
    (r3_attn_experiments.py:_std_multib_kernel, nb = 2): the same head of
    batch rows 2y and 2y + 1, their chains interleaved in each warp
    (schedule TWO_IMAGES). B even."""
    return _std_probe(multi_image_attention, qkv, num_heads, "full", TWO_IMAGES)


def multi_image_octic_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    """The octic attention with two images a CTA
    (r3_attn_experiments.py:_octic_multib_kernel, nb = 2). B even."""
    return _octic_probe(multi_image_octic_attention, (a1, a2, b1, b2, e0, e1), num_heads,
                        TWO_IMAGES)


def hoist_assembly_reference(a1, a2, b1, b2, e0, e1, num_heads: int, slot: int = ALIGN):
    arrs = (a1, a2, b1, b2, e0, e1)
    b, n, _, _, _, dh = _octic_dims(arrs, num_heads)
    out = torch.zeros(b, n, 3, num_heads, slot, dtype=a1.dtype, device=a1.device)
    out[..., :dh] = torch.stack(_octic_heads(arrs, num_heads), dim=2).transpose(1, 3)
    return out.reshape(b, n, 3 * num_heads * slot)


def hoist_assembly(a1, a2, b1, b2, e0, e1, num_heads: int, slot: int = ALIGN) -> torch.Tensor:
    """Phase 1 of r3_attn_experiments.py:_octic_hoist_kernel: every (s, head)
    slice of the six octic arrays gathered into the padded qkv ``[B, N, 3 H
    slot]`` (head h of s at column (s H + h) slot, the pad zero), the layout
    of probes k-n. The TPU kernel keeps it in VMEM; here it is written to
    HBM (csrc/attention_probe.cu:hoist_kernel)."""
    arrs = (a1, a2, b1, b2, e0, e1)
    if not on_cuda(arrs):
        return hoist_assembly_reference(*arrs, num_heads, slot)
    qkvp = _hoist(arrs, num_heads, slot)
    hoist_assembly.launches += 1
    return qkvp


def _hoist(arrs, num_heads, slot):
    b, n, c8, d1, de, dh = _octic_dims(arrs, num_heads)
    if d1 % 2 or slot % 8 or slot < dh:
        raise ValueError(f"hoist assembly: d1={d1} must be even and slot={slot} a multiple of 8 "
                         f">= {dh}")
    for i, t in enumerate(arrs):
        check_kernel_arg(t, f"qkv[{i}]", (b, n, 3 * c8 if i < 4 else 6 * c8))
    qkvp = _empty(arrs[0], b, n, 3 * num_heads * slot)
    kernels.launch("ovt_hoist_octic", *arrs, *[3 * c8] * 4, *[6 * c8] * 2, qkvp, b, n, num_heads,
                   d1, de, slot)
    return qkvp


def hoist_octic_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int,
                                    split: bool = False) -> tuple:
    return _octic_reference((a1, a2, b1, b2, e0, e1), num_heads, split)


def hoist_octic_attention(a1, a2, b1, b2, e0, e1, num_heads: int, split: bool = False) -> tuple:
    """r3_attn_experiments.py:_octic_hoist_kernel: the octic attention with
    its assembly hoisted out of the heads' loop. Phase 1 writes the padded
    qkv (:func:`hoist_assembly`'s kernel), phase 2 is probe l
    (:func:`padded_octic_attention`) on it, with the cls-split keys if
    `split` -> 4 x ``[B, N, C/8]``, 2 x ``[B, N, C/4]``. Counts one launch
    of the pair."""
    arrs = (a1, a2, b1, b2, e0, e1)
    n, dh = a1.shape[1], _octic_dims(arrs, num_heads)[5]
    if split:
        _check_split(n)
    if not on_cuda(arrs):
        return hoist_octic_attention_reference(*arrs, num_heads, split)
    _check_probe(n, dh)
    qkvp = _hoist(arrs, num_heads, ALIGN)
    return _padded_probe(hoist_octic_attention, qkvp, num_heads, dh, "full", True, split)


#: the probe ops of kernel row 14a (rows a-d and f-p), in order
PROBE_OPS_14A = (aligned_loads_attention, aligned_all_attention, aligned_nosm_attention,
                 aligned_cheap_attention, scores_only_attention, scores_softmax_attention,
                 full_attention, interleave2_attention, phased_attention, padded_attention,
                 padded_octic_attention, bh_std_attention, bh_octic_attention,
                 headmajor_attention, headmajor_attention_bwd)
#: the attention probes of kernel row 14b (scripts/r3_attn_experiments.py)
EXPERIMENT_OPS = (cls_split_attention, cls_split_octic_attention, multi_image_attention,
                  multi_image_octic_attention, hoist_assembly, hoist_octic_attention)
for _op in PROBE_OPS_14A + EXPERIMENT_OPS:
    _op.launches = 0
    _op.reference = globals()[f"{_op.__name__}_reference"]
del _op


def whole_head_octic_attention_reference(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    return octic_attention_reference(a1, a2, b1, b2, e0, e1, num_heads)


def whole_head_octic_attention(a1, a2, b1, b2, e0, e1, num_heads: int) -> tuple:
    """:func:`~octic_vits_tpu_torch.ops.attention.octic_attention`'s forward
    on K-attn's whole-head core (csrc/attention.cu:ovt_attention_octic_rows:
    one CTA a (head, batch), the whole head gathered into shared memory before
    the first product), the kernel the octic forwards ran before streaming
    their keys; N up to the core's shared memory (:func:`~octic_vits_tpu_torch.
    ops.attention._check_attention_shape`). CPU tensors take the reference;
    CUDA tensors launch the core. The op runs on no model path."""
    qs = (a1, a2, b1, b2, e0, e1)
    if not on_cuda(qs):
        return whole_head_octic_attention_reference(*qs, num_heads)
    b, n, c8, d1, de = _attention._octic_dims(qs, num_heads)
    _check_attention_shape(n, 8 * d1)
    lds = [row_stride(t, f"qkv[{i}]", (b, n, 3 * (c8 if i < 4 else 2 * c8)))
           for i, t in enumerate(qs)]
    outs = _octic_outputs(a1, b, n, c8)
    whole_head_octic_attention.launches += 1
    kernels.launch("ovt_attention_octic_rows", *qs, *lds, *outs, b, n, num_heads, d1, de)
    return outs


whole_head_octic_attention.launches = 0
whole_head_octic_attention.reference = whole_head_octic_attention_reference
