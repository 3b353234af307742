"""Chip smoke test of the PyTorch + CUDA port (octic_vits_tpu_torch) on one
NVIDIA GPU. Run from the repository root: ``python3 chip_smoke.py``.

Phases, one line each (any failure raises and exits non-zero):
  P0 device  the card's name and power limit (nvidia-smi); no CUDA -> exit 2
  P1 build   nvcc builds csrc/ into build/octic_vits_tpu_torch/
  P2 kernels each hand-written kernel against its plain PyTorch version at
             the ViT-H/14 B=64 bf16 shapes and at a ragged small shape, with
             the stated tolerance and CUDA-event median times
  P3 slice   hybrid ViT-H/14 (hybrid_deit_huge_patch14, full width and depth,
             seeded random weights, LayerScale init 1.0) forward at B=64 224^2
             bf16: finite logits, 16 launches of each kernel, and logits of two
             images against the same weights in f32 through the plain path on
             the CPU
  P4 timing  hybrid and standard (deit_huge_patch14_LS) forward, img/s
  P5 train kernels  each kernel of the train path that P2 does not cover
             (standard_attention_bwd, octic_attention forward and backward,
             linear_d8_fused with and without GELU) against its plain version
             at the ViT-H/14 B=32 bf16 shapes and at the ragged shape, with
             the stated tolerance and CUDA-event median times
  P6 train slice  hybrid ViT-H/14 (f32 parameters, bf16 compute, remat) takes
             one DeiT III step at B=32 (LAMB, clip 1.0, EMA, BCE on
             mixup/cutmix targets, drop path 0.45): finite loss and gradients,
             launches of every train kernel; a deterministic step on 2 images
             (mixup off, drop path 0) against the same weights in f32 through
             the plain path on the CPU (loss and gradient cosine); the
             convergence check of scripts/smoke_train_tpu.py (60 AdamW steps)
  P7 train timing  hybrid and standard train step at B=32 224^2: median ms,
             img/s, ratio, peak device memory
  P8 SSL kernels  the backward of the fused octic qkv + attention (the chain
             K-lin-d8 -> K-attn-bwd -> K-lin-d8-bwd) against its plain version at
             the hybrid ViT-L/16 B=32 shapes (global crops 64 x 197 tokens, local
             crops 256 x 37) and at the ragged shape, with CUDA-event times of
             the chain and its plain version; then at the L/16 global and
             local crops and, on the packed container, at ViT-H/14 B=32 (row
             10b): the chain's first two launches, and K-lin-d8-bwd (one
             persistent TMA + wgmma launch and its fixed-order reduction)
             against its plain version under the forward bar (the weight
             gradients too, stricter than the backward bar), two launches
             bitwise equal, its device ms by CUDA-graph replay beside its
             bound, its windowed ms, the host µs to enqueue one call and
             cuBLAS doing the same products; every other kernel of the SSL
             step at the L/16 shapes (correctness only)
  P9 SSL slice  hybrid_dinov2_vit_large_patch16 (full width and depth, f32
             parameters, bf16 compute, remat, drop path 0.3, DINO/iBOT head
             65536 wide) takes one DINOv2 step at B=32 (2 x 32 global 224^2 and
             8 x 32 local 96^2 crops, iBOT masks from collate_crops_and_masks):
             finite loss, gradients and centers, launches of every kernel; a
             deterministic step on B=2 (drop path 0) against the same weights in
             f32 through the plain path on the CPU (loss and gradient cosine)
  P10 SSL timing  hybrid against dinov2_vit_large_patch16 at B=32: median ms
             over 10 steps after 2 warm-up, range, img/s (B images a step),
             ratio, peak device memory
  P11 glue kernels  the octic block's fused-glue kernels against their plain
             versions: the D8 LayerNorm forward with its affine, the
             statistics-only LN pair, the proj with the LayerScale + residual
             epilogue and the fused MLP branch at ViT-H/14 B=64; the affine LN
             backward and the D8-GELU forward and backward on the MLP hidden at
             B=32; all of them at the ragged shape; then the affine LN backward
             (row 8; one persistent launch fed by 1-D bulk copies and the sum of
             its partials) at ViT-H/14 B=32, the L/16 global crop and the ragged
             shape: dx under the forward bar, the parameter gradients under the
             backward bar, two launches bitwise equal, its device ms by
             CUDA-graph replay beside its bound and the parent kernel's
             (PARENT_LN_BWD_MS); then one forward and backward of
             LayerNormD8(elementwise_affine=False), the only caller of the
             statistics-only pair
  P12 path A  hybrid ViT-H/14 B=64 bf16 with fuse_mlp_branch and the LN kernel
             (OCTIC_PALLAS_LN): launches of every kernel, logits of two images
             against P3's CPU f32 logits (same weights)
  P13 path B  the same with fuse_block_epilogues; then img/s of P4's hybrid and
             paths A and B in turns
  P14 path C  the DeiT III step of P6 with plain octic linears, the D8-GELU
             kernel and the LN kernel (use_pallas_linear=False,
             use_pallas_gelu=True): launches; a deterministic 2-image step
             against P6's CPU f32 step (loss, gradient cosine); median step ms
             of P7's hybrid and path C in turns
  P15 packed kernels  the packed-container kernels against their plain
             versions: the fused qkv + attention (row 10) and the fused MLP
             (row 11) on the packed [B, N, C] container at ViT-H/14 B=64, the
             backward of row 10 (K-lin-d8 -> K-attn-bwd -> K-lin-d8-bwd writing
             the packed dx) and of the fused MLP (row 4's, on the container's
             views) at B=32; all of them at the ragged shape
  P16 inv-early d8_inv_early_deit_huge_patch14 (full width and depth, seeded
             random weights, LayerScale 1.0) forward at B=64 bf16 with the
             flat-E carry and with packed_carry: 16 launches of each kernel,
             logits of two images against the same weights in f32 through the
             plain tuple path on the CPU; img/s of P4's hybrid and both
             inv-early variants in turns
  P17 packed train  the DeiT III step of P6 on the inv-early model with
             packed_carry, fuse_qkv and fuse_mlp at B=32: finite loss and
             gradients, launches against PACKED_TRAIN_LAUNCHES; a
             deterministic 2-image step against the CPU f32 plain path (loss,
             gradient cosine); median step ms and peak memory of P7's hybrid,
             the inv-early model with P7's flags and the packed one, in turns
  P18 wide kernels  the wide-qkv kernels against their plain versions: the
             wide-1d octic attention (row 12) and the attention over one
             interleaved qkv (row 13a) at ViT-H/14 B=64, their backwards at B=32,
             linear_d8_qkv_wide (row 13b) and the wide-1d qkv product at B=64;
             all at the ragged shape and at d1 = 10 with 4 heads; then the qkv +
             attention segments of scripts/profile_wide_qkv.py in turns, forward
             at B=64 and forward + backward at B=32: A linear_d8_fused +
             octic_attention, B the fused qkv + attention (row 2), C
             linear_d8_qkv_wide + octic_attention_wide, D the wide-1d product +
             octic_attention_wide1d (segment C's launches: the row-13 path)
  P19 wide inference  P3's hybrid with use_wide_qkv: launches against
             WIDE_INFERENCE_LAUNCHES, logits of two images against P3's CPU f32
             logits, img/s in turns with P4's hybrid and path B
  P20 wide train  P6's DeiT III step with use_wide_qkv: finite loss and
             gradients, launches against WIDE_TRAIN_LAUNCHES; the deterministic
             2-image step against P6's CPU f32 loss and gradients; median step
             ms and the step's peak memory in turns with P7's hybrid
  P21 probe kernels  the forward-attention probes of kernel row 14a
             (ops/attention_probe.py: K-attn's stages, schedules and layouts,
             and K-attn-bwd on the head-major qkv) against their plain
             versions at ViT-H/14 B=64 (the backward at B=32) and at a ragged
             shape (B=3, N=37), each with its time, bound and library call;
             then each probe op launched once (launches against 1 each)
  P22 probes 14b  the probes of kernel row 14b against their plain versions
             with P21's bars: the cls-split, two-images and hoisted-assembly
             attention of scripts/r3_attn_experiments.py at ViT-H/14 B=64 and
             at B=4, N=37; K-lin-d8's tile sweep (scripts/profile_lin_tiles.py,
             both stores, M = 16448 and 148), each tile also bitwise equal to
             the mma.sync core's 64 x 32 instantiation (ops.lin_d8_sync, the
             model paths' K-lin-d8 before its TMA + wgmma redesign); the
             product-cost law's twelve shapes
             (scripts/r3_matmul_law.py, B=64) with the law's own bar
             (LAW_ATOL, LAW_RTOL), shown to fail a kernel that drops an
             edge or a head; each with its time, bound and library call;
             then each row-14b op launched once
  P23 probes 14c  the probes of kernel row 14c (scripts/r3_attn_bwd_ablate.py)
             against their plain versions: the octic backward with the wide
             store and with the wide cotangent, the head-group attention
             (K-attn-group: the standard pack at G = 1, 2, 4 with the shared
             max, the standard masked pair, the octic masked groups at G = 1,
             2, 4; forward and backward) and the fused qkv + attention with and
             without the proj, forwards at ViT-H/14 B=64, backwards at B=32,
             all at B=2, N=45; each with its time, bound (and a masked probe's
             extra products) and library call; then each row-14c op launched
             once
  P24 redesign  K-attn's standard forward (csrc/attention_std.cu) and K-dense
             (csrc/dense.cu), both TMA + wgmma, against their plain versions at
             every main-path shape (ViT-H/14 B=64 and B=32, the L/16 SSL global
             and local crops) and at their plans' edges (dh 16, 24, 32, 40,
             120, 128; N = 1, 65, 100, 197, 257; ragged M, K and F); then in
             turns the new standard forward, K-attn's whole-head core (probe
             h) and SDPA under each backend that runs (and the kernels the
             default SDPA launched), K-dense against cuBLASLt's GELU
             epilogue, each with TFLOP/s and share of the bound; and the host
             time per call of each (tensor maps are encoded per launch)
  P25 redesign 2  K-lin-d8 (csrc/lin_d8.cu) and the octic attention forward
             (csrc/attention_octic.cu), both TMA + wgmma: K-lin-d8 in every
             mode and store against its plain version at the ViT-H/14 B=64
             and B=32 and L/16 shapes and at ragged edges (M = 148, F = 24,
             c = 16; d1 = 2, 8, 10; packed row strides); the five octic
             forwards (rows 2, 5, 10, 12, 13a) at the same shapes; every
             octic forward and every attention backward layout (std, octic,
             wide-1d, wide, rows 2b and 10b) just past the old whole-head
             limits and at N = 1025; then, in turns by
             CUDA-graph replay, K-lin-d8 against the mma.sync core it replaced
             (ops.lin_d8_sync) and a cuBLAS bmm + matmul pair, the octic
             forward against the whole-head core (ops.whole_head_octic_
             attention), each beside its bound; route (b) of rows 5 and 12 in
             turns with one copy into the wide qkv + route (a); the host time
             per call; the two yardsticks launched once each (0 on every model
             path: P3 checks every counter).
             `python3 chip_smoke.py --p25` runs P25 alone after the build and
             prints no result
  P26 redesign 3  K-attn-bwd on TMA + wgmma (csrc/attention_bwd.cu on
             csrc/attention_bwd_sm90.cuh) in every layout (std; the octic
             arrays of row 5, the wide-1d of row 12 and the wide qkv of row
             13a, all through route (a); the chains of rows 2b and 10b)
             against its plain version under the backward bar at ViT-H/14
             B=32, the L/16 SSL shapes and the plan's edges (N from 1 to
             1025, dh 16 to 128); two launches bitwise equal; a non-finite
             value in one head reaching no other head's gradients; then in
             turns by CUDA-graph replay the new kernel against its mma.sync
             core in both forms (ops.attention_bwd_sync) and SDPA's backward
             under each backend that runs (and the kernels the default SDPA
             launched), each beside its bound, with route (a)'s assembly alone;
             the host time per call; the yardstick launched once (0 on every
             model path).
             `python3 chip_smoke.py --p26` runs P26 alone
P15 also times row 4's backward as it was (the hidden's cotangent and the
recomputed pre-activation rounded to bf16), with the cotangent in f32, and
with both in f32 (the shipped rule), each against the f32 plain backward.
The line before the last is the per-kernel JSON summary (with each kernel's
bound on the card and, where one PyTorch call computes the same function,
that call's time); the last line is ``{"ok": true, "device": {...}}``. Each
phase prints its seconds.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

BATCH, IMG = 64, 224
TRAIN_BATCH = 32
SSL_BATCH, LOCAL_IMG = 32, 96  # configs/train/hybrid_vitl16.yaml: batch_size_per_gpu 32
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): bf16 tensor
# cores, float32 outside the tensor cores, and HBM3; a kernel's bound is the
# larger of its operations over the rate of their type and its bytes (each
# input read once, each output written once) over the memory rate
PEAK_FLOPS, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# bf16 kernel vs f32 plain version (both rounded to bf16 at the same points):
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise. Covers one or two
# bf16 ulps of the output and the summation order of f32 accumulators.
ATOL, RTOL = 1e-2, 2e-2
# The product law (P22): both sides sum exact bf16 products in f32 (TF32 off),
# so they differ only in the order of the sums, ~1e-6 relative
LAW_ATOL, LAW_RTOL = 1e-6, 1e-4
# P3: relative L2 error of bf16-on-card logits against f32-on-CPU logits
# over 32 blocks of bf16 activations
SLICE_REL_TOL = 5e-2
# Backward kernels: |kernel - plain| <= BWD_TOL * (max|plain| + |plain|). A
# gradient sums 2N = 514 products whose operands the kernel rounds to bf16
# (P and dS, as the JAX bf16 kernel does) while the plain version keeps them
# in f32; the error of a sum scales with the size of the whole gradient, not
# with each element, so the bar is set against max|plain|.
BWD_TOL = 2e-2
# P6: cosine similarity of the whole flattened gradient, bf16 on the card
# against f32 on the CPU. Elementwise bf16 noise of relative size e gives a
# cosine of ~1 - e^2/2 (0.999 at e = 4e-2); a wrong gradient of any large
# tensor drops it far below. The loss shares the P3 bar.
GRAD_COS_MIN = 0.99
T0 = time.perf_counter()


def phase(tag: str, msg: str) -> None:
    print(f"{tag} [{time.perf_counter() - T0:.1f} s] {msg}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of `fn` over `iters` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def sdpa_views(qkv, heads):
    """q, k, v ``[B, H, N, dh]`` as views of a standard qkv ``[B, N, 3C]``."""
    b, n, w = qkv.shape
    return qkv.view(b, n, 3, heads, w // (3 * heads)).permute(2, 0, 3, 1, 4).unbind(0)


def library_sdpa(qkv, heads):
    """One PyTorch call computing standard_attention: SDPA on the qkv views."""
    q, k, v = sdpa_views(qkv, heads)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def library_sdpa_bwd(qkv, g, heads):
    """One PyTorch call computing standard_attention_bwd: the autograd
    backward of SDPA on the qkv views (dqkv for the cotangent g), after one
    recorded forward."""
    leaf = qkv.detach().requires_grad_()
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(*sdpa_views(leaf, heads))
    b, n, c = g.shape
    gv = g.view(b, n, heads, c // heads).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaf, gv, retain_graph=True)


def library_dense_gelu(x, w, bias):
    """One PyTorch call computing dense + GELU: cuBLASLt's GELU epilogue
    (the tanh form of GELU, within ~1e-3 of the erf form the kernel uses)."""
    x2 = x.reshape(-1, x.shape[-1])
    return lambda: torch._addmm_activation(bias, x2, w.t(), use_gelu=True)


def kernel_cases(gen, b, n, c, heads, bias):
    """(name, kernel op, reference op, args, library call or None) of the four
    kernels at one shape."""
    from octic_vits_tpu_torch import ops

    c8 = c // 8
    opt = lambda t: t if bias else None  # noqa: E731
    qkv = randn(gen, b, n, 3 * c)
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    wq1, wqe = randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5), randn(gen, 2 * c8, 6 * c8,
                                                                   scale=(2 * c8) ** -0.5)
    x = randn(gen, b, n, c)
    w_fc1, b_fc1 = randn(gen, 4 * c, c, scale=c ** -0.5), randn(gen, 4 * c, scale=0.1)
    h8 = 4 * c8
    w1a, wea = randn(gen, 4, c8, h8, scale=c8 ** -0.5), randn(gen, 2 * c8, 2 * h8,
                                                              scale=(2 * c8) ** -0.5)
    w1b, web = randn(gen, 4, h8, c8, scale=h8 ** -0.5), randn(gen, 2 * h8, 2 * c8,
                                                              scale=(2 * h8) ** -0.5)
    b1, b2, bq = randn(gen, h8, scale=0.1), randn(gen, c8, scale=0.1), randn(gen, 3 * c8,
                                                                            scale=0.1)
    return [
        ("standard_attention", ops.standard_attention, ops.standard_attention_reference,
         (qkv, heads), library_sdpa(qkv, heads)),
        ("octic_attention_fused_qkv", ops.octic_attention_fused_qkv,
         ops.octic_attention_fused_qkv_reference, (*xs, wq1, wqe, opt(bq), heads), None),
        ("dense_gelu", ops.dense_gelu, ops.dense_gelu_reference, (x, w_fc1, opt(b_fc1)),
         library_dense_gelu(x, w_fc1, b_fc1) if bias else None),
        ("mlp_d8_fused", ops.mlp_d8_fused, ops.mlp_d8_fused_reference,
         (xs, w1a, wea, opt(b1), w1b, web, opt(b2)), None),
    ]


def train_kernel_cases(gen, b, n, c, heads, bias):
    """(name, kernel op, reference op, args, scaled bar, library call or None)
    of the train-path kernels P2 does not cover, at one shape: the MLP widths
    for linear_d8_fused (fc1 c -> 4c with GELU, fc2 4c -> c)."""
    from octic_vits_tpu_torch import ops

    c8, h8 = c // 8, c // 2
    opt = lambda t: t if bias else None  # noqa: E731
    qkv, g = randn(gen, b, n, 3 * c), randn(gen, b, n, c)
    ef = randn(gen, b, n, 12 * c8)  # flat-E qkv: e0, e1 are its column halves
    qs = tuple(randn(gen, b, n, 3 * c8) for _ in range(4)) + (ef[..., :6 * c8], ef[..., 6 * c8:])
    gs = tuple(randn(gen, b, n, c8) for _ in range(4)) + tuple(
        randn(gen, b, n, 2 * c8) for _ in range(2))
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    hs = tuple(randn(gen, b, n, h8) for _ in range(4)) + (randn(gen, b, n, 4 * h8),)
    fc1 = (xs, randn(gen, 4, c8, h8, scale=c8 ** -0.5),
           randn(gen, 2 * c8, 2 * h8, scale=(2 * c8) ** -0.5), opt(randn(gen, h8, scale=0.1)),
           True)
    fc2 = (hs, randn(gen, 4, h8, c8, scale=h8 ** -0.5),
           randn(gen, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5), opt(randn(gen, c8, scale=0.1)),
           False)
    return [
        ("standard_attention_bwd", ops.standard_attention_bwd,
         ops.standard_attention_bwd_reference, (qkv, g, heads), True,
         library_sdpa_bwd(qkv, g, heads)),
        ("octic_attention", ops.octic_attention, ops.octic_attention_reference,
         (*qs, heads), False, None),
        ("octic_attention_bwd", ops.octic_attention_bwd, ops.octic_attention_bwd_reference,
         (qs, gs, heads), True, None),
        ("linear_d8_fused", ops.linear_d8_fused, ops.linear_d8_fused_reference, fc1, False, None),
        ("linear_d8_fused", ops.linear_d8_fused, ops.linear_d8_fused_reference, fc2, False, None),
    ]


def ssl_kernel_cases(gen, b, n, c, heads, bias):
    """The kernel the SSL step adds: the backward of the fused octic qkv +
    attention from its residuals (flat-E input, qkv weights) and the six
    output cotangents, the E ones as column slices of one [B, N, C/2] tensor
    (the proj's input gradient on the train path). Scaled bar: the chain
    runs the attention backward kernel."""
    from octic_vits_tpu_torch import ops

    c8 = c // 8
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    w1 = randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5)
    we = randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5)
    bq = randn(gen, 3 * c8, scale=0.1) if bias else None
    ge = randn(gen, b, n, 4 * c8)
    gs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (ge[..., :2 * c8], ge[..., 2 * c8:])
    return [("octic_attention_fused_qkv_bwd", ops.octic_attention_fused_qkv_bwd,
             ops.octic_attention_fused_qkv_bwd_reference, (xs, w1, we, bq, gs, heads), True,
             None)]


def work(name: str, b: int, n: int, c: int, heads: int, bias: bool) -> tuple:
    """(bytes, tensor-core operations, float32 operations) that kernel `name`
    must move and do at one shape of the cases above: each input read once,
    each output written once (bf16 activations; the LN's f32 parameters,
    gradients and variance at 4 bytes), the products of its function (2 per
    multiply-add), and for the elementwise glue kernels the float32
    arithmetic a value takes in the kernel, a transcendental counted as one
    (LN forward 7, its affine backward 17, the statistics-only backward 8;
    D8-GELU forward 13, backward 22)."""
    m, c8, e = b * n, c // 8, 2
    attn_fwd = 4 * b * n * n * c   # S = QK^T and PV over every head
    attn_bwd = 10 * b * n * n * c  # S again, dV = P^T dO, dP = dO V^T, dQ, dK
    qkv_w = 24 * c8 * c8           # w1 [4, C/8, 3C/8] + we [C/4, 3C/4]
    qkv_ops = 72 * m * c8 * c8     # the block-diagonal qkv product
    lin4_w, lin4_ops = 32 * c8 * c8, 96 * m * c8 * c8  # one octic LinearD8 C <-> 4C
    bq = 3 * c8 if bias else 0
    if name in ("standard_attention", "octic_attention", "octic_attention_wide1d",
                "octic_attention_wide"):
        return m * 4 * c * e, attn_fwd, 0
    if name in ("standard_attention_bwd", "octic_attention_bwd", "octic_attention_wide1d_bwd",
                "octic_attention_wide_bwd"):
        return m * 7 * c * e, attn_bwd, 0
    if name in ("linear_d8_qkv_wide", "linear_d8_wide1d"):  # x in, the 3C qkv out
        return (4 * m * c + qkv_w + bq) * e, qkv_ops, 0
    if name in ("octic_attention_fused_qkv", "octic_attention_fused_qkv_packed"):
        return (2 * m * c + qkv_w + bq) * e, qkv_ops + attn_fwd, 0
    if name in ("octic_attention_fused_qkv_bwd", "octic_attention_fused_qkv_packed_bwd"):
        return (3 * m * c + 2 * qkv_w + 2 * bq) * e, 3 * qkv_ops + attn_bwd, 0  # dx, dw, dbias
    if name == "dense_gelu":
        return (m * c + 4 * c * c + 4 * c + 4 * m * c) * e, 8 * m * c * c, 0
    if name in ("mlp_d8_fused", "mlp_d8_fused_packed"):
        return (2 * m * c + 2 * lin4_w + 5 * c8) * e, 2 * lin4_ops, 0
    if name == "mlp_d8_fused_bwd":  # x, g, weights in; dx, weight gradients out; the
        # hidden once more (fc1), then fc2's and fc1's transpose and weight products;
        # the D8-GELU forward and backward on the 4C hidden
        return (3 * m * c + 4 * lin4_w + 10 * c8) * e, 5 * lin4_ops, (13 + 22) * 4 * m * c
    if name == "linear_d8_fused":  # fc1 (C -> 4C) and fc2 (4C -> C), the two timed cases
        return (10 * m * c + 2 * lin4_w + 5 * c8) * e, 2 * lin4_ops, 0
    # the glue kernels (the cases of glue_b64_cases and glue_b32_cases)
    if name == "ln_affine_d8_flat_tuple":  # x in, y out; bf16 alpha, alpha_ef, beta
        return (2 * m * c + 9 * c8) * e, 0, 7 * m * c
    if name == "ln_affine_d8_bwd":  # x, u in, dx out; f32 alphas in, their gradients out
        return 3 * m * c * e + (8 * c8 + 9 * c8) * 4, 0, 17 * m * c
    if name == "ln_d8_flat_tuple":  # x in; y and the f32 var out
        return 2 * m * c * e + 4 * m, 0, 7 * m * c
    if name == "ln_d8_bwd":  # y, f32 var, u in; dx out
        return 3 * m * c * e + 4 * m, 0, 8 * m * c
    if name == "gelu_d8":  # on the MLP hidden, 4C wide
        return 2 * 4 * m * c * e, 0, 13 * 4 * m * c
    if name == "gelu_d8_bwd":
        return 3 * 4 * m * c * e, 0, 22 * 4 * m * c
    if name == "linear_d8_epilogue":  # the proj C -> C: x, r in, y out; w, bias, ls
        return (3 * m * c + 8 * c8 * c8 + (c8 if bias else 0) + 6 * c8) * e, 24 * m * c8 * c8, \
            2 * m * c
    if name == "mlp_branch_d8":  # x in, y out; LN, fc1, fc2 and LayerScale parameters
        return (2 * m * c + 2 * lin4_w + 5 * c8 + 9 * c8 + 6 * c8) * e, 2 * lin4_ops, \
            (7 + 13 * 4 + 2) * m * c
    if name in PROBE_WORK:  # the probes: columns read and written, products / (b n^2 c)
        dh = c // heads
        cols_in, cols_out, k = PROBE_WORK[name](c, dh, heads)
        return m * (cols_in + cols_out) * e, k * b * n * n * c, 0
    raise KeyError(name)


# The attention probes (kernel row 14a) at one shape of probe_cases: (columns
# of [B, N, .] that the function reads, columns it writes, its products in
# units of b n^2 c: 2 for q k^T, 2 more for P.V, 10 for a backward). The
# aligned probes read the min(H, 3) distinct 80-column slices of a1, a2, b1;
# the padded ones the real channels of the padded qkv (the pad is zero) and
# write every column of probe k's and m's [B, N, 128 H]; probe k sums its
# two stages, as its time does; "loads_only" (the gather and the store, out
# = v) reads v alone.
PROBE_WORK = {
    "aligned_loads_attention": lambda c, dh, h: (3 * min(h, 3) * dh, c, 4),
    "aligned_all_attention": lambda c, dh, h: (3 * min(h, 3) * dh, c, 4),
    "aligned_nosm_attention": lambda c, dh, h: (3 * min(h, 3) * dh, c, 4),
    "aligned_cheap_attention": lambda c, dh, h: (3 * min(h, 3) * dh, c, 4),
    "loads_only": lambda c, dh, h: (c, c, 0),
    "scores_only_attention": lambda c, dh, h: (3 * c, c, 2),
    "scores_softmax_attention": lambda c, dh, h: (3 * c, c, 2),
    "full_attention": lambda c, dh, h: (3 * c, c, 4),
    "interleave2_attention": lambda c, dh, h: (3 * c, c, 4),
    "phased_attention": lambda c, dh, h: (3 * c, c, 4),
    "padded_attention": lambda c, dh, h: (2 * 3 * c, 2 * 128 * h, 6),
    "padded_octic_attention": lambda c, dh, h: (3 * c, c, 4),
    "bh_std_attention": lambda c, dh, h: (3 * c, 128 * h, 4),
    "bh_octic_attention": lambda c, dh, h: (3 * c, c, 4),
    "headmajor_attention": lambda c, dh, h: (3 * c, c, 4),
    "headmajor_attention_bwd": lambda c, dh, h: (4 * c, 3 * c, 10),
}


def bound_of(nbytes: float, tc_ops: float, f32_ops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for work of
    `nbytes` bytes, `tc_ops` tensor-core and `f32_ops` float32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, max(tc_ops / PEAK_FLOPS, f32_ops / PEAK_F32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound(name: str, shape: tuple) -> tuple:
    """(bound_ms, bound_by) of kernel `name` at one shape (`work`)."""
    return bound_of(*work(name, *shape))


def flat(out) -> tuple:
    """The tensors of a nested tuple, in order."""
    if isinstance(out, (tuple, list)):
        return tuple(t for o in out for t in flat(o))
    return (out,)


def compare(out, ref, scaled=False, tol=(ATOL, RTOL)):
    """Max abs error and whether every output is finite and inside its bar:
    atol + rtol |ref| elementwise (`tol`, the forward bar unless given), or
    BWD_TOL (max|ref| + |ref|) if `scaled` (a bool for all outputs, or one
    per output of the flattened tuple). An output that is None (no bias, no
    bias gradient) must be None on both sides."""
    outs, refs = flat(out), flat(ref)
    if isinstance(scaled, bool):
        scaled = (scaled,) * len(outs)
    err, ok = 0.0, True
    for o, r, scaled in zip(outs, refs, scaled, strict=True):
        if o is None or r is None:
            ok &= o is None and r is None
            continue
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {o.shape} {o.dtype} vs {r.shape} {r.dtype}")
        r = r.float()
        d = (o.float() - r).abs()
        err = max(err, d.max().item())
        bar = BWD_TOL * (r.abs().max() + r.abs()) if scaled else tol[0] + tol[1] * r.abs()
        ok &= bool((d <= bar).all()) and bool(o.isfinite().all())
    return err, ok


PROBE_SRC = "octic_vits_tpu_torch/csrc/attention_probe.cu"
GROUP_SRC = "octic_vits_tpu_torch/csrc/attention_group.cu"
# kernel -> (source, replaced JAX function at file:line, the path whose run
# gives its launch count)
META = {
    "standard_attention": ("octic_vits_tpu_torch/csrc/attention_std.cu",
                           "octic_vits_tpu/ops/pallas_attention.py:1234", "inference"),
    "octic_attention_fused_qkv": ("octic_vits_tpu_torch/csrc/attention_octic.cu",
                                  "octic_vits_tpu/ops/pallas_attention.py:538", "inference"),
    "dense_gelu": ("octic_vits_tpu_torch/csrc/dense.cu", "octic_vits_tpu/ops/pallas_dense.py:111",
                   "inference"),
    "mlp_d8_fused": ("octic_vits_tpu_torch/csrc/lin_d8.cu",
                     "octic_vits_tpu/ops/pallas_linear.py:550", "inference"),
    "standard_attention_bwd": ("octic_vits_tpu_torch/csrc/attention_bwd.cu",
                               "octic_vits_tpu/ops/pallas_attention.py:1259", "train"),
    "octic_attention": ("octic_vits_tpu_torch/csrc/attention_octic.cu",
                        "octic_vits_tpu/ops/pallas_attention.py:356", "train"),
    "octic_attention_bwd": ("octic_vits_tpu_torch/csrc/attention_bwd.cu",
                            "octic_vits_tpu/ops/pallas_attention.py:391", "train"),
    "linear_d8_fused": ("octic_vits_tpu_torch/csrc/lin_d8.cu",
                        "octic_vits_tpu/ops/pallas_linear.py:196", "train"),
    "octic_attention_fused_qkv_bwd": ("octic_vits_tpu_torch/csrc/lin_d8_bwd.cu",
                                      "octic_vits_tpu/ops/pallas_attention.py:737", "ssl"),
    "ln_affine_d8_flat_tuple": ("octic_vits_tpu_torch/csrc/ln_d8.cu",
                                "octic_vits_tpu/ops/pallas_ln.py:366", "epilogue_inference"),
    "ln_affine_d8_bwd": ("octic_vits_tpu_torch/csrc/ln_d8.cu",
                         "octic_vits_tpu/ops/pallas_ln.py:385", "glue_train"),
    "ln_d8_flat_tuple": ("octic_vits_tpu_torch/csrc/ln_d8.cu",
                         "octic_vits_tpu/ops/pallas_ln.py:397", "ln_stats_module"),
    "ln_d8_bwd": ("octic_vits_tpu_torch/csrc/ln_d8.cu", "octic_vits_tpu/ops/pallas_ln.py:412",
                  "ln_stats_module"),
    "gelu_d8": ("octic_vits_tpu_torch/csrc/gelu_d8.cu", "octic_vits_tpu/ops/pallas_gelu.py:200",
                "glue_train"),
    "gelu_d8_bwd": ("octic_vits_tpu_torch/csrc/gelu_d8.cu",
                    "octic_vits_tpu/ops/pallas_gelu.py:214", "glue_train"),
    "linear_d8_epilogue": ("octic_vits_tpu_torch/csrc/lin_d8.cu",
                           "octic_vits_tpu/ops/pallas_linear.py:196", "epilogue_inference"),
    "mlp_branch_d8": ("octic_vits_tpu_torch/csrc/ln_d8.cu",
                      "octic_vits_tpu/ops/pallas_mlp_branch.py:251", "fused_branch_inference"),
    "octic_attention_fused_qkv_packed": ("octic_vits_tpu_torch/csrc/attention_octic.cu",
                                         "octic_vits_tpu/ops/pallas_attention.py:904",
                                         "packed_inference"),
    "octic_attention_fused_qkv_packed_bwd": ("octic_vits_tpu_torch/csrc/lin_d8_bwd.cu",
                                             "octic_vits_tpu/ops/pallas_attention.py:959",
                                             "packed_train"),
    "mlp_d8_fused_packed": ("octic_vits_tpu_torch/csrc/lin_d8.cu",
                            "octic_vits_tpu/ops/pallas_linear.py:712", "packed_inference"),
    "mlp_d8_fused_bwd": ("octic_vits_tpu_torch/csrc/lin_d8.cu",
                         "octic_vits_tpu/ops/pallas_linear.py:566", "packed_train"),
    "octic_attention_wide1d": ("octic_vits_tpu_torch/csrc/attention_octic.cu",
                               "octic_vits_tpu/ops/pallas_attention.py:1058", "wide_inference"),
    "octic_attention_wide1d_bwd": ("octic_vits_tpu_torch/csrc/attention_bwd.cu",
                                   "octic_vits_tpu/ops/pallas_attention.py:1087", "wide_train"),
    "octic_attention_wide": ("octic_vits_tpu_torch/csrc/attention_octic.cu",
                             "octic_vits_tpu/ops/pallas_attention.py:1154", "wide_segments"),
    "octic_attention_wide_bwd": ("octic_vits_tpu_torch/csrc/attention_bwd.cu",
                                 "octic_vits_tpu/ops/pallas_attention.py:1188", "wide_segments"),
    "linear_d8_qkv_wide": ("octic_vits_tpu_torch/csrc/lin_d8.cu",
                           "octic_vits_tpu/ops/pallas_linear.py:380", "wide_segments"),
    # kernel row 14a: the forward-attention probes of scripts/ (P21)
    "aligned_loads_attention": (PROBE_SRC, "scripts/profile_attn_kernel.py:61", "probe"),
    "aligned_all_attention": (PROBE_SRC, "scripts/profile_attn_kernel.py:82", "probe"),
    "aligned_nosm_attention": (PROBE_SRC, "scripts/profile_attn_kernel.py:94", "probe"),
    "aligned_cheap_attention": (PROBE_SRC, "scripts/profile_attn_kernel.py:101", "probe"),
    "scores_only_attention": (PROBE_SRC, "scripts/r3_attn_ablate.py:54", "probe"),
    "scores_softmax_attention": (PROBE_SRC, "scripts/r3_attn_ablate.py:63", "probe"),
    "full_attention": (PROBE_SRC, "scripts/r3_attn_ablate.py:72", "probe"),
    "interleave2_attention": (PROBE_SRC, "scripts/r3_attn_ablate.py:80", "probe"),
    "phased_attention": (PROBE_SRC, "scripts/r3_attn_ablate.py:94", "probe"),
    "padded_attention": (PROBE_SRC, "scripts/r3_attn_ablate.py:118", "probe"),
    "padded_octic_attention": (PROBE_SRC, "scripts/r3_attn_ablate.py:142", "probe"),
    "bh_std_attention": (PROBE_SRC, "scripts/r3_attn_bh.py:49", "probe"),
    "bh_octic_attention": (PROBE_SRC, "scripts/r3_attn_bh.py:54", "probe"),
    "headmajor_attention": (PROBE_SRC, "scripts/r3_attn_headmajor.py:44", "probe"),
    "headmajor_attention_bwd": ("octic_vits_tpu_torch/csrc/attention_bwd_probe.cu",
                                "scripts/r3_attn_headmajor.py:69", "probe"),
    # kernel row 14b (P22): scripts/r3_attn_experiments.py, profile_lin_tiles.py and
    # r3_matmul_law.py
    "cls_split_attention": (PROBE_SRC, "scripts/r3_attn_experiments.py:279", "probe_14b"),
    "cls_split_octic_attention": (PROBE_SRC, "scripts/r3_attn_experiments.py:234",
                                  "probe_14b"),
    "multi_image_attention": (PROBE_SRC, "scripts/r3_attn_experiments.py:303", "probe_14b"),
    "multi_image_octic_attention": (PROBE_SRC, "scripts/r3_attn_experiments.py:208",
                                    "probe_14b"),
    "hoist_assembly": (PROBE_SRC, "scripts/r3_attn_experiments.py:234", "probe_14b"),
    "hoist_octic_attention": (PROBE_SRC, "scripts/r3_attn_experiments.py:234", "probe_14b"),
    "lin_d8_tiled": ("octic_vits_tpu_torch/csrc/lin_d8_probe.cu",
                     "scripts/profile_lin_tiles.py:41", "probe_14b"),
    "matmul_law": ("octic_vits_tpu_torch/csrc/mma_law.cu", "scripts/r3_matmul_law.py:65",
                   "probe_14b"),
    "matmul_law_batched": ("octic_vits_tpu_torch/csrc/mma_law.cu",
                           "scripts/r3_matmul_law.py:134", "probe_14b"),
    # kernel row 14c (P23): scripts/r3_attn_bwd_ablate.py
    "octic_attention_bwd_widestore": ("octic_vits_tpu_torch/csrc/attention_bwd_probe.cu",
                                      "scripts/r3_attn_bwd_ablate.py:795", "probe_14c"),
    "octic_attention_bwd_wideg": ("octic_vits_tpu_torch/csrc/attention_bwd_probe.cu",
                                  "scripts/r3_attn_bwd_ablate.py:812", "probe_14c"),
    "std_pack_attention": (GROUP_SRC, "scripts/r3_attn_bwd_ablate.py:839", "probe_14c"),
    "std_pack_attention_bwd": (GROUP_SRC, "scripts/r3_attn_bwd_ablate.py:865", "probe_14c"),
    "std_maskpair_attention": (GROUP_SRC, "scripts/r3_attn_bwd_ablate.py:883", "probe_14c"),
    "std_maskpair_attention_bwd": (GROUP_SRC, "scripts/r3_attn_bwd_ablate.py:895", "probe_14c"),
    "octic_group_attention": (GROUP_SRC, "scripts/r3_attn_bwd_ablate.py:926", "probe_14c"),
    "octic_group_attention_bwd": (GROUP_SRC, "scripts/r3_attn_bwd_ablate.py:779", "probe_14c"),
    "octic_qkv_attention": ("octic_vits_tpu_torch/csrc/qkv_attention.cu",
                            "scripts/r3_attn_bwd_ablate.py:735", "probe_14c"),
    "octic_qkv_attention_proj": ("octic_vits_tpu_torch/csrc/qkv_attention.cu",
                                 "scripts/r3_attn_bwd_ablate.py:693", "probe_14c"),
    # the yardsticks of the Hopper redesigns (P25): the kernels they replaced
    "lin_d8_sync": ("octic_vits_tpu_torch/csrc/lin_d8_probe.cu",
                    "octic_vits_tpu/ops/pallas_linear.py:196", "probe_25"),
    "whole_head_octic_attention": ("octic_vits_tpu_torch/csrc/attention.cu",
                                   "octic_vits_tpu/ops/pallas_attention.py:356", "probe_25"),
    # the yardstick of K-attn-bwd's redesign (P26): its mma.sync core
    "attention_bwd_sync": ("octic_vits_tpu_torch/csrc/attention_bwd_probe.cu",
                           "octic_vits_tpu/ops/pallas_attention.py:1259", "probe_26"),
}
# kernels whose chain launches more than the source named in META
ALSO = {"octic_attention_fused_qkv": ["octic_vits_tpu_torch/csrc/lin_d8.cu"],
        "octic_attention_fused_qkv_bwd": ["octic_vits_tpu_torch/csrc/lin_d8.cu",
                                          "octic_vits_tpu_torch/csrc/attention_bwd.cu"],
        "mlp_branch_d8": ["octic_vits_tpu_torch/csrc/lin_d8.cu"],
        "octic_attention_fused_qkv_packed": ["octic_vits_tpu_torch/csrc/lin_d8.cu"],
        "octic_attention_fused_qkv_packed_bwd": ["octic_vits_tpu_torch/csrc/lin_d8.cu",
                                                 "octic_vits_tpu_torch/csrc/attention_bwd.cu"]}
# launches of each kernel in one hybrid ViT-L/16 DINOv2 step at B=32 (12 octic
# and 12 standard blocks) under remat. The teacher's forward (eval mode) runs
# the fused inference kernels once per block: 12 octic_attention_fused_qkv,
# 12 mlp_d8_fused, 12 standard_attention, 12 dense_gelu. Each of the two
# student passes (global and local crops, train mode) runs per octic block the
# fused qkv + attention forward once (outside remat) and its backward chain
# once, fc1 and fc2 twice (forward and replay), and per standard block the
# attention forward and backward once and dense_gelu twice.
SSL_LAUNCHES = {"octic_attention_fused_qkv": 12 + 2 * 12, "octic_attention_fused_qkv_bwd": 2 * 12,
                "mlp_d8_fused": 12, "linear_d8_fused": 2 * 12 * 2 * 2,
                "standard_attention": 12 + 2 * 12, "standard_attention_bwd": 2 * 12,
                "dense_gelu": 12 + 2 * 12 * 2, "octic_attention": 0, "octic_attention_bwd": 0}
# launches of each kernel in one hybrid ViT-H/14 train step under remat: the
# attention kernels run once forward and once backward per block (remat saves
# their inputs and outputs); fc1/fc2 and dense_gelu run again in the replay
TRAIN_LAUNCHES = {"standard_attention": 16, "standard_attention_bwd": 16, "octic_attention": 16,
                  "octic_attention_bwd": 16, "linear_d8_fused": 64, "dense_gelu": 32,
                  "octic_attention_fused_qkv": 0, "mlp_d8_fused": 0,
                  "octic_attention_fused_qkv_bwd": 0}
# launches in one hybrid ViT-H/14 forward (16 octic blocks) on the two
# fused-glue inference paths, with the LN kernel on. A: norm1 through the LN
# kernel and norm2 ... ls2 + residual as one mlp_branch_d8 (its own LN, fc1
# and fc2 launches count under its name); no mlp_d8_fused. B: both norms
# through the LN kernel; proj (epilogue), fc1 (GELU) and fc2 (epilogue) as
# linear_d8_fused, of which the proj and fc2 count under linear_d8_epilogue
# too. The standard blocks and the fused qkv + attention as in P3.
GLUE_INFERENCE_LAUNCHES = {
    "fused_branch_inference": {"octic_attention_fused_qkv": 16, "standard_attention": 16,
                               "dense_gelu": 16, "ln_affine_d8_flat_tuple": 16,
                               "mlp_branch_d8": 16},
    "epilogue_inference": {"octic_attention_fused_qkv": 16, "standard_attention": 16,
                           "dense_gelu": 16, "ln_affine_d8_flat_tuple": 32, "linear_d8_fused": 48,
                           "linear_d8_epilogue": 32},
}
# launches in the DeiT III step of path C (TRAIN_LAUNCHES' model, plain octic
# linears): per octic block norm1 and norm2 run forward twice under remat
# (the forward and the replay) and backward once, and so does the D8-GELU
# between fc1 and fc2; no linear_d8_fused
GLUE_TRAIN_LAUNCHES = TRAIN_LAUNCHES | {"linear_d8_fused": 0, "ln_affine_d8_flat_tuple": 64,
                                        "ln_affine_d8_bwd": 32, "gelu_d8": 32, "gelu_d8_bwd": 16}
# the statistics-only LN pair, one forward and one backward of the module
LN_MODULE_LAUNCHES = {"ln_d8_flat_tuple": 1, "ln_d8_bwd": 1}
# launches in one inv-early ViT-H/14 forward (16 octic blocks) with the flat-E
# carry (P3's kernels) and with the packed carry (the packed ops instead)
INV_INFERENCE_LAUNCHES = {
    "inv_flat_inference": {"octic_attention_fused_qkv": 16, "mlp_d8_fused": 16,
                           "standard_attention": 16, "dense_gelu": 16},
    "packed_inference": {"octic_attention_fused_qkv_packed": 16, "mlp_d8_fused_packed": 16,
                         "standard_attention": 16, "dense_gelu": 16},
}
# launches in the packed DeiT III step (fuse_qkv, fuse_mlp, remat): per octic
# block the packed fused qkv + attention runs once forward (outside remat) and
# its backward chain once; the packed MLP runs in the remat region, forward
# and replay, and its backward (row 4's, which recomputes the hidden) once;
# no linear_d8_fused. The standard blocks as in TRAIN_LAUNCHES
# launches in one hybrid ViT-H/14 forward with use_wide_qkv: per octic block the
# wide-1d qkv product (one K-lin-d8 with the wide-1d store) and the wide-1d
# attention in place of the fused qkv + attention; the rest as in P3
WIDE_INFERENCE_LAUNCHES = {"linear_d8_wide1d": 16, "octic_attention_wide1d": 16,
                           "mlp_d8_fused": 16, "standard_attention": 16, "dense_gelu": 16}
# launches in the DeiT III step with use_wide_qkv (TRAIN_LAUNCHES' schedule):
# remat replays norm1 + the wide-1d product in the backward (2 a block) and
# keeps the attention's five inputs and six outputs, so the wide-1d attention
# runs once forward and once backward a block; fc1 and fc2 and the standard
# blocks as in TRAIN_LAUNCHES
WIDE_TRAIN_LAUNCHES = {"linear_d8_wide1d": 32, "octic_attention_wide1d": 16,
                       "octic_attention_wide1d_bwd": 16, "linear_d8_fused": 64,
                       "standard_attention": 16, "standard_attention_bwd": 16, "dense_gelu": 32}
# one forward + backward of segment C (P18): the row-13 chain
WIDE_SEGMENT_LAUNCHES = {"linear_d8_qkv_wide": 1, "octic_attention_wide": 1,
                         "octic_attention_wide_bwd": 1}
PACKED_TRAIN_LAUNCHES = {"octic_attention_fused_qkv_packed": 16,
                         "octic_attention_fused_qkv_packed_bwd": 16, "mlp_d8_fused_packed": 32,
                         "mlp_d8_fused_bwd": 16, "standard_attention": 16,
                         "standard_attention_bwd": 16, "dense_gelu": 32}


def expected_launches(table: dict) -> dict:
    """Every kernel op's launches: those of `table`, every other 0."""
    from octic_vits_tpu_torch import ops

    return {op.__name__: 0 for op in ops.KERNEL_OPS} | table


def kernel_phase(tag, cases_fn, shapes, gen, summary, record=True):
    """Run each case at each shape against its plain version. With `record`,
    time the first shape (kernel, plain version and, where there is one, the
    library call) and keep the times and that shape for the summary; without
    it the shapes are checked only. Raises if a kernel is outside its bar or
    its counter did not move."""
    failed = []
    for label, shape in shapes:
        with torch.no_grad():
            for name, kern, ref, args, scaled, lib in cases_fn(gen, *shape):
                out = kern(*args)
                torch.cuda.synchronize()
                expected = ref(*args)
                err, ok = compare(out, expected, scaled)
                entry = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                                  "library_ms": None})
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                bar = (f"{BWD_TOL}*(max|ref|+|ref|)" if scaled is True else
                       f"{ATOL}+{RTOL}*|ref|" if scaled is False else
                       f"{ATOL}+{RTOL}*|ref| on dx, {BWD_TOL}*(max|ref|+|ref|) on the rest")
                line = f"{name} [{label}] max_abs_err {err:.3e} (tol {bar}) "
                line += "ok" if ok else "FAIL"
                if record and label == shapes[0][0]:
                    before = kern.launches
                    ms = time_ms(lambda: kern(*args))
                    plain_ms = time_ms(lambda: ref(*args), iters=10)
                    if kern.launches <= before:
                        raise AssertionError(f"{name}: launch counter did not move")
                    # a kernel with several cases (fc1 and fc2) sums their times
                    entry["ms"] += ms
                    entry["plain_ms"] += plain_ms
                    entry["shape"] = shape
                    line += f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                    if lib is not None:
                        entry["library_ms"] = time_ms(lib)
                        line += f", library call {entry['library_ms']:.4f} ms"
                phase(tag, line)
                if not ok:
                    failed.append(f"{name}[{label}]")
                del out, expected
    if failed:
        raise AssertionError(f"kernels outside tolerance: {failed}")


def p2_cases(gen, *shape):
    return [case[:4] + (False, case[4]) for case in kernel_cases(gen, *shape)]


def grad_cosine(card_model, cpu_model) -> tuple:
    """Cosine similarity of the two models' whole flattened gradients (f64
    sums, one parameter at a time), their norms, and the number of values."""
    dot = nn_a = nn_b = 0.0
    count = 0
    for a, b in zip(card_model.parameters(), cpu_model.parameters(), strict=True):
        ga, gb = a.grad.detach().cpu().double(), b.grad.detach().double()
        dot += (ga * gb).sum().item()
        nn_a += ga.square().sum().item()
        nn_b += gb.square().sum().item()
        count += ga.numel()
    return dot / math.sqrt(nn_a * nn_b), math.sqrt(nn_a), math.sqrt(nn_b), count


def set_drop_path(model, rate: float) -> None:
    for m in model.modules():
        if hasattr(m, "draw"):  # DropPath / DropPathD8
            m.rate = rate


def train_setup(model, cfg):
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine

    opt = engine.build_optimizer(cfg, model)
    return common.create_train_state(model, opt, ema=True), engine.make_deit_train_step(
        model, cfg, opt)


def time_train_steps(state, step, images, labels, gen, steps=10, warmup=2):
    """Median host-clock ms of one synchronized train step."""
    times = []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, images, labels, gen)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError("non-finite loss while timing")
    return statistics.median(times), times


def convergence_check(steps: int = 60) -> tuple:
    """scripts/smoke_train_tpu.py:supervised_smoke on the port: a small hybrid
    (embed 128, depth 4, 4 heads) in bf16 compute fits 32 fixed images
    with AdamW 3e-4 (optax.adamw's default decay 1e-4); the loss must fall
    below half its first value."""
    from octic_vits_tpu_torch import init_weights
    from octic_vits_tpu_torch.models import OcticVisionTransformer
    from octic_vits_tpu_torch.train.common import cross_entropy_loss

    model = OcticVisionTransformer(img_size=64, patch_size=8, embed_dim=128, depth=4,
                                   num_heads=4, mlp_ratio=2.0, qkv_bias=True, num_classes=8,
                                   init_scale=1.0,
                                   compute_dtype=torch.bfloat16, device="cuda")
    init_weights(model, torch.Generator("cuda").manual_seed(SEED + 2))
    gen = torch.Generator("cuda").manual_seed(SEED)
    images = torch.randn(32, 64, 64, 3, generator=gen, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, 8, (32,), generator=gen, device="cuda")
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    model.train()
    losses = []
    for _ in range(steps + 1):
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(images), labels)
        losses.append(loss.item())
        if len(losses) <= steps:
            loss.backward()
            opt.step()
    return losses[0], losses[steps - 1], losses[steps]


def ssl_batch(b: int, seed: int, n_local: int = 8) -> dict:
    """A DINOv2 batch of random crops (2b global 224^2, n_local * b local 96^2)
    through the port's collate: iBOT masks on half the global crops, the
    masked-token buffer padded to its bound (octic_vits_tpu/train/dinov2/
    cli.py builds the generator the same way)."""
    import random

    import numpy as np

    from octic_vits_tpu_torch.train.dinov2.masking import MaskingGenerator, collate_crops_and_masks

    npr = np.random.default_rng(seed)
    grid = IMG // 16
    gc = npr.standard_normal((2 * b, IMG, IMG, 3), dtype=np.float32)
    lc = npr.standard_normal((n_local * b, LOCAL_IMG, LOCAL_IMG, 3), dtype=np.float32)
    gen = MaskingGenerator(grid, num_masking_patches=grid * grid // 2)
    return collate_crops_and_masks(gc, lc, grid * grid, gen, mask_probability=0.5,
                                   mask_ratio_tuple=(0.1, 0.5), rng=random.Random(seed))


def chain_times(gen, b, n, c, heads, packed=False) -> dict:
    """The fused backward chain at one shape (with bias): CUDA-event ms of the
    K-lin-d8 qkv recompute (the wide store) and of K-attn-bwd (route (a),
    with the cotangents' assembly); then K-lin-d8-bwd on their output, held
    against its plain version under the forward bar (dx, and dw1, dwe and
    dbias too: stricter than the backward bar), two launches bitwise equal, its device ms by
    CUDA-graph replay (tools/timing.py), its windowed ms, the host µs to
    enqueue one call and the cuBLAS yardstick's device ms. With `packed` the
    five inputs are the slot views of one packed container and dx lands in
    the views of one packed gradient (row 10b)."""
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f
    from octic_vits_tpu_torch.ops import attention as A
    from octic_vits_tpu_torch.ops import linear as Lin
    from octic_vits_tpu_torch.tools import timing
    from octic_vits_tpu_torch.tools.time_kernels import lin_d8_bwd_cublas

    ((_, _, _, (xs, w1, we, bq, gs, _), _, _),) = ssl_kernel_cases(gen, b, n, c, heads, True)
    out = None
    if packed:
        xs = unpack_packed_5f(randn(gen, b, n, c))
        out = unpack_packed_5f(torch.empty(b, n, c, device="cuda", dtype=torch.bfloat16))
    with torch.no_grad():
        qkv = Lin.lin_d8_wide_launch(xs, w1, we, bq, heads)
        dq = A._octic_wide_bwd_tuple(qkv, gs, heads)

        def kern():
            return Lin.lin_d8_bwd_launch(xs, w1, we, dq[:4], dq[4:], True, out=out)
        got = kern()
        first = tuple(t.clone() for t in tuple(got[0]) + got[1:])
        got = kern()
        torch.cuda.synchronize()
        got = tuple(got[0]) + got[1:]
        bitwise = all(torch.equal(x, y) for x, y in zip(first, got))
        ref = Lin.lin_d8_bwd_reference(xs, w1, we, dq[:4], dq[4:], bq)
        err, ok = compare(got, tuple(ref[0]) + ref[1:])
        return {
            "qkv_recompute": time_ms(lambda: Lin.lin_d8_wide_launch(xs, w1, we, bq, heads)),
            "attention_bwd": time_ms(lambda: A._octic_wide_bwd_tuple(qkv, gs, heads)),
            "lin_d8_bwd": timing.time_per_launch(kern, graph=True),
            "lin_d8_bwd_window": timing.time_per_launch(kern),
            "lin_d8_bwd_host_us": timing.host_us_per_call(kern),
            "lin_d8_bwd_cublas": timing.time_per_launch(
                lin_d8_bwd_cublas(xs, w1, we, dq[:4], dq[4:]), graph=True),
            "lin_d8_bwd_plain": time_ms(lambda: Lin.lin_d8_bwd_reference(xs, w1, we, dq[:4],
                                                                        dq[4:], bq), iters=10),
            "lin_d8_bwd_err": err, "lin_d8_bwd_ok": ok, "lin_d8_bwd_bitwise": bitwise,
        }


def time_ssl_steps(state, step, batch, sched, gen, steps=10, warmup=2):
    """Median host-clock ms of one synchronized SSL step, and every step's."""
    times = []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, sched, gen)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(metrics["total_loss"])):
        raise AssertionError("non-finite SSL loss while timing")
    return statistics.median(times), times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    card = gpu_name_and_power()
    print(card, flush=True)
    phase("P0", f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
                f"| count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from octic_vits_tpu_torch import create_model, init_weights, ops
    from octic_vits_tpu_torch.kernels import build, library
    from octic_vits_tpu_torch.train.common import bce_target_loss
    from octic_vits_tpu_torch.train.deit.engine import DeiTConfig

    lib_path, seconds = build(verbose=True)
    library()
    phase("P1", f"build: {seconds:.2f} s -> {lib_path}")

    gen = torch.Generator("cuda").manual_seed(SEED)
    summary = {}
    if sys.argv[1:] == ["--p25"]:  # P25 alone, for work on its kernels; prints no result
        summary = {"octic_attention": {"max_abs_err": 0.0},
                   "octic_attention_fused_qkv": {"max_abs_err": 0.0},
                   "standard_attention_bwd": {"max_abs_err": 0.0}}
        redesign_25_phases(gen, summary, card)
        return 1
    if sys.argv[1:] == ["--p26"]:  # P26 alone, likewise
        redesign_26_phases(gen, {"standard_attention_bwd": {}}, card)
        return 1
    kernel_phase("P2", p2_cases, (("vith14_b64", (BATCH, 257, 1280, 16, True)),
                                  ("ragged", (3, 65, 64, 2, False))), gen, summary)

    # ---- P3: the inference slice, full-width hybrid ViT-H/14 ----
    # on the CPU every op is its plain version: this model is the f32
    # reference of P3 (inference) and of P6 (training)
    torch.manual_seed(SEED)
    cpu_model = create_model("hybrid_deit_huge_patch14", init_scale=1.0, device="cpu").eval()
    init_weights(cpu_model, torch.Generator().manual_seed(SEED))
    model = create_model("hybrid_deit_huge_patch14", init_scale=1.0, device="cuda",
                         dtype=torch.bfloat16).eval()
    model.load_state_dict(cpu_model.state_dict(), strict=True)
    images = torch.randn(BATCH, IMG, IMG, 3, generator=torch.Generator().manual_seed(SEED + 1))
    images_gpu = images.to("cuda", torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = model(images_gpu)
    torch.cuda.synchronize()
    launches = {op.__name__: op.launches for op in ops.INFERENCE_OPS}
    if tuple(logits.shape) != (BATCH, 1000) or not bool(logits.isfinite().all()):
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    # 16 launches of each inference kernel and none of any other op: the
    # yardsticks that the redesigns replaced (ops.PARENT_OPS) stay at 0
    if ops.launch_counts() != expected_launches({name: 16 for name in launches}):
        raise AssertionError(f"expected 16 launches of each kernel and 0 of the others, got "
                             f"{ops.launch_counts()}")
    with torch.no_grad():
        ref = cpu_model(images[:2].to(torch.bfloat16).float())
    got = logits[:2].float().cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    phase("P3", f"hybrid_deit_huge_patch14 B={BATCH} bf16: logits {tuple(logits.shape)} finite, "
                f"launches {launches}, yardsticks "
                f"{ {op.__name__: op.launches for op in ops.PARENT_OPS} }; "
                f"2 images vs CPU f32 plain path: rel L2 err {rel:.3e} "
                f"(tol {SLICE_REL_TOL}), max abs err {(got - ref).abs().max().item():.3e}, "
                f"|ref| max {ref.abs().max().item():.3e}")
    if not rel <= SLICE_REL_TOL:
        raise AssertionError("hybrid logits disagree with the CPU f32 plain path")

    # ---- P4: inference timing, hybrid vs standard ----
    std = create_model("deit_huge_patch14_LS", device="cuda", dtype=torch.bfloat16).eval()
    init_weights(std, torch.Generator("cuda").manual_seed(SEED))
    with torch.no_grad():
        ms_h = time_ms(lambda: model(images_gpu), iters=10, warmup=2)
        ms_s = time_ms(lambda: std(images_gpu), iters=10, warmup=2)
        ms_h2 = time_ms(lambda: model(images_gpu), iters=10, warmup=1)
    ips_h, ips_s = BATCH / (min(ms_h, ms_h2) / 1e3), BATCH / (ms_s / 1e3)
    phase("P4", f"B={BATCH} 224^2 bf16 on {card}: hybrid {ips_h:.1f} img/s "
                f"({ms_h:.2f} / {ms_h2:.2f} ms), standard {ips_s:.1f} img/s ({ms_s:.2f} ms), "
                f"ratio hybrid/standard {ips_h / ips_s:.4f}")
    del model, std, logits, images_gpu
    torch.cuda.empty_cache()

    # ---- P5: the train path's kernels ----
    kernel_phase("P5", train_kernel_cases, (("vith14_b32", (TRAIN_BATCH, 257, 1280, 16, True)),
                                            ("ragged", (3, 65, 64, 2, False))), gen, summary)
    torch.cuda.empty_cache()

    # ---- P6: the train slice, full-width full-depth hybrid ViT-H/14 ----
    cfg = DeiTConfig()  # the paper recipe: LAMB, clip 1.0, EMA, BCE, mixup/cutmix
    train_model = create_model("hybrid_deit_huge_patch14", init_scale=1.0, remat=True, drop_path_rate=cfg.drop_path,
                               compute_dtype=torch.bfloat16, device="cuda")
    train_model.load_state_dict(cpu_model.state_dict(), strict=True)
    state, step = train_setup(train_model, cfg)
    tgen = torch.Generator().manual_seed(SEED + 3)
    timages = torch.randn(TRAIN_BATCH, IMG, IMG, 3, generator=tgen).cuda()
    tlabels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=tgen).cuda()
    ops.reset_launch_counts()
    state, metrics = step(state, timages, tlabels, tgen)
    torch.cuda.synchronize()
    train_launches = ops.launch_counts()
    finite_grads = all(bool(torch.isfinite(p.grad).all()) for p in train_model.parameters())
    loss = metrics["loss"].item()
    phase("P6", f"hybrid_deit_huge_patch14 train step B={TRAIN_BATCH} (f32 params, bf16 compute, "
                f"remat, LAMB, mixup/cutmix, drop path {cfg.drop_path}): loss {loss:.4f}, "
                f"grad norm {metrics['grad_norm'].item():.4f}, finite grads {finite_grads}, "
                f"launches {train_launches}")
    if not (math.isfinite(loss) and finite_grads):
        raise AssertionError("non-finite loss or gradients in the train step")
    if train_launches != expected_launches(TRAIN_LAUNCHES):
        raise AssertionError(f"train launches {train_launches}, expected {TRAIN_LAUNCHES}")

    # deterministic step on 2 images against the CPU f32 plain path
    det_cfg = DeiTConfig(mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0)
    set_drop_path(train_model, 0.0)
    train_model.load_state_dict(cpu_model.state_dict(), strict=True)
    det_state, det_step = train_setup(train_model, det_cfg)
    dimages = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(SEED + 4))
    dimages = dimages.to(torch.bfloat16).float()
    dlabels = torch.tensor([3, 977])
    det_state, det_metrics = det_step(det_state, dimages.cuda(), dlabels.cuda(),
                                      torch.Generator().manual_seed(SEED))
    cpu_model.train()
    targets = torch.nn.functional.one_hot(dlabels, 1000).float()
    cpu_loss = bce_target_loss(cpu_model(dimages), targets)
    cpu_loss.backward()
    cos, _, norm_cpu, count = grad_cosine(train_model, cpu_model)
    loss_rel = abs(det_metrics["loss"].item() - cpu_loss.item()) / abs(cpu_loss.item())
    phase("P6", f"deterministic step, 2 images: loss card {det_metrics['loss'].item():.6f} vs CPU "
                f"f32 {cpu_loss.item():.6f} (rel err {loss_rel:.3e}, tol {SLICE_REL_TOL}); "
                f"gradient cosine {cos:.6f} (min {GRAD_COS_MIN}) over {count} values; grad "
                f"norm card {det_metrics['grad_norm'].item():.4f} vs CPU {norm_cpu:.4f}")
    if not (loss_rel <= SLICE_REL_TOL and cos >= GRAD_COS_MIN):
        raise AssertionError("train step disagrees with the CPU f32 plain path")
    del det_state, det_step  # cpu_model keeps its f32 gradients for P14

    first, last, after = convergence_check()
    phase("P6", f"convergence (embed 128, depth 4, 4 heads, B=32, AdamW 3e-4, 60 steps, bf16): "
                f"loss {first:.4f} -> {last:.4f} (after the last update {after:.4f}); "
                f"must fall below {0.5 * first:.4f}")
    if not (math.isfinite(last) and last < 0.5 * first):
        raise AssertionError("the small model did not fit its batch")

    # ---- P7: train-step timing, hybrid vs standard ----
    set_drop_path(train_model, cfg.drop_path)
    state, step = train_setup(train_model, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms_th, times_h = time_train_steps(state, step, timages, tlabels, tgen)
    mem_h = torch.cuda.max_memory_allocated()
    del state, step, train_model
    torch.cuda.empty_cache()
    std_model = create_model("deit_huge_patch14_LS", remat=True, drop_path_rate=cfg.drop_path,
                             compute_dtype=torch.bfloat16, device="cuda")
    init_weights(std_model, torch.Generator("cuda").manual_seed(SEED))
    state, step = train_setup(std_model, cfg)
    torch.cuda.reset_peak_memory_stats()
    ms_ts, times_s = time_train_steps(state, step, timages, tlabels, tgen)
    mem_s = torch.cuda.max_memory_allocated()
    del state, step, std_model
    phase("P7", f"train step B={TRAIN_BATCH} 224^2 (f32 params, bf16 compute, remat, LAMB, EMA) "
                f"on {card}: hybrid {ms_th:.2f} ms ({TRAIN_BATCH / ms_th * 1e3:.1f} img/s, "
                f"peak {mem_h / 2**30:.2f} GiB), standard {ms_ts:.2f} ms "
                f"({TRAIN_BATCH / ms_ts * 1e3:.1f} img/s, peak {mem_s / 2**30:.2f} GiB), "
                f"ratio hybrid/standard img/s {ms_ts / ms_th:.4f}; "
                f"step ms hybrid {[round(t, 2) for t in times_h]}, "
                f"standard {[round(t, 2) for t in times_s]}")

    torch.cuda.empty_cache()
    ssl_launches = ssl_phases(gen, summary, card)

    torch.cuda.empty_cache()
    det = dict(cfg=cfg, det_cfg=det_cfg, images=dimages, labels=dlabels, cpu_loss=cpu_loss.item(),
               timages=timages, tlabels=tlabels, tgen=tgen)
    glue_launches = glue_phases(gen, summary, card, cpu_model, images, ref, det)

    torch.cuda.empty_cache()
    packed_launches = packed_phases(gen, summary, card, cpu_model, images, det)

    torch.cuda.empty_cache()
    wide_launches = wide_phases(gen, summary, card, cpu_model, images, ref, det)

    torch.cuda.empty_cache()
    probe_launches = probe_phases(gen, summary, card)

    torch.cuda.empty_cache()
    probe_14b_launches = probe_14b_phases(gen, summary, card)

    torch.cuda.empty_cache()
    probe_14c_launches = probe_14c_phases(gen, summary, card)

    torch.cuda.empty_cache()
    redesign_phases(gen, summary, card)

    torch.cuda.empty_cache()
    probe_25_launches = redesign_25_phases(gen, summary, card)

    torch.cuda.empty_cache()
    probe_26_launches = redesign_26_phases(gen, summary, card)

    counts = {"inference": launches, "train": train_launches, "ssl": ssl_launches,
              **glue_launches, **packed_launches, **wide_launches, "probe": probe_launches,
              "probe_14b": probe_14b_launches, "probe_14c": probe_14c_launches,
              "probe_25": probe_25_launches, "probe_26": probe_26_launches}
    kernels = []
    for name, (source, replaces, path) in META.items():
        e = summary[name]
        n = counts[path][name]
        if n == 0:
            raise AssertionError(f"{name} was not launched on the {path} path")
        bound_ms, bound_by = e["bound"] if "bound" in e else bound(name, e["shape"])
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": n, "path": path, "max_abs_err": e["max_abs_err"],
                        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": e["library_ms"],
                        "shape": list(e["shape"]),
                        "launches_by_path": {p: c[name] for p, c in counts.items() if c.get(name)}})
        if name in ALSO:
            kernels[-1]["also"] = ALSO[name]
        if "cases" in e:  # the row-14b and 14c ops' other cases (tiles, shapes, groups)
            kernels[-1]["cases"] = e["cases"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ssl_phases(gen, summary, card) -> dict:
    """P8-P10, the DINOv2 slice. Returns the launches of the P9 step."""
    from octic_vits_tpu_torch import init_weights, ops
    from octic_vits_tpu_torch.train.dinov2.schedules import sqrt_lr_scaling
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import (
        SSLConfig,
        SSLMetaArch,
        batch_to_device,
    )

    # ---- P8: the SSL kernels at the hybrid ViT-L/16 B=32 shapes ----
    l16 = (("vitl16_global_b32", (2 * SSL_BATCH, 197, 1024, 16, True)),
           ("vitl16_local_b32", (8 * SSL_BATCH, 37, 1024, 16, True)),
           ("ragged", (3, 65, 64, 2, False)))
    kernel_phase("P8", ssl_kernel_cases, l16, gen, summary)
    # K-lin-d8-bwd's shapes on the main paths: the SSL step's L/16 global and
    # local crops (row 2b) and the packed DeiT step's H/14 B=32 (row 10b)
    from octic_vits_tpu_torch.tools.time_kernels import LIN_BWD_SHAPES

    cases = {}
    for label, b, n, c, packed in LIN_BWD_SHAPES:
        ct = chain_times(gen, b, n, c, 16, packed)
        lb_ms, lb_by = bound_lin_d8_bwd(b, n, c)
        phase("P8", f"fused qkv + attention backward chain at {label} ({b} x {n}, C={c}"
                    f"{', packed' if packed else ''}): K-lin-d8 recompute "
                    f"{ct['qkv_recompute']:.4f} ms, K-attn-bwd {ct['attention_bwd']:.4f} ms; "
                    f"K-lin-d8-bwd {ct['lin_d8_bwd']:.4f} ms device (CUDA-graph replay; "
                    f"windowed {ct['lin_d8_bwd_window']:.4f} ms; bound {lb_ms:.4f} ms by {lb_by}, "
                    f"{lb_ms / ct['lin_d8_bwd']:.1%} of it; cuBLAS's products "
                    f"{ct['lin_d8_bwd_cublas']:.4f} ms; plain {ct['lin_d8_bwd_plain']:.4f} ms), "
                    f"host {ct['lin_d8_bwd_host_us']:.1f} us to enqueue; max_abs_err "
                    f"{ct['lin_d8_bwd_err']:.3e} {'ok' if ct['lin_d8_bwd_ok'] else 'FAIL'}, two "
                    f"launches {'bitwise equal' if ct['lin_d8_bwd_bitwise'] else 'DIFFER'}")
        if not ct["lin_d8_bwd_ok"]:
            raise AssertionError(f"K-lin-d8-bwd outside tolerance at {label}")
        if not ct["lin_d8_bwd_bitwise"]:
            raise AssertionError(f"K-lin-d8-bwd: two launches differ at {label}")
        cases[f"lin_d8_bwd[{label}]"] = {
            "ms": ct["lin_d8_bwd"], "bound_ms": lb_ms, "bound_by": lb_by,
            "cublas_ms": ct["lin_d8_bwd_cublas"], "host_us": ct["lin_d8_bwd_host_us"],
            "max_abs_err": ct["lin_d8_bwd_err"]}
    summary["octic_attention_fused_qkv_bwd"]["cases"] = cases
    # the SSL step runs every other kernel at these shapes too: correctness only
    kernel_phase("P8", p2_cases, l16[:2], gen, summary, record=False)
    kernel_phase("P8", train_kernel_cases, l16[:2], gen, summary, record=False)
    torch.cuda.empty_cache()

    # ---- P9: one DINOv2 step of the full-size hybrid ViT-L/16 at B=32 ----
    cfg = SSLConfig(backbone_remat=True)  # drop path 0.3, heads 65536, bf16 compute
    arch = SSLMetaArch(cfg, device="cuda")
    state = arch.init(torch.Generator("cuda").manual_seed(SEED))
    step = arch.make_train_step()
    lr = sqrt_lr_scaling(4e-3, SSL_BATCH)  # the recipe's base lr after warmup
    sched = dict(lr=lr, wd=0.04, last_layer_lr=lr, momentum=0.992, teacher_temp=0.04)
    batch = batch_to_device(ssl_batch(SSL_BATCH, SEED + 5), "cuda")
    sgen = torch.Generator().manual_seed(SEED + 6)
    ops.reset_launch_counts()
    state, metrics = step(state, batch, sched, sgen)
    torch.cuda.synchronize()
    ssl_launches = ops.launch_counts()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in state.student.parameters())
    finite &= bool(torch.isfinite(state.dino_center).all() and torch.isfinite(
        state.ibot_center).all()) and state.dino_center.abs().max().item() > 0
    loss = metrics["total_loss"].item()
    terms = {k: round(v.item(), 5) for k, v in metrics.items()}
    n_params = sum(p.numel() for p in state.student.parameters())
    phase("P9", f"{cfg.arch} SSL step B={SSL_BATCH} ({2 * SSL_BATCH} global 224^2 + "
                f"{8 * SSL_BATCH} local 96^2 crops, {int(batch['n_masked_patches'])} masked "
                f"tokens of a {batch['mask_indices'].numel()} buffer; f32 params "
                f"({n_params} in the student), bf16 compute, remat, drop path "
                f"{cfg.drop_path_rate}): {terms}; finite grads and centers {finite}; "
                f"launches {ssl_launches}")
    if not (math.isfinite(loss) and finite):
        raise AssertionError("non-finite SSL loss, gradients or centers")
    if ssl_launches != expected_launches(SSL_LAUNCHES):
        raise AssertionError(f"SSL launches {ssl_launches}, expected {SSL_LAUNCHES}")

    # deterministic step on B=2 against the same weights in f32 on the CPU
    # (LayerScale 1.0 so that the blocks are not hidden behind 1e-5)
    det = dict(drop_path_rate=0.0)
    cpu_arch = SSLMetaArch(SSLConfig(compute_dtype=None, **det), device="cpu", init_scale=1.0)
    cpu_student = cpu_arch.build_student()
    init_weights(cpu_student, torch.Generator().manual_seed(SEED))
    card_arch = SSLMetaArch(SSLConfig(backbone_remat=True, **det), device="cuda", init_scale=1.0)
    card_student = card_arch.build_student()
    card_student.load_state_dict(cpu_student.state_dict(), strict=True)
    dbatch = ssl_batch(2, SEED + 7)
    card_loss, _ = card_arch.forward_backward(card_arch.state_from_student(card_student),
                                              batch_to_device(dbatch, "cuda"), 0.04)
    cpu_loss, _ = cpu_arch.forward_backward(cpu_arch.state_from_student(cpu_student),
                                            batch_to_device(dbatch, "cpu"), 0.04)
    cos, _, norm_cpu, count = grad_cosine(card_student, cpu_student)
    loss_rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    phase("P9", f"deterministic SSL step, B=2: loss card {card_loss.item():.6f} vs CPU f32 "
                f"{cpu_loss.item():.6f} (rel err {loss_rel:.3e}, tol {SLICE_REL_TOL}); gradient "
                f"cosine {cos:.6f} (min {GRAD_COS_MIN}) over {count} values; CPU grad norm "
                f"{norm_cpu:.4f}")
    if not (loss_rel <= SLICE_REL_TOL and cos >= GRAD_COS_MIN):
        raise AssertionError("SSL step disagrees with the CPU f32 plain path")
    del cpu_student, card_student, cpu_arch, card_arch

    # ---- P10: SSL step timing, hybrid against the standard ViT-L/16 ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms_h, times_h = time_ssl_steps(state, step, batch, sched, sgen)
    mem_h = torch.cuda.max_memory_allocated()
    del state, step, arch
    torch.cuda.empty_cache()
    std_arch = SSLMetaArch(SSLConfig(arch="dinov2_vit_large_patch16", backbone_remat=True),
                           device="cuda")
    std_state = std_arch.init(torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.reset_peak_memory_stats()
    ms_s, times_s = time_ssl_steps(std_state, std_arch.make_train_step(), batch, sched, sgen)
    mem_s = torch.cuda.max_memory_allocated()
    del std_state, std_arch
    torch.cuda.empty_cache()
    phase("P10", f"SSL step B={SSL_BATCH} (L/16, 2 global + 8 local crops per image, f32 params, "
                 f"bf16 compute, remat, AdamW, EMA) on {card}: hybrid {ms_h:.2f} ms "
                 f"({SSL_BATCH / ms_h * 1e3:.1f} img/s, range {min(times_h):.2f}-"
                 f"{max(times_h):.2f} ms, peak {mem_h / 2**30:.2f} GiB), standard {ms_s:.2f} ms "
                 f"({SSL_BATCH / ms_s * 1e3:.1f} img/s, range {min(times_s):.2f}-"
                 f"{max(times_s):.2f} ms, peak {mem_s / 2**30:.2f} GiB), ratio hybrid/standard "
                 f"img/s {ms_s / ms_h:.4f}; step ms hybrid {[round(t, 2) for t in times_h]}, "
                 f"standard {[round(t, 2) for t in times_s]}")
    return ssl_launches


def tuple5(gen, b, n, c8, shift=0.0):
    """A flat-E 5-tuple on the card: a* [b, n, c8], ef [b, n, 4 c8]."""
    return tuple(randn(gen, b, n, c8) + shift for _ in range(4)) + (
        randn(gen, b, n, 4 * c8) - shift,)


def ln_params(gen, c8, dtype):
    """alpha [4, c8], alpha_ef [1, 4 c8] near 1 and beta [1, c8], in `dtype`."""
    al = 1.0 + 0.2 * torch.randn(4, c8, generator=gen, device="cuda")
    ae = 1.0 + 0.2 * torch.randn(1, 4 * c8, generator=gen, device="cuda")
    be = 0.2 * torch.randn(1, c8, generator=gen, device="cuda")
    return tuple(t.to(dtype) for t in (al, ae, be))


def glue_b64_cases(gen, b, n, c, heads, bias):
    """P11 at the inference batch: the LN forward with its affine (bf16
    parameters, as the bf16 model holds them), the statistics-only pair (its
    backward from the plain version's saved output and var), the proj with
    the LayerScale + residual epilogue, and the fused MLP branch."""
    from octic_vits_tpu_torch import ops

    c8, h8 = c // 8, c // 2
    opt = lambda t: t if bias else None  # noqa: E731
    xs, us = tuple5(gen, b, n, c8, shift=0.5), tuple5(gen, b, n, c8)
    outs, var = ops.ln_d8_reference(xs)
    w1, we = randn(gen, 4, c8, c8, scale=c8 ** -0.5), randn(gen, 2 * c8, 2 * c8,
                                                            scale=(2 * c8) ** -0.5)
    ls = (randn(gen, 4, c8, scale=0.5), randn(gen, 2 * c8, scale=0.5))
    al, ae, be = ln_params(gen, c8, torch.bfloat16)
    zero = lambda k: torch.zeros(k, device="cuda", dtype=torch.bfloat16)  # noqa: E731
    params11 = (al, ae[0, :2 * c8], be[0] if bias else zero(c8),
                randn(gen, 4, c8, h8, scale=c8 ** -0.5),
                randn(gen, 2 * c8, 2 * h8, scale=(2 * c8) ** -0.5),
                randn(gen, h8, scale=0.1) if bias else zero(h8),
                randn(gen, 4, h8, c8, scale=h8 ** -0.5),
                randn(gen, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5),
                randn(gen, c8, scale=0.1) if bias else zero(c8)) + ls
    return [
        ("ln_affine_d8_flat_tuple", ops.ln_affine_d8_flat_tuple, ops.ln_affine_d8_reference,
         (xs, al, ae, be), False, None),
        ("ln_d8_flat_tuple", ops.ln_d8_flat_tuple, lambda x: ops.ln_d8_reference(x)[0], (xs,),
         False, None),
        ("ln_d8_bwd", ops.ln_d8_bwd, ops.ln_d8_bwd_reference, (outs, var, us), False, None),
        ("linear_d8_epilogue", ops.linear_d8_epilogue,
         lambda x, w, v, bb, s, r: ops.linear_d8_fused_reference(x, w, v, bb, False, s, r),
         (xs, w1, we, opt(randn(gen, c8, scale=0.1)), ls, us), False, None),
        ("mlp_branch_d8", ops.mlp_branch_d8, ops.mlp_branch_d8_reference, (xs, params11), False,
         None),
    ]


def glue_b32_cases(gen, b, n, c, heads, bias):
    """P11 at the train batch: the affine LN backward (f32 parameters, as the
    train step holds them; dx against the forward bar, the parameter
    gradients, f32 sums over the tokens, against the scaled one) and the
    D8-GELU forward and backward on the MLP hidden (4C wide)."""
    from octic_vits_tpu_torch import ops

    c8, h8 = c // 8, c // 2
    xs, us = tuple5(gen, b, n, c8, shift=0.5), tuple5(gen, b, n, c8)
    al, ae, _ = ln_params(gen, c8, torch.float32)
    hs, gs = tuple5(gen, b, n, h8), tuple5(gen, b, n, h8)
    return [
        ("ln_affine_d8_bwd", ops.ln_affine_d8_bwd, ops.ln_affine_d8_bwd_reference,
         (xs, al, ae, us), (False,) * 5 + (True,) * 3, None),
        ("gelu_d8", ops.gelu_d8, ops.gelu_d8_reference, (hs,), False, None),
        ("gelu_d8_bwd", ops.gelu_d8_bwd, ops.gelu_d8_bwd_reference, (hs, gs), False, None),
    ]


# The affine LN backward's device ms before its redesign (csrc/ln_d8.cu at
# f5ef818: CTAs of 16 rows, the parameter sums in shared memory), by
# CUDA-graph replay in tools/time_kernels.py (ln_bwd[shape]) on an NVIDIA H100
# 80GB HBM3 at 700 W: its two turns in the A/B of PERF.md section 6, row 8
PARENT_LN_BWD_MS = {"h14_b32": "0.0707-0.0709", "l16_global": "0.0900-0.0903",
                    "ragged": "0.0066-0.0068"}


def ln_bwd_checks(gen) -> dict:
    """P11's affine LN backward (row 8) at tools/time_kernels.LN_BWD_SHAPES:
    f32 scales as the train step holds them; dx against the forward bar and
    the parameter gradients against the backward bar, two launches bitwise
    equal, the device ms by CUDA-graph replay (tools/timing.py) beside its
    bound, its plain version's ms and the parent's. Raises on a failed check;
    returns each shape's numbers under ``ln_bwd[shape]``."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.tools import timing
    from octic_vits_tpu_torch.tools.time_kernels import LN_BWD_SHAPES

    cases, failed = {}, []
    for label, b, n, c8 in LN_BWD_SHAPES:
        xs, us = tuple5(gen, b, n, c8, shift=0.5), tuple5(gen, b, n, c8)
        al, ae, _ = ln_params(gen, c8, torch.float32)

        def kern():
            return ops.ln_affine_d8_bwd(xs, al, ae, us)
        with torch.no_grad():
            first = tuple(t.clone() for t in flat(kern()))
            got = flat(kern())
            torch.cuda.synchronize()
            bitwise = all(torch.equal(x, y) for x, y in zip(first, got, strict=True))
            ref = ops.ln_affine_d8_bwd_reference(xs, al, ae, us)
            err, ok = compare(got, flat(ref), (False,) * 5 + (True,) * 3)
            ms = timing.time_per_launch(kern, graph=True)
            plain_ms = time_ms(lambda: ops.ln_affine_d8_bwd_reference(xs, al, ae, us), iters=10)
        b_ms, b_by = bound("ln_affine_d8_bwd", (b, n, 8 * c8, 0, False))
        phase("P11", f"affine LN backward at {label} ({b} x {n}, c={c8}): {ms:.4f} ms device "
                     f"(CUDA-graph replay; bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it; "
                     f"parent {PARENT_LN_BWD_MS[label]} ms; plain {plain_ms:.4f} ms); "
                     f"max_abs_err {err:.3e} (dx {ATOL}+{RTOL}*|ref|, parameters "
                     f"{BWD_TOL}*(max|ref|+|ref|)) {'ok' if ok else 'FAIL'}, two launches "
                     f"{'bitwise equal' if bitwise else 'DIFFER'}")
        if not (ok and bitwise):
            failed.append(label)
        cases[f"ln_bwd[{label}]"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                                     "plain_ms": plain_ms, "max_abs_err": err}
        del xs, us, first, got, ref
    if failed:
        raise AssertionError(f"affine LN backward outside its bars or not repeatable: {failed}")
    return cases


def with_ln_kernel(on: bool) -> None:
    """The D8 LayerNorm kernel switch (OCTIC_PALLAS_LN), read at each call."""
    from octic_vits_tpu_torch.layers import d8_layers

    d8_layers.OCTIC_PALLAS_LN = on


def glue_phases(gen, summary, card, cpu_model, images, ref, det) -> dict:
    """P11-P14, the octic block's fused glue. `cpu_model` is P3's f32 model
    on the CPU (with P6's deterministic-step gradients), `images` P3's batch
    and `ref` its f32 logits of the first two images; `det` holds P6's
    configs, batches and CPU loss. Returns the launches of each path."""
    from octic_vits_tpu_torch import create_model, ops
    from octic_vits_tpu_torch.layers.d8_layers import LayerNormD8

    h14 = (BATCH, 257, 1280, 16, True)
    ragged = ("ragged", (3, 65, 64, 2, False))
    # ---- P11: the glue kernels against their plain versions ----
    kernel_phase("P11", glue_b64_cases, (("vith14_b64", h14), ragged), gen, summary)
    kernel_phase("P11", glue_b32_cases, (("vith14_b32", (TRAIN_BATCH,) + h14[1:]), ragged), gen,
                 summary)
    summary["ln_affine_d8_bwd"]["cases"] = ln_bwd_checks(gen)
    with_ln_kernel(True)
    c8 = h14[2] // 8
    xs = tuple(t.requires_grad_() for t in tuple5(gen, BATCH, 257, c8, shift=0.5))
    norm = LayerNormD8(h14[2], elementwise_affine=False, use_kernel=True)
    ops.reset_launch_counts()
    torch.autograd.backward(norm(xs), tuple5(gen, BATCH, 257, c8))
    torch.cuda.synchronize()
    module_launches = ops.launch_counts()
    finite = all(bool(torch.isfinite(x.grad).all()) for x in xs)
    phase("P11", f"LayerNormD8(elementwise_affine=False) forward + backward at B={BATCH}: "
                 f"finite grads {finite}, launches {LN_MODULE_LAUNCHES}")
    if not finite or module_launches != expected_launches(LN_MODULE_LAUNCHES):
        raise AssertionError(f"statistics-only LN module: launches {module_launches}")
    del xs, norm
    counts = {"ln_stats_module": module_launches}

    # ---- P12, P13: the fused-branch and the epilogue inference paths ----
    images_gpu = images.to("cuda", torch.bfloat16)
    models = {}
    for tag, path, flags in (("P12", "fused_branch_inference", dict(fuse_mlp_branch=True)),
                             ("P13", "epilogue_inference", dict(fuse_block_epilogues=True)),
                             (None, "P4 hybrid", {})):
        m = create_model("hybrid_deit_huge_patch14", init_scale=1.0, dtype=torch.bfloat16,
                         **flags).eval()
        m.load_state_dict(cpu_model.state_dict(), strict=True)
        models[path] = m
        if tag is None:
            continue
        ops.reset_launch_counts()
        with torch.no_grad():
            logits = m(images_gpu)
        torch.cuda.synchronize()
        counts[path] = ops.launch_counts()
        got = logits[:2].float().cpu()
        rel = ((got - ref).norm() / ref.norm()).item()
        phase(tag, f"hybrid_deit_huge_patch14 B={BATCH} bf16, {flags}, LN kernel on: logits "
                   f"{tuple(logits.shape)} finite {bool(logits.isfinite().all())}; launches "
                   f"{ {k: v for k, v in counts[path].items() if v} }; 2 images vs P3's CPU f32 "
                   f"logits: rel L2 err {rel:.3e} (tol {SLICE_REL_TOL})")
        if tuple(logits.shape) != (BATCH, ref.shape[-1]) or not bool(logits.isfinite().all()):
            raise AssertionError(f"{path}: bad logits")
        if counts[path] != expected_launches(GLUE_INFERENCE_LAUNCHES[path]):
            raise AssertionError(f"{path}: launches differ from {GLUE_INFERENCE_LAUNCHES[path]}")
        if not rel <= SLICE_REL_TOL:
            raise AssertionError(f"{path}: logits disagree with the CPU f32 plain path")
        del logits
    # img/s in turns: P4's configuration (LN kernel off) and the two paths
    times = {path: [] for path in models}
    with torch.no_grad():
        for path in ("P4 hybrid", "fused_branch_inference", "epilogue_inference",
                     "epilogue_inference", "fused_branch_inference", "P4 hybrid"):
            with_ln_kernel(path != "P4 hybrid")
            times[path].append(time_ms(lambda: models[path](images_gpu), iters=10, warmup=2))
    ips = {path: BATCH / (min(t) / 1e3) for path, t in times.items()}
    phase("P13", f"B={BATCH} 224^2 bf16 on {card}, in turns: "
                 + ", ".join(f"{p} {ips[p]:.1f} img/s ({' / '.join(f'{t:.2f}' for t in times[p])} "
                             f"ms)" for p in times)
                 + f"; ratio to P4's hybrid: A {ips['fused_branch_inference'] / ips['P4 hybrid']:.4f}"
                 f", B {ips['epilogue_inference'] / ips['P4 hybrid']:.4f}")
    del models, images_gpu
    torch.cuda.empty_cache()

    # ---- P14: path C, the DeiT III step with plain linears and the kernels ----
    with_ln_kernel(True)
    cfg = det["cfg"]
    model_c = create_model("hybrid_deit_huge_patch14", init_scale=1.0, remat=True,
                           drop_path_rate=cfg.drop_path, compute_dtype=torch.bfloat16,
                           use_pallas_linear=False, use_pallas_gelu=True)
    model_c.load_state_dict(cpu_model.state_dict(), strict=True)
    state, step = train_setup(model_c, cfg)
    ops.reset_launch_counts()
    state, metrics = step(state, det["timages"], det["tlabels"], det["tgen"])
    torch.cuda.synchronize()
    counts["glue_train"] = ops.launch_counts()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in model_c.parameters())
    loss = metrics["loss"].item()
    phase("P14", f"path C train step B={TRAIN_BATCH} (use_pallas_linear=False, use_pallas_gelu="
                 f"True, LN kernel on; the P6 recipe): loss {loss:.4f}, grad norm "
                 f"{metrics['grad_norm'].item():.4f}, finite grads {finite}, launches "
                 f"{ {k: v for k, v in counts['glue_train'].items() if v} }")
    if not (math.isfinite(loss) and finite):
        raise AssertionError("path C: non-finite loss or gradients")
    if counts["glue_train"] != expected_launches(GLUE_TRAIN_LAUNCHES):
        raise AssertionError(f"path C launches differ from {GLUE_TRAIN_LAUNCHES}")
    del state, step
    set_drop_path(model_c, 0.0)
    model_c.load_state_dict(cpu_model.state_dict(), strict=True)
    det_state, det_step = train_setup(model_c, det["det_cfg"])
    _, det_metrics = det_step(det_state, det["images"].cuda(), det["labels"].cuda(),
                              torch.Generator().manual_seed(SEED))
    cos, _, norm_cpu, count = grad_cosine(model_c, cpu_model)
    card_loss = det_metrics["loss"].item()
    loss_rel = abs(card_loss - det["cpu_loss"]) / abs(det["cpu_loss"])
    phase("P14", f"deterministic step, 2 images: loss card {card_loss:.6f} vs P6's CPU f32 "
                 f"{det['cpu_loss']:.6f} (rel err {loss_rel:.3e}, tol {SLICE_REL_TOL}); gradient "
                 f"cosine {cos:.6f} (min {GRAD_COS_MIN}) over {count} values; grad norm card "
                 f"{det_metrics['grad_norm'].item():.4f} vs CPU {norm_cpu:.4f}")
    if not (loss_rel <= SLICE_REL_TOL and cos >= GRAD_COS_MIN):
        raise AssertionError("path C step disagrees with the CPU f32 plain path")
    del det_state, det_step
    # step ms in turns: P7's hybrid (LN kernel off) and path C
    set_drop_path(model_c, cfg.drop_path)
    base = create_model("hybrid_deit_huge_patch14", init_scale=1.0, remat=True,
                        drop_path_rate=cfg.drop_path, compute_dtype=torch.bfloat16)
    base.load_state_dict(cpu_model.state_dict(), strict=True)
    runs = {"P7 hybrid": train_setup(base, cfg), "path C": train_setup(model_c, cfg)}
    times = {k: [] for k in runs}
    for key in ("P7 hybrid", "path C", "path C", "P7 hybrid"):
        with_ln_kernel(key == "path C")
        state, step = runs[key]
        _, t = time_train_steps(state, step, det["timages"], det["tlabels"], det["tgen"],
                                steps=5, warmup=1)
        times[key] += t
    med = {k: statistics.median(t) for k, t in times.items()}
    phase("P14", f"train step B={TRAIN_BATCH} 224^2 on {card}, in turns (5 steps each, twice): "
                 + ", ".join(f"{k} median {med[k]:.2f} ms ({TRAIN_BATCH / med[k] * 1e3:.1f} img/s, "
                             f"range {min(times[k]):.2f}-{max(times[k]):.2f})" for k in times)
                 + f"; ratio path C / P7 img/s {med['P7 hybrid'] / med['path C']:.4f}")
    with_ln_kernel(False)
    del runs, base, model_c
    torch.cuda.empty_cache()
    return counts


def packed_b64_cases(gen, b, n, c, heads, bias):
    """P15 at the inference batch: the fused qkv + attention (row 10) and the
    fused MLP (row 11) on one packed [B, N, C] container, which the kernels
    read in place through its slot views."""
    from octic_vits_tpu_torch import ops

    c8, h8 = c // 8, c // 2
    opt = lambda t: t if bias else None  # noqa: E731
    x = randn(gen, b, n, c)
    wq1, wqe = randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5), randn(gen, 2 * c8, 6 * c8,
                                                                   scale=(2 * c8) ** -0.5)
    mlp = (randn(gen, 4, c8, h8, scale=c8 ** -0.5), randn(gen, 2 * c8, 2 * h8, scale=(2 * c8) ** -0.5),
           opt(randn(gen, h8, scale=0.1)), randn(gen, 4, h8, c8, scale=h8 ** -0.5),
           randn(gen, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5), opt(randn(gen, c8, scale=0.1)))
    return [
        ("octic_attention_fused_qkv_packed", ops.octic_attention_fused_qkv_packed,
         ops.octic_attention_fused_qkv_packed_reference,
         (x, wq1, wqe, opt(randn(gen, 3 * c8, scale=0.1)), heads), False, None),
        ("mlp_d8_fused_packed", ops.mlp_d8_fused_packed, ops.mlp_d8_fused_packed_reference,
         (x.reshape(-1, c),) + mlp, False, None),
    ]


def packed_b32_cases(gen, b, n, c, heads, bias):
    """P15 at the train batch: the backward of row 10 from its residuals
    (the packed input, the qkv weights) and six output cotangents, and the
    fused MLP's backward (row 4's) on the slot views of a packed container,
    as the packed MLP's backward runs it. Scaled bar: gradients that sum over
    the tokens or through the attention backward."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f

    c8, h8 = c // 8, c // 2
    opt = lambda t: t if bias else None  # noqa: E731
    x = randn(gen, b, n, c)
    ge = randn(gen, b, n, 4 * c8)
    gs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (ge[..., :2 * c8], ge[..., 2 * c8:])
    attn = (x, randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5),
            randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5), opt(randn(gen, 3 * c8, scale=0.1)),
            gs, heads)
    mlp = (randn(gen, 4, c8, h8, scale=c8 ** -0.5), randn(gen, 2 * c8, 2 * h8, scale=(2 * c8) ** -0.5),
           opt(randn(gen, h8, scale=0.1)), randn(gen, 4, h8, c8, scale=h8 ** -0.5),
           randn(gen, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5), opt(randn(gen, c8, scale=0.1)))
    xs, gm = unpack_packed_5f(randn(gen, b, n, c)), unpack_packed_5f(randn(gen, b, n, c))
    return [
        ("octic_attention_fused_qkv_packed_bwd", ops.octic_attention_fused_qkv_packed_bwd,
         ops.octic_attention_fused_qkv_packed_bwd_reference, attn, True, None),
        ("mlp_d8_fused_bwd", ops.mlp_d8_fused_bwd, ops.mlp_d8_fused_bwd_reference,
         (xs,) + mlp + (gm,), True, None),
    ]


def packed_phases(gen, summary, card, cpu_model, images, det) -> dict:
    """P15-P17, the packed trunk carry with the invariant-early ViT-H/14.
    `cpu_model` is P3's f32 hybrid on the CPU (the weights of P4's and P7's
    hybrid), `images` P3's batch, `det` P6's configs and batches. Returns the
    launches of each path."""
    from octic_vits_tpu_torch import create_model, init_weights, ops
    from octic_vits_tpu_torch.train.common import bce_target_loss

    h14 = (BATCH, 257, 1280, 16, True)
    ragged = ("ragged", (3, 65, 64, 2, False))
    # ---- P15: the packed kernels against their plain versions ----
    kernel_phase("P15", packed_b64_cases, (("vith14_b64", h14), ragged), gen, summary)
    kernel_phase("P15", packed_b32_cases, (("vith14_b32", (TRAIN_BATCH,) + h14[1:]), ragged), gen,
                 summary)
    row4_variants(gen, (TRAIN_BATCH,) + h14[1:3])
    torch.cuda.empty_cache()

    # ---- P16: inv-early ViT-H/14 inference, flat-E and packed ----
    name = "d8_inv_early_deit_huge_patch14"
    cpu_inv = create_model(name, init_scale=1.0, device="cpu").eval()
    init_weights(cpu_inv, torch.Generator().manual_seed(SEED + 8))
    with torch.no_grad():
        ref = cpu_inv(images[:2].to(torch.bfloat16).float())
    images_gpu = images.to("cuda", torch.bfloat16)
    counts, models = {}, {}
    for path, flags in (("inv_flat_inference", {}), ("packed_inference", dict(packed_carry=True))):
        m = create_model(name, init_scale=1.0, dtype=torch.bfloat16, **flags).eval()
        m.load_state_dict(cpu_inv.state_dict(), strict=True)
        models[path] = m
        ops.reset_launch_counts()
        with torch.no_grad():
            logits = m(images_gpu)
        torch.cuda.synchronize()
        counts[path] = ops.launch_counts()
        got = logits[:2].float().cpu()
        rel = ((got - ref).norm() / ref.norm()).item()
        phase("P16", f"{name} B={BATCH} bf16, {flags}: logits {tuple(logits.shape)} finite "
                     f"{bool(logits.isfinite().all())}; launches "
                     f"{ {k: v for k, v in counts[path].items() if v} }; 2 images vs CPU f32 "
                     f"plain tuple path: rel L2 err {rel:.3e} (tol {SLICE_REL_TOL}), max abs err "
                     f"{(got - ref).abs().max().item():.3e}, |ref| max {ref.abs().max().item():.3e}")
        if tuple(logits.shape) != (BATCH, 1000) or not bool(logits.isfinite().all()):
            raise AssertionError(f"{path}: bad logits")
        if counts[path] != expected_launches(INV_INFERENCE_LAUNCHES[path]):
            raise AssertionError(f"{path}: launches differ from {INV_INFERENCE_LAUNCHES[path]}")
        if not rel <= SLICE_REL_TOL:
            raise AssertionError(f"{path}: logits disagree with the CPU f32 plain path")
        del logits
    hybrid = create_model("hybrid_deit_huge_patch14", init_scale=1.0, dtype=torch.bfloat16).eval()
    hybrid.load_state_dict(cpu_model.state_dict(), strict=True)
    models["P4 hybrid"] = hybrid
    times = {p: [] for p in ("P4 hybrid", "inv_flat_inference", "packed_inference")}
    with torch.no_grad():
        for path in ("P4 hybrid", "inv_flat_inference", "packed_inference", "packed_inference",
                     "inv_flat_inference", "P4 hybrid"):
            times[path].append(time_ms(lambda: models[path](images_gpu), iters=10, warmup=2))
    ips = {p: BATCH / (min(t) / 1e3) for p, t in times.items()}
    phase("P16", f"B={BATCH} 224^2 bf16 on {card}, in turns: "
                 + ", ".join(f"{p} {ips[p]:.1f} img/s ({' / '.join(f'{t:.2f}' for t in times[p])} "
                             f"ms)" for p in times)
                 + f"; packed / flat-E inv-early {ips['packed_inference'] / ips['inv_flat_inference']:.4f}"
                 f", inv-early flat-E / P4 hybrid {ips['inv_flat_inference'] / ips['P4 hybrid']:.4f}")
    del models, hybrid, images_gpu
    torch.cuda.empty_cache()

    # ---- P17: the packed inv-early DeiT III step ----
    cfg = det["cfg"]
    packed_flags = dict(packed_carry=True, fuse_qkv=True, fuse_mlp=True)
    train_kw = dict(init_scale=1.0, remat=True, drop_path_rate=cfg.drop_path,
                    compute_dtype=torch.bfloat16)
    model_p = create_model(name, **train_kw, **packed_flags)
    model_p.load_state_dict(cpu_inv.state_dict(), strict=True)
    state, step = train_setup(model_p, cfg)
    ops.reset_launch_counts()
    state, metrics = step(state, det["timages"], det["tlabels"], det["tgen"])
    torch.cuda.synchronize()
    counts["packed_train"] = ops.launch_counts()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in model_p.parameters())
    loss = metrics["loss"].item()
    phase("P17", f"{name} packed train step B={TRAIN_BATCH} ({packed_flags}; the P6 recipe): "
                 f"loss {loss:.4f}, grad norm {metrics['grad_norm'].item():.4f}, finite grads "
                 f"{finite}, launches { {k: v for k, v in counts['packed_train'].items() if v} }")
    if not (math.isfinite(loss) and finite):
        raise AssertionError("packed train step: non-finite loss or gradients")
    if counts["packed_train"] != expected_launches(PACKED_TRAIN_LAUNCHES):
        raise AssertionError(f"packed train launches differ from {PACKED_TRAIN_LAUNCHES}")
    del state, step
    set_drop_path(model_p, 0.0)
    model_p.load_state_dict(cpu_inv.state_dict(), strict=True)
    det_state, det_step = train_setup(model_p, det["det_cfg"])
    _, det_metrics = det_step(det_state, det["images"].cuda(), det["labels"].cuda(),
                              torch.Generator().manual_seed(SEED))
    cpu_inv.train()
    cpu_loss = bce_target_loss(cpu_inv(det["images"]),
                               torch.nn.functional.one_hot(det["labels"], 1000).float())
    cpu_loss.backward()
    cos, _, norm_cpu, count = grad_cosine(model_p, cpu_inv)
    card_loss = det_metrics["loss"].item()
    loss_rel = abs(card_loss - cpu_loss.item()) / abs(cpu_loss.item())
    phase("P17", f"deterministic step, 2 images: loss card {card_loss:.6f} vs CPU f32 "
                 f"{cpu_loss.item():.6f} (rel err {loss_rel:.3e}, tol {SLICE_REL_TOL}); gradient "
                 f"cosine {cos:.6f} (min {GRAD_COS_MIN}) over {count} values; grad norm card "
                 f"{det_metrics['grad_norm'].item():.4f} vs CPU {norm_cpu:.4f}")
    if not (loss_rel <= SLICE_REL_TOL and cos >= GRAD_COS_MIN):
        raise AssertionError("packed train step disagrees with the CPU f32 plain path")
    del det_state, det_step, cpu_inv
    # step ms in turns: P7's hybrid, the inv-early model with P7's flags, packed
    set_drop_path(model_p, cfg.drop_path)
    base = create_model("hybrid_deit_huge_patch14", **train_kw)
    base.load_state_dict(cpu_model.state_dict(), strict=True)
    inv_flat = create_model(name, **train_kw)
    inv_flat.load_state_dict(model_p.state_dict(), strict=True)
    runs = {"P7 hybrid": train_setup(base, cfg), "inv-early flat-E": train_setup(inv_flat, cfg),
            "inv-early packed": train_setup(model_p, cfg)}
    times = {k: [] for k in runs}
    peak = dict.fromkeys(runs, 0)
    for key in ("P7 hybrid", "inv-early flat-E", "inv-early packed", "inv-early packed",
                "inv-early flat-E", "P7 hybrid"):
        state, step = runs[key]
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, t = time_train_steps(state, step, det["timages"], det["tlabels"], det["tgen"],
                                steps=5, warmup=1)
        # the step's own peak above what the resident train states hold
        peak[key] = max(peak[key], torch.cuda.max_memory_allocated() - base_mem)
        times[key] += t
    med = {k: statistics.median(t) for k, t in times.items()}
    phase("P17", f"train step B={TRAIN_BATCH} 224^2 on {card}, in turns (5 steps each, twice): "
                 + ", ".join(f"{k} median {med[k]:.2f} ms ({TRAIN_BATCH / med[k] * 1e3:.1f} img/s, "
                             f"range {min(times[k]):.2f}-{max(times[k]):.2f}, step peak "
                             f"{peak[k] / 2**30:.2f} GiB above the states)" for k in times)
                 + f"; packed / flat-E inv-early img/s "
                 f"{med['inv-early flat-E'] / med['inv-early packed']:.4f}, packed / P7 hybrid "
                 f"{med['P7 hybrid'] / med['inv-early packed']:.4f}")
    del runs, base, inv_flat, model_p
    torch.cuda.empty_cache()
    return counts


def row4_variants(gen, shape) -> None:
    """Row 4's backward at one shape, as the card ran it before the hidden's
    cotangent was kept in f32 (dh and the recomputed pre-activation z rounded
    to bf16), with dh in f32, and with dh and z in f32 (the shipped rule):
    max abs error of each output against the f32 plain backward, whether all
    are inside the backward bar, and CUDA-event ms, in turns."""
    from octic_vits_tpu_torch.ops import linear as Lin

    ((_, _, ref_fn, args, _, _),) = packed_b32_cases(gen, *shape, 16, True)[1:]
    xs, params, gs = args[0], args[1:7], args[7]
    ref = ref_fn(*args)
    variants = {"before (bf16 dh, bf16 z)": dict(dh_f32=False, z_f32=False),
                "f32 dh, bf16 z": dict(dh_f32=True, z_f32=False),
                "after (f32 dh, f32 z)": {}}

    def run(kw):
        h = Lin.lin_d8_launch(tuple(xs), *params[:3], gelu=True)
        return Lin._mlp_bwd_from_hidden(tuple(xs), h, *params, tuple(gs), **kw)

    res, times = {}, {k: [] for k in variants}
    with torch.no_grad():
        for key, kw in variants.items():
            out = run(kw)
            torch.cuda.synchronize()
            names = ("dx", "dw1a", "dwea", "db1", "dw1b", "dweb", "db2")
            errs = {nm: round((o.float() - r.float()).abs().max().item(), 5)
                    for nm, o, r in zip(names, (torch.cat([t.reshape(-1) for t in out[:5]]),)
                                        + tuple(out[5:]), (torch.cat(
                                            [t.reshape(-1) for t in ref[:5]]),) + tuple(ref[5:]))}
            res[key] = (errs, compare(out, ref, True)[1])
        for key in tuple(variants) + tuple(reversed(variants)):
            times[key].append(time_ms(lambda: run(variants[key]), iters=10))
    phase("P15", f"row 4's backward at B={shape[0]} N={shape[1]} C={shape[2]}, in turns: "
                 + "; ".join(f"{k}: {' / '.join(f'{t:.4f}' for t in times[k])} ms, max abs err "
                             f"{res[k][0]} {'ok' if res[k][1] else 'FAIL'}" for k in variants))
    if not res["after (f32 dh, f32 z)"][1]:
        raise AssertionError("row 4's backward outside its bar")


def wide_b64_cases(gen, b, n, c, heads, bias):
    """P18 at the inference batch: the wide-1d attention (row 12) on the
    column views of one wide-1d qkv, the attention over one interleaved qkv
    (row 13a), linear_d8_qkv_wide (row 13b) and the wide-1d qkv product."""
    from octic_vits_tpu_torch import ops

    c8 = c // 8
    y1d, ef = randn(gen, b, n, 12 * c8), randn(gen, b, n, 12 * c8)
    w = 4 * c8
    qs = (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], ef[..., :6 * c8], ef[..., 6 * c8:])
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    x1, xef = torch.stack(xs[:4]).reshape(4, b * n, c8), xs[4].reshape(b * n, 4 * c8)
    wq = (randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5), randn(gen, 2 * c8, 6 * c8,
                                                              scale=(2 * c8) ** -0.5),
          randn(gen, 3 * c8, scale=0.1) if bias else None)
    return [
        ("octic_attention_wide1d", ops.octic_attention_wide1d,
         ops.octic_attention_wide1d_reference, (*qs, heads), False, None),
        ("octic_attention_wide", ops.octic_attention_wide, ops.octic_attention_wide_reference,
         (randn(gen, b, n, 3 * c), heads), False, None),
        ("linear_d8_qkv_wide", ops.linear_d8_qkv_wide, ops.linear_d8_qkv_wide_reference,
         (x1, xef) + wq + (heads,), False, None),
        ("linear_d8_wide1d", ops.linear_d8_wide1d, ops.linear_d8_wide1d_reference,
         (xs,) + wq + (heads,), False, None),
    ]


def wide_b32_cases(gen, b, n, c, heads, bias):
    """P18 at the train batch: the backwards of rows 12 and 13a from their
    inputs and six output cotangents (scaled bar)."""
    from octic_vits_tpu_torch import ops

    c8 = c // 8
    y1d, ef = randn(gen, b, n, 12 * c8), randn(gen, b, n, 12 * c8)
    w = 4 * c8
    qs = (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], ef[..., :6 * c8], ef[..., 6 * c8:])
    ge = randn(gen, b, n, 4 * c8)
    gs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (ge[..., :2 * c8], ge[..., 2 * c8:])
    return [
        ("octic_attention_wide1d_bwd", ops.octic_attention_wide1d_bwd,
         ops.octic_attention_wide1d_bwd_reference, (qs, gs, heads), True, None),
        ("octic_attention_wide_bwd", ops.octic_attention_wide_bwd,
         ops.octic_attention_wide_bwd_reference, (randn(gen, b, n, 3 * c), gs, heads), True,
         None),
    ]


def qkv_segments(gen, b, n, c, heads):
    """The qkv + attention segments of scripts/profile_wide_qkv.py on shared
    inputs (x1 [4, M, C/8], xef [M, C/2] and the flat-E views of them) and
    qkv weights with bias: name -> a function of (x1, xef, w1, we, bias)
    returning the six attention outputs."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.ops.attention import _qkv_rows

    c8 = c // 8

    def views(x1, xef):
        return tuple(x1[g].view(b, n, c8) for g in range(4)) + (xef.view(b, n, 4 * c8),)

    segs = {
        "A linear_d8_fused + octic_attention": lambda x1, xef, w1, we, bq: ops.octic_attention(
            *_qkv_rows(ops.linear_d8_fused(views(x1, xef), w1, we, bq)), heads),
        "B fused qkv + attention (row 2)": lambda x1, xef, w1, we, bq:
            ops.octic_attention_fused_qkv(*views(x1, xef), w1, we, bq, heads),
        "C linear_d8_qkv_wide + octic_attention_wide": lambda x1, xef, w1, we, bq:
            ops.octic_attention_wide(ops.linear_d8_qkv_wide(x1, xef, w1, we, bq, heads).view(
                b, n, 3 * c), heads),
        "D wide-1d product + octic_attention_wide1d": lambda x1, xef, w1, we, bq:
            ops.octic_attention_wide1d(*ops.linear_d8_wide1d(views(x1, xef), w1, we, bq, heads),
                                       heads),
    }
    args = (randn(gen, 4, b * n, c8), randn(gen, b * n, 4 * c8),
            randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5),
            randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5), randn(gen, 3 * c8, scale=0.1))
    return segs, args


def time_segments(gen, b, n, c, heads, backward: bool) -> tuple:
    """CUDA-event ms of each segment (forward, or forward + backward of
    every input and weight for fixed output cotangents), in turns A B C D D C
    B A; with `backward`, also the launches of one forward + backward of
    segment C (counted from 0 just before it)."""
    from octic_vits_tpu_torch import ops

    segs, args = qkv_segments(gen, b, n, c, heads)
    c8 = c // 8
    gs = tuple(randn(gen, b, n, c8) for _ in range(4)) + tuple(
        randn(gen, b, n, 2 * c8) for _ in range(2))
    leaves = tuple(t.detach().requires_grad_(backward) for t in args)
    outs = {}

    def run(fn):
        if not backward:
            with torch.no_grad():
                return fn(*leaves)
        out = fn(*leaves)
        torch.autograd.backward(out, gs)
        return out

    for name, fn in segs.items():  # the four segments compute the same attention
        outs[name] = tuple(o.detach() for o in run(fn))
    first = next(iter(outs.values()))
    for name, out in outs.items():
        err, ok = compare(out, first)
        if not ok:
            raise AssertionError(f"segment {name} disagrees with segment A (max abs err {err})")
    launches = None
    if backward:
        ops.reset_launch_counts()
        run(segs["C linear_d8_qkv_wide + octic_attention_wide"])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    order = list(segs) + list(reversed(segs))
    times = {k: [] for k in segs}
    for name in order:
        times[name].append(time_ms(lambda: run(segs[name]), iters=10, warmup=2))
    return times, launches


def wide_phases(gen, summary, card, cpu_model, images, ref, det) -> dict:
    """P18-P20, the wide-qkv slice. `cpu_model` is P3's f32 hybrid on the CPU
    (with P6's deterministic-step gradients), `images` P3's batch, `ref` its
    f32 logits of the first two images, `det` P6's configs, batches and CPU
    loss. Returns the launches of each path."""
    from octic_vits_tpu_torch import create_model, ops

    h14 = (BATCH, 257, 1280, 16, True)
    others = (("ragged", (3, 65, 64, 2, False)), ("d1_10_4heads", (2, 33, 320, 4, True)))
    # ---- P18: the wide kernels against their plain versions, then the segments ----
    kernel_phase("P18", wide_b64_cases, (("vith14_b64", h14),) + others, gen, summary)
    kernel_phase("P18", wide_b32_cases, (("vith14_b32", (TRAIN_BATCH,) + h14[1:]),) + others,
                 gen, summary)
    counts = {}
    for label, shape, backward in (("forward", h14[:4], False),
                                   ("forward + backward", (TRAIN_BATCH,) + h14[1:4], True)):
        times, launches = time_segments(gen, *shape, backward)
        phase("P18", f"qkv + attention segments, {label}, B={shape[0]} on {card}, in turns: "
                     + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms (min "
                                 f"{min(v):.4f})" for k, v in times.items()))
        if launches is not None:
            counts["wide_segments"] = launches
            if launches != expected_launches(WIDE_SEGMENT_LAUNCHES):
                raise AssertionError(f"segment C launches {launches}")
    torch.cuda.empty_cache()

    # ---- P19: hybrid ViT-H/14 inference with use_wide_qkv ----
    images_gpu = images.to("cuda", torch.bfloat16)
    models = {}
    for path, flags in (("wide_inference", dict(use_wide_qkv=True)), ("P4 hybrid", {}),
                        ("path B", dict(fuse_block_epilogues=True))):
        m = create_model("hybrid_deit_huge_patch14", init_scale=1.0, dtype=torch.bfloat16,
                         **flags).eval()
        m.load_state_dict(cpu_model.state_dict(), strict=True)
        models[path] = m
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = models["wide_inference"](images_gpu)
    torch.cuda.synchronize()
    counts["wide_inference"] = ops.launch_counts()
    got = logits[:2].float().cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    phase("P19", f"hybrid_deit_huge_patch14 B={BATCH} bf16, use_wide_qkv: logits "
                 f"{tuple(logits.shape)} finite {bool(logits.isfinite().all())}; launches "
                 f"{ {k: v for k, v in counts['wide_inference'].items() if v} }; 2 images vs "
                 f"P3's CPU f32 logits: rel L2 err {rel:.3e} (tol {SLICE_REL_TOL})")
    if tuple(logits.shape) != (BATCH, ref.shape[-1]) or not bool(logits.isfinite().all()):
        raise AssertionError("wide inference: bad logits")
    if counts["wide_inference"] != expected_launches(WIDE_INFERENCE_LAUNCHES):
        raise AssertionError(f"wide inference: launches differ from {WIDE_INFERENCE_LAUNCHES}")
    if not rel <= SLICE_REL_TOL:
        raise AssertionError("wide inference: logits disagree with the CPU f32 plain path")
    del logits
    times = {path: [] for path in models}
    with torch.no_grad():
        for path in ("P4 hybrid", "wide_inference", "path B", "path B", "wide_inference",
                     "P4 hybrid"):
            with_ln_kernel(path == "path B")
            times[path].append(time_ms(lambda: models[path](images_gpu), iters=10, warmup=2))
    with_ln_kernel(False)
    ips = {path: BATCH / (min(t) / 1e3) for path, t in times.items()}
    phase("P19", f"B={BATCH} 224^2 bf16 on {card}, in turns: "
                 + ", ".join(f"{p} {ips[p]:.1f} img/s ({' / '.join(f'{t:.2f}' for t in times[p])} "
                             f"ms)" for p in ("P4 hybrid", "wide_inference", "path B"))
                 + f"; ratio wide / P4 hybrid {ips['wide_inference'] / ips['P4 hybrid']:.4f}")
    del models, images_gpu
    torch.cuda.empty_cache()

    # ---- P20: the DeiT III step with use_wide_qkv ----
    cfg = det["cfg"]
    train_kw = dict(init_scale=1.0, remat=True, drop_path_rate=cfg.drop_path,
                    compute_dtype=torch.bfloat16)
    model_w = create_model("hybrid_deit_huge_patch14", use_wide_qkv=True, **train_kw)
    model_w.load_state_dict(cpu_model.state_dict(), strict=True)
    state, step = train_setup(model_w, cfg)
    ops.reset_launch_counts()
    state, metrics = step(state, det["timages"], det["tlabels"], det["tgen"])
    torch.cuda.synchronize()
    counts["wide_train"] = ops.launch_counts()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in model_w.parameters())
    loss = metrics["loss"].item()
    phase("P20", f"use_wide_qkv train step B={TRAIN_BATCH} (the P6 recipe): loss {loss:.4f}, grad "
                 f"norm {metrics['grad_norm'].item():.4f}, finite grads {finite}, launches "
                 f"{ {k: v for k, v in counts['wide_train'].items() if v} }")
    if not (math.isfinite(loss) and finite):
        raise AssertionError("wide train step: non-finite loss or gradients")
    if counts["wide_train"] != expected_launches(WIDE_TRAIN_LAUNCHES):
        raise AssertionError(f"wide train launches differ from {WIDE_TRAIN_LAUNCHES}")
    del state, step
    set_drop_path(model_w, 0.0)
    model_w.load_state_dict(cpu_model.state_dict(), strict=True)
    det_state, det_step = train_setup(model_w, det["det_cfg"])
    _, det_metrics = det_step(det_state, det["images"].cuda(), det["labels"].cuda(),
                              torch.Generator().manual_seed(SEED))
    cos, _, norm_cpu, count = grad_cosine(model_w, cpu_model)
    card_loss = det_metrics["loss"].item()
    loss_rel = abs(card_loss - det["cpu_loss"]) / abs(det["cpu_loss"])
    phase("P20", f"deterministic step, 2 images: loss card {card_loss:.6f} vs P6's CPU f32 "
                 f"{det['cpu_loss']:.6f} (rel err {loss_rel:.3e}, tol {SLICE_REL_TOL}); gradient "
                 f"cosine {cos:.6f} (min {GRAD_COS_MIN}) over {count} values; grad norm card "
                 f"{det_metrics['grad_norm'].item():.4f} vs CPU {norm_cpu:.4f}")
    if not (loss_rel <= SLICE_REL_TOL and cos >= GRAD_COS_MIN):
        raise AssertionError("wide train step disagrees with the CPU f32 plain path")
    del det_state, det_step
    set_drop_path(model_w, cfg.drop_path)
    base = create_model("hybrid_deit_huge_patch14", **train_kw)
    base.load_state_dict(cpu_model.state_dict(), strict=True)
    runs = {"P7 hybrid": train_setup(base, cfg), "use_wide_qkv": train_setup(model_w, cfg)}
    times = {k: [] for k in runs}
    peak = dict.fromkeys(runs, 0)
    for key in ("P7 hybrid", "use_wide_qkv", "use_wide_qkv", "P7 hybrid"):
        state, step = runs[key]
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, t = time_train_steps(state, step, det["timages"], det["tlabels"], det["tgen"],
                                steps=5, warmup=1)
        peak[key] = max(peak[key], torch.cuda.max_memory_allocated() - base_mem)
        times[key] += t
    med = {k: statistics.median(t) for k, t in times.items()}
    phase("P20", f"train step B={TRAIN_BATCH} 224^2 on {card}, in turns (5 steps each, twice): "
                 + ", ".join(f"{k} median {med[k]:.2f} ms ({TRAIN_BATCH / med[k] * 1e3:.1f} img/s, "
                             f"range {min(times[k]):.2f}-{max(times[k]):.2f}, step peak "
                             f"{peak[k] / 2**30:.2f} GiB above the states)" for k in times)
                 + f"; ratio use_wide_qkv / P7 hybrid img/s "
                 f"{med['P7 hybrid'] / med['use_wide_qkv']:.4f}")
    del runs, base, model_w
    torch.cuda.empty_cache()
    return counts


def library_sdpa_padded(qkvp, heads, dh):
    """One PyTorch call computing bh_std_attention: SDPA on the views of the
    padded qkv's 128-wide slots with the scale dh^-0.5 (the pad columns
    give p 0 = 0, as the probe writes them)."""
    q, k, v = sdpa_views(qkvp, heads)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=dh ** -0.5)


def library_sdpa_headmajor_bwd(qkv_hm, g_hm):
    """One PyTorch call computing headmajor_attention_bwd: the autograd
    backward of SDPA on the head-major q, k, v, after one recorded forward."""
    leaf = qkv_hm.detach().requires_grad_()
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(*leaf.unbind(1))
    return lambda: torch.autograd.grad(out, leaf, g_hm, retain_graph=True)


def probe_cases(gen, b, n, c, heads):
    """(row, kernel op, args, scaled bar, written columns or None, library
    call or None) of the attention probes (kernel row 14a) at one shape; the
    backward (row p) at min(b, TRAIN_BATCH). `row` is None for a case that
    is checked and timed but kept out of its op's summary (probe f's "loads"
    stage, the floor of the split). Rows b-d leave the pad columns of their
    128-wide head slots unwritten, as the JAX kernels do: only the written
    columns are compared. Row c (no softmax) takes the backward bar: its
    output is an unnormalised sum of N products of bf16-rounded scores, and
    a score that differs in its last f32 bit (another summation order)
    rounds to a neighbouring bf16 value, so its error scales with the whole
    sum, as a gradient's does."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes.r3_attn_bh import pad_qkv
    from octic_vits_tpu_torch.probes.r3_attn_headmajor import to_headmajor

    c8, dh, bb = c // 8, c // heads, min(b, TRAIN_BATCH)
    arrs = tuple(randn(gen, b, n, 3 * c8) for _ in range(4)) + tuple(
        randn(gen, b, n, 6 * c8) for _ in range(2))
    qkv = randn(gen, b, n, 3 * c)
    qkvp = pad_qkv(qkv, heads, 128)
    hm = to_headmajor(qkv, heads)
    hm_b, g_hm = hm[:bb], randn(gen, bb, heads, n, dh)
    written = (torch.arange(128 * heads, device="cuda") % 128) < dh
    q, k, v = hm.unbind(1)
    sdpa_hm = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    return [
        ("aligned_loads_attention", ops.aligned_loads_attention, arrs + (heads,), False, None,
         None),
        ("aligned_all_attention", ops.aligned_all_attention, arrs + (heads,), False, written, None),
        ("aligned_nosm_attention", ops.aligned_nosm_attention, arrs + (heads,), True, written,
         None),
        ("aligned_cheap_attention", ops.aligned_cheap_attention, arrs + (heads,), False, written,
         None),
        ("scores_only_attention", ops.scores_only_attention, (qkv, heads), False, None, None),
        (None, ops.scores_only_attention, (qkv, heads, "loads"), False, None, None),
        ("scores_softmax_attention", ops.scores_softmax_attention, (qkv, heads), False, None,
         None),
        ("full_attention", ops.full_attention, (qkv, heads), False, None,
         library_sdpa(qkv, heads)),
        ("interleave2_attention", ops.interleave2_attention, (qkv, heads), False, None,
         library_sdpa(qkv, heads)),
        ("phased_attention", ops.phased_attention, (qkv, heads), False, None,
         library_sdpa(qkv, heads)),
        ("padded_attention", ops.padded_attention, (qkvp, heads, dh, "scores"), False, None, None),
        ("padded_attention", ops.padded_attention, (qkvp, heads, dh), False, None, None),
        ("padded_octic_attention", ops.padded_octic_attention, (qkvp, heads, dh), False, None,
         None),
        ("bh_std_attention", ops.bh_std_attention, (qkvp, heads, dh), False, None,
         library_sdpa_padded(qkvp, heads, dh)),
        ("bh_octic_attention", ops.bh_octic_attention, (qkvp, heads, dh), False, None, None),
        ("headmajor_attention", ops.headmajor_attention, (hm, heads), False, None, sdpa_hm),
        ("headmajor_attention_bwd", ops.headmajor_attention_bwd, (hm_b, g_hm, heads), True, None,
         library_sdpa_headmajor_bwd(hm_b, g_hm)),
    ]


def probe_phases(gen, summary, card) -> dict:
    """P21, the probes of K-attn's time (kernel row 14a): each probe against
    its plain version at ViT-H/14 B=64 (the backward at B=32) and at a
    ragged shape; times at the first shape (k = 20 back-to-back launches a
    window, tools/timing.py, as the probes are read in differences of tens
    of microseconds; the plain version with time_ms), bound and library
    call; then each probe op driven once, its counter set to 0 just before.
    Returns the launches of that run."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.tools.timing import time_per_launch

    shapes = (("vith14_b64", (BATCH, 257, 1280, 16)), ("ragged", (3, 37, 1280, 16)))
    failed = []
    for label, shape in shapes:
        with torch.no_grad():
            cases = probe_cases(gen, *shape)
            for row, op, args, scaled, cols, lib in cases:
                name = op.__name__ + ("" if row else "[loads]")
                out = op(*args)
                torch.cuda.synchronize()
                ref = op.reference(*args)
                if cols is not None:
                    out, ref = out[..., cols], ref[..., cols]
                err, ok = compare(out, ref, scaled)
                bar = f"{BWD_TOL}*(max|ref|+|ref|)" if scaled else f"{ATOL}+{RTOL}*|ref|"
                line = f"{name} [{label}] max_abs_err {err:.3e} (tol {bar}) "
                line += "ok" if ok else "FAIL"
                del out, ref
                if label == shapes[0][0]:
                    before = op.launches
                    ms = time_per_launch(lambda: op(*args))
                    if op.launches <= before:
                        raise AssertionError(f"{name}: launch counter did not move")
                    plain_ms = time_ms(lambda: op.reference(*args), iters=5, warmup=1)
                    lib_ms = time_per_launch(lib) if lib is not None else None
                    b = min(shape[0], TRAIN_BATCH) if op is ops.headmajor_attention_bwd else \
                        shape[0]
                    full = (b,) + shape[1:] + (True,)
                    bms, bby = bound(op.__name__ if row else "loads_only", full)
                    line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
                             f"({bby})" + (f", library call {lib_ms:.4f} ms" if lib else ""))
                    if row:
                        e = summary.setdefault(row, {"max_abs_err": 0.0, "ms": 0.0,
                                                     "plain_ms": 0.0, "library_ms": None})
                        e["ms"] += ms  # probe k sums its two stages, as its bound does
                        e["plain_ms"] += plain_ms
                        e["library_ms"] = lib_ms
                        e["shape"] = full
                if row:
                    summary[row]["max_abs_err"] = max(summary[row]["max_abs_err"], err)
                phase("P21", line)
                if not ok:
                    failed.append(f"{name}[{label}]")
            del cases
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"probe kernels outside tolerance: {failed}")
    # the probe path: each probe op once at ViT-H/14 (its first case)
    with torch.no_grad():
        cases = probe_cases(gen, BATCH, 257, 1280, 16)
        first = {}
        for row, op, args, *_ in cases:
            first.setdefault(op, args)
        ops.reset_launch_counts()
        for op, args in first.items():
            op(*args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    want = {op.__name__: 1 for op in ops.PROBE_OPS_14A}
    if counts != expected_launches(want):
        raise AssertionError(f"probe launches {counts}, expected {want}")
    phase("P21", f"probe path: each of the {len(want)} probe ops launched once on {card}")
    del cases, first
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# P22: the probes of kernel row 14b
# ---------------------------------------------------------------------------


def experiment_work(name: str, split: bool, b: int, n: int, c: int, heads: int) -> tuple:
    """(bytes, tensor-core operations, float32 operations) of one row-14b
    attention probe at [B, N, C]: the qkv (3C columns) read once and the
    output (C) written once; the hoist assembly reads the qkv and writes the
    padded qkv (3 H 128 columns), no products. With the cls-split the
    products cover N - 1 keys and key N - 1 takes 2 f32 operations a
    multiply-add (q . k[N-1] and p v[N-1])."""
    m = b * n
    if name == "hoist_assembly":
        return m * (3 * c + 3 * heads * 128) * 2, 0, 0
    keys = n - 1 if split else n
    return m * 4 * c * 2, 4 * m * keys * c, 4 * m * c if split else 0


def law_work(b: int, a_shape: tuple, b_shape: tuple, mode: str, reps) -> tuple:
    """The product law at one shape: each batch row's operands read once and
    its [8, 128] f32 output written; reps products (or the 16 heads') of 2
    M K L operations, and the max over each product's M L values."""
    m, k = a_shape[-2:]
    l = b_shape[-2] if mode == "nt" else b_shape[-1]
    count = 16 if reps is None else reps
    nbytes = b * (math.prod(a_shape) + math.prod(b_shape)) * 2 + b * 8 * 128 * 4
    return nbytes, b * count * 2 * m * k * l, b * count * m * l


def experiment_cases(gen, b, n, c, heads):
    """(label, kernel op, args, keyword args, library call or None, work) of
    the row-14b attention probes (scripts/r3_attn_experiments.py) at one
    shape. The label of an op's first case is its name."""
    from octic_vits_tpu_torch import ops

    c8 = c // 8
    arrs = tuple(randn(gen, b, n, 3 * c8) for _ in range(4)) + tuple(
        randn(gen, b, n, 6 * c8) for _ in range(2))
    qkv = randn(gen, b, n, 3 * c)
    octic = arrs + (heads,)
    work = lambda name, split=False: experiment_work(name, split, b, n, c, heads)  # noqa: E731
    return [
        ("cls_split_attention", ops.cls_split_attention, (qkv, heads), {},
         library_sdpa(qkv, heads), work("cls_split_attention", True)),
        ("cls_split_octic_attention", ops.cls_split_octic_attention, octic, {}, None,
         work("cls_split_octic_attention", True)),
        ("multi_image_attention", ops.multi_image_attention, (qkv, heads), {},
         library_sdpa(qkv, heads), work("multi_image_attention")),
        ("multi_image_octic_attention", ops.multi_image_octic_attention, octic, {}, None,
         work("multi_image_octic_attention")),
        ("hoist_assembly", ops.hoist_assembly, octic, {}, None, work("hoist_assembly")),
        ("hoist_octic_attention", ops.hoist_octic_attention, octic, {}, None,
         work("hoist_octic_attention")),
        ("hoist_octic_attention[split]", ops.hoist_octic_attention, octic, {"split": True}, None,
         work("hoist_octic_attention", True)),
    ]


def lin_tile_cases(gen, m, c8, heads):
    """(label, kernel op, args, keyword args, library call, work, extra
    check) of the tile sweep of K-lin-d8's mma.sync core
    (scripts/profile_lin_tiles.py) at M tokens: both stores at every tile.
    The extra check holds the output bitwise equal to the core's own 64 x 32
    instantiation (ops.lin_d8_sync, the model paths' kernel before the TMA +
    wgmma redesign, which sums in another order) of the same store."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.ops.linear_probe import STORES, TILES
    from octic_vits_tpu_torch.probes.profile_lin_tiles import lin_inputs, shipped

    xs = lin_inputs(sys.modules[__name__], gen, m, c8)
    wk = work("linear_d8_qkv_wide", 1, m, 8 * c8, heads, False)

    def same_as_shipped(store):
        def check(out):
            want = flat(shipped(store, *xs, heads))
            same = all(torch.equal(o, r) for o, r in zip(flat(out), want))
            return same, f"bitwise equal to the mma.sync core at 64x32: {same}"
        return check

    return [(f"lin_d8_tiled[{store} {bm}x{bn}]", ops.lin_d8_tiled, xs,
             dict(bm=bm, bn=bn, store=store, num_heads=heads), None, wk, same_as_shipped(store))
            for store in STORES for bm, bn in TILES]


def tol_of(op) -> tuple:
    """(atol, rtol) of a kernel op against its plain version: the product
    law's bar for the law's ops, the forward bar for every other."""
    law = op.__name__ in ("matmul_law", "matmul_law_batched")
    return (LAW_ATOL, LAW_RTOL) if law else (ATOL, RTOL)


def law_inputs(gen, b, a_shape, b_shape, mode, c=0.0625):
    """Operands of the product law at B batch rows (scale 0.02, as the
    script's), with every odd batch row's largest product planted at the
    ragged edges: the last row of A times the last output column, both c
    (exact in bf16), in head H - 1 - (row // 2) % H where batched. That
    value, c^2 K, needs every contraction element, so a kernel that drops
    the last row, output column or contraction element, or a head, misses
    it by far more than the law's bar; the even rows stay random, so
    faults inside the tiles show as well."""
    a, bm = randn(gen, b, *a_shape, scale=0.02), randn(gen, b, *b_shape, scale=0.02)
    for r in range(1, b, 2):
        ar, br = a[r], bm[r]
        if a.ndim == 4:
            h = a.shape[1] - 1 - (r // 2) % a.shape[1]
            ar, br = ar[h], br[h]
        ar[-1, :] = c
        if mode == "nt":
            br[-1, :] = c
        else:
            br[:, -1] = c
    return a, bm


def law_mutants(op, a, b, mode, *reps) -> dict:
    """What a kernel returns that drops the last row of A, the last output
    column, the last contraction element, or (batched) computes the first
    head alone or drops the last: the plain version on the cut operands."""
    ref = op.reference
    cut_l = (lambda t: t[..., :-1, :]) if mode == "nt" else (lambda t: t[..., :-1])
    cut_k = (lambda t: t[..., :-1]) if mode == "nt" else (lambda t: t[..., :-1, :])
    muts = {"last row of A dropped": ref(a[..., :-1, :], b, mode, *reps),
            "last output column dropped": ref(a, cut_l(b), mode, *reps),
            "last contraction element dropped": ref(a[..., :-1], cut_k(b), mode, *reps)}
    if a.ndim == 4:
        muts["first head alone"] = ref(a[:, :1], b[:, :1], mode)
        muts["last head dropped"] = ref(a[:, :-1], b[:, :-1], mode)
    return muts


def law_bar_fails_mutants(op, args):
    """The law's extra check: every mutant of law_mutants falls outside the
    law's bar around the plain version; reports the smallest excess (the
    mutant's largest |mutant - plain| over the bar)."""
    def check(out):
        ref = op.reference(*args).float()
        bar = LAW_ATOL + LAW_RTOL * ref.abs()
        excess = {k: ((m.float() - ref).abs() / bar).max().item()
                  for k, m in law_mutants(op, *args).items()}
        worst = min(excess, key=excess.get)
        ok = all(x > 1 for x in excess.values())
        return ok, (f"mutants outside the bar: {ok} (closest: {worst}, "
                    f"{excess[worst]:.3g}x the bar)")
    return check


def law_cases(gen, b):
    """(label, kernel op, args, keyword args, library call, work, extra
    check) of the product law's twelve shapes (scripts/r3_matmul_law.py:main)
    at B CTAs; the extra check shows that the law's bar fails a kernel that
    drops an edge or a head (law_inputs)."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes.r3_matmul_law import LAW_SHAPES

    cases = []
    for label, a_shape, b_shape, mode, reps in LAW_SHAPES:
        a, bm = law_inputs(gen, b, a_shape, b_shape, mode)
        if reps is None:
            op, args = ops.matmul_law_batched, (a, bm, mode)
        else:
            op, args = ops.matmul_law, (a, bm, mode, reps)
        cases.append((f"{op.__name__}[{label}]", op, args, {}, None,
                      law_work(b, a_shape, b_shape, mode, reps), law_bar_fails_mutants(op, args)))
    return cases


def probe_14b_phases(gen, summary, card) -> dict:
    """P22, the probes of kernel row 14b: each against its plain version with
    P21's bars (the law's ops with theirs, `tol_of`) at the scripts'
    full-width shapes and a ragged one, with each case's extra check (each
    K-lin-d8 tile bitwise equal to the mma.sync core at 64 x 32; the law's bar
    failing every mutant of `law_mutants`); times at the
    full-width shape (tools/timing.py, as P21), bound and library call. An
    op's summary row is its first case, its other cases listed under
    "cases". Then each row-14b op driven once, every counter set to 0 just
    before. Returns the launches of that run."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.tools.timing import time_per_launch

    h14 = (BATCH, 257, 1280, 16)
    m14 = (BATCH * 257, 160, 480)  # the qkv product's M, C/8, F
    # (label, shape of the summary, cases); the first label's cases are timed
    groups = [("vith14_b64", h14, lambda: experiment_cases(gen, *h14)),
              ("ragged", None, lambda: experiment_cases(gen, 4, 37, 1280, 16)),
              ("vith14_b64", m14, lambda: lin_tile_cases(gen, m14[0], m14[1], 16)),
              ("ragged", None, lambda: lin_tile_cases(gen, 4 * 37, 160, 16)),
              ("vith14_b64", (BATCH,), lambda: law_cases(gen, BATCH))]
    failed = []
    first = {}
    for label, shape, make in groups:
        with torch.no_grad():
            for name, op, args, kw, lib, wk, *extra in make():
                out = op(*args, **kw)
                torch.cuda.synchronize()
                atol, rtol = tol_of(op)
                err, ok = compare(out, op.reference(*args, **kw), tol=(atol, rtol))
                line = f"{name} [{label}] max_abs_err {err:.3e} (tol {atol}+{rtol}*|ref|) "
                line += "ok" if ok else "FAIL"
                if extra:
                    good, text = extra[0](out)
                    ok &= good
                    line += f"; {text}"
                del out
                if label == "vith14_b64":
                    before = op.launches
                    ms = time_per_launch(lambda: op(*args, **kw))
                    if op.launches <= before:
                        raise AssertionError(f"{name}: launch counter did not move")
                    plain_ms = time_ms(lambda: op.reference(*args, **kw), iters=5, warmup=1)
                    lib_ms = time_per_launch(lib) if lib is not None else None
                    bms, bby = bound_of(*wk)
                    line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
                             f"({bby})" + (f", library call {lib_ms:.4f} ms" if lib else ""))
                    row = op.__name__
                    case = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": bms, "bound_by": bby, "max_abs_err": err}
                    if row not in summary:
                        summary[row] = dict(case, bound=(bms, bby), shape=shape, cases={})
                        first[op] = (args, kw)
                    summary[row]["cases"][name] = case
                if op.__name__ in summary:
                    e = summary[op.__name__]
                    e["max_abs_err"] = max(e["max_abs_err"], err)
                phase("P22", line)
                if not ok:
                    failed.append(f"{name}[{label}]")
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"row-14b probes outside tolerance: {failed}")
    # the row-14b path: each op once, at its first case
    with torch.no_grad():
        ops.reset_launch_counts()
        for op, (args, kw) in first.items():
            op(*args, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    want = {op.__name__: 1 for op in ops.PROBE_OPS_14B}
    if counts != expected_launches(want):
        raise AssertionError(f"row-14b probe launches {counts}, expected {want}")
    phase("P22", f"probe path: each of the {len(want)} row-14b probe ops launched once on {card}")
    del first
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# P23: the probes of kernel row 14c (scripts/r3_attn_bwd_ablate.py)
# ---------------------------------------------------------------------------


def probe_14c_work(name: str, b: int, n: int, c: int, group: int = 1,
                   masked: bool = False) -> tuple:
    """(bytes, tensor-core operations, float32 operations, extra operations)
    of one row-14c probe at [B, N, C]: the function's bytes and products
    (each input read once, each output written once), as work() counts rows
    1, 1b and 2; the fused proj adds its 24 B N (C/8)^2 products, its weights
    and bias. A masked probe computes its zero terms too: `extra` is the
    (G - 1) times the function's products that it adds, kept out of the
    bound."""
    if name == "octic_qkv_attention":
        nbytes, ops_, _ = work("octic_attention_fused_qkv", b, n, c, 16, True)
    elif name == "octic_qkv_attention_proj":
        nbytes, ops_, _ = work("octic_attention_fused_qkv", b, n, c, 16, True)
        c8 = c // 8
        nbytes, ops_ = nbytes + (8 * c8 * c8 + c8) * 2, ops_ + 24 * b * n * c8 * c8
    elif name.endswith(("_bwd", "_widestore", "_wideg")):
        nbytes, ops_, _ = work("standard_attention_bwd", b, n, c, 16, True)
    else:
        nbytes, ops_, _ = work("standard_attention", b, n, c, 16, True)
    return nbytes, ops_, 0, (group - 1) * ops_ if masked else 0


def probe_14c_cases(gen, b, n, c, heads):
    """(label, kernel op, args, keyword args, scaled bar, library call or
    None, work) of the row-14c probes at one shape, the forwards at B, the
    backwards at min(B, TRAIN_BATCH); the label of an op's first case is its
    name. The group ops run at G = 1 and 4 too (G = 1: the family's own
    baseline)."""
    from octic_vits_tpu_torch import ops

    c8, bb = c // 8, min(b, TRAIN_BATCH)
    qkv, g = randn(gen, b, n, 3 * c), randn(gen, bb, n, c)
    qs = tuple(randn(gen, b, n, 3 * c8) for _ in range(4)) + tuple(
        randn(gen, b, n, 6 * c8) for _ in range(2))
    gs = tuple(randn(gen, bb, n, c8) for _ in range(4)) + tuple(
        randn(gen, bb, n, 2 * c8) for _ in range(2))
    qs_b, qkv_b, gw = tuple(t[:bb] for t in qs), qkv[:bb], randn(gen, bb, n, c)
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    w1, we = randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5), randn(gen, 2 * c8, 6 * c8,
                                                                scale=(2 * c8) ** -0.5)
    w1p, wep = randn(gen, 4, c8, c8, scale=c8 ** -0.5), randn(gen, 2 * c8, 2 * c8,
                                                              scale=(2 * c8) ** -0.5)
    bq, bp = randn(gen, 3 * c8, scale=0.1), randn(gen, c8, scale=0.1)
    fwd = lambda name, grp=1, m=False: probe_14c_work(name, b, n, c, grp, m)  # noqa: E731
    bwd = lambda name, grp=1, m=False: probe_14c_work(name, bb, n, c, grp, m)  # noqa: E731
    sdpa, sdpa_bwd = library_sdpa(qkv, heads), library_sdpa_bwd(qkv_b, g, heads)
    cases = [
        ("octic_attention_bwd_widestore", ops.octic_attention_bwd_widestore, (qs_b, gs, heads),
         {}, True, None, bwd("octic_attention_bwd_widestore")),
        ("octic_attention_bwd_wideg", ops.octic_attention_bwd_wideg, (qs_b, gw, heads), {}, True,
         None, bwd("octic_attention_bwd_wideg")),
    ]
    for grp in (2, 1, 4):
        tag = "" if grp == 2 else f"[G={grp}]"
        cases += [
            ("std_pack_attention" + tag, ops.std_pack_attention, (qkv, heads, grp), {}, False,
             sdpa, fwd("std_pack_attention")),
            ("std_pack_attention_bwd" + tag, ops.std_pack_attention_bwd, (qkv_b, g, heads, grp),
             {}, True, sdpa_bwd, bwd("std_pack_attention_bwd")),
            ("octic_group_attention" + tag, ops.octic_group_attention, qs + (heads, grp), {},
             False, None, fwd("octic_group_attention", grp, True)),
            ("octic_group_attention_bwd" + tag, ops.octic_group_attention_bwd,
             (qs_b, gs, heads, grp), {}, True, None, bwd("octic_group_attention_bwd", grp, True)),
        ]
    cases += [
        ("std_maskpair_attention", ops.std_maskpair_attention, (qkv, heads), {}, False, sdpa,
         fwd("std_maskpair_attention", 2, True)),
        ("std_maskpair_attention_bwd", ops.std_maskpair_attention_bwd, (qkv_b, g, heads), {},
         True, sdpa_bwd, bwd("std_maskpair_attention_bwd", 2, True)),
        ("octic_qkv_attention", ops.octic_qkv_attention, xs + (w1, we, bq, heads), {}, False,
         None, fwd("octic_qkv_attention")),
        ("octic_qkv_attention_proj", ops.octic_qkv_attention_proj,
         xs + (w1, we, bq, w1p, wep, bp, heads), {}, False, None,
         fwd("octic_qkv_attention_proj")),
    ]
    return cases


def probe_14c_phases(gen, summary, card) -> dict:
    """P23, the probes of kernel row 14c: each against its plain version
    (forwards with the forward bar, backwards with the backward bar) at
    ViT-H/14 (forwards B=64, backwards B=32) and at B=2, N=45; times at the
    full-width shape (tools/timing.py, as P21), bound (a masked probe's extra
    products printed beside it) and library call. An op's summary row is its
    first case (the pair for the group ops), its other cases under "cases".
    Then each row-14c op driven once, every counter set to 0 just before.
    Returns the launches of that run."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.tools.timing import time_per_launch

    shapes = (("vith14_b64", (BATCH, 257, 1280, 16)), ("ragged", (2, 45, 1280, 16)))
    failed, first = [], {}
    for label, shape in shapes:
        with torch.no_grad():
            for name, op, args, kw, scaled, lib, wk in probe_14c_cases(gen, *shape):
                out = op(*args, **kw)
                torch.cuda.synchronize()
                err, ok = compare(out, op.reference(*args, **kw), scaled)
                bar = f"{BWD_TOL}*(max|ref|+|ref|)" if scaled else f"{ATOL}+{RTOL}*|ref|"
                line = f"{name} [{label}] max_abs_err {err:.3e} (tol {bar}) "
                line += "ok" if ok else "FAIL"
                del out
                if label == shapes[0][0]:
                    before = op.launches
                    ms = time_per_launch(lambda: op(*args, **kw))
                    if op.launches <= before:
                        raise AssertionError(f"{name}: launch counter did not move")
                    plain_ms = time_ms(lambda: op.reference(*args, **kw), iters=5, warmup=1)
                    lib_ms = time_per_launch(lib) if lib is not None else None
                    bms, bby = bound_of(*wk[:3])
                    line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
                             f"({bby})" + (f", extra products {wk[3] / 1e9:.2f} GFLOP"
                                           if wk[3] else "")
                             + (f", library call {lib_ms:.4f} ms" if lib else ""))
                    row = op.__name__
                    case = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": bms, "bound_by": bby, "max_abs_err": err,
                            "extra_gflop": wk[3] / 1e9}
                    if row not in summary:
                        lead = args[0][0] if isinstance(args[0], tuple) else args[0]
                        summary[row] = dict(case, bound=(bms, bby), shape=tuple(lead.shape),
                                            cases={})
                        first[op] = (args, kw)
                    summary[row]["cases"][name] = case
                if op.__name__ in summary:
                    e = summary[op.__name__]
                    e["max_abs_err"] = max(e["max_abs_err"], err)
                phase("P23", line)
                if not ok:
                    failed.append(f"{name}[{label}]")
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"row-14c probes outside tolerance: {failed}")
    # the row-14c path: each op once, at its first case
    with torch.no_grad():
        ops.reset_launch_counts()
        for op, (args, kw) in first.items():
            op(*args, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    want = {op.__name__: 1 for op in ops.PROBE_OPS_14C}
    if counts != expected_launches(want):
        raise AssertionError(f"row-14c probe launches {counts}, expected {want}")
    phase("P23", f"probe path: each of the {len(want)} row-14c probe ops launched once on {card}")
    del first
    torch.cuda.empty_cache()
    return counts


# P24: the redesigned kernels (TMA + wgmma): K-attn's standard forward (row
# 1) and K-dense (row 3), at every shape of the main path and at the edges
# of their launch plans. Attention shapes (b, n, heads, dh); dense (m, k, f).
STD_SHAPES = (("vith14_b64", (BATCH, 257, 16, 80)), ("vith14_b32", (TRAIN_BATCH, 257, 16, 80)),
              ("l16_global", (2 * SSL_BATCH, 197, 16, 64)),
              ("l16_local", (8 * SSL_BATCH, 37, 16, 64)))
STD_EDGES = (("dh16", (4, 257, 4, 16)), ("dh24", (4, 65, 4, 24)), ("dh32", (4, 197, 4, 32)),
             ("dh128", (4, 257, 4, 128)), ("dh40_n100", (3, 100, 2, 40)),
             ("dh120_n1", (2, 1, 2, 120)), ("ragged", (3, 65, 2, 32)))
DENSE_SHAPES = (("vith14_b64", (BATCH * 257, 1280, 5120)),
                ("vith14_b32", (TRAIN_BATCH * 257, 1280, 5120)),
                ("l16_global", (2 * SSL_BATCH * 197, 1024, 4096)),
                ("l16_local", (8 * SSL_BATCH * 37, 1024, 4096)))
DENSE_EDGES = (("ragged_k64", (195, 64, 264)), ("ragged_k192", (300, 192, 8)),
               ("m129", (129, 1280, 5120)), ("m7", (7, 64, 128)))


def std_work(b, n, heads, dh) -> tuple:
    """(bytes, tensor-core operations) of the standard attention forward."""
    c = heads * dh
    return 4 * b * n * c * 2, 4 * b * n * n * c


def dense_work(m, k, f) -> tuple:
    """(bytes, tensor-core operations) of dense + GELU with bias."""
    return (m * k + f * k + f + m * f) * 2, 2 * m * k * f


def sdpa_backend(qkv, heads, backend):
    """SDPA on the qkv views under one backend (torch.nn.attention.SDPBackend)."""
    from torch.nn.attention import sdpa_kernel

    q, k, v = sdpa_views(qkv, heads)

    def call():
        with sdpa_kernel(backend):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return call


def device_kernel_names(fn) -> list:
    """The CUDA kernels one call of `fn` launches (torch.profiler; a second
    try where the process's first profile saw none, as --p26 alone did)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"})
        if names:
            break
    return names


def redesign_phases(gen, summary, card) -> None:
    """P24: K-attn's standard forward and K-dense on TMA + wgmma against their
    plain versions (P2's bar) at every main-path shape and at the plans'
    edges; then, in turns in one process (tools/timing.py), the new standard
    forward against K-attn's whole-head core (probe h, ops.full_attention)
    and SDPA under each backend that runs, and K-dense against cuBLASLt's
    GELU epilogue, with TFLOP/s and share of the bound; the SDPA kernels the
    default dispatch launched; and each op's host time per call (the tensor
    maps are encoded at every launch). The times go under each kernel's
    "cases" in the summary."""
    from torch.nn.attention import SDPBackend

    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.tools.timing import host_us_per_call, in_turns

    failed = []
    with torch.no_grad():
        for label, (b, n, heads, dh) in STD_SHAPES + STD_EDGES:
            qkv = randn(gen, b, n, 3 * heads * dh)
            out = ops.standard_attention(qkv, heads)
            torch.cuda.synchronize()
            err, ok = compare(out, ops.standard_attention_reference(qkv, heads))
            phase("P24", f"standard_attention [{label} B={b} N={n} H={heads} dh={dh}] max_abs_err "
                         f"{err:.3e} (tol {ATOL}+{RTOL}*|ref|) " + ("ok" if ok else "FAIL"))
            summary["standard_attention"]["max_abs_err"] = max(
                summary["standard_attention"]["max_abs_err"], err)
            failed += [] if ok else [f"standard_attention[{label}]"]
        for label, (m, k, f) in DENSE_SHAPES + DENSE_EDGES:
            x, w = randn(gen, m, k), randn(gen, f, k, scale=k ** -0.5)
            for bias in (randn(gen, f, scale=0.1), None) if label == "ragged_k64" else (
                    randn(gen, f, scale=0.1),):
                out = ops.dense_gelu(x, w, bias)
                torch.cuda.synchronize()
                err, ok = compare(out, ops.dense_gelu_reference(x, w, bias))
                phase("P24", f"dense_gelu [{label} M={m} K={k} F={f} bias={bias is not None}] "
                             f"max_abs_err {err:.3e} (tol {ATOL}+{RTOL}*|ref|) "
                             + ("ok" if ok else "FAIL"))
                summary["dense_gelu"]["max_abs_err"] = max(summary["dense_gelu"]["max_abs_err"],
                                                           err)
                failed += [] if ok else [f"dense_gelu[{label}]"]
        torch.cuda.empty_cache()
        if failed:
            raise AssertionError(f"redesigned kernels outside tolerance: {failed}")

        backends = {"SDPA flash": SDPBackend.FLASH_ATTENTION,
                    "SDPA efficient": SDPBackend.EFFICIENT_ATTENTION,
                    "SDPA cuDNN": SDPBackend.CUDNN_ATTENTION}
        for label, (b, n, heads, dh) in STD_SHAPES:
            qkv = randn(gen, b, n, 3 * heads * dh)
            cases = {"std TMA + wgmma": lambda: ops.standard_attention(qkv, heads),
                     "whole-head core (probe h)": lambda: ops.full_attention(qkv, heads),
                     "SDPA (yardstick)": library_sdpa(qkv, heads)}
            for name, be in backends.items():
                fn = sdpa_backend(qkv, heads, be)
                try:
                    fn()
                    torch.cuda.synchronize()
                    cases[name] = fn
                except RuntimeError as exc:  # the backend has no kernel for these inputs
                    phase("P24", f"{name} does not run at {label}: {str(exc).splitlines()[0]}")
            res = in_turns(cases)
            bms, bby = bound_of(*std_work(b, n, heads, dh))
            flops = std_work(b, n, heads, dh)[1]
            yard = device_kernel_names(cases["SDPA (yardstick)"])
            line = f"standard_attention [{label}] in turns on {card}:"
            for name, ms in res["median"].items():
                line += (f" {name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                         f"{bms / ms:.1%} of bound);")
            phase("P24", line + f" bound {bms:.4f} ms ({bby}); the yardstick SDPA launched {yard}")
            summary["standard_attention"].setdefault("cases", {})[label] = {
                "ms": res["median"]["std TMA + wgmma"],
                "whole_head_core_ms": res["median"]["whole-head core (probe h)"],
                "library_ms": res["median"]["SDPA (yardstick)"], "sdpa_kernels": yard,
                "sdpa_backend_ms": {k: v for k, v in res["median"].items() if k in backends},
                "bound_ms": bms, "bound_by": bby}
            del qkv, cases
        for label, (m, k, f) in DENSE_SHAPES:
            x, w, bias = randn(gen, m, k), randn(gen, f, k, scale=k ** -0.5), randn(gen, f,
                                                                                      scale=0.1)
            res = in_turns({"K-dense TMA + wgmma": lambda: ops.dense_gelu(x, w, bias),
                            "_addmm_activation GELU": library_dense_gelu(x, w, bias)})
            bms, bby = bound_of(*dense_work(m, k, f))
            flops = dense_work(m, k, f)[1]
            line = f"dense_gelu [{label}] in turns on {card}:"
            for name, ms in res["median"].items():
                line += (f" {name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                         f"{bms / ms:.1%} of bound);")
            phase("P24", line + f" bound {bms:.4f} ms ({bby})")
            summary["dense_gelu"].setdefault("cases", {})[label] = {
                "ms": res["median"]["K-dense TMA + wgmma"],
                "library_ms": res["median"]["_addmm_activation GELU"],
                "bound_ms": bms, "bound_by": bby}
            del x, w, bias
        torch.cuda.empty_cache()

        # the host's side of a launch: the plan and (new kernels) the tensor maps
        qkv = randn(gen, 1, 37, 3 * 2 * 64)
        x, w, bias = randn(gen, 64, 64), randn(gen, 64, 64), randn(gen, 64)
        host = {"std TMA + wgmma": host_us_per_call(lambda: ops.standard_attention(qkv, 2)),
                "whole-head core (probe h)": host_us_per_call(lambda: ops.full_attention(qkv, 2)),
                "K-dense TMA + wgmma": host_us_per_call(lambda: ops.dense_gelu(x, w, bias)),
                "_addmm_activation GELU": host_us_per_call(library_dense_gelu(x, w, bias))}
        phase("P24", "host us per call (enqueue, small shapes): "
                     + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
        summary["standard_attention"]["host_us"] = host["std TMA + wgmma"]
        summary["dense_gelu"]["host_us"] = host["K-dense TMA + wgmma"]


# ---------------------------------------------------------------------------
# P25: K-lin-d8 (csrc/lin_d8.cu) and the octic attention forward
# (csrc/attention_octic.cu) on TMA + wgmma; the octic kernels at any N
# ---------------------------------------------------------------------------
# K-lin-d8's cases (label, m, c, f, mode, heads of the wide stores): the H/14
# B=64 qkv (tuple, wide and wide-1d stores), fc1 + GELU, fc2 + LayerScale and
# proj + LayerScale; the same at B=32 and at the L/16 SSL crops; ragged
# edges (M = 148, F = 24, c = 16; d1 = 2, 8, 10) and the packed views
LIN_CASES = [("qkv", 160, 480, "tuple", 16), ("qkv_wide", 160, 480, "wide", 16),
             ("qkv_wide1d", 160, 480, "wide1d", 16), ("fc1_gelu", 160, 640, "gelu", None),
             ("fc2_ls", 640, 160, "ls", None), ("proj_ls", 160, 160, "ls", None)]
LIN_SSL_CASES = [("qkv", 128, 384, "tuple", 16), ("fc1_gelu", 128, 512, "gelu", None),
                 ("fc2_ls", 512, 128, "ls", None), ("proj_ls", 128, 128, "ls", None)]
LIN_EDGES = [("ragged_d1_2", 148, 16, 24, 4), ("d1_8", 148, 24, 48, 2), ("d1_10", 300, 40, 120, 4)]
# the octic forward: (label, b, n, heads, d1)
OCTIC_SHAPES = (("vith14_b64", BATCH, 257, 16, 10), ("vith14_b32", TRAIN_BATCH, 257, 16, 10),
                ("l16_global", 2 * SSL_BATCH, 197, 16, 8), ("l16_local", 8 * SSL_BATCH, 37, 16, 8))
# just past the old limits, and one long N: forward (b, n, heads, d1),
# backward (b, n, heads, dh)
OCTIC_LONG = (("fwd_449_dh80", 2, 449, 4, 10), ("fwd_545_dh64", 2, 545, 4, 8),
              ("fwd_1025_dh80", 2, 1025, 4, 10))
BWD_LONG = (("bwd_321_dh80", 2, 321, 4, 80), ("bwd_385_dh64", 2, 385, 4, 64),
            ("bwd_257_dh128", 2, 257, 2, 128), ("bwd_1025_dh80", 2, 1025, 4, 80))


def lin_work(m, c, f, mode) -> tuple:
    """(bytes, tensor-core operations) of one K-lin-d8 launch: the flat-E
    input (8c a token) and the weights (8cf) read once, the output (8f a
    token) written once, the LayerScale's residual read; 24 m c f products."""
    nbytes = (m * 8 * c + 8 * c * f + f + m * 8 * f) * 2
    if mode == "ls":
        nbytes += (m * 8 * f + 6 * f) * 2
    return nbytes, 24 * m * c * f


def lin_inputs(gen, m, c, f, mode, packed=False):
    """(args, keyword args) of ops.lin_d8_sync and of the op that runs the
    new kernel in `mode` (see lin_run)."""
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f

    if packed:
        xs = unpack_packed_5f(randn(gen, m, 8 * c, scale=0.5))
    else:
        xs = tuple(randn(gen, m, c, scale=0.5) for _ in range(4)) + (
            randn(gen, m, 4 * c, scale=0.5),)
    w1, we = randn(gen, 4, c, f, scale=c ** -0.5), randn(gen, 2 * c, 2 * f, scale=(2 * c) ** -0.5)
    bias = randn(gen, f, scale=0.1)
    kw = {}
    if mode == "gelu":
        kw = dict(gelu=True)
    if mode == "ls":
        kw = dict(layerscale=(randn(gen, 4, f, scale=0.5), randn(gen, 2 * f, scale=0.5)),
                  residual=tuple(randn(gen, m, f) for _ in range(4)) + (randn(gen, m, 4 * f),))
    return (xs, w1, we, bias), kw


def lin_run(mode, heads):
    """(new kernel, its plain version) on the arguments of lin_inputs."""
    from octic_vits_tpu_torch import ops

    if mode == "wide":
        return (lambda xs, w1, we, b: ops.linear_d8_qkv_wide(torch.stack(xs[:4]), xs[4], w1, we,
                                                             b, heads),
                lambda xs, w1, we, b: ops.linear_d8_qkv_wide_reference(
                    torch.stack(xs[:4]), xs[4], w1, we, b, heads))
    if mode == "wide1d":
        return (lambda xs, w1, we, b: ops.linear_d8_wide1d(xs, w1, we, b, heads),
                lambda xs, w1, we, b: ops.linear_d8_wide1d_reference(xs, w1, we, b, heads))
    return (lambda xs, w1, we, b, **kw: ops.linear_d8_fused(xs, w1, we, b, **_fused_kw(kw)),
            lambda xs, w1, we, b, **kw: ops.linear_d8_fused_reference(xs, w1, we, b,
                                                                      **_fused_kw(kw)))


def _fused_kw(kw):
    return {"fuse_gelu" if k == "gelu" else k: v for k, v in kw.items()}


def octic_fwd_cases(gen, b, n, heads, d1):
    """(row, op, plain version, args) of the five octic forwards at one shape:
    row 2 (fused qkv + attention, route (a)), row 5 (the six arrays, route
    (b)), row 10 (the packed container, route (a)), row 12 (wide-1d, route
    (b)) and row 13a (the wide qkv, route (a))."""
    from octic_vits_tpu_torch import ops

    c8 = heads * d1
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    wq = (randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5),
          randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5), randn(gen, 3 * c8, scale=0.1))
    ef = randn(gen, b, n, 12 * c8)
    qs = tuple(randn(gen, b, n, 3 * c8) for _ in range(4)) + (ef[..., :6 * c8], ef[..., 6 * c8:])
    y1d = randn(gen, b, n, 12 * c8)
    w = 4 * c8
    q1d = (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], ef[..., :6 * c8], ef[..., 6 * c8:])
    x = randn(gen, b, n, 8 * c8)
    qkv = randn(gen, b, n, 24 * c8)
    return [("row2", ops.octic_attention_fused_qkv, ops.octic_attention_fused_qkv_reference,
             (*xs, *wq, heads)),
            ("row5", ops.octic_attention, ops.octic_attention_reference, (*qs, heads)),
            ("row10", ops.octic_attention_fused_qkv_packed,
             ops.octic_attention_fused_qkv_packed_reference, (x, *wq, heads)),
            ("row12", ops.octic_attention_wide1d, ops.octic_attention_wide1d_reference,
             (*q1d, heads)),
            ("row13a", ops.octic_attention_wide, ops.octic_attention_wide_reference, (qkv, heads))]


def octic_bwd_cases(gen, b, n, heads, dh):
    """(layout, op, plain version, args) of the attention backwards: the
    standard, octic, wide-1d and wide layouts and the chains of rows 2b and
    10's backward."""
    from octic_vits_tpu_torch import ops

    c = heads * dh
    c8 = c // 8
    gs = tuple(randn(gen, b, n, c8) for _ in range(4)) + tuple(
        randn(gen, b, n, 2 * c8) for _ in range(2))
    ef = randn(gen, b, n, 12 * c8)
    qs = tuple(randn(gen, b, n, 3 * c8) for _ in range(4)) + (ef[..., :6 * c8], ef[..., 6 * c8:])
    y1d = randn(gen, b, n, 12 * c8)
    w = 4 * c8
    q1d = (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], ef[..., :6 * c8], ef[..., 6 * c8:])
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    wq = (randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5),
          randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5), randn(gen, 3 * c8, scale=0.1))
    x = randn(gen, b, n, c)
    qkv, g = randn(gen, b, n, 3 * c), randn(gen, b, n, c)
    return [("std", ops.standard_attention_bwd, ops.standard_attention_bwd_reference,
             (qkv, g, heads)),
            ("octic", ops.octic_attention_bwd, ops.octic_attention_bwd_reference,
             (qs, gs, heads)),
            ("wide1d", ops.octic_attention_wide1d_bwd, ops.octic_attention_wide1d_bwd_reference,
             (q1d, gs, heads)),
            ("wide", ops.octic_attention_wide_bwd, ops.octic_attention_wide_bwd_reference,
             (qkv, gs, heads)),
            ("row2b", ops.octic_attention_fused_qkv_bwd,
             ops.octic_attention_fused_qkv_bwd_reference, (xs, *wq, gs, heads)),
            ("row10b", ops.octic_attention_fused_qkv_packed_bwd,
             ops.octic_attention_fused_qkv_packed_bwd_reference, (x, *wq, gs, heads))]


def redesign_25_phases(gen, summary, card) -> dict:
    """P25: K-lin-d8 on TMA + wgmma against its plain version in every mode
    and store at the main path's shapes and at ragged edges; the octic
    forward (rows 2, 5, 10, 12, 13a) at H/14 B=64 and B=32 and the L/16
    crops; every octic forward and every attention backward layout just past
    the old whole-head limits and at N = 1025; then, in turns, K-lin-d8
    against its mma.sync core at 64
    x 32 (ops.lin_d8_sync) and the octic forward against the whole-head core
    (ops.whole_head_octic_attention), each beside its bound, with the cuBLAS
    pair of the products for information: device times, each window one
    replay of a CUDA graph of 20 launches (tools/timing.py), since a K-lin-d8
    launch's host time (its Python checks and its 14-19 tensor maps,
    printed) is of the order of its device time; route (b)
    against copy + route (a) at the octic shapes; then the two yardstick ops
    once each.
    Returns the launches of that run."""
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.ops.attention import _qkv_rows
    from octic_vits_tpu_torch.tools.timing import host_us_per_call, in_turns

    failed = []

    def check(label, out, ref, scaled=False):
        torch.cuda.synchronize()
        err, ok = compare(out, ref, scaled)
        bar = f"{BWD_TOL}*(max|ref|+|ref|)" if scaled else f"{ATOL}+{RTOL}*|ref|"
        phase("P25", f"{label} max_abs_err {err:.3e} (tol {bar}) " + ("ok" if ok else "FAIL"))
        if not ok:
            failed.append(label)
        return err

    with torch.no_grad():
        lin_err = 0.0
        shapes = [(f"vith14_b64 {k}", BATCH * 257, c, f, mode, hd) for k, c, f, mode, hd in
                  LIN_CASES] + [(f"vith14_b32 {k}", TRAIN_BATCH * 257, c, f, mode, hd)
                                for k, c, f, mode, hd in LIN_CASES[:1] + LIN_CASES[3:]]
        shapes += [(f"l16_{crop} {k}", m, c, f, mode, hd) for crop, m in
                   (("global", 2 * SSL_BATCH * 197), ("local", 8 * SSL_BATCH * 37))
                   for k, c, f, mode, hd in LIN_SSL_CASES]
        shapes += [(f"{k} {mode}", m, c, f, mode, hd) for k, m, c, f, hd in LIN_EDGES
                   for mode in ("tuple", "gelu", "ls", "wide", "wide1d")]
        for label, m, c, f, mode, hd in shapes:
            args, kw = lin_inputs(gen, m, c, f, mode)
            run, ref = lin_run(mode, hd)
            lin_err = max(lin_err, check(f"K-lin-d8 [{label} M={m} c={c} F={f}]",
                                         run(*args, **kw), ref(*args, **kw)))
            del args, kw
        for m, c, f in ((148, 16, 24), (BATCH * 257, 160, 640)):  # the packed views, in and out
            for mode in ("tuple", "gelu"):
                (xs, w1, we, bias), kw = lin_inputs(gen, m, c, f, mode, packed=True)
                from octic_vits_tpu_torch.d8.group import unpack_packed_5f
                y = torch.full((m, 8 * f), float("nan"), device="cuda", dtype=torch.bfloat16)
                out = ops.lin_d8_launch(xs, w1, we, bias, mode == "gelu", out=unpack_packed_5f(y))
                lin_err = max(lin_err, check(
                    f"K-lin-d8 [packed row strides {mode} M={m} c={c} F={f}]", tuple(out),
                    ops.linear_d8_fused_reference(xs, w1, we, bias, mode == "gelu")))
                del xs, y, out
        torch.cuda.empty_cache()

        attn_err = 0.0
        for label, b, n, heads, d1 in OCTIC_SHAPES + OCTIC_LONG:
            for row, op, ref, args in octic_fwd_cases(gen, b, n, heads, d1):
                attn_err = max(attn_err, check(f"octic forward {row} [{label} B={b} N={n} "
                                               f"H={heads} d1={d1}]", op(*args), ref(*args)))
            torch.cuda.empty_cache()
        for label, b, n, heads, dh in BWD_LONG:
            for lay, op, ref, args in octic_bwd_cases(gen, b, n, heads, dh):
                check(f"backward {lay} [{label} B={b} N={n} H={heads} dh={dh}]",
                      op(*args), ref(*args), scaled=True)
        torch.cuda.empty_cache()
        if failed:
            raise AssertionError(f"P25 kernels outside tolerance: {failed}")

        # ---- times in turns at H/14 B=64, each beside its bound
        m = BATCH * 257
        lin_times = {}
        for key, c, f, mode, hd in LIN_CASES[:2] + LIN_CASES[3:]:
            args, kw = lin_inputs(gen, m, c, f, mode)
            run, _ = lin_run(mode, hd)
            xs, w1, we, bias = args
            sync_kw = dict(kw, num_heads=hd) if mode == "wide" else kw
            x1 = torch.stack(xs[:4])
            rows = xs[4].view(m, 2, 2 * c)
            cases = {"K-lin-d8 TMA + wgmma": lambda: run(*args, **kw),
                     "mma.sync core 64x32 (parent)": lambda: ops.lin_d8_sync(*args, **sync_kw),
                     "cuBLAS bmm + matmul (no epilogue)": lambda: (torch.bmm(x1, w1),
                                                                   torch.matmul(rows, we))}
            res = in_turns(cases, graph=True)
            bms, bby = bound_of(*lin_work(m, c, f, mode))
            med = res["median"]
            lin_times[key] = {"ms": med["K-lin-d8 TMA + wgmma"],
                              "parent_ms": med["mma.sync core 64x32 (parent)"],
                              "cublas_ms": med["cuBLAS bmm + matmul (no epilogue)"],
                              "bound_ms": bms, "bound_by": bby,
                              "turns": res["ms"]}
            phase("P25", f"K-lin-d8 [{key} vith14_b64 M={m} c={c} F={f}] in turns on {card}: "
                         + "; ".join(f"{k} {v:.4f} ms ({bms / v:.1%} of bound)"
                                     for k, v in med.items())
                         + f"; bound {bms:.4f} ms ({bby}); turns "
                         + str({k: [round(t, 4) for t in v] for k, v in res["ms"].items()}))
            del args, kw, cases, x1
        g = lin_times["qkv_wide"]["ms"] / lin_times["qkv"]["ms"]
        phase("P25", f"K-lin-d8 grouped-column store / tuple store at the H/14 qkv: {g:.3f}")
        args, kw = lin_inputs(gen, 148, 16, 24, "tuple")
        host = {"K-lin-d8 TMA + wgmma": host_us_per_call(lambda: ops.lin_d8_launch(*args, False)),
                "mma.sync core 64x32 (parent)": host_us_per_call(lambda: ops.lin_d8_sync(*args)),
                "linear_d8_fused (the op)": host_us_per_call(lambda: ops.linear_d8_fused(*args))}
        phase("P25", "host us per call (enqueue, small shape; the first two launch directly): "
                     + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))

        b, n, heads, d1 = BATCH, 257, 16, 10
        cases5 = {c[0]: c for c in octic_fwd_cases(gen, b, n, heads, d1)}
        _, _, _, a5 = cases5["row5"]
        _, _, _, a2 = cases5["row2"]
        _, _, _, a13 = cases5["row13a"]
        _, _, _, a12 = cases5["row12"]
        xs2, wq2 = a2[:5], a2[5:8]
        std_qkv = randn(gen, b, n, 3 * 8 * heads * d1)
        cases = {"row 5, route (b)": lambda: ops.octic_attention(*a5),
                 "whole-head core (parent)": lambda: ops.whole_head_octic_attention(*a5),
                 "row 13a, route (a)": lambda: ops.octic_attention_wide(*a13),
                 "row 12, route (b)": lambda: ops.octic_attention_wide1d(*a12),
                 "standard forward, same bytes": lambda: ops.standard_attention(std_qkv, heads),
                 "row 2: qkv + route (a)": lambda: ops.octic_attention_fused_qkv(*a2),
                 "row 2 parent: mma.sync qkv + whole-head core": lambda: (
                     ops.whole_head_octic_attention(*_qkv_rows(ops.lin_d8_sync(xs2, *wq2)),
                                                    heads))}
        res = in_turns(cases, graph=True)
        med = res["median"]
        bms, bby = bound_of(*work("octic_attention", b, n, 8 * heads * d1, heads, False))
        b2ms, b2by = bound_of(*work("octic_attention_fused_qkv", b, n, 8 * heads * d1, heads,
                                    True))
        phase("P25", f"octic forward [vith14_b64] in turns on {card}: "
                     + "; ".join(f"{k} {v:.4f} ms" for k, v in med.items())
                     + f"; bound {bms:.4f} ms ({bby}), row 2's {b2ms:.4f} ms ({b2by}); turns "
                     + str({k: [round(t, 4) for t in v] for k, v in res["ms"].items()}))
        del cases, cases5, a5, a2, a13, a12, std_qkv
        torch.cuda.empty_cache()
        route_b = route_b_against_copy(gen, card)

        summary.setdefault("linear_d8_fused", {}).setdefault("cases", {}).update(
            {f"p25_{k}": v for k, v in lin_times.items()})
        summary["linear_d8_fused"]["max_abs_err"] = max(
            summary["linear_d8_fused"].get("max_abs_err", 0.0), lin_err)
        summary["octic_attention"].setdefault("cases", {})["p25_vith14_b64"] = {
            "ms": med["row 5, route (b)"], "route_a_ms": med["row 13a, route (a)"],
            "wide1d_ms": med["row 12, route (b)"], "parent_ms": med["whole-head core (parent)"],
            "bound_ms": bms, "bound_by": bby}
        summary["octic_attention"]["cases"].update(
            {f"p25_route_b_{k}": v for k, v in route_b.items()})
        summary["octic_attention"]["max_abs_err"] = max(summary["octic_attention"]["max_abs_err"],
                                                        attn_err)
        summary["octic_attention_fused_qkv"].setdefault("cases", {})["p25_vith14_b64"] = {
            "ms": med["row 2: qkv + route (a)"],
            "parent_ms": med["row 2 parent: mma.sync qkv + whole-head core"],
            "bound_ms": b2ms, "bound_by": b2by}
        # the yardsticks' own rows: their time here, the plain version's, the bound
        (xs, w1, we, bias), _ = lin_inputs(gen, m, 160, 480, "tuple")
        _, _, _, a5 = octic_fwd_cases(gen, b, n, heads, d1)[1]
        summary["lin_d8_sync"] = {
            "ms": lin_times["qkv"]["parent_ms"], "max_abs_err": 0.0, "library_ms": None,
            "plain_ms": time_ms(lambda: ops.lin_d8_sync.reference(xs, w1, we, bias), iters=5),
            "bound": (lin_times["qkv"]["bound_ms"], lin_times["qkv"]["bound_by"]),
            "shape": [m, 160, 480], "cases": lin_times}
        summary["whole_head_octic_attention"] = {
            "ms": med["whole-head core (parent)"], "max_abs_err": 0.0, "library_ms": None,
            "plain_ms": time_ms(lambda: ops.whole_head_octic_attention.reference(*a5), iters=5),
            "bound": (bms, bby), "shape": [b, n, 8 * heads * d1, heads, False]}
        for op, args, kw in ((ops.lin_d8_sync, (xs, w1, we, bias), {}),
                             (ops.whole_head_octic_attention, a5, {})):
            err, ok = compare(op(*args, **kw), op.reference(*args, **kw))
            summary[op.__name__]["max_abs_err"] = err
            phase("P25", f"{op.__name__} [vith14_b64] max_abs_err {err:.3e} (tol {ATOL}+{RTOL}"
                         f"*|ref|) " + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError(f"{op.__name__} outside tolerance")
        # the yardsticks' path: each once
        ops.reset_launch_counts()
        ops.lin_d8_sync(xs, w1, we, bias)
        ops.whole_head_octic_attention(*a5)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    want = {"lin_d8_sync": 1, "whole_head_octic_attention": 1}
    if counts != expected_launches(want):
        raise AssertionError(f"P25 yardstick launches {counts}, expected {want}")
    phase("P25", f"yardstick path: {sorted(want)} launched once each on {card}")
    del xs, a5
    torch.cuda.empty_cache()
    return counts


def route_b_against_copy(gen, card) -> dict:
    """Route (b) of rows 5 and 12 (the caller's arrays read in place as
    padded boxes) in turns with the same op as one copy into the wide qkv
    (torch.cat) and route (a), and with the copy alone, at H/14 B=64 and B=32
    and the L/16 crops: device times by CUDA-graph replay."""
    from octic_vits_tpu_torch.ops import attention as A
    from octic_vits_tpu_torch.tools.timing import in_turns

    out = {}
    with torch.no_grad():
        for label, b, n, heads, d1 in OCTIC_SHAPES:
            cases = {c[0]: c[3] for c in octic_fwd_cases(gen, b, n, heads, d1)}
            a5, a12 = cases["row5"][:6], cases["row12"][:5]
            res = in_turns({
                "row 5, route (b)": lambda: A._octic_rows_launch(a5, heads),
                "row 5, copy + route (a)": lambda: A._octic_wide_launch(
                    A._octic_to_wide(a5, heads), heads),
                "row 12, route (b)": lambda: A.octic_attention_wide1d(*a12, heads),
                "row 12, copy + route (a)": lambda: A._octic_wide_launch(
                    A._wide1d_to_wide(a12, heads), heads),
                "copy alone (row 5)": lambda: A._octic_to_wide(a5, heads)}, graph=True)
            med = res["median"]
            out[label] = {k: round(v, 5) for k, v in med.items()}
            phase("P25", f"route (b) against copy + route (a) [{label} B={b} N={n} H={heads} "
                         f"d1={d1}] in turns on {card}: "
                         + "; ".join(f"{k} {v:.4f} ms" for k, v in med.items()) + "; turns "
                         + str({k: [round(t, 4) for t in v] for k, v in res["ms"].items()}))
            del cases, a5, a12
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# P26: K-attn-bwd (csrc/attention_bwd.cu on csrc/attention_bwd_sm90.cuh) on
# TMA + wgmma, every layout, against its mma.sync core
# ---------------------------------------------------------------------------
# (label, b, n, heads, dh): the main path's shapes, then the plan's edges
# (heads so that C/8 is a multiple of 8, as the chains' K-lin-d8 needs)
BWD_SHAPES = (("vith14_b32", TRAIN_BATCH, 257, 16, 80),
              ("l16_global", 2 * SSL_BATCH, 197, 16, 64),
              ("l16_local", 8 * SSL_BATCH, 37, 16, 64))
BWD_EDGES = tuple((f"n{n}_dh{dh}", 2, n, 64 // math.gcd(dh, 64) * (2 if dh % 64 == 0 else 1), dh)
                  for n, dh in ((1, 16), (37, 24), (64, 40), (65, 64), (197, 80), (257, 120),
                                (321, 128), (385, 80), (1025, 80), (65, 16), (257, 128),
                                (1025, 64)))


def sdpa_backend_bwd(qkv, g, heads, backend):
    """SDPA's backward (as library_sdpa_bwd) after one forward recorded under
    one backend (torch.nn.attention.SDPBackend), which picks the backward's
    kernel."""
    from torch.nn.attention import sdpa_kernel

    leaf = qkv.detach().requires_grad_()
    with torch.enable_grad(), sdpa_kernel(backend):
        out = torch.nn.functional.scaled_dot_product_attention(*sdpa_views(leaf, heads))
    b, n, c = g.shape
    gv = g.view(b, n, heads, c // heads).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaf, gv, retain_graph=True)


def bwd_heads_independent(gen, b=2, n=65, heads=4, dh=80) -> bool:
    """An Inf in every column of head 1 of q, k, v and of the cotangent, in
    each octic layout's arrays, leaves head 0's gradients as they were."""
    from octic_vits_tpu_torch import ops

    d1 = dh // 8
    ok = True
    for lay, op, _, args in octic_bwd_cases(gen, b, n, heads, dh)[1:4]:
        clean = [t.clone() for t in op(*args)]
        qs, gs = args[0], args[1]
        if lay == "wide":  # one interleaved qkv: head 1's slice of each of q, k, v
            for s_ in range(3):
                qs[..., (s_ * heads + 1) * dh:(s_ * heads + 2) * dh] = float("inf")
        elif lay == "octic":
            for i, t in enumerate(qs):
                w = d1 if i < 4 else 2 * d1
                for s_ in range(3):
                    t[..., (s_ * heads + 1) * w:(s_ * heads + 2) * w] = float("inf")
        else:  # wide1d: q1d, k1d, v1d head 1's 4 d1 slice; e0, e1 as the octic arrays
            for i, t in enumerate(qs):
                w = 4 * d1 if i < 3 else 2 * d1
                for s_ in range(1 if i < 3 else 3):
                    t[..., (s_ * heads + 1) * w:(s_ * heads + 2) * w] = float("inf")
        for i, t in enumerate(gs):
            w = d1 if i < 4 else 2 * d1
            t[..., w:2 * w] = float("inf")
        got = op(*args)
        torch.cuda.synchronize()
        for out, want in zip(got, clean):
            w = out.shape[-1] // (3 * heads) if lay != "wide" else dh
            if lay == "wide1d" and out.shape[-1] == 4 * heads * d1:
                cols = [slice(0, 4 * d1)]
            else:
                cols = [slice(s_ * heads * w, s_ * heads * w + w) for s_ in range(3)]
            ok &= all(torch.equal(out[..., c], want[..., c]) for c in cols)
    return ok


def redesign_26_phases(gen, summary, card) -> dict:
    """P26: K-attn-bwd on TMA + wgmma in every layout against its plain
    version under the backward bar at the main path's shapes and at the
    plan's edges; bitwise repeatable; heads independent; then in turns by
    CUDA-graph replay (tools/timing.py) the new kernel against its mma.sync
    core in both forms (ops.attention_bwd_sync, the form forced) and SDPA's
    backward under each backend that runs, each beside its bound; route (a)'s
    assembly alone; the host time per call; the yardstick launched once.
    Returns the launches of that run."""
    from torch.nn.attention import SDPBackend

    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.ops import attention as A
    from octic_vits_tpu_torch.tools.timing import host_us_per_call, in_turns

    failed, errs = [], {}
    with torch.no_grad():
        for label, b, n, heads, dh in BWD_SHAPES + BWD_EDGES:
            for lay, op, ref, args in octic_bwd_cases(gen, b, n, heads, dh):
                out, want = op(*args), ref(*args)
                torch.cuda.synchronize()
                err, ok = compare(out, want, scaled=True)
                errs[lay] = max(errs.get(lay, 0.0), err)
                phase("P26", f"backward {lay} [{label} B={b} N={n} H={heads} dh={dh}] "
                             f"max_abs_err {err:.3e} (tol {BWD_TOL}*(max|ref|+|ref|)) "
                             + ("ok" if ok else "FAIL"))
                failed += [] if ok else [f"{lay}[{label}]"]
            torch.cuda.empty_cache()
        b, n, heads, dh = BWD_SHAPES[0][1:]
        cases = {c[0]: c for c in octic_bwd_cases(gen, b, n, heads, dh)}
        for lay in ("std", "octic", "row2b"):
            _, op, _, args = cases[lay]
            first, second = op(*args), op(*args)
            same = all(torch.equal(x, y) for x, y in zip(
                first if isinstance(first, tuple) else (first,),
                second if isinstance(second, tuple) else (second,)) if x is not None)
            phase("P26", f"backward {lay} [vith14_b32] two launches bitwise equal: {same}")
            failed += [] if same else [f"{lay} not repeatable"]
        apart = bwd_heads_independent(gen)
        phase("P26", f"backward octic, wide-1d, wide: an Inf in head 1 leaves head 0's "
                     f"gradients unchanged: {apart}")
        failed += [] if apart else ["heads not independent"]
        # the yardstick's mma.sync core in both layouts and both forms
        for lay in ("std", "octic"):
            _, _, ref, args = cases[lay]
            want = ref(*args)
            for streamed in (False, True):
                form = "streamed" if streamed else "whole-head"
                err, ok = compare(ops.attention_bwd_sync(*args, streamed), want, scaled=True)
                errs["sync"] = max(errs.get("sync", 0.0), err)
                phase("P26", f"attention_bwd_sync {lay} {form} [vith14_b32] max_abs_err "
                             f"{err:.3e} (tol {BWD_TOL}*(max|ref|+|ref|)) " + ("ok" if ok else "FAIL"))
                failed += [] if ok else [f"attention_bwd_sync {lay} {form}"]
        if failed:
            raise AssertionError(f"P26 kernels outside tolerance: {failed}")

        # ---- times in turns, each beside its bound
        times = {}
        for label, b, n, heads, dh in BWD_SHAPES + (("n1025_dh80", 2, 1025, 16, 80),):
            c = heads * dh
            qkv, g = randn(gen, b, n, 3 * c), randn(gen, b, n, c)
            cs = {"TMA + wgmma": lambda: ops.standard_attention_bwd(qkv, g, heads),
                  "mma.sync core, streamed": lambda: ops.attention_bwd_sync(qkv, g, heads, True)}
            if not A.attention_bwd_plan(n, dh)["streamed"]:
                cs["mma.sync core, whole-head"] = (
                    lambda: ops.attention_bwd_sync(qkv, g, heads, False))
            res = in_turns(cs, graph=True)
            lib = {"SDPA backward (yardstick)": library_sdpa_bwd(qkv, g, heads)}
            for name, be in (("SDPA flash", SDPBackend.FLASH_ATTENTION),
                             ("SDPA efficient", SDPBackend.EFFICIENT_ATTENTION),
                             ("SDPA cuDNN", SDPBackend.CUDNN_ATTENTION)):
                try:
                    fn = sdpa_backend_bwd(qkv, g, heads, be)
                    fn()
                    torch.cuda.synchronize()
                    lib[name] = fn
                except RuntimeError as exc:  # the backend has no kernel for these inputs
                    phase("P26", f"{name} backward does not run at {label}: "
                                 f"{str(exc).splitlines()[0]}")
            lres = in_turns(lib)  # autograd's backward: windows of 20 calls, host included
            med = res["median"] | lres["median"]
            bms, bby = bound_of(*work("standard_attention_bwd", b, n, c, heads, False))
            yard = device_kernel_names(lib["SDPA backward (yardstick)"])
            phase("P26", f"standard_attention_bwd [{label} B={b} N={n} H={heads} dh={dh}] in "
                         f"turns on {card}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in med.items())
                         + f"; bound {bms:.4f} ms ({bby}); the yardstick SDPA launched {yard}; "
                         f"turns {res['ms']}")
            times[label] = {"ms": med["TMA + wgmma"], "sync_ms": {
                k: v for k, v in med.items() if k.startswith("mma.sync")},
                "library_ms": med["SDPA backward (yardstick)"], "sdpa_kernels": yard,
                "sdpa_backend_ms": {k: v for k, v in med.items() if k.startswith("SDPA ")},
                "bound_ms": bms, "bound_by": bby}
            del qkv, g, cs, lib
            torch.cuda.empty_cache()
        for label in ("vith14_b32", "n1025_dh80"):
            t = times[label]
            phase("P26", f"[{label}] mma.sync streamed / TMA + wgmma: "
                         f"{t['sync_ms']['mma.sync core, streamed'] / t['ms']:.3f}")

        b, n, heads, dh = BWD_SHAPES[0][1:]
        c8 = heads * dh // 8
        cases = {c[0]: c for c in octic_bwd_cases(gen, b, n, heads, dh)}
        qs, gs, _ = cases["octic"][3]
        lq, lg = [t.stride(-2) for t in qs], [t.stride(-2) for t in gs]
        segs = [dh // 8] * 4 + [dh // 4] * 2
        wide = torch.empty(b, n, 24 * c8, device="cuda", dtype=torch.bfloat16)
        gw = torch.empty(b, n, 8 * c8, device="cuda", dtype=torch.bfloat16)
        run = {f"{lay} TMA + wgmma": (lambda op=op, args=args: op(*args))
               for lay, op, _, args in cases.values()}
        run |= {"octic mma.sync core, whole-head": lambda: ops.attention_bwd_sync(qs, gs, heads,
                                                                                  False),
                "octic mma.sync core, streamed": lambda: ops.attention_bwd_sync(qs, gs, heads,
                                                                                True),
                "route (a) assembly of the octic qkv": lambda: A._pack_heads(
                    wide, A._octic_array_pieces(qs, lq, heads, dh // 8), segs, heads),
                "route (a) assembly of the cotangents": lambda: A._pack_heads(
                    gw, [[(t, ld, 0, w) for t, ld, w in zip(gs, lg, segs)]], segs, heads)}
        res = in_turns(run, graph=True)
        bms, bby = bound_of(*work("octic_attention_bwd", b, n, heads * dh, heads, False))
        phase("P26", f"octic backwards [vith14_b32] in turns on {card}: "
                     + "; ".join(f"{k} {v:.4f} ms" for k, v in res["median"].items())
                     + f"; bound {bms:.4f} ms ({bby}); turns {res['ms']}")
        times["octic_vith14_b32"] = dict(res["median"], bound_ms=bms, bound_by=bby)
        del cases, qs, gs, wide, gw, run
        torch.cuda.empty_cache()

        # the host's side of a launch: the plan, the table, the tensor maps
        small = {c[0]: c[3] for c in octic_bwd_cases(gen, 1, 37, 2, 64)}
        host = {"standard_attention_bwd": host_us_per_call(
                    lambda: ops.standard_attention_bwd(*small["std"])),
                "attention_bwd_sync (std)": host_us_per_call(
                    lambda: ops.attention_bwd_sync(*small["std"])),
                "octic_attention_bwd": host_us_per_call(
                    lambda: ops.octic_attention_bwd(*small["octic"])),
                "attention_bwd_sync (octic)": host_us_per_call(
                    lambda: ops.attention_bwd_sync(*small["octic"]))}
        phase("P26", "host us per call (enqueue, B=1, N=37, 2 heads, dh 64): "
                     + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
        times["host_us"] = host
        del small

        summary["standard_attention_bwd"].setdefault("cases", {}).update(
            {f"p26_{k}": v for k, v in times.items()})
        for lay, name in (("std", "standard_attention_bwd"), ("octic", "octic_attention_bwd"),
                          ("wide1d", "octic_attention_wide1d_bwd"),
                          ("wide", "octic_attention_wide_bwd")):
            if name in summary and "max_abs_err" in summary[name]:
                summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], errs[lay])
        # the yardstick's own row: its time here (SDPA's backward at the same
        # shape the library call), the plain version's, the bound
        b, n, heads, dh = BWD_SHAPES[0][1:]
        qkv, g = randn(gen, b, n, 3 * heads * dh), randn(gen, b, n, heads * dh)
        t = times["vith14_b32"]
        summary["attention_bwd_sync"] = {
            "ms": t["sync_ms"]["mma.sync core, whole-head"], "max_abs_err": errs["sync"],
            "library_ms": t["library_ms"],
            "plain_ms": time_ms(lambda: ops.attention_bwd_sync.reference(qkv, g, heads), iters=5),
            "bound": (t["bound_ms"], t["bound_by"]), "shape": [b, n, heads * dh, heads, False],
            "cases": {"streamed_ms": t["sync_ms"]["mma.sync core, streamed"]}}
        # the yardstick's path: once
        ops.reset_launch_counts()
        ops.attention_bwd_sync(qkv, g, heads)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    want = {"attention_bwd_sync": 1}
    if counts != expected_launches(want):
        raise AssertionError(f"P26 yardstick launches {counts}, expected {want}")
    phase("P26", f"yardstick path: attention_bwd_sync launched once on {card}")
    del qkv, g
    torch.cuda.empty_cache()
    return counts


def bound_lin_d8_bwd(b: int, n: int, c: int) -> tuple:
    """(bound_ms, bound_by) of K-lin-d8-bwd alone: x and dqkv in, dx out, the
    weights in and their gradients out; dx and dW products."""
    m, c8 = b * n, c // 8
    return bound_of((m * (c + 3 * c + c) + 2 * 24 * c8 * c8) * 2, 144 * m * c8 * c8)


if __name__ == "__main__":
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    sys.exit(rc)
