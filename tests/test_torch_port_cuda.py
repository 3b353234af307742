"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (bf16), forward and backward, and the small hybrid model on the
card (inference, and one train step) against the same weights in f32 on the
CPU. Skipped without a CUDA device. This file imports
no JAX; on a machine without JAX run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_cuda.py
"""

import pytest
import torch

from octic_vits_tpu_torch import create_model, init_weights, ops

pytestmark = pytest.mark.gpu

# |kernel - plain| <= ATOL + RTOL |plain|: one or two bf16 ulps of the
# output plus f32 summation order (both sides round to bf16 at the same points)
ATOL, RTOL = 1e-2, 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _assert_close(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(outs) == len(refs)
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.shape == r.shape and o.dtype == r.dtype == torch.bfloat16
        torch.testing.assert_close(o.float(), r.float(), atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"output {i}: {m}")


def _counted(op, *args):
    before = op.launches
    out = op(*args)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    return out


def _only(**counts) -> dict:
    """Every kernel op's launch count: those given, every other 0."""
    return {op.__name__: 0 for op in ops.KERNEL_OPS} | counts


# (b, n, c, heads, bias). The octic head pieces (d1 = c/(8 heads), de = 2 d1)
# take the attention gather's 8-byte (d1=4), 4-byte (d1=10, ViT-H) and
# 2-byte (d1=3) load paths; the standard head dims take 16-byte loads.
SHAPES = [(2, 17, 64, 2, True), (3, 65, 64, 2, False), (2, 257, 1280, 16, True),
          (1, 50, 192, 3, True), (2, 33, 192, 8, False)]


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_standard_attention_kernel(gen, b, n, c, heads, bias):
    qkv = _randn(gen, b, n, 3 * c)
    _assert_close(_counted(ops.standard_attention, qkv, heads),
                  ops.standard_attention_reference(qkv, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_fused_qkv_kernel(gen, b, n, c, heads, bias):
    c8 = c // 8
    xs = [_randn(gen, b, n, c8) for _ in range(4)] + [_randn(gen, b, n, 4 * c8)]
    w1 = _randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5)
    we = _randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5)
    bq = _randn(gen, 3 * c8, scale=0.1) if bias else None
    _assert_close(_counted(ops.octic_attention_fused_qkv, *xs, w1, we, bq, heads),
                  ops.octic_attention_fused_qkv_reference(*xs, w1, we, bq, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_dense_gelu_kernel(gen, b, n, c, heads, bias):
    x = _randn(gen, b, n, c)
    w = _randn(gen, 4 * c, c, scale=c ** -0.5)
    bb = _randn(gen, 4 * c, scale=0.1) if bias else None
    _assert_close(_counted(ops.dense_gelu, x, w, bb), ops.dense_gelu_reference(x, w, bb))


# The TMA + wgmma kernels' edges: every head width's column boxes (16, 16 +
# 8, 32, 32 + 8, 64, 64 + 16, 64 + 32 + 16 + 8, 64 + 64), token counts that
# fold key N - 1 in (65, 257), end on a masked key tile (37, 197) or hold
# one token; K-dense's ragged M, K of one and three 64-blocks, F off the
# 128-column tile, M below one tile.
STD_EDGES = [(2, n, 2, dh) for dh in (16, 24, 32, 40, 64, 80, 120, 128)
             for n in (1, 37, 65, 197, 257)]
DENSE_EDGES = [(130, 64, 264, True), (300, 192, 8, False), (1000, 1280, 520, True),
               (129, 1280, 5120, True), (7, 64, 128, False)]


@pytest.mark.parametrize("b,n,heads,dh", STD_EDGES)
def test_standard_attention_sm90_edges(gen, b, n, heads, dh):
    qkv = _randn(gen, b, n, 3 * heads * dh)
    _assert_close(_counted(ops.standard_attention, qkv, heads),
                  ops.standard_attention_reference(qkv, heads))


@pytest.mark.parametrize("m,k,f,bias", DENSE_EDGES)
def test_dense_gelu_sm90_edges(gen, m, k, f, bias):
    x = _randn(gen, m, k)
    w = _randn(gen, f, k, scale=k ** -0.5)
    bb = _randn(gen, f, scale=0.1) if bias else None
    _assert_close(_counted(ops.dense_gelu, x, w, bb), ops.dense_gelu_reference(x, w, bb))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_mlp_d8_fused_kernel(gen, b, n, c, heads, bias):
    c8, h8 = c // 8, c // 2
    xs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),)
    args = (xs, _randn(gen, 4, c8, h8, scale=c8 ** -0.5),
            _randn(gen, 2 * c8, 2 * h8, scale=(2 * c8) ** -0.5),
            _randn(gen, h8, scale=0.1) if bias else None,
            _randn(gen, 4, h8, c8, scale=h8 ** -0.5),
            _randn(gen, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5),
            _randn(gen, c8, scale=0.1) if bias else None)
    _assert_close(_counted(ops.mlp_d8_fused, *args), ops.mlp_d8_fused_reference(*args))


# Backward kernels: |kernel - plain| <= BWD_TOL * (max|plain| + |plain|). The
# gradients sum 2N products whose operands the kernel rounds to bf16 (P and
# dS, as the JAX bf16 kernel does) while the plain version keeps f32, so the
# bar is set against the scale of the whole gradient, not each element.
BWD_TOL = 2e-2


def _assert_close_scaled(out, ref, tol=BWD_TOL):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(outs) == len(refs)
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.shape == r.shape and o.dtype == r.dtype == torch.bfloat16
        o, r = o.float(), r.float()
        assert torch.isfinite(o).all()
        err = (o - r).abs()
        bar = tol * (r.abs().max() + r.abs())
        assert bool((err <= bar).all()), f"output {i}: max err {err.max().item():.3e}, " \
            f"max |ref| {r.abs().max().item():.3e}"


def _octic_qkv(gen, b, n, c):
    """a1..b2 [B,N,3C/8] and e0, e1 as the two column halves of one flat-E
    qkv [B,N,3C/2] (strided views, as on the train path)."""
    c8 = c // 8
    ones = tuple(_randn(gen, b, n, 3 * c8) for _ in range(4))
    ef = _randn(gen, b, n, 12 * c8)
    return ones + (ef[..., :6 * c8], ef[..., 6 * c8:])


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_standard_attention_bwd_kernel(gen, b, n, c, heads, bias):
    qkv, g = _randn(gen, b, n, 3 * c), _randn(gen, b, n, c)
    _assert_close_scaled(_counted(ops.standard_attention_bwd, qkv, g, heads),
                         ops.standard_attention_bwd_reference(qkv, g, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_kernel(gen, b, n, c, heads, bias):
    qs = _octic_qkv(gen, b, n, c)
    _assert_close(_counted(ops.octic_attention, *qs, heads),
                  ops.octic_attention_reference(*qs, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_bwd_kernel(gen, b, n, c, heads, bias):
    qs = _octic_qkv(gen, b, n, c)
    c8 = c // 8
    gs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + tuple(
        _randn(gen, b, n, 2 * c8) for _ in range(2))
    _assert_close_scaled(_counted(ops.octic_attention_bwd, qs, gs, heads),
                         ops.octic_attention_bwd_reference(qs, gs, heads))


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_linear_d8_fused_kernel(gen, b, n, c, heads, bias, gelu):
    c8, f8 = c // 8, c // 2
    xs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),)
    args = (xs, _randn(gen, 4, c8, f8, scale=c8 ** -0.5),
            _randn(gen, 2 * c8, 2 * f8, scale=(2 * c8) ** -0.5),
            _randn(gen, f8, scale=0.1) if bias else None, gelu)
    _assert_close(_counted(ops.linear_d8_fused, *args), ops.linear_d8_fused_reference(*args))


def test_attention_autograd_launches_backward_kernels(gen):
    qkv = _randn(gen, 2, 17, 192).requires_grad_()
    qs = tuple(t.detach().requires_grad_() for t in _octic_qkv(gen, 2, 17, 64))
    ops.reset_launch_counts()
    out = ops.standard_attention(qkv, 2).float().sum()
    out = out + sum(o.float().sum() for o in ops.octic_attention(*qs, 2))
    out.backward()
    counts = ops.launch_counts()
    assert counts["standard_attention_bwd"] == counts["octic_attention_bwd"] == 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (qkv,) + qs)


def test_mlp_d8_fused_autograd_launches_backward(gen):
    """The fused octic MLP is differentiable since the packed-carry slice:
    its backward (row 4's) recomputes the hidden through K-lin-d8 and matches
    the plain backward."""
    xs = tuple(_randn(gen, 1, 5, 8) for _ in range(4)) + (_randn(gen, 1, 5, 32),)
    ws = (_randn(gen, 4, 8, 16), _randn(gen, 16, 32), None, _randn(gen, 4, 16, 8),
          _randn(gen, 32, 16), None)
    leaves = tuple(t.detach().requires_grad_() for t in xs)
    gs = tuple(_randn(gen, *t.shape) for t in xs)
    ops.reset_launch_counts()
    torch.autograd.backward(ops.mlp_d8_fused(leaves, *ws), gs)
    assert ops.launch_counts() == _only(mlp_d8_fused=1, mlp_d8_fused_bwd=1)
    ref = ops.mlp_d8_fused_bwd_reference(xs, *ws, gs)
    _assert_close_scaled(tuple(t.grad for t in leaves), ref[:5])


def test_eval_mode_model_differentiates(gen):
    """In eval mode the octic blocks take the fused kernels, each with its
    backward: the input gradient of the eval-mode model is finite."""
    model = create_model("hybrid_vit_small_test", device="cuda", dtype=torch.bfloat16).eval()
    init_weights(model, torch.Generator("cuda").manual_seed(0))
    img = _randn(gen, 1, 64, 64, 3).requires_grad_()
    ops.reset_launch_counts()
    model(img).float().sum().backward()
    counts = ops.launch_counts()
    assert counts["octic_attention_fused_qkv_bwd"] == counts["mlp_d8_fused_bwd"] == 2
    assert torch.isfinite(img.grad).all()


def test_kernels_reject_f32(gen):
    with pytest.raises(TypeError):
        ops.standard_attention(torch.zeros(1, 4, 48, device="cuda"), 2)


def test_octic_attention_rejects_wrong_qkv_width(gen):
    c8 = 8
    xs = [_randn(gen, 1, 5, c8) for _ in range(4)] + [_randn(gen, 1, 5, 4 * c8)]
    w1, we = _randn(gen, 4, c8, 2 * c8), _randn(gen, 2 * c8, 4 * c8)
    with pytest.raises(ValueError):
        ops.octic_attention_fused_qkv(*xs, w1, we, None, 2)


def test_small_hybrid_model_on_card(gen):
    cpu = create_model("hybrid_vit_small_test", init_scale=1.0, device="cpu").eval()
    init_weights(cpu, torch.Generator().manual_seed(0))
    gpu = create_model("hybrid_vit_small_test", init_scale=1.0, device="cuda",
                       dtype=torch.bfloat16).eval()
    gpu.load_state_dict(cpu.state_dict())
    img = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    img = img.to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = gpu(img.cuda()).float().cpu()
        ref = cpu(img.float())
    assert ops.launch_counts() == _only(standard_attention=2, octic_attention_fused_qkv=2,
                                        dense_gelu=2, mlp_d8_fused=2)
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 5e-2


def test_small_hybrid_train_step_on_card(gen):
    """One DeiT III step of the small hybrid (train flags, remat, bf16
    compute over f32 parameters) on the card against the same weights in f32
    on the CPU: loss within 5e-2 and gradient cosine above 0.99 (the bars of
    chip_smoke.py P6), every train kernel launched."""
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine

    cpu = create_model("hybrid_vit_small_test", init_scale=1.0, device="cpu")
    init_weights(cpu, torch.Generator().manual_seed(0))
    card = create_model("hybrid_vit_small_test", init_scale=1.0,
                        remat=True, compute_dtype=torch.bfloat16, device="cuda")
    card.load_state_dict(cpu.state_dict())
    cfg = engine.DeiTConfig(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0)
    opt = engine.build_optimizer(cfg, card)
    step = engine.make_deit_train_step(card, cfg, opt)
    img = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    img = img.to(torch.bfloat16).float()
    labels = torch.tensor([1, 4, 7, 9])
    ops.reset_launch_counts()
    _, metrics = step(common.create_train_state(card, opt), img.cuda(), labels.cuda(),
                      torch.Generator().manual_seed(0))
    counts = ops.launch_counts()
    assert counts["standard_attention_bwd"] == counts["octic_attention_bwd"] == 2
    assert counts["octic_attention"] == counts["standard_attention"] == 2
    assert counts["linear_d8_fused"] == 8 and counts["dense_gelu"] == 4
    cpu.train()
    loss = common.bce_target_loss(cpu(img), torch.nn.functional.one_hot(labels, 10).float())
    loss.backward()
    assert abs(metrics["loss"].item() - loss.item()) <= 5e-2 * abs(loss.item())
    a = torch.cat([p.grad.float().reshape(-1).cpu() for p in card.parameters()])
    b = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0).item() > 0.99


# ---- the DINOv2 slice: K-lin-d8-bwd and the backward of the fused qkv + attention


def _fused_bwd_args(gen, b, n, c, bias):
    """Residuals of the fused op (flat-E input, qkv weights) and its six
    output cotangents, the E ones as column slices of one [B, N, C/2]
    tensor (the proj's input gradient on the train path)."""
    c8 = c // 8
    xs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),)
    w1 = _randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5)
    we = _randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5)
    bq = _randn(gen, 3 * c8, scale=0.1) if bias else None
    ge = _randn(gen, b, n, 4 * c8)
    gs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (ge[..., :2 * c8], ge[..., 2 * c8:])
    return xs, w1, we, bq, gs


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_lin_d8_bwd_kernel(gen, b, n, c, heads, bias):
    """K-lin-d8-bwd alone: bf16 operands, f32 sums, one bf16 rounding of each
    output on both sides, so the elementwise bar of the forward kernels."""
    c8 = c // 8
    xs, w1, we, bq, _ = _fused_bwd_args(gen, b, n, c, bias)
    dq = tuple(_randn(gen, b, n, 3 * c8) for _ in range(4))
    de = tuple(_randn(gen, b, n, 6 * c8) for _ in range(2))
    dxs, dw1, dwe, db = ops.lin_d8_bwd_launch(xs, w1, we, dq, de, bias)
    torch.cuda.synchronize()
    rxs, rw1, rwe, rb = ops.lin_d8_bwd_reference(xs, w1, we, dq, de, bq)
    _assert_close(dxs + (dw1, dwe), rxs + (rw1, rwe))
    assert (db is None) == (rb is None)
    if bias:
        _assert_close(db, rb)


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_fused_qkv_bwd_kernel(gen, b, n, c, heads, bias):
    """The chain K-lin-d8 -> K-attn-bwd -> K-lin-d8-bwd against the plain
    backward, with the scaled bar of the attention backward kernels."""
    xs, w1, we, bq, gs = _fused_bwd_args(gen, b, n, c, bias)
    out = _counted(ops.octic_attention_fused_qkv_bwd, xs, w1, we, bq, gs, heads)
    ref = ops.octic_attention_fused_qkv_bwd_reference(xs, w1, we, bq, gs, heads)
    assert (out[7] is None) == (not bias)
    _assert_close_scaled(tuple(t for t in out if t is not None),
                         tuple(t for t in ref if t is not None))


def test_octic_attention_fused_qkv_autograd_launches_bwd_chain(gen):
    xs, w1, we, bq, gs = _fused_bwd_args(gen, 2, 37, 128, True)
    leaves = tuple(t.detach().requires_grad_() for t in xs + (w1, we, bq))
    ops.reset_launch_counts()
    outs = ops.octic_attention_fused_qkv(*leaves, 2)
    torch.autograd.backward(outs, gs)
    counts = ops.launch_counts()
    assert counts["octic_attention_fused_qkv"] == counts["octic_attention_fused_qkv_bwd"] == 1
    assert counts["octic_attention_bwd"] == 0  # the chain counts once, under its own name
    ref = ops.octic_attention_fused_qkv_bwd_reference(xs, w1, we, bq, gs, 2)
    _assert_close_scaled(tuple(t.grad for t in leaves), ref)


def test_small_ssl_step_on_card(gen):
    """One DINOv2 step of a small hybrid (embed 64, the DINOv2 train flags,
    remat, bf16 compute over f32 parameters) on the card against the same
    weights in f32 on the CPU: loss within 5e-2 and gradient cosine above
    0.99 (the bars of chip_smoke.py P9); every SSL kernel launched."""
    import random

    import numpy as np

    from octic_vits_tpu_torch import init_weights as init
    from octic_vits_tpu_torch.models import DINOHead, OcticDinoVisionTransformer
    from octic_vits_tpu_torch.train.dinov2.masking import MaskingGenerator, collate_crops_and_masks
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import (
        SSLConfig,
        SSLMetaArch,
        batch_to_device,
    )

    def student(device, dtype, remat):
        backbone = OcticDinoVisionTransformer(
            img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, mlp_ratio=2.0,
            init_scale=1.0, fuse_qkv=True, remat=remat, compute_dtype=dtype, device=device)
        return torch.nn.ModuleDict({"backbone": backbone,
                                    "dino_head": DINOHead(64, 128, 64, 32, device=device)})

    kw = dict(img_size=32, local_crop_size=16, patch_size=8, drop_path_rate=0.0, dino_out_dim=128,
              ibot_out_dim=128, n_local_crops=2)
    cpu = student("cpu", None, False)
    init(cpu, torch.Generator().manual_seed(0))
    card = student("cuda", torch.bfloat16, True)
    card.load_state_dict(cpu.state_dict())
    npr = np.random.RandomState(0)
    batch = collate_crops_and_masks(npr.randn(4, 32, 32, 3), npr.randn(4, 16, 16, 3), 16,
                                    MaskingGenerator(4, num_masking_patches=8),
                                    rng=random.Random(0))
    results = []
    for model, dtype, device in ((card, torch.bfloat16, "cuda"), (cpu, None, "cpu")):
        arch = SSLMetaArch(SSLConfig(compute_dtype=dtype, **kw), device=device)
        state = arch.state_from_student(model)
        ops.reset_launch_counts()
        loss, _ = arch.forward_backward(state, batch_to_device(batch, device), 0.04)
        results.append((loss.item(), ops.launch_counts()))
    (card_loss, counts), (cpu_loss, _) = results
    assert counts["octic_attention_fused_qkv_bwd"] == 2 and counts["octic_attention_bwd"] == 0
    assert counts["octic_attention_fused_qkv"] == 3 and counts["mlp_d8_fused"] == 1
    assert counts["linear_d8_fused"] == 8 and counts["standard_attention_bwd"] == 2
    assert abs(card_loss - cpu_loss) <= 5e-2 * abs(cpu_loss)
    a = torch.cat([p.grad.float().reshape(-1).cpu() for p in card.parameters()])
    b = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0).item() > 0.99


# ---- the octic block's fused glue: K-ln-d8, K-gelu-d8, the LayerScale + residual
# epilogue of K-lin-d8 and the fused MLP branch

# (b, n, c8): the slot width c8 = C/8 takes the LN kernel's 1, 2, 4, 5 (ViT-H)
# and 8 chunk registers a lane; M = 195 and 50 are no multiple of a CTA's rows
GLUE_SHAPES = [(2, 17, 8), (3, 65, 8), (2, 257, 160), (1, 50, 24), (2, 9, 40), (2, 9, 96),
               (1, 9, 256)]


def _tuple5(gen, b, n, c8, shift=0.0):
    return tuple(_randn(gen, b, n, c8) + shift for _ in range(4)) + (
        _randn(gen, b, n, 4 * c8) - shift,)


def _ln_params(gen, c8, dtype):
    al = 1.0 + 0.2 * torch.randn(4, c8, generator=gen, device="cuda")
    ae = 1.0 + 0.2 * torch.randn(1, 4 * c8, generator=gen, device="cuda")
    be = 0.2 * torch.randn(1, c8, generator=gen, device="cuda")
    return tuple(t.to(dtype) for t in (al, ae, be))


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,c8", GLUE_SHAPES)
def test_ln_affine_d8_kernel(gen, b, n, c8, param_dtype):
    xs = _tuple5(gen, b, n, c8, shift=0.5)
    params = _ln_params(gen, c8, param_dtype)
    _assert_close(_counted(ops.ln_affine_d8_flat_tuple, xs, *params),
                  ops.ln_affine_d8_reference(xs, *params))


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,c8", GLUE_SHAPES)
def test_ln_affine_d8_bwd_kernel(gen, b, n, c8, param_dtype):
    """dx within the forward bar (f32 math on both sides, one bf16 rounding);
    the parameter gradients (f32 sums over the tokens, in another order)
    within the scaled bar; and the same bits on a second run, which pins the
    fixed-order split-M reduction."""
    xs, us = _tuple5(gen, b, n, c8, shift=0.5), _tuple5(gen, b, n, c8)
    al, ae, _ = _ln_params(gen, c8, param_dtype)
    out = _counted(ops.ln_affine_d8_bwd, xs, al, ae, us)
    ref = ops.ln_affine_d8_bwd_reference(xs, al, ae, us)
    _assert_close(out[0], ref[0])
    for o, r in zip(out[1:], ref[1:], strict=True):
        assert o.dtype == r.dtype == torch.float32 and o.shape == r.shape
        assert bool(((o - r).abs() <= BWD_TOL * (r.abs().max() + r.abs())).all())
    again = ops.ln_affine_d8_bwd(xs, al, ae, us)
    for o, a in zip(out[1:], again[1:]):
        assert torch.equal(o, a)


@pytest.mark.parametrize("b,n,c8", GLUE_SHAPES)
def test_ln_d8_kernels(gen, b, n, c8):
    """The statistics-only pair: the forward against its plain version, and
    the backward from the plain version's saved output and var."""
    xs, us = _tuple5(gen, b, n, c8, shift=-0.3), _tuple5(gen, b, n, c8)
    outs, var = ops.ln_d8_reference(xs)
    _assert_close(_counted(ops.ln_d8_flat_tuple, xs), outs)
    _assert_close(_counted(ops.ln_d8_bwd, outs, var, us), ops.ln_d8_bwd_reference(outs, var, us))


def test_ln_kernels_reject_wide_rows(gen):
    xs = _tuple5(gen, 1, 3, 264)
    with pytest.raises(ValueError, match="at most"):
        ops.ln_d8_flat_tuple(xs)


@pytest.mark.parametrize("flat_e", [True, False])
@pytest.mark.parametrize("b,n,c8", GLUE_SHAPES)
def test_gelu_d8_kernels(gen, b, n, c8, flat_e):
    """Forward and backward on the MLP hidden (width 4 c8), flat-E or with
    the E rows as [..., 2, 2c]."""
    h = 4 * c8
    xs, gs = _tuple5(gen, b, n, h), _tuple5(gen, b, n, h)
    if not flat_e:
        xs, gs = (t[:4] + (t[4].unflatten(-1, (2, -1)),) for t in (xs, gs))
    _assert_close(_counted(ops.gelu_d8, xs), ops.gelu_d8_reference(xs))
    _assert_close(_counted(ops.gelu_d8_bwd, xs, gs), ops.gelu_d8_bwd_reference(xs, gs))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("b,n,c8", GLUE_SHAPES)
def test_linear_d8_epilogue_kernel(gen, b, n, c8, wide):
    """y = r + ls * linear(x): the proj (c8 -> c8) and fc2 (4 c8 -> c8)."""
    k = 4 * c8 if wide else c8
    xs, res = _tuple5(gen, b, n, k), _tuple5(gen, b, n, c8)
    w1, we = _randn(gen, 4, k, c8, scale=k ** -0.5), _randn(gen, 2 * k, 2 * c8,
                                                              scale=(2 * k) ** -0.5)
    bias = _randn(gen, c8, scale=0.1)
    ls = (_randn(gen, 4, c8, scale=0.5), _randn(gen, 2 * c8, scale=0.5))
    before = ops.linear_d8_fused.launches
    out = _counted(ops.linear_d8_epilogue, xs, w1, we, bias, ls, res)
    assert ops.linear_d8_fused.launches == before + 1
    _assert_close(out, ops.linear_d8_fused_reference(xs, w1, we, bias, False, ls, res))


def _branch_params(gen, c8):
    h = 4 * c8
    return (1.0 + _randn(gen, 4, c8, scale=0.1), 1.0 + _randn(gen, 2 * c8, scale=0.1),
            _randn(gen, c8, scale=0.1), _randn(gen, 4, c8, h, scale=c8 ** -0.5),
            _randn(gen, 2 * c8, 2 * h, scale=(2 * c8) ** -0.5), _randn(gen, h, scale=0.1),
            _randn(gen, 4, h, c8, scale=h ** -0.5), _randn(gen, 2 * h, 2 * c8,
                                                           scale=(2 * h) ** -0.5),
            _randn(gen, c8, scale=0.1), _randn(gen, 4, c8, scale=0.5),
            _randn(gen, 2 * c8, scale=0.5))


@pytest.mark.parametrize("b,n,c8", GLUE_SHAPES)
def test_mlp_branch_d8_kernel(gen, b, n, c8):
    """The three launches against the plain version that rounds where they
    do; and against the JAX bf16 kernel's rounding points (the fc1
    pre-activation rounded to bf16 before the GELU, pallas_mlp_branch.py:
    101-106). That one more rounding of each hidden value (relative 2^-9)
    reaches the output through fc2 and the LayerScale as a sum of 8 c8
    rounding errors, up to ~0.013 at these shapes: twice ATOL covers it."""
    from octic_vits_tpu_torch.ops.mlp_branch import _norm_affine

    xs, p = _tuple5(gen, b, n, c8), _branch_params(gen, c8)
    out = _counted(ops.mlp_branch_d8, xs, p)
    _assert_close(out, ops.mlp_branch_d8_reference(xs, p))
    n_ = ops.ln_affine_d8_reference(xs, *_norm_affine(p))
    z = ops.linear_d8_fused_reference(n_, p[3], p[4], p[5])  # rounded before the GELU
    jax_points = ops.linear_d8_fused_reference(ops.gelu_d8_reference(z), p[6], p[7], p[8], False,
                                               (p[9], p[10]), xs)
    for o, r in zip(out, jax_points, strict=True):
        torch.testing.assert_close(o.float(), r.float(), atol=2 * ATOL, rtol=RTOL)


def test_glue_autograd_launches_backward_kernels(gen):
    xs = tuple(t.requires_grad_() for t in _tuple5(gen, 2, 17, 16, shift=0.5))
    al, ae, be = (t.requires_grad_() for t in _ln_params(gen, 16, torch.float32))
    ops.reset_launch_counts()
    hs = ops.gelu_d8(ops.ln_affine_d8_flat_tuple(xs, al, ae, be)[:4] + (xs[4],))
    torch.autograd.backward(hs, _tuple5(gen, 2, 17, 16))
    counts = ops.launch_counts()
    assert counts == _only(ln_affine_d8_flat_tuple=1, ln_affine_d8_bwd=1, gelu_d8=1,
                           gelu_d8_bwd=1)
    assert all(torch.isfinite(t.grad).all() for t in xs + (al, ae, be))


@pytest.fixture
def pallas_ln(monkeypatch):
    from octic_vits_tpu_torch.layers import d8_layers

    monkeypatch.setattr(d8_layers, "OCTIC_PALLAS_LN", True)


# hybrid_vit_small_test has 2 octic and 2 standard blocks
GLUE_PATHS = {
    "fuse_mlp_branch": dict(ln_affine_d8_flat_tuple=2, mlp_branch_d8=2),
    "fuse_block_epilogues": dict(ln_affine_d8_flat_tuple=4, linear_d8_fused=6,
                                 linear_d8_epilogue=4),
}


@pytest.mark.parametrize("flag", sorted(GLUE_PATHS))
def test_small_hybrid_glue_inference_on_card(gen, pallas_ln, flag):
    """The fused-branch and epilogue inference paths against the plain model
    in f32 on the CPU (the bar of test_small_hybrid_model_on_card)."""
    cpu = create_model("hybrid_vit_small_test", init_scale=1.0, device="cpu").eval()
    init_weights(cpu, torch.Generator().manual_seed(0))
    card = create_model("hybrid_vit_small_test", init_scale=1.0, device="cuda",
                        dtype=torch.bfloat16, **{flag: True}).eval()
    card.load_state_dict(cpu.state_dict())
    img = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    img = img.to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = card(img.cuda()).float().cpu()
        ref = cpu(img.float())
    assert ops.launch_counts() == _only(standard_attention=2, octic_attention_fused_qkv=2,
                                        dense_gelu=2, **GLUE_PATHS[flag])
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 5e-2


def test_small_hybrid_gelu_kernel_train_step_on_card(gen, pallas_ln):
    """One DeiT III step with plain octic linears and the D8-GELU kernel
    (use_pallas_linear=False, use_pallas_gelu=True) and the LN kernel, under
    remat, against the plain model in f32 on the CPU (the bars of
    test_small_hybrid_train_step_on_card)."""
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine

    cpu = create_model("hybrid_vit_small_test", init_scale=1.0, device="cpu")
    init_weights(cpu, torch.Generator().manual_seed(0))
    card = create_model("hybrid_vit_small_test", init_scale=1.0, remat=True,
                        compute_dtype=torch.bfloat16, use_pallas_linear=False,
                        use_pallas_gelu=True, device="cuda")
    card.load_state_dict(cpu.state_dict())
    cfg = engine.DeiTConfig(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0)
    opt = engine.build_optimizer(cfg, card)
    step = engine.make_deit_train_step(card, cfg, opt)
    img = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    img = img.to(torch.bfloat16).float()
    labels = torch.tensor([1, 4, 7, 9])
    ops.reset_launch_counts()
    _, metrics = step(common.create_train_state(card, opt), img.cuda(), labels.cuda(),
                      torch.Generator().manual_seed(0))
    # per octic block: norm1 and norm2 forward twice (remat), backward once
    assert ops.launch_counts() == _only(
        standard_attention=2, standard_attention_bwd=2, octic_attention=2, octic_attention_bwd=2,
        dense_gelu=4, ln_affine_d8_flat_tuple=8, ln_affine_d8_bwd=4, gelu_d8=4, gelu_d8_bwd=2)
    cpu.train()
    loss = common.bce_target_loss(cpu(img), torch.nn.functional.one_hot(labels, 10).float())
    loss.backward()
    assert abs(metrics["loss"].item() - loss.item()) <= 5e-2 * abs(loss.item())
    a = torch.cat([p.grad.float().reshape(-1).cpu() for p in card.parameters()])
    b = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0).item() > 0.99


# ---- the packed trunk carry: K-lin-d8 and K-lin-d8-bwd through row strides, the
# packed ops (rows 10 and 11), row 4's backward and the invariant-early model


def _packed(gen, b, n, c8):
    """A packed [b, n, 8 c8] container and its five flat-E slot views."""
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f

    x = _randn(gen, b, n, 8 * c8)
    return x, unpack_packed_5f(x)


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_lin_d8_strided_kernel(gen, b, n, c, heads, bias, gelu):
    """K-lin-d8 reading the slot views of a packed container and writing the
    slot views of another in place (fc1 widths: c8 -> 4 c8)."""
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f

    c8, f8 = c // 8, c // 2
    _, xs = _packed(gen, b, n, c8)
    w1, we = _randn(gen, 4, c8, f8, scale=c8 ** -0.5), _randn(gen, 2 * c8, 2 * f8,
                                                              scale=(2 * c8) ** -0.5)
    bq = _randn(gen, f8, scale=0.1) if bias else None
    y = torch.full((b, n, 8 * f8), float("nan"), device="cuda", dtype=torch.bfloat16)
    out = ops.lin_d8_launch(xs, w1, we, bq, gelu, out=unpack_packed_5f(y))
    torch.cuda.synchronize()
    assert all(o.data_ptr() == v.data_ptr() for o, v in zip(out, unpack_packed_5f(y)))
    _assert_close(tuple(out), ops.linear_d8_fused_reference(xs, w1, we, bq, gelu))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_lin_d8_bwd_strided_kernel(gen, b, n, c, heads, bias):
    """K-lin-d8-bwd reading the packed input in place and writing dx into the
    slot views of one packed gradient."""
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f

    c8 = c // 8
    _, w1, we, bq, _ = _fused_bwd_args(gen, b, n, c, bias)
    _, xs = _packed(gen, b, n, c8)
    dq = tuple(_randn(gen, b, n, 3 * c8) for _ in range(4))
    de = tuple(_randn(gen, b, n, 6 * c8) for _ in range(2))
    dx = torch.full((b, n, c), float("nan"), device="cuda", dtype=torch.bfloat16)
    dxs, dw1, dwe, db = ops.lin_d8_bwd_launch(xs, w1, we, dq, de, bias, out=unpack_packed_5f(dx))
    torch.cuda.synchronize()
    rxs, rw1, rwe, rb = ops.lin_d8_bwd_reference(xs, w1, we, dq, de, bq)
    _assert_close(tuple(unpack_packed_5f(dx)) + (dw1, dwe), rxs + (rw1, rwe))
    if bias:
        _assert_close(db, rb)


def test_lin_d8_rejects_misaligned_views(gen):
    """A view whose start or row stride is not a multiple of 16 bytes raises
    (never copied): the kernels load 16 bytes at a time."""
    x = _randn(gen, 2, 5, 72)
    xs = tuple(x[..., 1 + 8 * g:9 + 8 * g] for g in range(4)) + (x[..., 33:65],)
    w1, we = _randn(gen, 4, 8, 8), _randn(gen, 16, 16)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.lin_d8_launch(xs, w1, we, None, False)
    y = _randn(gen, 2, 5, 68)  # row stride 68 elements
    ys = tuple(y[..., 8 * g:8 * g + 8] for g in range(4)) + (y[..., 32:64],)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.lin_d8_launch(ys, w1, we, None, False)


def _packed_attn_args(gen, b, n, c, bias):
    c8 = c // 8
    x = _randn(gen, b, n, c)
    w1 = _randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5)
    we = _randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5)
    bq = _randn(gen, 3 * c8, scale=0.1) if bias else None
    return x, w1, we, bq


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_fused_qkv_packed_kernel(gen, b, n, c, heads, bias):
    args = _packed_attn_args(gen, b, n, c, bias) + (heads,)
    _assert_close(_counted(ops.octic_attention_fused_qkv_packed, *args),
                  ops.octic_attention_fused_qkv_packed_reference(*args))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_fused_qkv_packed_bwd_kernel(gen, b, n, c, heads, bias):
    x, w1, we, bq = _packed_attn_args(gen, b, n, c, bias)
    gs = _fused_bwd_args(gen, b, n, c, bias)[4]
    out = _counted(ops.octic_attention_fused_qkv_packed_bwd, x, w1, we, bq, gs, heads)
    ref = ops.octic_attention_fused_qkv_packed_bwd_reference(x, w1, we, bq, gs, heads)
    assert (out[3] is None) == (not bias)
    _assert_close_scaled(tuple(t for t in out if t is not None),
                         tuple(t for t in ref if t is not None))


def _mlp_weights(gen, c8, bias):
    h8 = 4 * c8
    return (_randn(gen, 4, c8, h8, scale=c8 ** -0.5), _randn(gen, 2 * c8, 2 * h8,
                                                             scale=(2 * c8) ** -0.5),
            _randn(gen, h8, scale=0.1) if bias else None, _randn(gen, 4, h8, c8, scale=h8 ** -0.5),
            _randn(gen, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5),
            _randn(gen, c8, scale=0.1) if bias else None)


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_mlp_d8_fused_packed_kernel(gen, b, n, c, heads, bias):
    x = _randn(gen, b * n, c)
    ws = _mlp_weights(gen, c // 8, bias)
    _assert_close(_counted(ops.mlp_d8_fused_packed, x, *ws),
                  ops.mlp_d8_fused_packed_reference(x, *ws))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_mlp_d8_fused_bwd_kernel(gen, b, n, c, heads, bias, packed):
    """Row 4's backward on a flat-E tuple, and on the slot views of a packed
    container (the backward of row 11)."""
    c8 = c // 8
    if packed:
        xs, gs = _packed(gen, b, n, c8)[1], _packed(gen, b, n, c8)[1]
    else:
        xs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),)
        gs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),)
    ws = _mlp_weights(gen, c8, bias)
    out = _counted(ops.mlp_d8_fused_bwd, xs, *ws, gs)
    ref = ops.mlp_d8_fused_bwd_reference(xs, *ws, gs)
    _assert_close_scaled(tuple(t for t in out if t is not None),
                         tuple(t for t in ref if t is not None))


def test_packed_ops_autograd_launch_backward(gen):
    """Autograd through rows 10 and 11: the packed attention's backward chain
    and row 4's backward run, each counted once, and the packed input's
    gradient matches the plain backwards."""
    x, w1, we, bq = _packed_attn_args(gen, 2, 37, 128, True)
    ws = _mlp_weights(gen, 16, True)
    gs = _fused_bwd_args(gen, 2, 37, 128, True)[4]
    gm = _randn(gen, 2 * 37, 128)
    leaf = x.detach().requires_grad_()
    ops.reset_launch_counts()
    outs = ops.octic_attention_fused_qkv_packed(leaf, w1, we, bq, 2)
    y = ops.mlp_d8_fused_packed(leaf.reshape(-1, 128), *ws)
    torch.autograd.backward(outs + (y,), gs + (gm,))
    assert ops.launch_counts() == _only(
        octic_attention_fused_qkv_packed=1, octic_attention_fused_qkv_packed_bwd=1,
        mlp_d8_fused_packed=1, mlp_d8_fused_bwd=1)
    from octic_vits_tpu_torch.d8.group import pack_5_to_flat, unpack_packed_5f

    dx_a = ops.octic_attention_fused_qkv_packed_bwd_reference(x, w1, we, bq, gs, 2)[0]
    dx_m = pack_5_to_flat(ops.mlp_d8_fused_bwd_reference(
        unpack_packed_5f(x.reshape(-1, 128)), *ws, unpack_packed_5f(gm))[:5])
    ref = (dx_a.float() + dx_m.reshape(x.shape).float()).to(torch.bfloat16)
    _assert_close_scaled(leaf.grad, ref)


@pytest.mark.parametrize("packed", [False, True])
def test_small_inv_early_model_on_card(gen, packed):
    kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2.0,
              qkv_bias=True, invariant=True, num_classes=10, init_scale=1.0)
    from octic_vits_tpu_torch.models import OcticVisionTransformer

    cpu = OcticVisionTransformer(**kw, device="cpu").eval()
    init_weights(cpu, torch.Generator().manual_seed(0))
    card = OcticVisionTransformer(**kw, packed_carry=packed, device="cuda",
                                  dtype=torch.bfloat16).eval()
    card.load_state_dict(cpu.state_dict())
    img = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = card(img.cuda()).float().cpu()
        ref = cpu(img.float())
    octic = (dict(octic_attention_fused_qkv_packed=2, mlp_d8_fused_packed=2) if packed else
             dict(octic_attention_fused_qkv=2, mlp_d8_fused=2))
    assert ops.launch_counts() == _only(standard_attention=2, dense_gelu=2, **octic)
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 5e-2


def test_small_inv_early_packed_train_step_on_card(gen):
    """One DeiT III step of the small inv-early model with the packed carry
    (fuse_qkv, fuse_mlp, remat, bf16 compute over f32 parameters) on the
    card against the same weights in f32 on the CPU (the bars of
    test_small_hybrid_train_step_on_card), the packed kernels launched."""
    from octic_vits_tpu_torch.models import OcticVisionTransformer
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine

    kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2.0,
              qkv_bias=True, invariant=True, num_classes=10, init_scale=1.0)
    cpu = OcticVisionTransformer(**kw, device="cpu")
    init_weights(cpu, torch.Generator().manual_seed(0))
    card = OcticVisionTransformer(**kw, packed_carry=True, fuse_qkv=True, fuse_mlp=True,
                                  remat=True, compute_dtype=torch.bfloat16, device="cuda")
    card.load_state_dict(cpu.state_dict())
    cfg = engine.DeiTConfig(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0)
    opt = engine.build_optimizer(cfg, card)
    step = engine.make_deit_train_step(card, cfg, opt)
    img = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    img = img.to(torch.bfloat16).float()
    labels = torch.tensor([1, 4, 7, 9])
    ops.reset_launch_counts()
    _, metrics = step(common.create_train_state(card, opt), img.cuda(), labels.cuda(),
                      torch.Generator().manual_seed(0))
    assert ops.launch_counts() == _only(
        octic_attention_fused_qkv_packed=2, octic_attention_fused_qkv_packed_bwd=2,
        mlp_d8_fused_packed=4, mlp_d8_fused_bwd=2, standard_attention=2,
        standard_attention_bwd=2, dense_gelu=4)
    cpu.train()
    loss = common.bce_target_loss(cpu(img), torch.nn.functional.one_hot(labels, 10).float())
    loss.backward()
    assert abs(metrics["loss"].item() - loss.item()) <= 5e-2 * abs(loss.item())
    a = torch.cat([p.grad.float().reshape(-1).cpu() for p in card.parameters()])
    b = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0).item() > 0.99


# ---- the wide-qkv slice: rows 12 and 13 (K-attn and K-attn-bwd over the wide
# layouts, K-lin-d8's grouped-column stores) and the small hybrid with use_wide_qkv


def _wide1d_qkv(gen, b, n, c):
    """q1d, k1d, v1d as column views of one wide-1d qkv [B,N,3C/2] and e0, e1
    as the halves of one E qkv [B,N,3C/2], as the wide-1d product gives them."""
    c8 = c // 8
    y1d, ef = _randn(gen, b, n, 12 * c8), _randn(gen, b, n, 12 * c8)
    w = 4 * c8
    return (y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:], ef[..., :6 * c8],
            ef[..., 6 * c8:])


def _octic_cotangents(gen, b, n, c):
    c8 = c // 8
    return tuple(_randn(gen, b, n, c8) for _ in range(4)) + tuple(
        _randn(gen, b, n, 2 * c8) for _ in range(2))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_wide1d_kernel(gen, b, n, c, heads, bias):
    qs = _wide1d_qkv(gen, b, n, c)
    _assert_close(_counted(ops.octic_attention_wide1d, *qs, heads),
                  ops.octic_attention_wide1d_reference(*qs, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_wide1d_bwd_kernel(gen, b, n, c, heads, bias):
    qs, gs = _wide1d_qkv(gen, b, n, c), _octic_cotangents(gen, b, n, c)
    _assert_close_scaled(_counted(ops.octic_attention_wide1d_bwd, qs, gs, heads),
                         ops.octic_attention_wide1d_bwd_reference(qs, gs, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_wide_kernel(gen, b, n, c, heads, bias):
    qkv = _randn(gen, b, n, 3 * c)
    _assert_close(_counted(ops.octic_attention_wide, qkv, heads),
                  ops.octic_attention_wide_reference(qkv, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_octic_attention_wide_bwd_kernel(gen, b, n, c, heads, bias):
    qkv, gs = _randn(gen, b, n, 3 * c), _octic_cotangents(gen, b, n, c)
    _assert_close_scaled(_counted(ops.octic_attention_wide_bwd, qkv, gs, heads),
                         ops.octic_attention_wide_bwd_reference(qkv, gs, heads))


def _qkv_weights(gen, c8, bias):
    return (_randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5),
            _randn(gen, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5),
            _randn(gen, 3 * c8, scale=0.1) if bias else None)


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_linear_d8_qkv_wide_kernel(gen, b, n, c, heads, bias):
    c8 = c // 8
    args = (_randn(gen, 4, b * n, c8), _randn(gen, b * n, 4 * c8)) + _qkv_weights(gen, c8, bias)
    _assert_close(_counted(ops.linear_d8_qkv_wide, *args, heads),
                  ops.linear_d8_qkv_wide_reference(*args, heads))


@pytest.mark.parametrize("b,n,c,heads,bias", SHAPES)
def test_linear_d8_wide1d_kernel(gen, b, n, c, heads, bias):
    """The wide-1d product, on a flat-E tuple and on a packed container's
    slot views; its outputs are views of two buffers."""
    c8 = c // 8
    ws = _qkv_weights(gen, c8, bias)
    for xs in (tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),),
               _packed(gen, b, n, c8)[1]):
        out = _counted(ops.linear_d8_wide1d, xs, *ws, heads)
        assert out[1].data_ptr() == out[0].data_ptr() + 8 * c8
        _assert_close(out, ops.linear_d8_wide1d_reference(xs, *ws, heads))


def test_octic_layouts_take_per_segment_loads(gen):
    """K-attn and K-attn-bwd pick each segment's load width on its own: the
    octic layout with 1-d arrays at odd column offsets (2-byte loads) beside
    16-byte-aligned E rows, and the standard layout again (rows 1 and 5)."""
    b, n, c8, heads = 2, 33, 16, 2
    big = _randn(gen, b, n, 4 * 3 * c8 + 4)
    ones = tuple(big[..., 1 + 3 * c8 * g:1 + 3 * c8 * (g + 1)] for g in range(4))
    ef = _randn(gen, b, n, 12 * c8)
    qs = ones + (ef[..., :6 * c8], ef[..., 6 * c8:])
    gs = _octic_cotangents(gen, b, n, 8 * c8)
    _assert_close(_counted(ops.octic_attention, *qs, heads),
                  ops.octic_attention_reference(*qs, heads))
    _assert_close_scaled(_counted(ops.octic_attention_bwd, qs, gs, heads),
                         ops.octic_attention_bwd_reference(qs, gs, heads))
    qkv = _randn(gen, b, n, 24 * c8)
    _assert_close(_counted(ops.standard_attention, qkv, heads),
                  ops.standard_attention_reference(qkv, heads))


def test_wide_ops_autograd_launch_backward(gen):
    """Autograd through the wide chains: the wide-1d product -> row 12 and
    row 13b -> row 13a, each backward kernel counted once, the input
    gradients finite and equal to the plain backward's."""
    b, n, c, heads = 2, 17, 128, 2
    c8 = c // 8
    xs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),)
    ws = _qkv_weights(gen, c8, True)
    gs = _octic_cotangents(gen, b, n, c)
    leaves = tuple(t.detach().requires_grad_() for t in xs)
    ops.reset_launch_counts()
    outs = ops.octic_attention_wide1d(*ops.linear_d8_wide1d(leaves, *ws, heads), heads)
    torch.autograd.backward(outs, gs)
    assert ops.launch_counts() == _only(linear_d8_wide1d=1, octic_attention_wide1d=1,
                                        octic_attention_wide1d_bwd=1)
    ref = ops.octic_attention_fused_qkv_bwd_reference(xs, *ws, gs, heads)
    _assert_close_scaled(tuple(t.grad for t in leaves), ref[:5])
    x1 = torch.stack(xs[:4]).reshape(4, b * n, c8).detach().requires_grad_()
    xef = xs[4].reshape(b * n, 4 * c8).detach().requires_grad_()
    ops.reset_launch_counts()
    qkv = ops.linear_d8_qkv_wide(x1, xef, *ws, heads).reshape(b, n, 3 * c)
    torch.autograd.backward(ops.octic_attention_wide(qkv, heads), gs)
    assert ops.launch_counts() == _only(linear_d8_qkv_wide=1, octic_attention_wide=1,
                                        octic_attention_wide_bwd=1)
    _assert_close_scaled((x1.grad.reshape(4, b, n, c8).unbind(0)) + (
        xef.grad.reshape(b, n, 4 * c8),), ref[:5])


def test_small_wide_hybrid_on_card(gen):
    """hybrid_vit_small_test with use_wide_qkv: inference against the same
    weights in f32 on the CPU, and one DeiT III step (remat, bf16 compute)
    against the CPU f32 step (the bars of test_small_hybrid_train_step_on_card),
    with the wide kernels launched."""
    from octic_vits_tpu_torch.train import common
    from octic_vits_tpu_torch.train.deit import engine

    cpu = create_model("hybrid_vit_small_test", init_scale=1.0, device="cpu")
    init_weights(cpu, torch.Generator().manual_seed(0))
    inf = create_model("hybrid_vit_small_test", init_scale=1.0, use_wide_qkv=True,
                       device="cuda", dtype=torch.bfloat16).eval()
    inf.load_state_dict(cpu.state_dict())
    img = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    img = img.to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = inf(img.cuda()).float().cpu()
        ref = cpu.eval()(img.float())
    assert ops.launch_counts() == _only(linear_d8_wide1d=2, octic_attention_wide1d=2,
                                        standard_attention=2, dense_gelu=2, mlp_d8_fused=2)
    assert ((out - ref).norm() / ref.norm()).item() < 5e-2
    card = create_model("hybrid_vit_small_test", init_scale=1.0, use_wide_qkv=True,
                        remat=True, compute_dtype=torch.bfloat16, device="cuda")
    card.load_state_dict(cpu.state_dict())
    cfg = engine.DeiTConfig(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0)
    opt = engine.build_optimizer(cfg, card)
    step = engine.make_deit_train_step(card, cfg, opt)
    img = img[:2].float()
    labels = torch.tensor([1, 4])
    ops.reset_launch_counts()
    _, metrics = step(common.create_train_state(card, opt), img.cuda(), labels.cuda(),
                      torch.Generator().manual_seed(0))
    assert ops.launch_counts() == _only(
        linear_d8_wide1d=4, octic_attention_wide1d=2, octic_attention_wide1d_bwd=2,
        linear_d8_fused=8, standard_attention=2, standard_attention_bwd=2, dense_gelu=4)
    cpu.train()
    loss = common.bce_target_loss(cpu(img), torch.nn.functional.one_hot(labels, 10).float())
    loss.backward()
    assert abs(metrics["loss"].item() - loss.item()) <= 5e-2 * abs(loss.item())
    a = torch.cat([p.grad.float().reshape(-1).cpu() for p in card.parameters()])
    b = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0).item() > 0.99


# ---------------------------------------------------------------------------
# the attention probes (kernel row 14a): each against its plain version, on
# chip_smoke's cases (P21) at the ragged shape, at full N and at ViT-L's
# head dim 64
# ---------------------------------------------------------------------------

PROBE_SHAPES = [(3, 37, 1280, 16), (2, 257, 1280, 16), (2, 65, 1024, 16)]
PROBE_CASE_IDS = ["a", "b", "c", "d", "f", "f_loads", "g", "h", "i", "j", "k_scores", "k_full",
                  "l", "m", "n", "o", "p"]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("case", range(len(PROBE_CASE_IDS)), ids=PROBE_CASE_IDS)
def test_attention_probe_kernel(gen, shape, case):
    import chip_smoke

    with torch.no_grad():
        cases = chip_smoke.probe_cases(gen, *shape)
        assert len(cases) == len(PROBE_CASE_IDS)
        _, op, args, scaled, cols, _ = cases[case]
        out = _counted(op, *args)
        ref = op.reference(*args)
    if cols is not None:
        out, ref = out[..., cols], ref[..., cols]
    err, ok = chip_smoke.compare(out, ref, scaled)
    assert ok, f"{op.__name__}: max abs err {err:.3e}"


def test_interleave2_probe_needs_even_heads(gen):
    qkv = _randn(gen, 1, 17, 3 * 240)
    with pytest.raises(ValueError, match="even number of heads"):
        ops.interleave2_attention(qkv, 3)


# ---------------------------------------------------------------------------
# the probes of kernel row 14b (P22): the attention probes of
# scripts/r3_attn_experiments.py on chip_smoke's cases at the ragged shape, at
# full N and at ViT-L's head dim 64; K-lin-d8's tile sweep, each tile bitwise
# equal to the shipped K-lin-d8; the product law's twelve shapes at B=2
# ---------------------------------------------------------------------------

EXPERIMENT_SHAPES = [(4, 37, 1280, 16), (2, 257, 1280, 16), (2, 65, 1024, 16)]
EXPERIMENT_IDS = ["cls_split", "cls_split_octic", "multi_image", "multi_image_octic",
                  "hoist_assembly", "hoist", "hoist_split"]
LIN_TILE_IDS = [f"{store}_{bm}x{bn}" for store in ("tuple", "wide")
                for bm, bn in ((32, 32), (64, 32), (128, 32), (64, 64))]
LAW_IDS = ["scores_nt_80", "av_nn_80", "av_nn_256", "av_nn_384", "av_nn_512", "nn_k257_128",
           "nn_k128_128", "nn_k512_128", "nt_128", "nn_square_512", "batched_scores_nt",
           "batched_av_nn"]


def _probe_case_ok(op, args, kw):
    import chip_smoke

    before = op.launches
    out = op(*args, **kw)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    err, ok = chip_smoke.compare(out, op.reference(*args, **kw), tol=chip_smoke.tol_of(op))
    assert ok, f"{op.__name__}: max abs err {err:.3e}"
    return out


@pytest.mark.parametrize("shape", EXPERIMENT_SHAPES)
@pytest.mark.parametrize("case", range(len(EXPERIMENT_IDS)), ids=EXPERIMENT_IDS)
def test_experiment_probe_kernel(gen, shape, case):
    import chip_smoke

    with torch.no_grad():
        cases = chip_smoke.experiment_cases(gen, *shape)
        assert len(cases) == len(EXPERIMENT_IDS)
        _, op, args, kw, _, _ = cases[case]
        _probe_case_ok(op, args, kw)


@pytest.mark.parametrize("m", [148, 2 * 257])
@pytest.mark.parametrize("case", range(len(LIN_TILE_IDS)), ids=LIN_TILE_IDS)
def test_lin_d8_tile_kernel_is_k_lin_d8(gen, m, case):
    import chip_smoke

    with torch.no_grad():
        cases = chip_smoke.lin_tile_cases(gen, m, 160, 16)
        assert len(cases) == len(LIN_TILE_IDS)
        _, op, args, kw, _, _, same_as_shipped = cases[case]
        same, text = same_as_shipped(_probe_case_ok(op, args, kw))
        assert same, text


@pytest.mark.parametrize("case", range(len(LAW_IDS)), ids=LAW_IDS)
def test_matmul_law_kernel(gen, case):
    import chip_smoke

    with torch.no_grad():
        cases = chip_smoke.law_cases(gen, 2)
        assert len(cases) == len(LAW_IDS)
        _, op, args, kw, _, _, bar_fails_mutants = cases[case]
        ok, text = bar_fails_mutants(_probe_case_ok(op, args, kw))
        assert ok, text


def test_row_14b_probes_reject_unsupported_shapes(gen):
    qkv = _randn(gen, 3, 17, 3 * 1280)
    with pytest.raises(ValueError, match="even batch"):
        ops.multi_image_attention(qkv, 16)
    with pytest.raises(ValueError, match="N >= 2"):
        ops.cls_split_attention(qkv[:, :1], 16)
    x1, xef = _randn(gen, 4, 64, 160), _randn(gen, 64, 640)
    w1, we = _randn(gen, 4, 160, 480), _randn(gen, 320, 960)
    with pytest.raises(ValueError, match="not built"):
        ops.lin_d8_tiled(x1, xef, w1, we, bm=128, bn=64, store="tuple")
    with pytest.raises(ValueError, match="at most"):
        ops.matmul_law(_randn(gen, 1, 400, 16), _randn(gen, 1, 16, 16), "nt", 1)


# ---------------------------------------------------------------------------
# the probes of kernel row 14c (P23): scripts/r3_attn_bwd_ablate.py on
# chip_smoke's cases at the ragged shape and at full N (the backwards at the
# same B), each launched once and held to its bar; the shapes and head counts
# the kernels do not take raise
# ---------------------------------------------------------------------------

PROBE_14C_SHAPES = [(2, 45, 1280, 16), (2, 257, 1280, 16), (3, 17, 1280, 16)]
PROBE_14C_IDS = ["widestore", "wideg"] + [
    f"{name}_g{grp}" for grp in (2, 1, 4)
    for name in ("std_pack", "std_pack_bwd", "octic_group", "octic_group_bwd")] + [
    "std_maskpair", "std_maskpair_bwd", "qkv_attention", "qkv_attention_proj"]


@pytest.mark.parametrize("shape", PROBE_14C_SHAPES)
@pytest.mark.parametrize("case", range(len(PROBE_14C_IDS)), ids=PROBE_14C_IDS)
def test_row_14c_probe_kernel(gen, shape, case):
    import chip_smoke

    with torch.no_grad():
        cases = chip_smoke.probe_14c_cases(gen, *shape)
        assert len(cases) == len(PROBE_14C_IDS)
        _, op, args, kw, scaled, _, _ = cases[case]
        before = op.launches
        out = op(*args, **kw)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        err, ok = chip_smoke.compare(out, op.reference(*args, **kw), scaled)
    assert ok, f"{PROBE_14C_IDS[case]}: max abs err {err:.3e}"


def test_row_14c_probes_reject_unsupported_shapes(gen):
    qkv = _randn(gen, 2, 17, 3 * 1280)
    with pytest.raises(ValueError, match="groups of 4"):
        ops.std_pack_attention(_randn(gen, 2, 17, 3 * 480), 6, 4)
    with pytest.raises(ValueError, match="head dim"):
        ops.std_pack_attention(_randn(gen, 2, 17, 3 * 512), 8, 2)
    with pytest.raises(ValueError, match="groups of 2"):
        ops.std_maskpair_attention(qkv[..., :3 * 1200], 15)
    xs = tuple(_randn(gen, 2, 17, 120) for _ in range(4)) + (_randn(gen, 2, 17, 480),)
    w1, we = _randn(gen, 4, 120, 360), _randn(gen, 240, 720)
    with pytest.raises(ValueError, match="unsupported by the kernel"):
        ops.octic_qkv_attention(*xs, w1, we, None, 12)


# ---- K-lin-d8 on TMA + wgmma (csrc/lin_d8.cu) in every mode and store, and
# the octic forwards and backwards at sequence lengths past the whole-head
# kernels' limits (forward: 448 at dh 80, 544 at dh 64; backward: 320 at dh
# 80, 384 at dh 64, none at dh 128 from N = 257)

# (label, m, c, f, heads of the wide stores): the H/14 qkv, fc1 and fc2, a
# ragged M with c = 16 and f = 24 (d1 = 2), and d1 = 8 and 10
LIN_SM90_SHAPES = [("qkv_h14", 16448, 160, 480, 16), ("fc1_h14", 16448, 160, 640, None),
                   ("fc2_h14", 16448, 640, 160, None), ("ragged_d1_2", 148, 16, 24, 4),
                   ("d1_8", 148, 24, 48, 2), ("d1_10", 300, 40, 120, 4)]
LIN_SM90_MODES = ["tuple", "bias", "gelu", "ls", "strided", "wide", "wide1d"]


def _lin_sm90_inputs(gen, m, c, f):
    xs = tuple(_randn(gen, m, c) for _ in range(4)) + (_randn(gen, m, 4 * c),)
    return (xs, _randn(gen, 4, c, f, scale=c ** -0.5), _randn(gen, 2 * c, 2 * f, scale=(2 * c) ** -0.5),
            _randn(gen, f, scale=0.1))


# every mode at every shape, but the wide stores only at the qkv's (f = 3 x heads x d1)
LIN_SM90_CASES = [shape + (mode,) for shape in LIN_SM90_SHAPES for mode in LIN_SM90_MODES
                  if shape[4] is not None or mode not in ("wide", "wide1d")]


@pytest.mark.parametrize("label,m,c,f,heads,mode", LIN_SM90_CASES,
                         ids=[f"{c[0]}-{c[5]}" for c in LIN_SM90_CASES])
def test_lin_d8_sm90_modes(gen, label, m, c, f, heads, mode):
    from octic_vits_tpu_torch.d8.group import unpack_packed_5f

    xs, w1, we, bq = _lin_sm90_inputs(gen, m, c, f)
    if mode == "tuple":
        _assert_close(tuple(ops.lin_d8_launch(xs, w1, we, None, False)),
                      ops.linear_d8_fused_reference(xs, w1, we, None))
    elif mode == "bias":
        _assert_close(_counted(ops.linear_d8_fused, xs, w1, we, bq),
                      ops.linear_d8_fused_reference(xs, w1, we, bq))
    elif mode == "gelu":
        _assert_close(_counted(ops.linear_d8_fused, xs, w1, we, bq, True),
                      ops.linear_d8_fused_reference(xs, w1, we, bq, True))
    elif mode == "ls":
        ls = (_randn(gen, 4, f, scale=0.5), _randn(gen, 2 * f, scale=0.5))
        res = tuple(_randn(gen, m, f) for _ in range(4)) + (_randn(gen, m, 4 * f),)
        _assert_close(_counted(ops.linear_d8_epilogue, xs, w1, we, bq, ls, res),
                      ops.linear_d8_fused_reference(xs, w1, we, bq, layerscale=ls, residual=res))
    elif mode == "strided":
        x = _randn(gen, m, 8 * c)
        px = unpack_packed_5f(x)
        y = torch.full((m, 8 * f), float("nan"), device="cuda", dtype=torch.bfloat16)
        out = ops.lin_d8_launch(px, w1, we, bq, False, out=unpack_packed_5f(y))
        torch.cuda.synchronize()
        _assert_close(tuple(out), ops.linear_d8_fused_reference(px, w1, we, bq))
    elif mode == "wide":
        x1 = torch.stack(xs[:4])
        _assert_close(_counted(ops.linear_d8_qkv_wide, x1, xs[4], w1, we, bq, heads),
                      ops.linear_d8_qkv_wide_reference(x1, xs[4], w1, we, bq, heads))
    else:
        _assert_close(_counted(ops.linear_d8_wide1d, xs, w1, we, bq, heads),
                      ops.linear_d8_wide1d_reference(xs, w1, we, bq, heads))


def test_lin_d8_sync_is_the_parent(gen):
    """The mma.sync core at 64 x 32 (the yardstick) in every mode."""
    xs, w1, we, bq = _lin_sm90_inputs(gen, 148, 16, 24)
    ls = (_randn(gen, 4, 24), _randn(gen, 48))
    res = tuple(_randn(gen, 148, 24) for _ in range(4)) + (_randn(gen, 148, 96),)
    for kw in (dict(), dict(gelu=True), dict(layerscale=ls, residual=res), dict(num_heads=4)):
        before = ops.lin_d8_sync.launches
        out = ops.lin_d8_sync(xs, w1, we, bq, **kw)
        torch.cuda.synchronize()
        assert ops.lin_d8_sync.launches == before + 1
        _assert_close(out, ops.lin_d8_sync.reference(xs, w1, we, bq, **kw))


# (b, n, heads, d1): just past the old forward limits, a long sequence, the
# H/14 shape, the L/16 local crops' shape and an odd d1 (route (b) where its
# pieces fit their boxes, route (a) after one copy where they do not)
OCTIC_FWD_LONG = [(1, 449, 4, 10), (1, 545, 2, 8), (1, 1025, 4, 10), (2, 257, 16, 10),
                  (3, 37, 2, 8), (2, 65, 8, 3)]
OCTIC_FWD_LAYOUTS = ["row2", "row5", "row10", "row12", "row13a"]


@pytest.mark.parametrize("layout", OCTIC_FWD_LAYOUTS)
@pytest.mark.parametrize("b,n,heads,d1", OCTIC_FWD_LONG)
def test_octic_forward_streams_any_n(gen, b, n, heads, d1, layout):
    c8 = heads * d1
    c = 8 * c8
    if layout == "row2":
        xs = [_randn(gen, b, n, c8) for _ in range(4)] + [_randn(gen, b, n, 4 * c8)]
        ws = _qkv_weights(gen, c8, True)
        _assert_close(_counted(ops.octic_attention_fused_qkv, *xs, *ws, heads),
                      ops.octic_attention_fused_qkv_reference(*xs, *ws, heads))
    elif layout == "row5":
        qs = _octic_qkv(gen, b, n, c)
        _assert_close(_counted(ops.octic_attention, *qs, heads),
                      ops.octic_attention_reference(*qs, heads))
    elif layout == "row10":
        args = _packed_attn_args(gen, b, n, c, True) + (heads,)
        _assert_close(_counted(ops.octic_attention_fused_qkv_packed, *args),
                      ops.octic_attention_fused_qkv_packed_reference(*args))
    elif layout == "row12":
        qs = _wide1d_qkv(gen, b, n, c)
        _assert_close(_counted(ops.octic_attention_wide1d, *qs, heads),
                      ops.octic_attention_wide1d_reference(*qs, heads))
    else:
        qkv = _randn(gen, b, n, 3 * c)
        _assert_close(_counted(ops.octic_attention_wide, qkv, heads),
                      ops.octic_attention_wide_reference(qkv, heads))


@pytest.mark.parametrize("layout", ["row5", "row12"])
def test_route_b_keeps_heads_independent(gen, layout):
    """Route (b) loads each piece in an over-wide box that also holds part
    of the next head's columns: an Inf in every k column of head 1 leaves
    head 0's outputs as they were (the box's extra columns are zeroed in q
    and k)."""
    b, n, heads, d1 = 2, 65, 4, 10
    c8, de = heads * d1, 2 * d1
    assert ops.octic_attention_plan(b, n, heads, d1, "b",
                                    "octic" if layout == "row5" else "wide1d")["fits"]
    if layout == "row5":
        op, qs = ops.octic_attention, _octic_qkv(gen, b, n, 8 * c8)
        k_cols = [slice(c8 + d1, c8 + 2 * d1)] * 4 + [slice(2 * c8 + de, 2 * c8 + 2 * de)] * 2
    else:
        op, qs = ops.octic_attention_wide1d, _wide1d_qkv(gen, b, n, 8 * c8)
        k_cols = [None, slice(4 * d1, 8 * d1), None] + [slice(2 * c8 + de, 2 * c8 + 2 * de)] * 2
    clean = [t.clone() for t in op(*qs, heads)]
    for t, cols in zip(qs, k_cols):
        if cols is not None:
            t[..., cols] = float("inf")
    got = op(*qs, heads)
    torch.cuda.synchronize()
    for i, (g, want) in enumerate(zip(got, clean)):
        w = d1 if i < 4 else de
        assert torch.equal(g[..., :w], want[..., :w]), f"output {i}: head 0 changed"


# (b, n, heads, dh): just past the old backward limits, dh 128 at N = 257, a
# long sequence
BWD_LONG = [(1, 321, 4, 80), (1, 385, 2, 64), (1, 257, 2, 128), (1, 1025, 4, 80)]
BWD_LAYOUTS = ["std", "octic", "wide1d", "wide", "row2b", "row10b"]


@pytest.mark.parametrize("layout", BWD_LAYOUTS)
@pytest.mark.parametrize("b,n,heads,dh", BWD_LONG)
def test_attention_bwd_streams_past_the_head(gen, b, n, heads, dh, layout):
    c = heads * dh
    c8 = c // 8
    assert ops.attention_bwd_plan(n, dh)["streamed"]
    gs = _octic_cotangents(gen, b, n, c)
    if layout == "std":
        qkv, g = _randn(gen, b, n, 3 * c), _randn(gen, b, n, c)
        _assert_close_scaled(_counted(ops.standard_attention_bwd, qkv, g, heads),
                             ops.standard_attention_bwd_reference(qkv, g, heads))
    elif layout == "octic":
        qs = _octic_qkv(gen, b, n, c)
        _assert_close_scaled(_counted(ops.octic_attention_bwd, qs, gs, heads),
                             ops.octic_attention_bwd_reference(qs, gs, heads))
    elif layout == "wide1d":
        qs = _wide1d_qkv(gen, b, n, c)
        _assert_close_scaled(_counted(ops.octic_attention_wide1d_bwd, qs, gs, heads),
                             ops.octic_attention_wide1d_bwd_reference(qs, gs, heads))
    elif layout == "wide":
        qkv = _randn(gen, b, n, 3 * c)
        _assert_close_scaled(_counted(ops.octic_attention_wide_bwd, qkv, gs, heads),
                             ops.octic_attention_wide_bwd_reference(qkv, gs, heads))
    elif layout == "row2b":
        xs = tuple(_randn(gen, b, n, c8) for _ in range(4)) + (_randn(gen, b, n, 4 * c8),)
        ws = _qkv_weights(gen, c8, True)
        got = _counted(ops.octic_attention_fused_qkv_bwd, xs, *ws, gs, heads)
        _assert_close_scaled(got[:7], ops.octic_attention_fused_qkv_bwd_reference(
            xs, *ws, gs, heads)[:7])
    else:
        x, w1, we, bq = _packed_attn_args(gen, b, n, c, True)
        got = _counted(ops.octic_attention_fused_qkv_packed_bwd, x, w1, we, bq, gs, heads)
        _assert_close_scaled(got[:3], ops.octic_attention_fused_qkv_packed_bwd_reference(
            x, w1, we, bq, gs, heads)[:3])


def test_tma_kernels_run_on_a_fresh_thread(gen):
    """The TMA kernels encode their tensor maps through the driver, which
    needs a context current on the calling thread: a thread that has made no
    CUDA runtime call yet (PyTorch's autograd worker running a backward that
    recomputes K-lin-d8) must launch them as the main thread does."""
    import threading

    xs, w1, we, bq = _lin_sm90_inputs(gen, 148, 16, 24)
    qkv = _randn(gen, 2, 37, 3 * 2 * 80)
    want = (ops.linear_d8_fused_reference(xs, w1, we, bq),
            ops.standard_attention_reference(qkv, 2))
    got, errors = [], []

    def run():
        try:
            got.append(ops.linear_d8_fused(xs, w1, we, bq))
            got.append(ops.standard_attention(qkv, 2))
            torch.cuda.synchronize()
        except Exception as exc:  # the assertion below reports it
            errors.append(exc)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert not errors, errors
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])


# ---- K-attn-bwd on TMA + wgmma (csrc/attention_bwd.cu on attention_bwd_sm90.cuh):
# every layout at the plan's edges (chip_smoke.py P26's shapes), repeatable
# bits, heads apart, the autograd worker and a fresh thread, the yardstick

def _bwd_edge_ids():
    import chip_smoke

    return [label for label, *_ in chip_smoke.BWD_EDGES]


def _bwd_edges():
    import chip_smoke

    return [shape for _, *shape in chip_smoke.BWD_EDGES]


@pytest.mark.parametrize("layout", BWD_LAYOUTS)
@pytest.mark.parametrize("b,n,heads,dh", _bwd_edges(), ids=_bwd_edge_ids())
def test_attention_bwd_sm90_edges(gen, b, n, heads, dh, layout):
    import chip_smoke

    cases = {c[0]: c for c in chip_smoke.octic_bwd_cases(gen, b, n, heads, dh)}
    _, op, ref, args = cases[layout]
    got, want = _counted(op, *args), ref(*args)
    if layout in ("row2b", "row10b"):  # dbias included: present on both sides
        assert (got[-1] is None) == (want[-1] is None)
        got = tuple(t for t in got if t is not None)
        want = tuple(t for t in want if t is not None)
    _assert_close_scaled(got, want)


@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_attention_bwd_is_bitwise_repeatable(gen, layout):
    import chip_smoke

    cases = {c[0]: c for c in chip_smoke.octic_bwd_cases(gen, 2, 257, 16, 80)}
    _, op, _, args = cases[layout]
    first, second = op(*args), op(*args)
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    assert all(torch.equal(x, y) for x, y in zip(first, second) if x is not None)


def test_octic_bwd_keeps_heads_independent(gen):
    """An Inf in head 1's columns of q, k, v and of the cotangents, in the
    arrays of the octic, wide-1d and wide layouts, leaves head 0's gradients
    as they were (chip_smoke.bwd_heads_independent)."""
    import chip_smoke

    assert chip_smoke.bwd_heads_independent(gen)


def test_attention_bwd_runs_on_autograd_and_fresh_threads(gen):
    """The backward encodes its tensor maps (cuTensorMapEncodeTiled) on the
    calling thread, which needs a current context: PyTorch's autograd worker
    (loss.backward) and a thread that has made no CUDA runtime call must
    launch it as the main thread does."""
    import threading

    b, n, heads, dh = 2, 65, 2, 80
    qkv, g = _randn(gen, b, n, 3 * heads * dh), _randn(gen, b, n, heads * dh)
    want = ops.standard_attention_bwd_reference(qkv, g, heads)
    x = qkv.clone().requires_grad_()
    before = ops.standard_attention_bwd.launches
    ops.standard_attention(x, heads).backward(g)
    torch.cuda.synchronize()
    assert ops.standard_attention_bwd.launches == before + 1
    _assert_close_scaled(x.grad, want)
    got, errors = [], []

    def run():
        try:
            got.append(ops.standard_attention_bwd(qkv, g, heads))
            torch.cuda.synchronize()
        except Exception as exc:  # the assertion below reports it
            errors.append(exc)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert not errors, errors
    _assert_close_scaled(got[0], want)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("layout", ["std", "octic"])
def test_attention_bwd_sync_is_the_parent(gen, layout, streamed):
    """The yardstick: K-attn-bwd's mma.sync core in both forms, which no
    model path launches any more."""
    import chip_smoke

    cases = {c[0]: c for c in chip_smoke.octic_bwd_cases(gen, 2, 257, 16, 80)}
    qkv, g, heads = cases[layout][3]
    before = {op.__name__: op.launches for op in ops.KERNEL_OPS}
    got = ops.attention_bwd_sync(qkv, g, heads, streamed)
    torch.cuda.synchronize()
    after = {op.__name__: op.launches for op in ops.KERNEL_OPS}
    assert {k: after[k] - before[k] for k in after} == _only(attention_bwd_sync=1)
    _assert_close_scaled(got, ops.attention_bwd_sync.reference(qkv, g, heads))
