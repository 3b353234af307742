"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (bf16), and the small hybrid model on the card against the same
weights in f32 on the CPU. Skipped without a CUDA device. This file imports
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
    cpu = create_model("hybrid_vit_small_test", init_scale=1.0).eval()
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
    assert {op.__name__: op.launches for op in ops.KERNEL_OPS} == {
        "standard_attention": 2, "octic_attention_fused_qkv": 2, "dense_gelu": 2,
        "mlp_d8_fused": 2}
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 5e-2
