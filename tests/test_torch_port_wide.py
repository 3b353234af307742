"""Parity of the port's wide-qkv octic attention with the JAX package on the
CPU, in f32: the wide-1d attention (kernel row 12) and the attention over one
interleaved qkv (row 13a), each forward and VJP against its JAX function (the
Pallas kernels in interpret mode, as the JAX package's own tests run them);
``linear_d8_qkv_wide`` (row 13b) and ``uninterleave_wide``; the wide-1d qkv
product; ``AttentionD8(use_wide_qkv)`` against the JAX module on shared
weights and against the port's own non-wide module; the small hybrid with
``use_wide_qkv`` (logits and one DeiT III step) against the JAX model. Also
row 4's backward, which keeps the hidden's cotangent in f32 into the D8-GELU
VJP, as the JAX rule does. Inputs come from seeded numpy generators and go
to both sides. Tolerance 1e-5 forward and 1e-4 on gradients (the bars of
tests/test_pallas_attention.py), unless a test says otherwise: f32 on both
sides, sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.layers import d8_layers as jd8
from octic_vits_tpu.models.registry import create_model as j_create_model
from octic_vits_tpu.ops.pallas_attention import (
    octic_attention_wide as j_attn_wide,
    octic_attention_wide1d as j_attn_wide1d,
)
from octic_vits_tpu.ops.pallas_linear import (
    linear_d8_qkv_wide as j_qkv_wide,
    mlp_d8_fused as j_mlp_fused,
    uninterleave_wide as j_uninterleave_wide,
)
from octic_vits_tpu.train.common import create_train_state as j_create_state
from octic_vits_tpu.train.deit import engine as jengine
from octic_vits_tpu_torch import create_model, ops
from octic_vits_tpu_torch.d8.group import pack_5_to_flat
from octic_vits_tpu_torch.layers import d8_layers as td8
from octic_vits_tpu_torch.ops import linear as tlinear
from octic_vits_tpu_torch.train import common
from octic_vits_tpu_torch.train.deit import engine
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = RTOL = 1e-5
GRAD_ATOL = 1e-4

# (b, n, c8, heads): two heads of d1 = 8, an odd case of three heads of d1 =
# 8, and d1 = 10 as at ViT-H/14 (the 20- and 40-byte pieces)
SHAPES = [(2, 9, 16, 2), (2, 9, 24, 3), (2, 9, 20, 2)]


def _n(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().float().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs, dtype=np.float32), atol=atol, rtol=rtol,
                               err_msg=msg)


def _out_cotangents(rng, b, n, c8):
    return tuple(_n(rng, b, n, c8) for _ in range(4)) + tuple(_n(rng, b, n, 2 * c8)
                                                            for _ in range(2))


# ---- rows 12 and 13a -----------------------------------------------------------------


@pytest.mark.parametrize("b,n,c8,heads", SHAPES)
def test_octic_attention_wide1d_matches_jax(b, n, c8, heads):
    """Forward and VJP; e0 and e1 are the column halves of one E qkv, as the
    wide-1d product hands them over."""
    rng = np.random.default_rng(0)
    one = [_n(rng, b, n, 4 * c8) for _ in range(3)]
    ef = _n(rng, b, n, 12 * c8)
    gs = _out_cotangents(rng, b, n, c8)
    jins = [jnp.asarray(a) for a in one] + [jnp.asarray(ef[..., :6 * c8]),
                                            jnp.asarray(ef[..., 6 * c8:])]
    jout, vjp = jax.vjp(lambda *xs: j_attn_wide1d(*xs, heads, True), *jins)
    jgrads = vjp(tuple(jnp.asarray(g) for g in gs))
    tone = [_t(a, grad=True) for a in one]
    tef = _t(ef, grad=True)
    tins = tone + [tef[..., :6 * c8], tef[..., 6 * c8:]]
    ours = ops.octic_attention_wide1d(*tins, heads)
    torch.autograd.backward(ours, [_t(g) for g in gs])
    for i in range(6):
        _close(ours[i], jout[i], msg=f"out {i}")
    for i in range(3):
        _close(tone[i].grad, jgrads[i], atol=GRAD_ATOL, msg=f"grad {i}")
    _close(tef.grad, np.concatenate([np.asarray(jgrads[3]), np.asarray(jgrads[4])], -1),
           atol=GRAD_ATOL, msg="grad E")
    # the plain backward alone, as the card's kernel is held against it
    plain = ops.octic_attention_wide1d_bwd_reference(tuple(t.detach() for t in tins),
                                                     tuple(map(_t, gs)), heads)
    for i in range(5):
        _close(plain[i], jgrads[i], atol=GRAD_ATOL, msg=f"plain grad {i}")


@pytest.mark.parametrize("b,n,c8,heads", SHAPES)
def test_octic_attention_wide_matches_jax(b, n, c8, heads):
    rng = np.random.default_rng(1)
    qkv = _n(rng, b, n, 24 * c8)
    gs = _out_cotangents(rng, b, n, c8)
    jout, vjp = jax.vjp(lambda x: j_attn_wide(x, heads, True), jnp.asarray(qkv))
    (jdqkv,) = vjp(tuple(jnp.asarray(g) for g in gs))
    x = _t(qkv, grad=True)
    ours = ops.octic_attention_wide(x, heads)
    torch.autograd.backward(ours, [_t(g) for g in gs])
    for i in range(6):
        _close(ours[i], jout[i], msg=f"out {i}")
    _close(x.grad, jdqkv, atol=GRAD_ATOL, msg="dqkv")
    _close(ops.octic_attention_wide_bwd_reference(_t(qkv), tuple(map(_t, gs)), heads), jdqkv,
           atol=GRAD_ATOL, msg="plain dqkv")


def test_wide_layouts_agree_with_octic_attention():
    """The three layouts carry the same attention: the wide-1d and the
    interleaved qkv built from the six irrep arrays give octic_attention's
    outputs."""
    rng = np.random.default_rng(2)
    b, n, c8, heads = 2, 9, 20, 2
    qkv5 = tuple(_t(_n(rng, b, n, 3 * c8)) for _ in range(4)) + (_t(_n(rng, b, n, 12 * c8)),)
    rows = qkv5[:4] + (qkv5[4][..., :6 * c8], qkv5[4][..., 6 * c8:])
    want = ops.octic_attention(*rows, heads)
    y1d = tlinear.interleave_wide1d(qkv5[:4], heads)
    w = 4 * c8
    got1d = ops.octic_attention_wide1d(y1d[..., :w], y1d[..., w:2 * w], y1d[..., 2 * w:],
                                       *rows[4:], heads)
    gotw = ops.octic_attention_wide(tlinear.interleave_wide(qkv5, heads), heads)
    for i in range(6):
        _close(got1d[i], want[i], msg=f"wide1d {i}")
        _close(gotw[i], want[i], msg=f"wide {i}")


# ---- row 13b and the wide-1d product --------------------------------------------------


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("b,n,c8,heads", SHAPES)
def test_linear_d8_qkv_wide_matches_jax(b, n, c8, heads, bias):
    rng = np.random.default_rng(3)
    m, f = b * n, 3 * c8
    args = [_n(rng, 4, m, c8), _n(rng, m, 4 * c8), _n(rng, 4, c8, f, scale=c8 ** -0.5),
            _n(rng, 2 * c8, 2 * f, scale=(2 * c8) ** -0.5), _n(rng, f, scale=0.1) if bias else None]
    g = _n(rng, m, 8 * f)
    present = [i for i, a in enumerate(args) if a is not None]

    def jf(*xs):
        full = list(args)
        for i, x in zip(present, xs):
            full[i] = x
        return j_qkv_wide(*full, heads, True)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(args[i]) for i in present))
    jgrads = vjp(jnp.asarray(g))
    leaves = [None if a is None else _t(a, grad=True) for a in args]
    ours = ops.linear_d8_qkv_wide(*leaves, heads)
    ours.backward(_t(g))
    _close(ours, jout, msg="y")
    for i, jg in zip(present, jgrads):
        _close(leaves[i].grad, jg, atol=GRAD_ATOL, msg=f"grad {i}")
    # the inverse store, exactly
    y1, yef = ops.uninterleave_wide(_t(np.asarray(jout)), heads)
    jy1, jyef = j_uninterleave_wide(jout, heads)
    _close(y1, jy1, atol=0, rtol=0, msg="uninterleave 1-d")
    _close(yef, jyef, atol=0, rtol=0, msg="uninterleave E")
    # and its inverse on the natural outputs
    natural = tuple(y1) + (yef,)
    _close(tlinear.interleave_wide(natural, heads), jout, atol=0, rtol=0, msg="interleave")


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("b,n,c8,heads", SHAPES)
def test_linear_d8_wide1d_matches_plain_qkv(b, n, c8, heads, bias):
    """The wide-1d product is the LinearD8 qkv with its 1-d outputs in (s,
    h, g, d1) order (the JAX layer's permuted dense product), forward and
    gradients against autograd through the plain composition."""
    rng = np.random.default_rng(4)
    f = 3 * c8
    xs = [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 4 * c8)]
    w = [_n(rng, 4, c8, f, scale=c8 ** -0.5), _n(rng, 2 * c8, 2 * f, scale=(2 * c8) ** -0.5),
         _n(rng, f, scale=0.1) if bias else None]
    gs = [_n(rng, b, n, 4 * c8) for _ in range(3)] + [_n(rng, b, n, 6 * c8) for _ in range(2)]
    res = []
    for wide in (True, False):
        txs = [_t(a, grad=True) for a in xs]
        tw = [None if a is None else _t(a, grad=True) for a in w]
        if wide:
            out = ops.linear_d8_wide1d(tuple(txs), *tw, heads)
        else:
            y = ops.linear_d8(tuple(txs), *tw)
            y1d = tlinear.interleave_wide1d(y[:4], heads)
            k = 4 * c8
            out = (y1d[..., :k], y1d[..., k:2 * k], y1d[..., 2 * k:], y[4][..., :6 * c8],
                   y[4][..., 6 * c8:])
        torch.autograd.backward(out, [_t(g) for g in gs])
        res.append((out, [t.grad for t in txs + tw if t is not None]))
    for i, (o, r) in enumerate(zip(res[0][0], res[1][0])):
        _close(o, r.detach(), msg=f"out {i}")
    for i, (o, r) in enumerate(zip(res[0][1], res[1][1])):
        _close(o, r, atol=GRAD_ATOL, msg=f"grad {i}")


# ---- AttentionD8(use_wide_qkv) -------------------------------------------------------


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree)


def _flat_e(rng, b, n, c8):
    return [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 4 * c8)]


def _module_run(tmod, xs, params):
    """The port module in train mode on `params` (a flax tree): outputs,
    parameter gradients and input gradients of sum(out^2)."""
    tmod.load_state_dict(params_from_jax({"params": params}, tmod), strict=True)
    tmod.train()
    tin = [_t(a, grad=True) for a in xs]
    out = tmod(tuple(tin))
    sum(o.square().sum() for o in out).backward()
    return out, {n: p.grad for n, p in tmod.named_parameters()}, [x.grad for x in tin]


@pytest.mark.parametrize("b,n,c8,heads", SHAPES)
def test_attention_d8_wide_qkv_matches_jax(b, n, c8, heads):
    """The port's wide AttentionD8 against the JAX one (use_wide_qkv,
    use_pallas_attention; interpret mode) on shared weights, and against the
    port's non-wide module on the same parameters: outputs, every parameter
    gradient and the input gradients (the port of the JAX test
    tests/test_pallas_attention.py:278)."""
    rng = np.random.default_rng(5)
    xs = _flat_e(rng, b, n, c8)
    c = 8 * c8
    jmod = jd8.AttentionD8(num_heads=heads, qkv_bias=True, use_pallas_attention=True,
                           use_wide_qkv=True)
    jin = tuple(jnp.asarray(a) for a in xs)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jin)["params"], 5, 0.1)

    def jloss(p, ins):
        out = jmod.apply({"params": p}, ins)
        return sum(jnp.sum(o ** 2) for o in out), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jin)
    wide = td8.AttentionD8(c, heads, qkv_bias=True, use_wide_qkv=True)
    out, grads, xgrads = _module_run(wide, xs, params)
    jgrads = params_from_jax({"params": jax.device_get(jgp)}, wide)
    for i, (o, t) in enumerate(zip(out, jout)):
        _close(o, t, msg=f"output {i}")
    for name, g in grads.items():
        _close(g, jgrads[name], atol=GRAD_ATOL, msg=name)
    for i, (g, jg) in enumerate(zip(xgrads, jgx)):
        _close(g, jg, atol=GRAD_ATOL, msg=f"input grad {i}")
    # the port's non-wide module (octic_attention over the plain qkv) on the
    # same parameters
    base_out, base_grads, base_xgrads = _module_run(td8.AttentionD8(c, heads, qkv_bias=True), xs,
                                                    params)
    for i, (o, t) in enumerate(zip(out, base_out)):
        _close(o, t.detach(), msg=f"vs non-wide output {i}")
    for name, g in grads.items():
        _close(g, base_grads[name], atol=GRAD_ATOL, msg=f"vs non-wide {name}")
    for i, (g, bg) in enumerate(zip(xgrads, base_xgrads)):
        _close(g, bg, atol=GRAD_ATOL, msg=f"vs non-wide input grad {i}")


def test_wide_qkv_keeps_the_parameter_tree():
    """use_wide_qkv changes no parameter: the same state_dict keys and shapes
    on the port's attention and model, and the same flax tree in JAX, so
    params_from_jax maps a wide model's tree unchanged."""
    a, b = (td8.AttentionD8(64, 2, use_wide_qkv=w, device="meta") for w in (True, False))
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    kw = dict(img_size=IMG, device="meta")
    mw = create_model("hybrid_vit_small_test", use_wide_qkv=True, **kw)
    mb = create_model("hybrid_vit_small_test", **kw)
    assert {k: v.shape for k, v in mw.state_dict().items()} == \
        {k: v.shape for k, v in mb.state_dict().items()}
    assert all(blk.attn.use_wide_qkv for blk in mw.blocks[:mw.break_layer])
    shapes = [jax.eval_shape(lambda m=m: m.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, IMG, IMG, 3))))["params"]
              for m in (j_create_model("hybrid_vit_small_test", img_size=IMG, use_wide_qkv=w,
                                       **TRAIN_FLAGS) for w in (True, False))]
    assert jax.tree.map(lambda s: s.shape, shapes[0]) == jax.tree.map(lambda s: s.shape,
                                                                      shapes[1])


def test_packed_block_with_wide_qkv_unpacks(monkeypatch):
    """packed_carry with use_wide_qkv: the block unpacks the container for the
    wide qkv (as the JAX layer does) and gives the flat-E block's result."""
    rng = np.random.default_rng(6)
    c, heads = 64, 2
    xs = _flat_e(rng, 2, 9, c // 8)
    blk = td8.BlockD8(c, heads, mlp_ratio=2.0, layerscale_init=1.0, use_wide_qkv=True)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=torch.Generator().manual_seed(0))
    blk.train()
    calls = []
    fn = td8.octic_attention_wide1d
    monkeypatch.setattr(td8, "octic_attention_wide1d", lambda *a: calls.append(1) or fn(*a))
    flat = blk(tuple(map(_t, xs)), remat_block=True)
    packed = blk(pack_5_to_flat(tuple(map(_t, xs))), remat_block=True)
    assert len(calls) == 2 and isinstance(packed, torch.Tensor)
    _close(packed, pack_5_to_flat(flat).detach(), msg="packed vs flat-E")


# ---- the small hybrid with use_wide_qkv ------------------------------------------------

TRAIN_FLAGS = dict(use_pallas_attention=True, use_pallas_linear=True, use_pallas_std_mlp=True,
                   flat_e_carry=True)  # train/deit/main.py:81-88, unscanned
IMG = 32


def _small_params(seed):
    jmodel = j_create_model("hybrid_vit_small_test", img_size=IMG, **TRAIN_FLAGS)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 3)))["params"]
    return _perturb(params, seed, 0.02)


def test_small_wide_hybrid_logits_match_jax():
    """Eval-mode logits of hybrid_vit_small_test with use_wide_qkv against
    the JAX model with the same flag (interpret mode), atol 1e-4 (the bar of
    tests/test_models_kernels.py), and against the port without it."""
    params = _small_params(7)
    img = np.random.default_rng(7).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    jmodel = j_create_model("hybrid_vit_small_test", img_size=IMG, use_wide_qkv=True,
                            **TRAIN_FLAGS)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(img)))
    logits = []
    for wide in (True, False):
        tmodel = create_model("hybrid_vit_small_test", img_size=IMG, use_wide_qkv=wide,
                              device="cpu")
        tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
        with torch.no_grad():
            logits.append(tmodel.eval()(_t(img)).numpy())
    np.testing.assert_allclose(logits[0], ref, atol=1e-4)
    np.testing.assert_allclose(logits[0], logits[1], atol=1e-4)


def test_small_wide_hybrid_deit_step_matches_jax():
    """One DeiT III step of hybrid_vit_small_test with use_wide_qkv and remat
    against the unscanned JAX model with the train flags and use_wide_qkv,
    with the package's own optimizer, from shared parameters: loss, gradient
    norm and every updated parameter (the harness of
    tests/test_torch_port_train.py)."""
    params = _small_params(8)
    rng = np.random.default_rng(8)
    images = _n(rng, 4, IMG, IMG, 3)
    labels = rng.integers(0, 10, size=4).astype(np.int32)
    cfg = dict(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0,
               warmup_epochs=0, epochs=10, steps_per_epoch=10, lr=1e-3)
    jmodel = j_create_model("hybrid_vit_small_test", img_size=IMG, drop_path_rate=0.0,
                            use_wide_qkv=True, **TRAIN_FLAGS)
    jcfg = jengine.DeiTConfig(**cfg)
    tx = jengine.build_optimizer(jcfg, params)
    jstate = j_create_state(jax.tree_util.tree_map(jnp.asarray, params), tx, ema=True)
    jstep = jax.jit(jengine.make_deit_train_step(jmodel, jcfg, tx))
    jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                             jax.random.PRNGKey(0))

    tmodel = create_model("hybrid_vit_small_test", img_size=IMG, remat=True, use_wide_qkv=True,
                          device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    tcfg = engine.DeiTConfig(**cfg)
    opt = engine.build_optimizer(tcfg, tmodel)
    state = common.create_train_state(tmodel, opt, ema=True)
    step = engine.make_deit_train_step(tmodel, tcfg, opt)
    ops.reset_launch_counts()
    state, metrics = step(state, _t(images), _t(labels).long(), torch.Generator().manual_seed(0))
    _close(metrics["loss"], jmetrics["loss"], msg="loss")
    _close(metrics["grad_norm"], jmetrics["grad_norm"], atol=GRAD_ATOL, msg="grad norm")
    new = params_from_jax({"params": jax.device_get(jstate.params)}, tmodel)
    for name, p in tmodel.named_parameters():
        _close(p, new[name], msg=name)


# ---- row 4's backward: the hidden's cotangent stays f32 --------------------------------


def test_mlp_bwd_keeps_hidden_cotangent_f32(monkeypatch):
    """Row 4's backward as the card composes it (the rounded hidden, then
    _mlp_bwd_from_hidden), on bf16 CPU tensors: fc2's dh reaches fc1's
    D8-GELU VJP in f32, unrounded (the f32 product of the bf16 operands, as
    dh1 / dhef in pallas_linear.py:_mlp_bwd_rule), and dx and the weight
    gradients agree with the JAX rule at the same bf16 inputs (interpret
    mode) within BAR = 2e-2 * (max|ref| + |ref|): the port rounds the GELU
    VJP's output to bf16 as a product operand, where JAX multiplies it in
    f32, and rounds dW to bf16."""
    rng = np.random.default_rng(9)
    m, c8, bf = 37, 8, torch.bfloat16
    h8 = 2 * c8
    x1, xef = _n(rng, 4, m, c8), _n(rng, m, 4 * c8)
    params = [_n(rng, 4, c8, h8, scale=c8 ** -0.5), _n(rng, 2 * c8, 2 * h8, scale=(2 * c8) ** -0.5),
              _n(rng, h8, scale=0.1), _n(rng, 4, h8, c8, scale=h8 ** -0.5),
              _n(rng, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5), _n(rng, c8, scale=0.1)]
    g1, gef = _n(rng, 4, m, c8), _n(rng, m, 4 * c8)
    # bf16 inputs on both sides
    x1, xef, g1, gef, *params = (np.asarray(_t(a).to(bf).float()) for a in
                                 [x1, xef, g1, gef] + params)
    seen = []
    vjp = tlinear.gelu_d8_vjp
    monkeypatch.setattr(tlinear, "gelu_d8_vjp", lambda z, g: seen.append(g) or vjp(z, g))
    xs = tuple(_t(x1[i]).to(bf) for i in range(4)) + (_t(xef).to(bf),)
    tp = [_t(p).to(bf) for p in params]
    h = ops.linear_d8_fused_reference(xs, *tp[:3], fuse_gelu=True)
    gs = tuple(_t(g1[i]).to(bf) for i in range(4)) + (_t(gef).to(bf),)
    grads = tlinear._mlp_bwd_from_hidden(xs, h, *tp, gs)
    (g,) = seen
    assert all(t.dtype == torch.float32 for t in g)
    # the unrounded f32 product of the bf16 operands
    dh = [torch.matmul(gs[i].float(), tp[3][i].float().t()) for i in range(4)]
    rows = gs[4].float().reshape(-1, 2, 2 * c8)
    dh.append(torch.matmul(rows, tp[4].float().t()).reshape(m, 4 * h8))
    for i in range(5):
        _close(g[i], dh[i], atol=1e-6, rtol=1e-6, msg=f"dh {i}")
    jout, jvjp = jax.vjp(lambda a, e, *p: j_mlp_fused(a, e, *p, True),
                         *(jnp.asarray(a, jnp.bfloat16) for a in [x1, xef] + params))
    jgrads = jvjp((jnp.asarray(g1, jnp.bfloat16), jnp.asarray(gef, jnp.bfloat16)))
    ours = [torch.stack(grads[:4]), grads[4]] + list(grads[5:])
    for i, (o, r) in enumerate(zip(ours, jgrads)):
        r = np.asarray(r, dtype=np.float32)
        err = np.abs(o.float().numpy() - r)
        bar = 2e-2 * (np.abs(r).max() + np.abs(r))
        assert (err <= bar).all(), f"grad {i}: max err {err.max():.3e}"
