"""Parity of the port's DINOv2 SSL slice with the JAX package on the CPU, in
f32: the VJP of the fused octic qkv + attention under both JAX rules (the
eager chain and the all-in-one kernel, in interpret mode as the package's
own tests run it), the octic attention and block with the DINOv2 train
flags (fuse_qkv, remat), the DINOv2 backbones' token dicts, the DINO head,
the losses, masking and collate, the schedules, the lr/wd multipliers, and
one whole SSL train step of the tiny octic DINOv2 against the JAX
``SSLMetaArch`` step from shared parameters. Inputs come from seeded numpy
generators and go to both sides. Tolerance 1e-5 unless a test says
otherwise: f32 on both sides, with sums in another order."""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octic_vits_tpu.ops.pallas_attention as jpa
from octic_vits_tpu.layers import d8_layers as jd8
from octic_vits_tpu.models import DinoVisionTransformer as JDino
from octic_vits_tpu.models import OcticDinoVisionTransformer as JOcticDino
from octic_vits_tpu.models.dino_head import DINOHead as JDINOHead
from octic_vits_tpu.models.registry import register_model as j_register_model
from octic_vits_tpu.train.dinov2 import losses as JL
from octic_vits_tpu.train.dinov2 import masking as jmasking
from octic_vits_tpu.train.dinov2 import schedules as jsched
from octic_vits_tpu.train.dinov2.param_groups import build_multiplier_trees as j_multipliers
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLConfig as JSSLConfig
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLMetaArch as JSSLMetaArch
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLState as JSSLState
from octic_vits_tpu_torch import create_model, ops
from octic_vits_tpu_torch.layers import d8_layers as td8
from octic_vits_tpu_torch.models import DINOHead, DinoVisionTransformer
from octic_vits_tpu_torch.train.dinov2 import losses as L
from octic_vits_tpu_torch.train.dinov2 import masking, schedules
from octic_vits_tpu_torch.train.dinov2.param_groups import build_multiplier_trees
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch, batch_to_device
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = RTOL = 1e-5


def _n(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol, err_msg=msg)


def _perturb(tree, seed, scale=0.02):
    """Noise on every leaf, so no LayerScale (init 1e-5), mask token or norm
    affine sits at a value that hides its path."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree)


# ---- the fused qkv + attention VJP (row 2b) ----------------------------------

# (c8, heads, bias): even heads with and without bias, and an odd head count
# (the JAX kernel's head-pair tail); N = 7 is ragged
FUSED_CASES = [(16, 2, True), (16, 2, False), (24, 3, True)]


@pytest.mark.parametrize("kernel_rule", [False, True], ids=["eager_rule", "kernel_rule"])
@pytest.mark.parametrize("c8,heads,bias", FUSED_CASES)
def test_fused_qkv_vjp_matches_jax(monkeypatch, kernel_rule, c8, heads, bias):
    monkeypatch.setattr(jpa, "FUSED_BWD_KERNEL", kernel_rule)
    rng = np.random.default_rng(20 + c8 + heads)
    b, n = 2, 7
    xs = [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 4 * c8)]
    w1, we = _n(rng, 4, c8, 3 * c8, scale=0.2), _n(rng, 2 * c8, 6 * c8, scale=0.2)
    bb = _n(rng, 3 * c8, scale=0.2) if bias else None
    gs = [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 2 * c8) for _ in range(2)]
    jargs = [jnp.asarray(a) for a in xs + [w1, we]] + ([jnp.asarray(bb)] if bias else [])
    fn = lambda *a: jpa.octic_attention_fused_qkv(*a[:7], a[7] if bias else None,  # noqa: E731
                                                  heads)
    outs, vjp = jax.vjp(fn, *jargs)
    jgrads = vjp(tuple(jnp.asarray(g) for g in gs))

    txs = [_t(a, grad=True) for a in xs]
    tw1, twe = _t(w1, grad=True), _t(we, grad=True)
    tb = _t(bb, grad=True) if bias else None
    ours = ops.octic_attention_fused_qkv(*txs, tw1, twe, tb, heads)
    torch.autograd.backward(ours, [_t(g) for g in gs])
    for i, (o, t) in enumerate(zip(ours, outs)):
        _close(o, t, msg=f"output {i}")
    got = [t.grad for t in txs] + [tw1.grad, twe.grad] + ([tb.grad] if bias else [])
    names = ["da1", "da2", "db1", "db2", "def", "dw1", "dwe", "dbias"]
    for name, g, j in zip(names, got, jgrads):
        _close(g, j, msg=name)
    # the plain backward called on its own gives the same gradients
    plain = ops.octic_attention_fused_qkv_bwd_reference(
        tuple(_t(a) for a in xs), _t(w1), _t(we), None if bb is None else _t(bb),
        tuple(_t(g) for g in gs), heads)
    assert (plain[7] is None) == (not bias)
    for name, g, j in zip(names, plain, jgrads):
        _close(g, j, msg=f"reference {name}")


# ---- the octic attention and block with the DINOv2 train flags ----------------

B, N, C, HEADS = 2, 9, 64, 2
C8 = C // 8
JAX_FLAGS = dict(use_pallas_attention=True, fuse_qkv=True)  # + use_pallas_linear on the block


def _flat_e(seed):
    rng = np.random.default_rng(seed)
    return [_n(rng, B, N, C8) for _ in range(4)] + [_n(rng, B, N, 4 * C8)]


def _jax_module_grads(jmod, xs, seed):
    """Perturbed parameters of the flax module, its outputs (deterministic)
    and the gradients of sum(out^2) for its parameters and inputs."""
    jin = tuple(jnp.asarray(a) for a in xs)
    params = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(seed), jin)["params"], seed, 0.1)

    def jloss(p, ins):
        out = jmod.apply({"params": p}, ins)
        return sum(jnp.sum(o ** 2) for o in out), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jin)
    return params, jout, jax.device_get(jgp), jgx


def _check_module_grads(tmod, xs, jax_side, remat):
    """The port module in train mode from the same parameters: outputs,
    parameter grads and input grads against the flax module's."""
    params, jout, jgp, jgx = jax_side
    tmod.load_state_dict(params_from_jax({"params": params}, tmod), strict=True)
    tmod.train()
    tin = [_t(a, grad=True) for a in xs]
    out = tmod(tuple(tin)) if remat is None else tmod(tuple(tin), remat_block=remat)
    sum(o.square().sum() for o in out).backward()
    for i, (o, t) in enumerate(zip(out, jout)):
        _close(o, np.asarray(t).reshape(o.shape), msg=f"output {i}")
    jgrads = params_from_jax({"params": jgp}, tmod)
    for name, p in tmod.named_parameters():
        _close(p.grad, jgrads[name], msg=name)
    for i, (x, g) in enumerate(zip(tin, jgx)):
        _close(x.grad, np.asarray(g).reshape(x.shape), msg=f"input grad {i}")


def test_attention_d8_fuse_qkv_train_grads():
    xs = _flat_e(30)
    jax_side = _jax_module_grads(jd8.AttentionD8(num_heads=HEADS, qkv_bias=True, **JAX_FLAGS),
                                 xs, 30)
    _check_module_grads(td8.AttentionD8(C, HEADS, qkv_bias=True, fuse_qkv=True), xs, jax_side,
                        None)


@pytest.fixture(scope="module")
def block_jax_side():
    xs = _flat_e(31)
    jmod = jd8.BlockD8(num_heads=HEADS, mlp_ratio=2.0, qkv_bias=True, layerscale_init=1e-5,
                       use_pallas_linear=True, **JAX_FLAGS)
    return xs, _jax_module_grads(jmod, xs, 31)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_block_d8_fuse_qkv_train_grads(block_jax_side, remat):
    xs, jax_side = block_jax_side
    _check_module_grads(td8.BlockD8(C, HEADS, mlp_ratio=2.0, qkv_bias=True, layerscale_init=1e-5,
                                    fuse_qkv=True), xs, jax_side, remat)


def test_block_d8_fuse_qkv_remat_runs_fused_op_once(monkeypatch):
    """Under remat the fused op sits outside the rematerialized halves: one
    forward per block, none in the backward replay."""
    calls = []
    fn = td8.octic_attention_fused_qkv
    monkeypatch.setattr(td8, "octic_attention_fused_qkv",
                        lambda *a: calls.append(1) or fn(*a))
    blk = td8.BlockD8(C, HEADS, mlp_ratio=2.0, fuse_qkv=True)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=torch.Generator().manual_seed(0))
    xs = tuple(_t(a, grad=True) for a in _flat_e(32))
    sum(o.square().sum() for o in blk.train()(xs, remat_block=True)).backward()
    assert len(calls) == 1


# ---- the DINOv2 backbones ---------------------------------------------------------

OCTIC_CFG = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
                 init_scale=1e-5)  # registry.py:hybrid_dinov2_vit_tiny_test


def _crops_and_masks(size, with_masks, seed):
    rng = np.random.default_rng(seed)
    img = _n(rng, 2, size, size, 3)
    n_tok = (size // 8) ** 2
    masks = rng.random((2, n_tok)) < 0.4 if with_masks else None
    return img, masks


def _check_token_dict(ours, theirs, masks):
    for k in ("x_norm_clstoken", "x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
        assert tuple(ours[k].shape) == tuple(theirs[k].shape), k
        _close(ours[k], theirs[k], atol=1e-4, msg=k)  # the model bar (test_torch_port_model)
    assert (ours["masks"] is None) == (masks is None)


@pytest.fixture(scope="module")
def octic_dino():
    """The flax tiny octic DINOv2 backbone, its perturbed parameters and a
    jitted ``forward_features``."""
    jmodel = JOcticDino(**OCTIC_CFG)
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))[
        "params"], 41)
    fwd = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, m,
                                               method=jmodel.forward_features))
    return params, fwd


@pytest.mark.parametrize("size", [32, 16], ids=["global32", "local16"])
@pytest.mark.parametrize("with_masks", [False, True], ids=["no_masks", "masks"])
def test_octic_dinov2_token_dict_matches_jax(octic_dino, size, with_masks):
    img, masks = _crops_and_masks(size, with_masks, seed=40 + size)
    params, fwd = octic_dino
    theirs = fwd(params, jnp.asarray(img), None if masks is None else jnp.asarray(masks))
    tmodel = create_model("hybrid_dinov2_vit_tiny_test", fuse_qkv=True, device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    tm = None if masks is None else torch.from_numpy(masks)
    for mode in ("eval", "train"):  # fused inference ops / the fuse_qkv train path
        getattr(tmodel, mode)()
        with torch.no_grad():
            _check_token_dict(tmodel.forward_features(_t(img), tm), theirs, masks)


@pytest.mark.parametrize("size", [32, 16], ids=["global32", "local16"])
def test_standard_dinov2_token_dict_matches_jax(size):
    img, masks = _crops_and_masks(size, True, seed=50 + size)
    cfg = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
               layerscale_init=1e-5)
    jmodel = JDino(**cfg)
    params = _perturb(jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"], 51)
    theirs = jmodel.apply({"params": params}, jnp.asarray(img), jnp.asarray(masks),
                          method=jmodel.forward_features)
    tmodel = DinoVisionTransformer(**cfg)
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    with torch.no_grad():
        _check_token_dict(tmodel.eval().forward_features(_t(img), torch.from_numpy(masks)),
                          theirs, masks)


@pytest.mark.parametrize("nlayers", [1, 3])
def test_dino_head_matches_jax(nlayers):
    rng = np.random.default_rng(60 + nlayers)
    x, g = _n(rng, 5, 32), _n(rng, 5, 64)
    jhead = JDINOHead(out_dim=64, hidden_dim=24, bottleneck_dim=16, nlayers=nlayers)
    params = _perturb(jhead.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 61, 0.05)
    out, vjp = jax.vjp(lambda p, a: jhead.apply({"params": p}, a),
                       jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    thead = DINOHead(32, 64, 24, 16, nlayers)
    thead.load_state_dict(params_from_jax({"params": params}, thead), strict=True)
    tx = _t(x, grad=True)
    ours = thead(tx)
    ours.backward(_t(g))
    _close(ours, out)
    _close(tx.grad, jgx)
    jgrads = params_from_jax({"params": jax.device_get(jgp)}, thead)
    for name, p in thead.named_parameters():
        _close(p.grad, jgrads[name], msg=name)


# ---- losses, masking, schedules, multipliers -------------------------------------


@pytest.mark.parametrize("centering", ["centering", "sinkhorn_knopp"])
def test_losses_match_jax(centering):
    """The teacher targets of one centering, then every loss on them."""
    rng = np.random.default_rng(70)
    t_logits, s_logits = _n(rng, 6, 16, scale=3.0), _n(rng, 6, 16, scale=3.0)
    center = _n(rng, 16, scale=0.5)
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    weights = np.where(valid, 0.25, 0.0).astype(np.float32)
    jt, tt = jnp.asarray(t_logits), _t(t_logits)
    if centering == "centering":
        jp, tp = JL.softmax_center_teacher(jt, jnp.asarray(center), 0.07), \
            L.softmax_center_teacher(tt, _t(center), 0.07)
        for w in (None, valid):
            jc = JL.update_center(JL.CenterState(jnp.asarray(center)), jt, 0.9,
                                  None if w is None else jnp.asarray(w)).center
            tc = L.update_center(L.CenterState(_t(center)), tt, 0.9,
                                 None if w is None else torch.from_numpy(w)).center
            _close(tc, jc, msg="center")
    else:
        jp = JL.sinkhorn_knopp_teacher(jt, 0.07, sample_mask=jnp.asarray(valid))
        tp = L.sinkhorn_knopp_teacher(tt, 0.07, sample_mask=torch.from_numpy(valid))
        _close(L.sinkhorn_knopp_teacher(tt, 0.07), JL.sinkhorn_knopp_teacher(jt, 0.07),
               msg="sinkhorn unmasked")
    _close(tp, jp, msg="teacher probs")
    js, ts = jnp.asarray(s_logits), _t(s_logits)
    jp, tp = jnp.asarray(tp.numpy()), tp
    _close(L.dino_loss([ts, ts * 0.5], [tp, tp.flip(0)], 0.1),
           JL.dino_loss([js, js * 0.5], [jp, jp[::-1]], 0.1), msg="dino")
    _close(L.ibot_patch_loss_masked(ts, tp, _t(weights), 2, 0.1),
           JL.ibot_patch_loss_masked(js, jp, jnp.asarray(weights), 2, 0.1), msg="ibot masked")
    m = valid.reshape(2, 3)
    _close(L.ibot_patch_loss_dense(ts.reshape(2, 3, 16), tp.reshape(2, 3, 16),
                                   torch.from_numpy(m), 0.1),
           JL.ibot_patch_loss_dense(js.reshape(2, 3, 16), jp.reshape(2, 3, 16),
                                    jnp.asarray(m), 0.1), msg="ibot dense")
    x = _t(s_logits, grad=True)
    L.koleo_loss(x).backward()
    jk, jg = jax.value_and_grad(JL.koleo_loss)(js)
    _close(L.koleo_loss(ts), jk, msg="koleo")
    _close(x.grad, jg, msg="koleo grad")


@pytest.mark.parametrize("seed", range(3))
def test_masking_and_collate_same_arrays(seed):
    """The same random.Random seed draws the same masks, indices and weights."""
    grid, n_tok = 14, 196
    ours = masking.MaskingGenerator(grid, num_masking_patches=n_tok // 2)
    theirs = jmasking.MaskingGenerator(grid, num_masking_patches=n_tok // 2)
    np.testing.assert_array_equal(ours(60, rng=random.Random(seed)),
                                  theirs(60, rng=random.Random(seed)))
    rng = np.random.default_rng(seed)
    gc, lc = _n(rng, 8, 4, 4, 3), _n(rng, 16, 2, 2, 3)
    a = masking.collate_crops_and_masks(gc, lc, n_tok, ours, rng=random.Random(seed + 10))
    b = jmasking.collate_crops_and_masks(gc, lc, n_tok, theirs, rng=random.Random(seed + 10))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert masking.mask_upperbound(64, 196, 0.5, (0.1, 0.5)) == jmasking.mask_upperbound(
        64, 196, 0.5, (0.1, 0.5))


def test_schedules_match_jax():
    cfg = types.SimpleNamespace(
        train=types.SimpleNamespace(OFFICIAL_EPOCH_LENGTH=5),
        optim=types.SimpleNamespace(epochs=4, lr=2e-3, min_lr=1e-6, warmup_epochs=1,
                                    weight_decay=0.04, weight_decay_end=0.2,
                                    freeze_last_layer_epochs=1),
        teacher=types.SimpleNamespace(momentum_teacher=0.992, final_momentum_teacher=1.0,
                                      teacher_temp=0.07, warmup_teacher_temp=0.04,
                                      warmup_teacher_temp_epochs=2))
    for ours, theirs in zip(schedules.build_ssl_schedules(cfg), jsched.build_ssl_schedules(cfg)):
        assert [ours[i] for i in range(25)] == [theirs[i] for i in range(25)]
    s = schedules.CosineScheduler(1.0, 0.1, 12, warmup_iters=3, freeze_iters=2)
    j = jsched.CosineScheduler(1.0, 0.1, 12, warmup_iters=3, freeze_iters=2)
    assert [s[i] for i in range(14)] == [j[i] for i in range(14)]
    assert schedules.sqrt_lr_scaling(4e-3, 256) == jsched.sqrt_lr_scaling(4e-3, 256)


# ---- one whole SSL step ----------------------------------------------------------


@j_register_model
def hybrid_dinov2_vit_tiny_test(img_size=32, **kwargs):
    """The JAX twin of the port's registry entry of the same name
    (tests/test_ssl_training.py:_test_octic_dinov2)."""
    kwargs.setdefault("drop_path_rate", 0.0)
    return JOcticDino(**dict(OCTIC_CFG, img_size=img_size), **kwargs)


SSL_CFG = dict(arch="hybrid_dinov2_vit_tiny_test", img_size=32, local_crop_size=16, patch_size=8,
               drop_path_rate=0.0, dino_out_dim=64, dino_head_hidden_dim=32,
               dino_head_bottleneck_dim=16, ibot_out_dim=64, n_local_crops=2)
SCHED = dict(lr=1e-3, wd=0.04, last_layer_lr=5e-4, momentum=0.9, teacher_temp=0.04)


def _ssl_batch(cfg_kw, b=2, seed=0):
    """tests/test_ssl_training.py:make_batch."""
    rng = random.Random(seed)
    npr = np.random.RandomState(seed)
    grid = cfg_kw["img_size"] // cfg_kw["patch_size"]
    gen = masking.MaskingGenerator(grid, num_masking_patches=grid * grid // 2)
    s, ls = cfg_kw["img_size"], cfg_kw["local_crop_size"]
    gc = npr.randn(2 * b, s, s, 3).astype(np.float32)
    lc = npr.randn(cfg_kw["n_local_crops"] * b, ls, ls, 3).astype(np.float32)
    return masking.collate_crops_and_masks(gc, lc, grid * grid, gen, rng=rng)


def test_multiplier_trees_match_jax():
    jarch = JSSLMetaArch(JSSLConfig(**SSL_CFG, compute_dtype=jnp.float32))
    jparams = jax.eval_shape(jarch.init, jax.random.PRNGKey(0)).student  # names and shapes
    student = SSLMetaArch(SSLConfig(**SSL_CFG, compute_dtype=None), device="cpu").build_student()
    names = [n for n, _ in student.named_parameters()]
    ours = build_multiplier_trees(names, 2, 0.9, 0.2)
    theirs = [params_from_jax({"params": jax.tree_util.tree_map(
        lambda v, p: np.full(p.shape, v, np.float32), tree, jparams)}, student)
        for tree in j_multipliers(jparams, 2, 0.9, 0.2)]
    assert len(names) == len(theirs[0])
    for o, t in zip(ours, theirs):
        for n in names:
            assert o[n] == pytest.approx(float(t[n].reshape(-1)[0]), rel=1e-6), n


# both centerings; the Sinkhorn case also runs the separate iBOT head layout
STEP_CASES = {"centering": dict(centering="centering"),
              "sinkhorn_separate_ibot_head": dict(centering="sinkhorn_knopp",
                                                  ibot_separate_head=True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_ssl_train_step_matches_jax(case):
    """The loss terms, every student gradient, then the updated student,
    teacher and centers after one step. AdamW's first step moves each
    parameter by about lr * sign(g) (m/bc1 = g, sqrt(v/bc2) = |g|), so a
    gradient that differs in its last bits moves the parameter the same way:
    the updated parameters are compared with atol 1e-2 * lr = 1e-5."""
    extra = STEP_CASES[case]
    jcfg = JSSLConfig(**SSL_CFG, **extra, compute_dtype=jnp.float32)
    jarch = JSSLMetaArch(jcfg)
    params = _perturb(jax.jit(jarch.init)(jax.random.PRNGKey(0)).student, 80)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    jstate = JSSLState(step=jnp.zeros((), jnp.int32), student=jparams, teacher=jparams,
                       mu=zeros, nu=zeros, dino_center=jnp.zeros(64), ibot_center=jnp.zeros(64))
    batch = _ssl_batch(SSL_CFG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(student):
        return jarch.loss_fn(student, jparams, jstate.dino_center, jstate.ibot_center, jbatch,
                             SCHED["teacher_temp"], None)

    @jax.jit
    def jboth(state):  # one compile: the gradients, and the step on its own
        return (jax.value_and_grad(jloss, has_aux=True)(state.student),
                jarch.make_train_step()(state, jbatch, SCHED, jax.random.PRNGKey(1)))

    ((jl, jaux), jgrads), (jstate2, jmetrics) = jboth(jstate)

    arch = SSLMetaArch(SSLConfig(**SSL_CFG, **extra, compute_dtype=None), device="cpu")
    student = arch.build_student()
    student.load_state_dict(params_from_jax({"params": params}, student), strict=True)
    state = arch.state_from_student(student)
    tbatch = batch_to_device(batch, "cpu")
    loss, aux = arch.forward_backward(state, tbatch, SCHED["teacher_temp"])
    _close(loss, jl, msg="loss")
    for k, v in aux["loss_dict"].items():
        _close(v, jaux["loss_dict"][k], msg=k)
    grads = params_from_jax({"params": jax.device_get(jgrads)}, student)
    for name, p in student.named_parameters():
        _close(p.grad, grads[name], atol=1e-6, rtol=1e-4, msg=f"grad {name}")

    state = arch.state_from_student(student)
    state, metrics = arch.make_train_step()(state, tbatch, SCHED, torch.Generator().manual_seed(0))
    assert state.step == 1
    for k, v in metrics.items():
        _close(v, jmetrics[k], msg=k)
    old = params_from_jax({"params": params}, student)
    new = params_from_jax({"params": jax.device_get(jstate2.student)}, student)
    teacher = params_from_jax({"params": jax.device_get(jstate2.teacher)}, student)
    lr_mult, wd_mult, last = build_multiplier_trees(old, 2, 0.9, 0.2)
    lr, m_t = SCHED["lr"], SCHED["momentum"]
    n_noise, n_total = 0, 0
    for (name, p), t in zip(student.named_parameters(), state.teacher.parameters()):
        # the port's own step from its own (clipped) gradient, in numpy: the
        # AdamW and EMA arithmetic everywhere, the noise-level entries included
        g, p0 = p.grad.numpy(), old[name].numpy()
        step_lr = (SCHED["last_layer_lr"] * last[name] + lr * (1 - last[name])) * lr_mult[name]
        want = p0 - step_lr * (g / (np.abs(g) + 1e-8) + SCHED["wd"] * wd_mult[name] * p0)
        _close(p, want, atol=1e-2 * lr, rtol=0, msg=f"own step {name}")
        _close(t, m_t * p0 + (1 - m_t) * want, atol=1e-2 * lr, rtol=0, msg=f"own EMA {name}")
        # against the JAX step. Where the gradient is zero up to f32 rounding
        # (|g| < 1e-6, e.g. entries that the pos-embed's symmetry cancels: a
        # few 1e-9 on both sides), g / (|g| + 1e-8) is the sign of that noise
        # on each side, and the two steps may differ by up to lr; elsewhere
        # they agree to 1e-2 lr.
        well = np.abs(grads[name].numpy()) >= 1e-6
        n_noise += int((~well).sum())
        n_total += well.size
        for ours, theirs, tag in ((p, new[name], ""), (t, teacher[name], "teacher ")):
            diff = np.abs(ours.detach().numpy() - theirs.numpy())
            assert diff[well].max(initial=0.0) <= 1e-2 * lr, f"{tag}{name}"
            assert diff.max() <= lr, f"{tag}{name}"
    assert n_noise < 0.05 * n_total  # ~3% here: the key biases' zero gradient and the like
    _close(state.dino_center, jstate2.dino_center, msg="dino center")
    _close(state.ibot_center, jstate2.ibot_center, msg="ibot center")
