"""One DINOv2 SSL step of the tiny invariant-early octic backbone in the port
against one jitted JAX ``SSLMetaArch`` step from shared parameters, on the
CPU in f32: the sizes of tests/test_ssl_training.py:_test_octic_dinov2 with
``invariant=True`` (the power-spectrum break and its projection after the
first of two blocks). The port's student runs the DINOv2 flags
(``fuse_qkv``), whose plain paths the CPU takes. The loss terms, every
student gradient, then the updated student, teacher and centers (within
1e-5, the bars of tests/test_torch_port_ssl.py's step test) are compared."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from octic_vits_tpu.models import OcticDinoVisionTransformer as JOcticDino
from octic_vits_tpu.models.registry import register_model as j_register_model
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLConfig as JSSLConfig
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLMetaArch as JSSLMetaArch
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLState as JSSLState
from octic_vits_tpu_torch.train.dinov2 import masking
from octic_vits_tpu_torch.train.dinov2.param_groups import build_multiplier_trees
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch, batch_to_device
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = RTOL = 1e-5
TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, init_scale=1e-5)


@j_register_model
def d8_inv_early_dinov2_vit_tiny_test(img_size=32, **kwargs):
    """The JAX twin of the port's tiny DINOv2 backbone with ``invariant=True``."""
    kwargs.setdefault("drop_path_rate", 0.0)
    return JOcticDino(img_size=img_size, invariant=True, **TINY, **kwargs)


COMMON = dict(img_size=32, local_crop_size=16, patch_size=8, drop_path_rate=0.0, dino_out_dim=64,
              dino_head_hidden_dim=32, dino_head_bottleneck_dim=16, ibot_out_dim=64,
              n_local_crops=2)
SCHED = dict(lr=1e-3, wd=0.04, last_layer_lr=5e-4, momentum=0.9, teacher_temp=0.04)


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


def _ssl_batch(b=2, seed=0):
    """tests/test_ssl_training.py:make_batch."""
    rng = random.Random(seed)
    npr = np.random.RandomState(seed)
    grid = COMMON["img_size"] // COMMON["patch_size"]
    gen = masking.MaskingGenerator(grid, num_masking_patches=grid * grid // 2)
    s, ls = COMMON["img_size"], COMMON["local_crop_size"]
    gc = npr.randn(2 * b, s, s, 3).astype(np.float32)
    lc = npr.randn(COMMON["n_local_crops"] * b, ls, ls, 3).astype(np.float32)
    return masking.collate_crops_and_masks(gc, lc, grid * grid, gen, rng=rng)


def test_inv_early_ssl_train_step_matches_jax():
    """AdamW's first step moves each parameter by about lr * sign(g), so the
    updated parameters are compared with atol 1e-2 * lr = 1e-5, except where
    the gradient is zero up to f32 rounding (|g| < 1e-6), where the sign of
    that noise may differ between the two sides (within lr)."""
    jarch = JSSLMetaArch(JSSLConfig(arch="d8_inv_early_dinov2_vit_tiny_test", **COMMON,
                                    compute_dtype=jnp.float32))
    params = _perturb(jax.jit(jarch.init)(jax.random.PRNGKey(0)).student, 90)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    jstate = JSSLState(step=jnp.zeros((), jnp.int32), student=jparams, teacher=jparams,
                       mu=zeros, nu=zeros, dino_center=jnp.zeros(64), ibot_center=jnp.zeros(64))
    batch = _ssl_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(student):
        return jarch.loss_fn(student, jparams, jstate.dino_center, jstate.ibot_center, jbatch,
                             SCHED["teacher_temp"], None)

    @jax.jit
    def jboth(state):  # one compile: the gradients, and the step on its own
        return (jax.value_and_grad(jloss, has_aux=True)(state.student),
                jarch.make_train_step()(state, jbatch, SCHED, jax.random.PRNGKey(1)))

    ((jl, jaux), jgrads), (jstate2, jmetrics) = jboth(jstate)

    arch = SSLMetaArch(SSLConfig(arch="hybrid_dinov2_vit_tiny_test", **COMMON,
                                 compute_dtype=None), device="cpu", invariant=True)
    student = arch.build_student()
    backbone = student["backbone"]
    assert backbone.invariant_proj.weight.shape == (32, 24) and backbone.break_layer == 1
    assert all(blk.attn.fuse_qkv for blk in backbone.blocks[:1])
    student.load_state_dict(params_from_jax({"params": params}, student), strict=True)
    state = arch.state_from_student(student)
    tbatch = batch_to_device(batch, "cpu")
    loss, aux = arch.forward_backward(state, tbatch, SCHED["teacher_temp"])
    _close(loss, jl, msg="loss")
    for k, v in aux["loss_dict"].items():
        _close(v, jaux["loss_dict"][k], msg=k)
    # gradients within 2e-5 of max(1, max|g|) of their tensor: the same step
    # in f64 on the port puts both f32 sides up to 3.3e-5 (port) and 2.5e-5
    # (JAX) from it on invariant_proj.bias (|g| up to 1.96), and within 1.8e-5
    # elsewhere: the order of f32 sums over ~300 tokens, on both sides alike
    grads = params_from_jax({"params": jax.device_get(jgrads)}, student)
    for name, p in student.named_parameters():
        scale = max(1.0, float(grads[name].abs().max()))
        _close(p.grad, grads[name], atol=2e-5 * scale, rtol=1e-4, msg=f"grad {name}")

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
        # the port's own step from its own (clipped) gradient, in numpy
        g, p0 = p.grad.numpy(), old[name].numpy()
        step_lr = (SCHED["last_layer_lr"] * last[name] + lr * (1 - last[name])) * lr_mult[name]
        want = p0 - step_lr * (g / (np.abs(g) + 1e-8) + SCHED["wd"] * wd_mult[name] * p0)
        _close(p, want, atol=1e-2 * lr, rtol=0, msg=f"own step {name}")
        _close(t, m_t * p0 + (1 - m_t) * want, atol=1e-2 * lr, rtol=0, msg=f"own EMA {name}")
        # against the JAX step
        well = np.abs(grads[name].numpy()) >= 1e-6
        n_noise += int((~well).sum())
        n_total += well.size
        for ours, theirs, tag in ((p, new[name], ""), (t, teacher[name], "teacher ")):
            diff = np.abs(ours.detach().numpy() - theirs.numpy())
            assert diff[well].max(initial=0.0) <= 1e-2 * lr, f"{tag}{name}"
            assert diff.max() <= lr, f"{tag}{name}"
    assert n_noise < 0.05 * n_total
    _close(state.dino_center, jstate2.dino_center, msg="dino center")
    _close(state.ibot_center, jstate2.ibot_center, msg="ibot center")
