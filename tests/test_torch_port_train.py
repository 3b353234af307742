"""Parity of the port's DeiT III train path with the JAX package on the CPU,
in f32: the gradients of the attention, linear and dense ops (the JAX
Pallas kernels in interpret mode, as the JAX package's own tests run them),
mixup/cutmix given the same draws, LAMB and AdamW against optax, the
learning-rate schedule, the losses, and one whole ``make_deit_train_step``
of ``hybrid_vit_small_test`` with the production train flags (scan, remat)
from shared parameters. Inputs come from seeded numpy generators and go to
both sides. Tolerance 1e-5 unless a test says otherwise: f32 on both sides,
with sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from octic_vits_tpu.data.mixup import mixup_cutmix as j_mixup_cutmix
from octic_vits_tpu.models.registry import create_model as j_create_model
from octic_vits_tpu.ops.pallas_attention import (
    octic_attention as j_octic_attention,
    standard_attention as j_standard_attention,
)
from octic_vits_tpu.ops.pallas_dense import dense_gelu as j_dense_gelu
from octic_vits_tpu.ops.pallas_linear import linear_d8_fused as j_linear_d8_fused
from octic_vits_tpu.train.common import (
    bce_target_loss as j_bce,
    create_train_state as j_create_state,
    cross_entropy_loss as j_ce,
)
from octic_vits_tpu.train.deit import engine as jengine
from octic_vits_tpu.train.deit.losses import distillation_loss as j_distillation_loss
from octic_vits_tpu_torch import create_model, init_weights, ops
from octic_vits_tpu_torch.data.mixup import MixDraws, mixup_cutmix
from octic_vits_tpu_torch.train import common
from octic_vits_tpu_torch.train.deit import engine
from octic_vits_tpu_torch.train.deit.losses import distillation_loss
from octic_vits_tpu_torch.train.optim import Lamb
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


# ---- kernels' gradients -----------------------------------------------------


@pytest.mark.parametrize("b,n,heads,dh", [(2, 17, 2, 8), (1, 13, 3, 16)])
def test_standard_attention_grad(b, n, heads, dh):
    rng = np.random.default_rng(10)
    qkv, g = _n(rng, b, n, 3 * heads * dh), _n(rng, b, n, heads * dh)
    out, vjp = jax.vjp(lambda x: j_standard_attention(x, heads, True), jnp.asarray(qkv))
    (dqkv,) = vjp(jnp.asarray(g))
    x = _t(qkv, grad=True)
    ours = ops.standard_attention(x, heads)
    ours.backward(_t(g))
    _close(ours, out)
    _close(x.grad, dqkv)
    _close(ops.standard_attention_bwd_reference(_t(qkv), _t(g), heads), dqkv)


# H=3 and H=5 leave the JAX kernel's head-pair tail (OCTIC_ATTN_GROUP=2);
# N=13 and 17 are ragged
@pytest.mark.parametrize("b,n,heads,d1", [(2, 17, 2, 1), (1, 13, 3, 2), (2, 9, 5, 1)])
def test_octic_attention_grad(b, n, heads, d1):
    rng = np.random.default_rng(11)
    c8 = heads * d1
    ones = [_n(rng, b, n, 3 * c8) for _ in range(4)]
    ef = _n(rng, b, n, 12 * c8)  # flat-E qkv: e0 | e1
    gs = [_n(rng, b, n, c8) for _ in range(4)] + [_n(rng, b, n, 2 * c8) for _ in range(2)]
    jins = [jnp.asarray(a) for a in ones] + [jnp.asarray(ef[..., :6 * c8]),
                                             jnp.asarray(ef[..., 6 * c8:])]
    outs, vjp = jax.vjp(lambda *xs: j_octic_attention(*xs, heads, True), *jins)
    jgrads = vjp(tuple(jnp.asarray(g) for g in gs))
    tones = [_t(a, grad=True) for a in ones]
    tef = _t(ef, grad=True)
    ours = ops.octic_attention(*tones, tef[..., :6 * c8], tef[..., 6 * c8:], heads)
    torch.autograd.backward(ours, [_t(g) for g in gs])
    for i, (o, t) in enumerate(zip(ours, outs)):
        _close(o, t, msg=f"output {i}")
    for i in range(4):
        _close(tones[i].grad, jgrads[i], msg=f"grad {i}")
    _close(tef.grad, np.concatenate([np.asarray(jgrads[4]), np.asarray(jgrads[5])], -1),
           msg="grad E")


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_d8_fused_forward_and_vjp(gelu, bias):
    rng = np.random.default_rng(12)
    b, n, c, f = 2, 5, 8, 16
    xs = [_n(rng, b, n, c) for _ in range(4)] + [_n(rng, b, n, 4 * c)]
    w1, we = _n(rng, 4, c, f, scale=0.3), _n(rng, 2 * c, 2 * f, scale=0.3)
    bb = _n(rng, f) if bias else None
    gs = [_n(rng, b, n, f) for _ in range(4)] + [_n(rng, b, n, 4 * f)]
    m = b * n
    x1 = np.stack([x.reshape(m, c) for x in xs[:4]])
    xef = xs[4].reshape(m, 4 * c)
    jargs = [jnp.asarray(a) for a in (x1, xef, w1, we)] + [None if bb is None else jnp.asarray(bb)]
    if bias:
        fn = lambda x1_, xef_, w1_, we_, b_: j_linear_d8_fused(  # noqa: E731
            x1_, xef_, w1_, we_, b_, fuse_gelu=gelu, interpret=True)
        (y1, yef), vjp = jax.vjp(fn, *jargs)
    else:
        fn = lambda x1_, xef_, w1_, we_: j_linear_d8_fused(  # noqa: E731
            x1_, xef_, w1_, we_, None, fuse_gelu=gelu, interpret=True)
        (y1, yef), vjp = jax.vjp(fn, *jargs[:4])
    g1 = jnp.asarray(np.stack([g.reshape(m, f) for g in gs[:4]]))
    jg = vjp((g1, jnp.asarray(gs[4].reshape(m, 4 * f))))

    txs = [_t(x, grad=True) for x in xs]
    tw1, twe = _t(w1, grad=True), _t(we, grad=True)
    tb = None if bb is None else _t(bb, grad=True)
    ours = ops.linear_d8_fused(tuple(txs), tw1, twe, tb, gelu)
    torch.autograd.backward(ours, [_t(g) for g in gs])
    for g in range(4):
        _close(ours[g], np.asarray(y1[g]).reshape(b, n, f), msg=f"y slot {g}")
        _close(txs[g].grad, np.asarray(jg[0][g]).reshape(b, n, c), msg=f"dx slot {g}")
    _close(ours[4], np.asarray(yef).reshape(b, n, 4 * f), msg="y E")
    _close(txs[4].grad, np.asarray(jg[1]).reshape(b, n, 4 * c), msg="dx E")
    _close(tw1.grad, jg[2], msg="dw1")
    _close(twe.grad, jg[3], msg="dwe")
    if bias:
        _close(tb.grad, jg[4], msg="dbias")
    # the tuple wrapper with E as [..., 2, 2c] gives the same map
    ys = ops.linear_d8_tuple(tuple(t.detach() for t in txs[:4]) + (
        txs[4].detach().reshape(b, n, 2, 2 * c),), tw1.detach(), twe.detach(),
        None if tb is None else tb.detach(), gelu)
    _close(ys[4].reshape(b, n, 4 * f), ours[4].detach())


@pytest.mark.parametrize("bias", [True, False])
def test_dense_gelu_vjp(bias):
    rng = np.random.default_rng(13)
    x, w = _n(rng, 2, 7, 16), _n(rng, 16, 40, scale=0.3)
    bb = _n(rng, 40) if bias else None
    g = _n(rng, 2, 7, 40)
    jargs = (jnp.asarray(x), jnp.asarray(w), None if bb is None else jnp.asarray(bb))
    out, vjp = jax.vjp(lambda a, b_, c_: j_dense_gelu(a, b_, c_), *jargs)
    jdx, jdw, jdb = vjp(jnp.asarray(g))
    tx, tw = _t(x, grad=True), _t(w.T, grad=True)
    tb = None if bb is None else _t(bb, grad=True)
    ours = ops.dense_gelu(tx, tw, tb)
    ours.backward(_t(g))
    _close(ours, out)
    _close(tx.grad, jdx)
    _close(tw.grad.T, jdw)
    if bias:
        _close(tb.grad, jdb)


def test_backward_kernel_shape_guard():
    """K-attn-bwd's whole-head form holds q, k, v and dO of a head in shared
    memory: ViT-H/14 (N=257, dh=80) fits, a long sequence or a wide head is
    refused by that form's guard before any launch; the ops' dispatch
    streams those and still raises on a head width no kernel takes."""
    from octic_vits_tpu_torch.ops.attention import (
        _check_attention_bwd_shape,
        attention_bwd_plan,
    )

    _check_attention_bwd_shape(257, 80)
    assert not attention_bwd_plan(257, 80)["streamed"]
    for n, dh in ((400, 80), (257, 128), (257, 20)):
        with pytest.raises(ValueError, match="shared memory|multiple of 8"):
            _check_attention_bwd_shape(n, dh)
        if dh % 8:
            with pytest.raises(ValueError, match="multiple of 8"):
                attention_bwd_plan(n, dh)
        else:
            assert attention_bwd_plan(n, dh)["streamed"]
    assert attention_bwd_plan(1024, 128)["streamed"]


def test_row_stride_accepts_column_slices_only():
    from octic_vits_tpu_torch.ops._dispatch import row_stride

    flat = torch.zeros(2, 5, 24, dtype=torch.bfloat16)
    assert row_stride(flat, "x", (2, 5, 24)) == 24
    assert row_stride(flat[..., 12:], "e1", (2, 5, 12)) == 24
    with pytest.raises(ValueError):
        row_stride(flat.transpose(0, 1), "x", (5, 2, 24))
    with pytest.raises(ValueError):
        row_stride(flat[..., ::2], "x", (2, 5, 12))
    with pytest.raises(TypeError):
        row_stride(flat.float(), "x", (2, 5, 24))


# ---- data and losses ----------------------------------------------------------


def _jax_draws(rng, h, w, mixup_alpha, cutmix_alpha, prob, switch_prob) -> MixDraws:
    """The draws jax mixup_cutmix makes from `rng` (its own key splits)."""
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(rng, 5)
    ky, kx = jax.random.split(k_box)
    return MixDraws(
        apply=bool(jax.random.bernoulli(k_apply, prob)),
        use_cutmix=bool(jax.random.bernoulli(k_switch, switch_prob)),
        lam_mix=float(jax.random.beta(k_lam_m, mixup_alpha, mixup_alpha)),
        lam_cut=float(jax.random.beta(k_lam_c, cutmix_alpha, cutmix_alpha)),
        cy=int(jax.random.randint(ky, (), 0, h)),
        cx=int(jax.random.randint(kx, (), 0, w)),
    )


@pytest.mark.parametrize("seed", range(6))
def test_mixup_cutmix_same_draws(seed):
    rng = np.random.default_rng(seed)
    images = _n(rng, 4, 16, 12, 3)
    labels = rng.integers(0, 10, size=4).astype(np.int32)
    prob, smoothing = 0.8, 0.1 * (seed % 2)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key, 16, 12, 0.8, 1.0, prob, 0.5)
    jm, jt = j_mixup_cutmix(key, jnp.asarray(images), jnp.asarray(labels), 10, 0.8, 1.0, prob,
                            0.5, smoothing)
    tm, tt = mixup_cutmix(_t(images), _t(labels), 10, draws, smoothing)
    _close(tm, jm, atol=1e-6, rtol=1e-6)
    _close(tt, jt, atol=1e-6, rtol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(14)
    logits, logits_t = _n(rng, 6, 10), _n(rng, 6, 10)
    targets = rng.random((6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=6)
    tl, jl = _t(logits), jnp.asarray(logits)
    _close(common.bce_target_loss(tl, _t(targets)), j_bce(jl, jnp.asarray(targets)))
    _close(common.cross_entropy_loss(tl, _t(labels)), j_ce(jl, jnp.asarray(labels)))
    _close(common.cross_entropy_loss(tl, _t(labels), 0.1), j_ce(jl, jnp.asarray(labels), 0.1))
    _close(common.cross_entropy_loss(tl, _t(targets)), j_ce(jl, jnp.asarray(targets)))
    for kind in ("soft", "hard"):
        ours = distillation_loss(torch.tensor(0.7), tl, _t(logits_t), kind, 0.3, 2.0)
        theirs = j_distillation_loss(jnp.float32(0.7), jl, jnp.asarray(logits_t), kind, 0.3, 2.0)
        _close(ours, theirs)


def test_lr_schedule_matches_jax():
    cfg = dict(lr=2e-3, warmup_epochs=2, steps_per_epoch=7, epochs=5, warmup_lr=1e-6,
               min_lr=1e-5)
    ours, theirs = engine.lr_schedule(engine.DeiTConfig(**cfg)), jengine.lr_schedule(
        jengine.DeiTConfig(**cfg))
    steps = list(range(0, 40, 3))
    _close(np.array([ours(s) for s in steps], np.float32),
           np.array([float(theirs(s)) for s in steps], np.float32), atol=0, rtol=1e-6)


# ---- optimizers ---------------------------------------------------------------


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"w": _n(rng, 6, 5), "b": _n(rng, 5), "z": np.zeros((3, 4), np.float32)}
    grads = [{k: _n(rng, *v.shape) for k, v in params.items()} for _ in range(3)]
    grads[0]["z"][:] = 0.0  # a zero update norm takes the trust ratio 1
    mask = {"w": True, "b": False, "z": True}
    return params, grads, mask


def _run_torch(opt_cls, params, grads, mask, **kw):
    ts = {k: _t(v.copy()) for k, v in params.items()}
    groups = [{"params": [ts[k] for k in ts if mask[k]], "weight_decay": kw.pop("wd")},
              {"params": [ts[k] for k in ts if not mask[k]], "weight_decay": 0.0}]
    opt = opt_cls(groups, **kw)
    for g in grads:
        for k, t in ts.items():
            t.grad = _t(g[k])
        opt.step()
    return ts


def _run_optax(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(p)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        p = optax.apply_updates(p, upd)
    return p


def test_lamb_matches_optax():
    params, grads, mask = _opt_case(15)
    ours = _run_torch(Lamb, params, grads, mask, lr=1e-2, betas=(0.9, 0.99), eps=1e-8, wd=0.05)
    theirs = _run_optax(optax.lamb(1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.05,
                                   mask=mask), params, grads)
    for k in params:
        _close(ours[k], theirs[k], msg=k)


def test_adamw_matches_optax():
    params, grads, mask = _opt_case(16)
    ours = _run_torch(torch.optim.AdamW, params, grads, mask, lr=1e-2, betas=(0.9, 0.99),
                      eps=1e-8, wd=0.05)
    theirs = _run_optax(optax.adamw(1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.05,
                                    mask=mask), params, grads)
    for k in params:
        _close(ours[k], theirs[k], msg=k)


# ---- the train step -----------------------------------------------------------

TRAIN_FLAGS = dict(use_pallas_attention=True, use_pallas_linear=True, use_pallas_std_mlp=True,
                   flat_e_carry=True, scan_blocks=True, remat=True)  # main.py:81-88
IMG = 32


def _perturbed_params(jmodel, seed):
    img = jnp.zeros((1, IMG, IMG, 3))
    params = jmodel.init(jax.random.PRNGKey(seed), img)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def _stacked(params):
    """True for the leaves of a scanned tree that carry the depth axis."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: str(getattr(path[0], "key", path[0])) in ("octic_blocks",
                                                                   "standard_blocks"), params)


def _lamb_per_block(cfg, params):
    """optax.lamb with timm's per-tensor rules on a scanned tree: a stacked
    leaf's rank for the decay mask and its LAMB trust ratio count each block
    on its own (optax on the stacked leaf would take one ratio over all the
    blocks of the stack, and decay their 1-d tensors). On an unscanned tree
    this is optax.lamb exactly."""
    stacked = _stacked(params)

    def decays(path, x, st):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        return "pos_embed" not in name and "cls_token" not in name and np.ndim(x) - st > 1

    def trust(u, p, st):
        axes = tuple(range(1, u.ndim)) if st else None
        pn = jnp.sqrt(jnp.sum(p * p, axis=axes, keepdims=st))
        un = jnp.sqrt(jnp.sum(u * u, axis=axes, keepdims=st))
        return u * jnp.where((pn == 0) | (un == 0), 1.0, pn / un)

    trust_tx = optax.GradientTransformation(
        optax.init_empty_state,
        lambda u, s, p: (jax.tree_util.tree_map(trust, u, p, stacked), s))
    return optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=cfg.opt_eps),
        optax.add_decayed_weights(cfg.weight_decay,
                                  jax.tree_util.tree_map_with_path(decays, params, stacked)),
        trust_tx,
        optax.scale_by_learning_rate(jengine.lr_schedule(cfg)))


@pytest.fixture(scope="module")
def small_train_setup():
    """The JAX model with the train flags, scanned (with remat) and
    unscanned, each with its perturbed parameters; one batch."""
    models = {}
    for scanned in (True, False):
        flags = dict(TRAIN_FLAGS, scan_blocks=scanned, remat=scanned)
        jmodel = j_create_model("hybrid_vit_small_test", img_size=IMG, drop_path_rate=0.0,
                                **flags)
        models[scanned] = (jmodel, _perturbed_params(jmodel, seed=3))
    rng = np.random.default_rng(4)
    images = _n(rng, 4, IMG, IMG, 3)
    labels = rng.integers(0, 10, size=4).astype(np.int32)
    return models, images, labels


# (accum_steps, config overrides, attention-only trainable mask, scanned
# JAX trunk): accum 1 and 2 with the recipe's BCE; CE with label smoothing,
# cosub and attention-only finetuning; and the recipe's BCE on the unscanned
# trunk with the package's own build_optimizer. Deterministic, drop path 0.
STEP_CASES = {"bce_accum1": (1, {}, False, True), "bce_accum2": (2, {}, False, True),
              "ce_cosub_attn_only": (1, dict(loss_type="ce", smoothing=0.1, cosub=True), True,
                                     True),
              "bce_unscanned_package_optimizer": (1, {}, False, False)}


def _attn_only(name: str) -> bool:
    return "attn" in name or "norm1" in name


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_deit_train_step_matches_jax(small_train_setup, case):
    accum, extra, frozen, scanned = STEP_CASES[case]
    models, images, labels = small_train_setup
    jmodel, params = models[scanned]
    cfg = dict(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0,
               warmup_epochs=0, epochs=10, steps_per_epoch=10, lr=1e-3, accum_steps=accum,
               **extra)
    jcfg = jengine.DeiTConfig(**cfg)
    # on the scanned tree optax.lamb would see each stack as one tensor, so
    # _lamb_per_block applies its per-tensor rules block by block; on the
    # unscanned tree the package's own optimizer (mask and groups) runs as is
    tx = _lamb_per_block(jcfg, params) if scanned else jengine.build_optimizer(jcfg, params)
    jmask = tmask = None
    if frozen:
        jmask = jax.tree_util.tree_map_with_path(
            lambda path, _: _attn_only("/".join(str(getattr(k, "key", k)) for k in path)), params)
    jstate = j_create_state(jax.tree_util.tree_map(jnp.asarray, params), tx, ema=True)
    jstep = jax.jit(jengine.make_deit_train_step(jmodel, jcfg, tx, trainable_mask=jmask))
    jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                             jax.random.PRNGKey(0))

    tmodel = create_model("hybrid_vit_small_test", img_size=IMG, remat=True, device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    tcfg = engine.DeiTConfig(**cfg)
    opt = engine.build_optimizer(tcfg, tmodel)
    state = common.create_train_state(tmodel, opt, ema=True)
    if frozen:
        tmask = {n: _attn_only(n) for n, _ in tmodel.named_parameters()}
    step = engine.make_deit_train_step(tmodel, tcfg, opt, trainable_mask=tmask)
    state, metrics = step(state, _t(images), _t(labels).long(), torch.Generator().manual_seed(0))

    assert state.step == 1
    _close(metrics["loss"], jmetrics["loss"], msg="loss")
    _close(metrics["grad_norm"], jmetrics["grad_norm"], msg="grad norm")
    new = params_from_jax({"params": jax.device_get(jstate.params)}, tmodel)
    ema = params_from_jax({"params": jax.device_get(jstate.ema_params)}, tmodel)
    moved = 0.0
    for name, p in tmodel.named_parameters():
        _close(p, new[name], msg=name)
        _close(state.ema[name], ema[name], msg=f"ema {name}")
        moved = max(moved, (p.detach() - _t(np.asarray(params_from_jax(
            {"params": params}, tmodel)[name]))).abs().max().item())
    assert moved > 1e-4  # the update is visible above the tolerance


def test_port_gradients_with_and_without_remat():
    """Remat (and the drop-path masks it replays) changes no gradient."""
    grads = []
    for remat in (False, True):
        model = create_model("hybrid_vit_small_test", img_size=IMG, remat=remat,
                             drop_path_rate=0.3, init_scale=1.0, device="cpu")
        init_weights(model, torch.Generator().manual_seed(0))
        model.train()
        x = torch.randn(4, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
        model(x, torch.Generator().manual_seed(2)).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=1e-6, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


def test_octic_kernel_choice_follows_train_mode(monkeypatch):
    """Train mode runs the DeiT III flags' octic ops, also under no_grad; eval
    mode runs the fused ops of the bench flags (each differentiable too:
    tests/test_torch_port_cuda.py)."""
    from octic_vits_tpu_torch.layers import d8_layers

    calls = []
    for name in ("octic_attention", "octic_attention_fused_qkv", "linear_d8_fused",
                 "mlp_d8_fused"):
        fn = getattr(d8_layers, name)
        monkeypatch.setattr(d8_layers, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    model = create_model("hybrid_vit_small_test", img_size=IMG, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.train()(x)
    assert set(calls) == {"octic_attention", "linear_d8_fused"}
    calls.clear()
    with torch.no_grad():
        model.eval()(x)
    assert set(calls) == {"octic_attention_fused_qkv", "mlp_d8_fused"}


def test_eval_step_matches_jax(small_train_setup):
    models, images, labels = small_train_setup
    jmodel, params = models[True]
    jeval = jengine.make_eval_step(jmodel)(params, jnp.asarray(images), jnp.asarray(labels))
    tmodel = create_model("hybrid_vit_small_test", img_size=IMG, device="cpu")
    sd = params_from_jax({"params": params}, tmodel)
    ours = engine.make_eval_step(tmodel)(_t(images), _t(labels).long(), params=sd)
    for k in ("top1", "top5", "n"):
        assert int(ours[k]) == int(jeval[k]), k
    _close(ours["loss_sum"], jeval["loss_sum"])
