"""Parity of the port's packed trunk carry and invariant-early models with the
JAX package on the CPU, in f32: the packers, the flat D8 LayerNorm (forward
and its analytic VJP), the fused qkv + attention and the fused MLP on the
packed container (kernel rows 10 and 11) and the fused MLP's new backward
(row 4), each forward and VJP against its JAX function (the Pallas kernels in
interpret mode, as the JAX package's own tests run them); the power-spectrum
invariant; ``params_from_jax`` with ``invariant_proj``; BlockD8 on the packed
container, with the packed ops and unpacked; and the small invariant-early
model of tests/test_models_kernels.py: logits flat-E and packed, gradients
under remat against the scanned JAX packed model, and one DeiT III step with
the packed carry. Inputs come from seeded numpy generators and go to both
sides. Tolerance 1e-5 unless a test says otherwise: f32 on both sides, sums
in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.d8 import group as jgroup
from octic_vits_tpu.layers import d8_layers as jd8
from octic_vits_tpu.layers.invariants import PowerSpectrumInvariant as JPowerSpectrum
from octic_vits_tpu.models import OcticVisionTransformer as JOctic
from octic_vits_tpu.ops.pallas_attention import (
    octic_attention_fused_qkv_packed as j_attn_packed,
)
from octic_vits_tpu.ops.pallas_linear import (
    mlp_d8_fused as j_mlp_fused,
    mlp_d8_fused_packed as j_mlp_packed,
)
from octic_vits_tpu.train.common import create_train_state as j_create_state
from octic_vits_tpu.train.deit import engine as jengine
from octic_vits_tpu_torch import create_model, ops
from octic_vits_tpu_torch.d8 import group as tgroup
from octic_vits_tpu_torch.layers import d8_layers as td8
from octic_vits_tpu_torch.layers.invariants import PowerSpectrumInvariant, make_invariant
from octic_vits_tpu_torch.models import OcticDinoVisionTransformer, OcticVisionTransformer
from octic_vits_tpu_torch.train import common
from octic_vits_tpu_torch.train.deit import engine
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = RTOL = 1e-5


def _n(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol, err_msg=msg)


def _vjp_both(jfn, jargs, tfn, targs, gs, tgs=None):
    """Forward and VJP of the JAX function and the port's on the same list
    of input arrays (None for an absent bias), with the cotangents `gs` (on
    the port's side `tgs` where its outputs are laid out otherwise); returns
    (JAX out, JAX grads, port out, port grads) of the present inputs."""
    present = [i for i, a in enumerate(jargs) if a is not None]

    def jf(*xs):
        full = list(jargs)
        for i, x in zip(present, xs):
            full[i] = x
        return jfn(*full)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(jargs[i]) for i in present))
    jgrads = vjp(jax.tree_util.tree_map(jnp.asarray, gs))
    leaves = [None if a is None else _t(a, grad=True) for a in targs]
    tout = tfn(*leaves)
    tgs = jax.tree_util.tree_leaves(gs) if tgs is None else tgs
    torch.autograd.backward(tout, [_t(g) for g in tgs])
    tgrads = [leaves[i].grad for i in present]
    return jout, list(jgrads), tout, tgrads


# ---- the packers and the flat LayerNorm -----------------------------------------


def test_packers_match_jax():
    rng = np.random.default_rng(0)
    c8 = 4
    xs5 = [_n(rng, 2, 3, c8) for _ in range(4)] + [_n(rng, 2, 3, 2, 2 * c8)]
    flat = np.asarray(jgroup.pack_5_to_flat(tuple(map(jnp.asarray, xs5))))
    ours = tgroup.pack_5_to_flat(tuple(map(_t, xs5)))
    _close(ours, flat, atol=0, rtol=0)
    # the flat-E 5-tuple packs to the same container
    xs5f = xs5[:4] + [xs5[4].reshape(2, 3, 4 * c8)]
    _close(tgroup.pack_5_to_flat(tuple(map(_t, xs5f))), flat, atol=0, rtol=0)
    for a, b in zip(tgroup.unpack_flat_to_5(_t(flat)), jgroup.unpack_flat_to_5(jnp.asarray(flat))):
        _close(a, b, atol=0, rtol=0)
    for a, b in zip(tgroup.unpack_packed_5f(_t(flat)), jd8.unpack_packed_5f(jnp.asarray(flat))):
        _close(a, b, atol=0, rtol=0)
    _close(tgroup.flat_to_break(_t(flat)), jgroup.flat_to_break(jnp.asarray(flat)), atol=0, rtol=0)
    # the views are free: they share the container's storage
    x = _t(flat)
    assert all(v.data_ptr() == x[..., 0].data_ptr() + 4 * g * c8
               for g, v in enumerate(tgroup.unpack_packed_5f(x)))


@pytest.mark.parametrize("lead,c8", [((2, 11), 8), ((3, 7), 4)])
def test_flat_ln_matches_jax(lead, c8):
    """layer_norm_d8_stats_flat and its analytic VJP (OCTIC_FLAT_LN_VJP, on
    by default in the JAX package) on a container with nonzero slot means."""
    assert jd8.OCTIC_FLAT_LN_VJP
    rng = np.random.default_rng(1)
    x = _n(rng, *lead, 8 * c8, shift=0.7)
    g = _n(rng, *lead, 8 * c8)
    jout, vjp = jax.vjp(lambda t: jd8.layer_norm_d8_stats_flat(t), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = _t(x, grad=True)
    out = td8.layer_norm_d8_stats_flat(tx)
    out.backward(_t(g))
    _close(out, jout, msg="out")
    _close(tx.grad, jdx, msg="dx")
    # the same statistics as the flat-E tuple's LayerNorm
    tup = td8.layer_norm_d8_stats(tgroup.unpack_packed_5f(_t(x)))
    _close(tgroup.pack_5_to_flat(tup), jout, msg="tuple")


# ---- rows 10, 11 and row 4's backward ---------------------------------------------

# (b, n, c, heads, bias): ragged token counts, and three heads of d1 = 8
ATTN_CASES = [(2, 11, 64, 2, True), (1, 13, 192, 3, False)]


@pytest.mark.parametrize("b,n,c,heads,bias", ATTN_CASES)
def test_octic_attention_fused_qkv_packed_matches_jax(b, n, c, heads, bias):
    rng = np.random.default_rng(2)
    c8 = c // 8
    args = [_n(rng, b, n, c), _n(rng, 4, c8, 3 * c8, scale=c8 ** -0.5),
            _n(rng, 2 * c8, 6 * c8, scale=(2 * c8) ** -0.5),
            _n(rng, 3 * c8, scale=0.1) if bias else None]
    gs = tuple(_n(rng, b, n, c8) for _ in range(4)) + tuple(_n(rng, b, n, 2 * c8)
                                                            for _ in range(2))
    jout, jgrads, tout, tgrads = _vjp_both(
        lambda x, w1, we, bq: j_attn_packed(x, w1, we, bq, heads, True), args,
        lambda x, w1, we, bq: ops.octic_attention_fused_qkv_packed(x, w1, we, bq, heads), args,
        gs)
    for i in range(6):
        _close(tout[i], jout[i], msg=f"out {i}")
    for i, (o, r) in enumerate(zip(tgrads, jgrads)):
        _close(o, r, atol=1e-4, msg=f"grad {i}")  # weight gradients sum over B*N tokens
    # the plain backward alone, as the card's chain is held against it
    dx, dw1, dwe, db = ops.octic_attention_fused_qkv_packed_bwd(
        *(None if a is None else _t(a) for a in args), tuple(map(_t, gs)), heads)
    _close(dx, jgrads[0], msg="bwd dx")
    assert (db is None) == (not bias)


def _mlp_args(rng, m, c8, bias):
    h8 = 2 * c8
    return [_n(rng, 4, c8, h8, scale=c8 ** -0.5), _n(rng, 2 * c8, 2 * h8, scale=(2 * c8) ** -0.5),
            _n(rng, h8, scale=0.1) if bias else None, _n(rng, 4, h8, c8, scale=h8 ** -0.5),
            _n(rng, 2 * h8, 2 * c8, scale=(2 * h8) ** -0.5), _n(rng, c8, scale=0.1) if bias else None]


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_d8_fused_packed_matches_jax(bias):
    rng = np.random.default_rng(3)
    m, c8 = 21, 8
    args = [_n(rng, m, 8 * c8)] + _mlp_args(rng, m, c8, bias)
    g = _n(rng, m, 8 * c8)
    jout, jgrads, tout, tgrads = _vjp_both(
        lambda *a: j_mlp_packed(*a, True), args, ops.mlp_d8_fused_packed, args, g)
    _close(tout, jout, msg="out")
    for i, (o, r) in enumerate(zip(tgrads, jgrads)):
        _close(o, r, atol=1e-4, msg=f"grad {i}")
    # the wrapper takes any leading dims
    x3 = _t(args[0]).reshape(3, 7, 8 * c8)
    y3 = ops.mlp_d8_packed(x3, *(None if a is None else _t(a) for a in args[1:]))
    _close(y3.reshape(m, -1), jout)


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_d8_fused_vjp_matches_jax(bias):
    """Row 4's new backward: the flat-E tuple op against the JAX custom VJP
    (_mlp_bwd_rule), inputs [4, M, c] + [M, 4c] on the JAX side."""
    rng = np.random.default_rng(4)
    m, c8 = 19, 8
    x1, xef = _n(rng, 4, m, c8), _n(rng, m, 4 * c8)
    params = _mlp_args(rng, m, c8, bias)
    g1, gef = _n(rng, 4, m, c8), _n(rng, m, 4 * c8)
    jout, jgrads, tout, tgrads = _vjp_both(
        lambda a, e, *p: j_mlp_fused(a, e, *p, True), [x1, xef] + params,
        lambda a, e, *p: ops.mlp_d8_fused(tuple(a) + (e,), *p), [x1, xef] + params, (g1, gef),
        tgs=list(g1) + [gef])
    for i in range(4):
        _close(tout[i], jout[0][i], msg=f"out {i}")
    _close(tout[4], jout[1], msg="out e")
    for i, (o, r) in enumerate(zip(tgrads, jgrads)):
        _close(o, r, atol=1e-4, msg=f"grad {i}")


# ---- the invariant and the conversion ----------------------------------------------


def test_power_spectrum_invariant_matches_jax():
    rng = np.random.default_rng(5)
    c8 = 4
    xs = [_n(rng, 2, 5, c8) for _ in range(4)] + [_n(rng, 2, 5, 2, 2 * c8)]
    g = _n(rng, 2, 5, 6 * c8)
    jinv = JPowerSpectrum(dim=8 * c8)
    jout, jgrads, tout, tgrads = _vjp_both(
        lambda *t: jinv.apply({}, t), xs, lambda *t: PowerSpectrumInvariant(8 * c8)(t), xs, g)
    _close(tout, jout)
    for i, (o, r) in enumerate(zip(tgrads, jgrads)):
        _close(o, r, msg=f"grad {i}")
    assert make_invariant("power_spectrum", 64).output_dim == 48
    assert make_invariant("polynomial", 64).output_dim == 256  # every kind is ported
    with pytest.raises(ValueError, match="invariant_kind"):
        make_invariant("no_such_kind", 64)


# the sizes of tests/test_models_kernels.py (KW): the invariant-early model
KW = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2.0,
          qkv_bias=True, invariant=True, num_classes=10, init_scale=1.0)
JAX_KERNELS = dict(use_pallas_attention=True, use_pallas_linear=True, use_pallas_std_mlp=True,
                   fuse_mlp=True, fuse_qkv=True)


def _images(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3)).astype(np.float32)


def _random_params(jmodule, seed, *args):
    """Seeded parameters in the flax tree of `jmodule` (its shapes from
    ``jax.eval_shape``, so no interpret-mode init): norm and LayerScale
    scales near 1, every other leaf small, none at a trivial value."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        base = 1.0 if ("alpha" in name or name.endswith("scale")) else 0.0
        return (base + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _perturbed_params(jmodel, seed):
    return _random_params(jmodel, seed, jnp.zeros((1, 32, 32, 3)))


@pytest.mark.parametrize("scanned", [False, True])
def test_params_from_jax_maps_invariant_proj(scanned):
    jmodel = JOctic(**KW, scan_blocks=scanned)
    params = _perturbed_params(jmodel, 6)
    tmodel = OcticVisionTransformer(**KW, device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    _close(tmodel.invariant_proj.weight, params["invariant_proj"]["kernel"].T, atol=0, rtol=0)
    _close(tmodel.invariant_proj.bias, params["invariant_proj"]["bias"], atol=0, rtol=0)


# ---- BlockD8 on the packed container --------------------------------------------------

C, HEADS = 64, 2


@pytest.mark.parametrize("fused", [True, False])
def test_packed_block_matches_jax(fused):
    """One train-mode BlockD8 on the packed container, forward and VJP,
    against the JAX packed block: with fuse_qkv and fuse_mlp the packed ops
    run (row 10, row 11); without them the block unpacks to the flat-E views
    and runs octic_attention and two linear_d8_fused, as the JAX layers do
    (d8_layers.py:632-634, :906-908)."""
    rng = np.random.default_rng(7)
    x = _n(rng, 2, 9, C, shift=0.3)
    jflags = dict(use_pallas_attention=True, use_pallas_linear=True, fuse_qkv=fused,
                  fuse_mlp=fused)
    jblk = jd8.BlockD8(num_heads=HEADS, mlp_ratio=2.0, qkv_bias=True, layerscale_init=1.0,
                       **jflags)
    params = _random_params(jblk, 8, jnp.asarray(x))
    tblk = td8.BlockD8(C, HEADS, mlp_ratio=2.0, qkv_bias=True, layerscale_init=1.0,
                       fuse_qkv=fused, fuse_mlp=fused)
    tblk.load_state_dict(params_from_jax({"params": params}, tblk), strict=True)
    tblk.train()
    g = _n(rng, 2, 9, C)
    jout, vjp = jax.vjp(lambda p, t: jblk.apply({"params": p}, t, deterministic=False),
                        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    ops.reset_launch_counts()
    tx = _t(x, grad=True)
    out = tblk(tx)
    out.backward(_t(g))
    assert isinstance(out, torch.Tensor) and out.shape == x.shape
    _close(out, jout, msg="out")
    _close(tx.grad, jgx, atol=1e-4, msg="dx")
    theirs = params_from_jax({"params": jax.device_get(jgp)}, tblk)
    for name, p in tblk.named_parameters():
        _close(p.grad, theirs[name], atol=1e-4, msg=name)




# ---- the small invariant-early model ---------------------------------------------------


@pytest.fixture(scope="module")
def inv_early_params():
    return _perturbed_params(JOctic(**KW), 9)


@pytest.fixture(scope="module")
def inv_early_logits(inv_early_params):
    """Images and the JAX logits of the plain model and of the packed-kernel
    model on them."""
    img = jnp.asarray(_images())
    variables = {"params": inv_early_params}
    return (np.asarray(img), np.asarray(JOctic(**KW).apply(variables, img)),
            np.asarray(JOctic(**KW, **JAX_KERNELS, packed_carry=True).apply(variables, img)))


@pytest.mark.parametrize("carry", ["flat_e", "packed"])
def test_small_inv_early_logits_match_jax(inv_early_params, inv_early_logits, carry):
    """Eval-mode logits of the port, flat-E and packed, against the JAX
    packed-kernel model and the plain model (the bar of
    tests/test_models_kernels.py)."""
    params, (img, ref, jpacked) = inv_early_params, inv_early_logits
    tmodel = OcticVisionTransformer(**KW, packed_carry=carry == "packed", device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    with torch.no_grad():
        ours = tmodel.eval()(_t(img)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    np.testing.assert_allclose(ours, jpacked, atol=1e-4)


def test_small_inv_early_grads_match_jax_under_remat():
    """Loss sum(logits^2) and every gradient of the packed model with
    fuse_qkv, fuse_mlp and remat (train mode, drop path 0) against the
    scanned JAX packed model under remat, from the same tree
    (tests/test_models_kernels.py:73-105; the same bars)."""
    img = _images(1)
    jplain = JOctic(**KW, scan_blocks=True)
    jpacked = JOctic(**KW, scan_blocks=True, remat=True, packed_carry=True, **JAX_KERNELS)
    params = _perturbed_params(jplain, 10)
    jval, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(jpacked.apply({"params": v}, jnp.asarray(img)) ** 2))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tmodel = OcticVisionTransformer(**KW, packed_carry=True, fuse_qkv=True, fuse_mlp=True,
                                    remat=True, device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    tmodel.train()
    ops.reset_launch_counts()
    loss = tmodel(_t(img)).square().sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-4)
    theirs = params_from_jax({"params": jax.device_get(jgrad)}, tmodel)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), theirs[name].numpy(), atol=5e-3, rtol=1e-3,
                                   err_msg=name)


def test_small_inv_early_deit_step_packed_matches_jax(inv_early_params):
    """One DeiT III step of the small invariant-early model with the packed
    carry (fuse_qkv, fuse_mlp, remat) against the unscanned JAX packed-kernel
    model and the package's own optimizer, from shared parameters: loss,
    gradient norm and every updated parameter."""
    params = inv_early_params
    rng = np.random.default_rng(11)
    images = _n(rng, 4, 32, 32, 3)
    labels = rng.integers(0, 10, size=4).astype(np.int32)
    cfg = dict(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0,
               warmup_epochs=0, epochs=10, steps_per_epoch=10, lr=1e-3)
    jmodel = JOctic(**KW, **JAX_KERNELS, packed_carry=True)
    jcfg = jengine.DeiTConfig(**cfg)
    tx = jengine.build_optimizer(jcfg, params)
    jstate = j_create_state(jax.tree_util.tree_map(jnp.asarray, params), tx, ema=True)
    jstep = jax.jit(jengine.make_deit_train_step(jmodel, jcfg, tx))
    jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                             jax.random.PRNGKey(0))

    tmodel = OcticVisionTransformer(**KW, packed_carry=True, fuse_qkv=True, fuse_mlp=True,
                                    remat=True, device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    tcfg = engine.DeiTConfig(**cfg)
    opt = engine.build_optimizer(tcfg, tmodel)
    state = common.create_train_state(tmodel, opt, ema=True)
    step = engine.make_deit_train_step(tmodel, tcfg, opt)
    state, metrics = step(state, _t(images), _t(labels).long(), torch.Generator().manual_seed(0))
    _close(metrics["loss"], jmetrics["loss"], msg="loss")
    _close(metrics["grad_norm"], jmetrics["grad_norm"], atol=1e-4, msg="grad norm")
    new = params_from_jax({"params": jax.device_get(jstate.params)}, tmodel)
    for name, p in tmodel.named_parameters():
        _close(p, new[name], msg=name)


def test_packed_carry_options():
    """The registry names build the invariant-early models; the DINOv2
    backbone takes both options; drop path in the packed trunk draws one
    mask per sample (the tuple path's draws)."""
    model = create_model("d8_inv_early_deit_huge_patch14", packed_carry=True, device="meta")
    assert model.invariant_proj.weight.shape == (1280, 960) and model.packed_carry
    assert len(model.blocks) == 32 and model.break_layer == 16
    assert create_model("d8_inv_early_deit_large_patch16",
                        device="meta").invariant_proj.weight.shape == (1024, 768)
    dino = OcticDinoVisionTransformer(img_size=32, patch_size=8, embed_dim=32, depth=2,
                                      num_heads=2, device="cpu", invariant=True,
                                      packed_carry=True)
    assert dino.invariant_proj.weight.shape == (32, 24) and dino.packed_carry
    kw = dict(KW, drop_path_rate=0.4)
    outs = []
    for packed in (False, True):
        m = OcticVisionTransformer(**kw, packed_carry=packed, device="cpu")
        m.load_state_dict(params_from_jax({"params": _perturbed_params(JOctic(**KW), 12)}, m))
        with torch.no_grad():
            outs.append(m.train()(_t(_images(2, b=4)), torch.Generator().manual_seed(3)))
    _close(outs[1], outs[0], atol=1e-5)
