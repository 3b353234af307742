"""Parity of the port's model options and newer layers with the JAX package
on the CPU, in f32 (tolerance 1e-5): the break layer, ``global_pool``,
registers (and JAX's global-pool-with-registers quirk), the SwiGLU FFN, the
hMLP stem, the parallel block, dropout rates in eval mode, ``num_classes=0``
and ``init_scale=None``; dropout in training by its properties (JAX's random
stream cannot be reproduced): independent masks per tuple element, the keep
share and the 1/(1-p) scale, masks drawn before the forward so that remat
replays them, the eager attention equal to the kernel path's plain version
at p = 0; the lr / weight-decay rules on register tokens and cls-less
models; and every name of JAX's registry built in the port on the meta
device with JAX's parameter count. Parameters come from seeded numpy draws
in the flax tree (``params_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.layers import vit_layers as jvl
from octic_vits_tpu.models import DinoVisionTransformer as JDino
from octic_vits_tpu.models import OcticDinoVisionTransformer as JOcticDino
from octic_vits_tpu.models import OcticVisionTransformer as JOctic
from octic_vits_tpu.models import VisionTransformer as JViT
from octic_vits_tpu.train.deit import engine as jengine
from octic_vits_tpu.train.dinov2.param_groups import build_multiplier_trees as j_multipliers
from octic_vits_tpu_torch import init_weights, ops
from octic_vits_tpu_torch.layers import d8_layers as td8
from octic_vits_tpu_torch.layers import vit_layers as tvl
from octic_vits_tpu_torch.layers.common import dropout_mask
from octic_vits_tpu_torch.models import (
    DinoVisionTransformer,
    OcticDinoVisionTransformer,
    OcticVisionTransformer,
    VisionTransformer,
)
from octic_vits_tpu_torch.train.deit.engine import no_weight_decay_mask
from octic_vits_tpu_torch.train.dinov2.param_groups import build_multiplier_trees
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = RTOL = 1e-5

# tests/test_models.py's octic model, LayerScale 1.0 so no block hides
OCTIC = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2.0,
             qkv_bias=True, num_classes=10, init_scale=1.0)
DINO = dict(img_size=32, patch_size=8, embed_dim=32, depth=4, num_heads=2, mlp_ratio=2.0)


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol, err_msg=msg)


def _images(seed=0, b=2, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _random_params(jmodule, seed, *args):
    """Seeded parameters in the flax tree of `jmodule` (shapes from
    ``jax.eval_shape``): norm, LayerScale and gamma scales near 1, every
    other leaf small, none at a trivial value."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        near_one = "alpha" in name or "gamma" in name or name.endswith("scale")
        return ((1.0 if near_one else 0.0) + 0.1 * rng.standard_normal(sd.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _loaded(tmodel, params):
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    return tmodel.eval()


def _model_pair(jmodel, tmodel, seed, img):
    params = _random_params(jmodel, seed, jnp.asarray(img))
    return params, _loaded(tmodel, params)


# ---- the octic and standard model options ------------------------------------------------

OCTIC_CASES = {
    "break0": dict(octic_equi_break_layer=0),
    "break1": dict(octic_equi_break_layer=1),
    "break3": dict(octic_equi_break_layer=3),
    "break1_invariant": dict(octic_equi_break_layer=1, invariant=True),
    "global_pool": dict(global_pool=True),
    "registers": dict(num_register_tokens=3),
    "global_pool_registers": dict(global_pool=True, num_register_tokens=3),
    "dropout_rates_eval": dict(drop_rate=0.3, attn_drop_rate=0.2),
    "no_head": dict(num_classes=0),
}


@pytest.mark.parametrize("case", sorted(OCTIC_CASES))
def test_octic_options_match_jax(case):
    opts = {**OCTIC, **OCTIC_CASES[case]}
    img = _images(1)
    jmodel = JOctic(**opts)
    params = _random_params(jmodel, 2, jnp.asarray(img))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    for packed in (False, True):
        tmodel = _loaded(OcticVisionTransformer(**opts, packed_carry=packed, device="cpu"),
                         params)
        with torch.no_grad():
            ours = tmodel(torch.from_numpy(img))
        assert tuple(ours.shape) == ref.shape
        _close(ours, ref, msg=f"packed={packed}")
    if opts.get("octic_equi_break_layer") is not None:
        assert tmodel.break_layer == jmodel.break_layer == opts["octic_equi_break_layer"]


def test_break_layer_bounds():
    with pytest.raises(ValueError, match="octic_equi_break_layer"):
        OcticVisionTransformer(**OCTIC, octic_equi_break_layer=4, device="meta")
    with pytest.raises(ValueError, match="depth must be even"):
        OcticVisionTransformer(**dict(OCTIC, depth=3), device="meta")
    # an odd depth with the break given builds, as in JAX
    assert OcticVisionTransformer(**dict(OCTIC, depth=3), octic_equi_break_layer=2,
                                  device="meta").break_layer == 2


def test_global_pool_registers_follow_the_first_patch_token():
    """JAX's quirk, copied: with global_pool there is no cls token, and the
    registers are still inserted after token 0, which is then the first
    patch token (octic_vit.py:245). Also a model without a cls token has no
    cls parameter."""
    model = OcticVisionTransformer(**OCTIC, global_pool=True, num_register_tokens=3,
                                   device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    assert model.cls_token_a1 is None
    patches = tuple(torch.randn(2, 16, s, generator=torch.Generator().manual_seed(i))
                    for i, s in enumerate((8, 8, 8, 8, 32)))
    xs = model._cat_cls_and_registers(patches, 2)
    assert xs[0].shape[1] == 19
    assert torch.equal(xs[0][:, 0], patches[0][:, 0])
    assert torch.equal(xs[0][:, 1:4], model.register_tokens_a1.expand(2, -1, -1))
    assert torch.equal(xs[0][:, 4:], patches[0][:, 1:])
    for x in xs[1:]:
        assert not x[:, 1:4].any()


VIT_CASES = {
    "global_pool": dict(global_pool=True),
    "no_head": dict(num_classes=0),
    "no_layerscale": dict(init_scale=None),
    "dropout_rates_eval": dict(drop_rate=0.3, attn_drop_rate=0.2),
}


@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_vit_options_match_jax(case):
    opts = dict(dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
                     mlp_ratio=2.0, qkv_bias=True, num_classes=10, init_scale=1.0,
                     norm_eps=1e-6), **VIT_CASES[case])
    img = _images(3)
    jmodel = JViT(**opts)
    params, tmodel = _model_pair(jmodel, VisionTransformer(**opts, device="cpu"), 4, img)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    with torch.no_grad():
        _close(tmodel(torch.from_numpy(img)), ref)
    if case == "no_layerscale":
        assert all(b.gamma_1 is None for b in tmodel.blocks)


def _token_dict_and_layers(jmodel, tmodel, params, img, n):
    jvars = {"params": params}
    theirs = jmodel.apply(jvars, jnp.asarray(img), method=jmodel.forward_features)
    jlayers = jmodel.apply(jvars, jnp.asarray(img), n, True, True,
                           method=jmodel.get_intermediate_layers)
    with torch.no_grad():
        ours = tmodel.forward_features(torch.from_numpy(img))
        layers = tmodel.get_intermediate_layers(torch.from_numpy(img), n, True, True)
    for k in ("x_norm_clstoken", "x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
        assert tuple(ours[k].shape) == tuple(theirs[k].shape), k
        _close(ours[k], theirs[k], msg=k)
    assert len(layers) == len(jlayers)
    for (o, c), (jo, jc) in zip(layers, jlayers):
        assert tuple(o.shape) == tuple(jo.shape)
        _close(o, jo, msg="patch tokens")
        _close(c, jc, msg="cls token")
    return ours


@pytest.mark.parametrize("ffn_layer,registers", [("mlp", 4), ("swiglu", 0), ("swiglu", 4)])
def test_standard_dinov2_registers_swiglu_match_jax(ffn_layer, registers):
    opts = dict(DINO, num_register_tokens=registers, ffn_layer=ffn_layer)
    img = _images(5)
    jmodel = JDino(**opts)
    params, tmodel = _model_pair(jmodel, DinoVisionTransformer(**opts, device="cpu"), 6, img)
    ours = _token_dict_and_layers(jmodel, tmodel, params, img, 2)
    assert ours["x_norm_regtokens"].shape[1] == registers


@pytest.mark.parametrize("invariant", [False, True], ids=["hybrid", "inv_early"])
def test_octic_dinov2_registers_match_jax(invariant):
    opts = dict(DINO, num_register_tokens=2, init_scale=1.0, invariant=invariant)
    img = _images(7)
    jmodel = JOcticDino(**opts)
    params, _ = _model_pair(jmodel, OcticDinoVisionTransformer(**opts, device="cpu"), 8, img)
    for packed in (False, True):
        tmodel = _loaded(OcticDinoVisionTransformer(**opts, packed_carry=packed, device="cpu"),
                         params)
        ours = _token_dict_and_layers(jmodel, tmodel, params, img, 2)
        assert ours["x_norm_regtokens"].shape[1] == 2


# ---- the newer standard layers ------------------------------------------------------------


def _layer_vjp(jmod, tmod, x, seed, **jkw):
    """Forward and VJP of the flax layer (deterministic) and the port's (eval
    mode) from the same parameters: output, input and parameter gradients."""
    params = _random_params(jmod, seed, jnp.asarray(x))
    jout, vjp = jax.vjp(lambda p, a: jmod.apply({"params": p}, a, **jkw),
                        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    g = np.random.default_rng(seed + 1).standard_normal(jout.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(g))
    tmod = _loaded(tmod, params)
    tx = torch.from_numpy(x).requires_grad_()
    out = tmod(tx)
    out.backward(torch.from_numpy(g))
    _close(out, jout, msg="output")
    _close(tx.grad, jgx, msg="input grad")
    theirs = params_from_jax({"params": jax.device_get(jgp)}, tmod)
    for name, p in tmod.named_parameters():
        _close(p.grad, theirs[name], msg=name)


def test_swiglu_ffn_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 5, 48)).astype(np.float32)
    tmod = tvl.SwiGLUFFN(48, 4 * 48)
    assert tmod.w3.in_features == (int(192 * 2 / 3) + 7) // 8 * 8 == 128
    _layer_vjp(jvl.SwiGLUFFN(hidden_features=192), tmod, x, 10)


def test_hmlp_stem_matches_jax():
    x = _images(11, size=32)
    _layer_vjp(jvl.HMLPStem(embed_dim=64), tvl.HMLPStem(64), x, 12)


@pytest.mark.parametrize("drop", [0.0, 0.2], ids=["no_dropout", "dropout_eval"])
def test_parallel_block_matches_jax(drop):
    x = np.random.default_rng(13).standard_normal((2, 7, 64)).astype(np.float32)
    kw = dict(mlp_ratio=2.0, qkv_bias=True, drop=drop, attn_drop=drop, layerscale_init=0.5)
    _layer_vjp(jvl.ParallelBlockx2(num_heads=2, **kw), tvl.ParallelBlockx2(64, 2, **kw), x, 14)


# ---- dropout in training, by its properties --------------------------------------------------


def test_dropout_d8_masks_are_independent_and_scaled():
    """Each tuple element has its own mask; a kept element is x / (1 - p),
    a dropped one 0; the keep share is 1 - p (within 5 standard errors)."""
    p, shape = 0.3, (4, 50, 100)
    drop = td8.DropoutD8(p).train()
    masks = drop.draw((shape,) * 4 + ((4, 50, 400),), torch.Generator().manual_seed(0))
    xs = tuple(torch.full(m.shape, 2.0) for m in masks)
    ys = drop(xs, masks)
    kept = [y != 0 for y in ys]
    for y, k in zip(ys, kept):
        assert torch.equal(y[k], torch.full_like(y[k], 2.0 / (1 - p)))
        share = k.float().mean().item()
        assert abs(share - (1 - p)) < 5 * (p * (1 - p) / k.numel()) ** 0.5
    assert not any(torch.equal(kept[0], kept[i]) for i in range(1, 4))
    assert drop.eval()(xs, None) is xs  # eval: the identity, no mask needed
    with pytest.raises(ValueError, match="masks"):
        drop.train()(xs, None)


@pytest.mark.parametrize("packed", [False, True], ids=["flat_e", "packed"])
def test_model_dropout_masks_replay_under_remat(packed):
    """In training, the masks come from the forward's generator, drawn before
    the trunk: the same seed gives the same logits and gradients with and
    without remat, another seed other logits; eval mode ignores the rates."""
    opts = dict(OCTIC, drop_rate=0.2, attn_drop_rate=0.2, drop_path_rate=0.1,
                packed_carry=packed, fuse_qkv=packed, fuse_mlp=packed)
    img = torch.from_numpy(_images(15))
    runs = []
    for remat, seed in ((False, 1), (True, 1), (False, 2)):
        model = OcticVisionTransformer(**opts, remat=remat, device="cpu")
        init_weights(model, torch.Generator().manual_seed(0))
        out = model.train()(img, torch.Generator().manual_seed(seed))
        out.square().sum().backward()
        runs.append((out.detach(), [q.grad for q in model.parameters()]))
    _close(runs[1][0], runs[0][0].numpy(), atol=1e-6, rtol=1e-6)
    for a, b in zip(runs[1][1], runs[0][1]):
        _close(a, b.numpy(), atol=1e-6, rtol=1e-5)
    assert (runs[2][0] - runs[0][0]).abs().max() > 1e-3
    with torch.no_grad():
        ev = model.eval()(img)
    model2 = OcticVisionTransformer(**dict(opts, drop_rate=0.0, attn_drop_rate=0.0,
                                           drop_path_rate=0.0), device="cpu")
    model2.load_state_dict(model.state_dict())
    with torch.no_grad():
        _close(ev, model2.eval()(img).numpy(), atol=0, rtol=0)


def test_chip_smoke_set_drop_path_leaves_dropout_alone():
    """chip_smoke.py's set_drop_path changes the drop-path rates only: the
    dropout modules, which also have a rate, stay off (at 0.45 they would turn
    the DeiT timing steps' attention into the eager dropout path)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root,
                                                                             "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    model = OcticVisionTransformer(**OCTIC, device="meta")
    chip_smoke.set_drop_path(model, 0.45)
    rates = {type(m).__name__: m.rate for m in model.modules() if hasattr(m, "rate")}
    assert rates["DropPathD8"] == rates["DropPath"] == 0.45
    assert rates["Dropout"] == rates["DropoutD8"] == 0.0


def test_eager_attention_equals_the_kernel_paths_plain_version():
    """At p = 0 the eager attention (the dropout path) equals the kernels'
    plain versions, octic and standard; it is selected exactly in training
    with attn_drop > 0."""
    rng = np.random.default_rng(16)
    c8, heads, b, n = 8, 2, 2, 9
    qs = [torch.from_numpy(rng.standard_normal((b, n, 3 * c8)).astype(np.float32))
          for _ in range(4)]
    qs += [torch.from_numpy(rng.standard_normal((b, n, 6 * c8)).astype(np.float32))
           for _ in range(2)]
    for a, r in zip(td8.octic_attention_eager(*qs, heads), ops.octic_attention(*qs, heads)):
        _close(a, r.numpy())
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * 64)).astype(np.float32))
    _close(tvl.attention_eager(qkv, heads), ops.standard_attention(qkv, heads).numpy())
    attn = td8.AttentionD8(64, heads, attn_drop=0.1)
    assert attn.train().eager() and not attn.eval().eager()
    assert not td8.AttentionD8(64, heads).train().eager()
    u = dropout_mask((b, heads, n, n), torch.Generator().manual_seed(0))
    dropped = tvl.attention_eager(qkv, heads, u, 0.5)
    assert (dropped - tvl.attention_eager(qkv, heads)).abs().max() > 1e-3


# ---- the optimiser rules on the new parameters ---------------------------------------------


@pytest.mark.parametrize("opts", [dict(num_register_tokens=2), dict(global_pool=True)],
                         ids=["registers", "global_pool"])
def test_param_rules_match_jax(opts):
    """The DINOv2 lr / weight-decay multipliers and the DeiT no-decay mask on
    a model with register tokens and on one without a cls token, against
    JAX's rules on the same (unscanned) parameter tree."""
    jmodel = JOctic(**OCTIC, **opts)
    params = _random_params(jmodel, 17, jnp.zeros((1, 32, 32, 3)))
    tmodel = OcticVisionTransformer(**OCTIC, **opts, device="cpu")
    names = [n for n, _ in tmodel.named_parameters()]
    ours = build_multiplier_trees(names, 4, 0.9, 0.2)
    theirs = [params_from_jax({"params": jax.tree_util.tree_map(
        lambda v, p: np.full(np.shape(p), v, np.float32), tree, params)}, tmodel)
        for tree in j_multipliers(params, 4, 0.9, 0.2)]
    for o, t in zip(ours, theirs):
        for n in names:
            assert o[n] == pytest.approx(float(t[n].reshape(-1)[0]), rel=1e-6), n
    jmask = params_from_jax({"params": jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), jengine.no_weight_decay_mask(params),
        params)}, tmodel)
    mask = no_weight_decay_mask(tmodel)
    for n in names:
        assert mask[n] == bool(jmask[n].reshape(-1)[0]), n
    if "num_register_tokens" in opts:
        assert mask["register_tokens_a1"] and ours[0]["register_tokens_a1"] == 0.9 ** 5
