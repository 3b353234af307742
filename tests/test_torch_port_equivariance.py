"""The port's D8 group actions against the JAX package's, and the
equivariance property of the port's plain layers (the checks of
tests/test_layers_equivariance.py run on octic_vits_tpu_torch): every
equivariant layer commutes with the isotypic action of all 8 group elements,
and its output is not degenerate; the patch embed and the inverse lift
commute with the image action. Inputs are seeded numpy draws; f32 on the
CPU, tolerance 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octic_vits_tpu.d8.group as J
from octic_vits_tpu.layers.d8_layers import IsotypicToPatchD8 as JIsoToPatch
from octic_vits_tpu_torch import init_weights
from octic_vits_tpu_torch.d8 import group as T
from octic_vits_tpu_torch.layers import d8_layers as td8
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = 1e-5


def _rand8(seed, shape):
    """Eight seeded slots, each with a per-token mean shift so that the
    LayerNorm's centring is exercised."""
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) + rng.standard_normal(shape[:-1] + (1,)))
                 .astype(np.float32) for _ in range(8))


def _t8(xs8):
    return tuple(torch.from_numpy(x) for x in xs8)


# ---- the group actions against JAX ------------------------------------------------


def test_tables_match_jax():
    assert T.GROUP_ELEMENTS == J.GROUP_ELEMENTS and T.IRREPS == J.IRREPS
    assert T.MULT_TABLE == J.MULT_TABLE
    assert T._ISO_SIGNED == J._ISO_SIGNED and T._REG_SIGNED == J._REG_SIGNED


@pytest.mark.parametrize("g", J.GROUP_ELEMENTS)
def test_group_actions_match_jax(g):
    xs8 = _rand8(1, (2, 16, 3))
    for ours, theirs in ((T.regular_group_action, J.regular_group_action),
                         (T.isotypic_group_action, J.isotypic_group_action),
                         (T.spatial_and_isotypic_group_action,
                          J.spatial_and_isotypic_group_action)):
        got = ours(g, _t8(xs8))
        want = theirs(g, tuple(jnp.asarray(x) for x in xs8))
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{ours.__name__} {i}")
    img = xs8[0].reshape(2, 3, 4, 4)
    np.testing.assert_array_equal(T.image_space_group_action(g, torch.from_numpy(img)).numpy(),
                                  np.asarray(J.image_space_group_action(g, jnp.asarray(img))))


def test_dense_butterflies_match_jax():
    xs8 = _rand8(2, (3, 5))
    t, j = _t8(xs8), tuple(jnp.asarray(x) for x in xs8)
    for ours, theirs, fast in ((T.isotypic_to_regular_dense, J.isotypic_to_regular_dense,
                                T.isotypic_to_regular),
                               (T.regular_to_isotypic_dense, J.regular_to_isotypic_dense,
                                T.regular_to_isotypic)):
        got = ours(t)
        for a, b, c in zip(got, theirs(j), fast(t)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=ATOL)
    # the change of basis is orthogonal: there and back is the identity
    back = T.regular_to_isotypic_dense(T.isotypic_to_regular_dense(t))
    for a, b in zip(back, t):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


# ---- equivariance of the port's plain layers --------------------------------------------


def _module(layer):
    """The port layer under test, seeded, in eval mode (its plain path on
    the CPU), and the token shape it takes."""
    c = 128
    mods = {
        "GeluD8": (td8.GeluD8(), (2, 3, 16)),
        "LinearD8": (td8.LinearD8(c, 48), (2, 3, 16)),
        "LayerNormD8": (td8.LayerNormD8(c), (2, 3, 16)),
        "ScaleD8": (td8.ScaleD8(c, 0.7, bias=True), (2, 3, 16)),
        "MlpD8": (td8.MlpD8(c, 256), (2, 3, 16)),
        "AttentionD8": (td8.AttentionD8(c, 2), (2, 5, 16)),
        "BlockD8": (td8.BlockD8(c, 2, layerscale_init=1e-1), (2, 5, 16)),
    }
    mod, shape = mods[layer]
    init_weights(mod, torch.Generator().manual_seed(3))
    if layer == "ScaleD8":  # a bias off zero, so the A1 shift is exercised
        torch.nn.init.normal_(mod.beta_a1, generator=torch.Generator().manual_seed(4))
    return mod.eval(), shape


@pytest.mark.parametrize("layer", ["GeluD8", "LinearD8", "LayerNormD8", "ScaleD8", "MlpD8",
                                   "AttentionD8", "BlockD8"])
def test_layer_is_equivariant(layer):
    """layer(g.x) == g.layer(x) on the flat-E tuple, for all 8 elements."""
    mod, shape = _module(layer)
    xs8 = _t8(_rand8(10, shape))

    def apply(xs):
        with torch.no_grad():
            return T.unpack_5f_to_8(mod(T.pack_8_to_5f(xs)))

    base = apply(xs8)
    for g in T.GROUP_ELEMENTS:
        lhs = T.isotypic_group_action(g, base)
        rhs = apply(T.isotypic_group_action(g, xs8))
        for slot, (x, y) in enumerate(zip(lhs, rhs)):
            assert x.abs().max() > 1e-6, f"degenerate slot {slot} g={g}"
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL,
                                       err_msg=f"g={g} slot={slot}")


def _nhwc_action(g, img):
    return T.image_space_group_action(g, img.movedim(-1, 1)).movedim(1, -1)


def test_patch_embed_d8_is_equivariant():
    """layer(g.img) == (spatial + isotypic g).layer(img)."""
    mod = td8.PatchEmbedD8(8, 32)
    init_weights(mod, torch.Generator().manual_seed(5))
    img = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 32, 32, 3))
                           .astype(np.float32))
    with torch.no_grad():
        base = T.unpack_5f_to_8(mod(img))
        for g in T.GROUP_ELEMENTS:
            lhs = T.spatial_and_isotypic_group_action(g, base)
            rhs = T.unpack_5f_to_8(mod(_nhwc_action(g, img)))
            for slot, (x, y) in enumerate(zip(lhs, rhs)):
                assert x.abs().max() > 1e-5
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL,
                                           err_msg=f"g={g} slot={slot}")


def test_isotypic_to_patch_d8_is_equivariant():
    """The inverse lift: img(g.xs) == g.img(xs) in image space."""
    mod = td8.IsotypicToPatchD8(32, 4, 3, reshape_to_image=True)
    init_weights(mod, torch.Generator().manual_seed(6))
    xs8 = _t8(_rand8(12, (2, 16, 4)))
    with torch.no_grad():
        base = mod(T.pack_8_to_5f(xs8))
        assert tuple(base.shape) == (2, 16, 16, 3)
        for g in T.GROUP_ELEMENTS:
            lhs = _nhwc_action(g, base)
            rhs = mod(T.pack_8_to_5f(T.spatial_and_isotypic_group_action(g, xs8)))
            assert lhs.abs().max() > 1e-5
            np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=ATOL, err_msg=f"g={g}")


@pytest.mark.parametrize("reshape", [False, True], ids=["patches", "image"])
def test_isotypic_to_patch_d8_matches_jax(reshape):
    """The inverse lift against JAX's from the same lin8 parameters, the
    input as JAX's E [..., 2, C/4] 5-tuple and as the port's flat-E tuple."""
    xs8 = _rand8(13, (2, 16, 4))
    jmod = JIsoToPatch(patch_side=4, out_channels=3, reshape_to_image=reshape)
    jxs = J.pack_8_to_5(tuple(jnp.asarray(x) for x in xs8))
    params = jmod.init(jax.random.PRNGKey(0), jxs)["params"]
    rng = np.random.default_rng(14)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = np.asarray(jmod.apply({"params": params}, jxs))
    mod = td8.IsotypicToPatchD8(32, 4, 3, reshape_to_image=reshape)
    mod.load_state_dict(params_from_jax({"params": params}, mod), strict=True)
    with torch.no_grad():
        for xs in (T.pack_8_to_5f(_t8(xs8)), T.pack_8_to_5(_t8(xs8))):
            got = mod(xs).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
