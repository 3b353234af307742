"""The port's depth stack (octic_vits_tpu_torch/models/depth.py, the
converter's depth heads and ``hub.load_depther``) against the JAX package's
on the CPU. Seeded numpy inputs; f32 on both sides at 1e-5 (relative, with
an absolute floor of 1e-5) unless a test states otherwise. The heads get
their weights both from a flax param tree through ``params_from_jax`` (JAX's
init for BNHead, seeded values of its init's shapes for DPTHead) and from one
seeded reference-layout state dict through both packages'
``convert_depth_head``; the encoder-decoder runs the small real backbone
``dinov2_vits14`` at a non-square size that needs padding, which also holds
the positional-embedding resize to a non-square grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octic_vits_tpu.hub as J_hub
from octic_vits_tpu.models import depth as J
from octic_vits_tpu.utils import convert as J_conv
from octic_vits_tpu_torch import hub
from octic_vits_tpu_torch.models import depth as T
from octic_vits_tpu_torch.utils import convert as T_conv
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((7, 9), (13, 5)), ((13, 11), (5, 4)), ((5, 3), (17, 19)),
                                     ((1, 6), (3, 6)), ((9, 7), (9, 7))])
def test_resize_bilinear_matches_jax(align_corners, src, dst):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    got = T.resize_bilinear(_t(x), dst, align_corners)
    assert tuple(got.shape) == (2, *dst, 3)
    _close(got, J.resize_bilinear(jnp.asarray(x), dst, align_corners))


def _random_params(module, feats, seed, scale=0.1):
    """A flax param tree of `module`'s shapes (``jax.eval_shape`` of its init,
    which is slow to run eagerly on the CPU) filled with seeded normals."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), feats)["params"]
    leaves, treedef = jax.tree.flatten(shapes)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(treedef, [jnp.asarray(scale * rs.randn(*x.shape), jnp.float32)
                                        for x in leaves])


class _Holder(torch.nn.Module):
    def __init__(self, mod):
        super().__init__()
        self.resize_0 = mod


@pytest.mark.parametrize("s", [2, 4])
def test_conv_transpose_matches_block_expand(s):
    """JAX's BlockExpand kernel [s, s, I, O] carried by params_from_jax onto
    the ConvTranspose2d (kernel = stride) that stands in its place."""
    x = np.random.RandomState(1).randn(2, 4, 3, 6).astype(np.float32)
    mod = J.BlockExpand(5, s)
    params = _random_params(mod, jnp.asarray(x), s, scale=0.5)
    ours = _Holder(torch.nn.ConvTranspose2d(6, 5, s, stride=s))
    ours.load_state_dict(params_from_jax({"resize_0": params}, ours), strict=True)
    with torch.no_grad():
        got = ours.resize_0(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, mod.apply({"params": params}, jnp.asarray(x)))


def _features(seed, n, b, hw, dim):
    """[(patch [b, h, w, dim], cls [b, dim])] in numpy."""
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, *hw, dim).astype(np.float32), rs.randn(b, dim).astype(np.float32))
            for _ in range(n)]


def _jax_feats(feats):
    return [(jnp.asarray(p), jnp.asarray(c)) for p, c in feats]


def _torch_feats(feats):
    return [(_t(p), _t(c)) for p, c in feats]


@pytest.mark.parametrize("bins", ["UD", "SID"])
@pytest.mark.parametrize("norm", ["linear", "softmax", "sigmoid"])
def test_bnhead_matches_jax(norm, bins):
    """Both bin spacings and all three normalisations; SID bins are
    10**linspace(min, max) (torch.logspace), so the range is (0.001, 2)."""
    dim, levels = 16, 4
    kw = dict(in_index=tuple(range(levels)), upsample=4, n_bins=32, bins_strategy=bins,
              norm_strategy=norm, min_depth=0.001, max_depth=80.0 if bins == "UD" else 2.0)
    feats = _features(3, levels, 2, (5, 3), dim)
    theirs = J.BNHead(**kw)
    params = theirs.init(jax.random.PRNGKey(0), _jax_feats(feats))["params"]
    ours = T.BNHead(dim, **kw)
    ours.load_state_dict(params_from_jax(params, ours), strict=True)
    with torch.no_grad():
        got = ours(_torch_feats(feats))
    assert tuple(got.shape) == (2, 20, 12, 1)
    _close(got, theirs.apply({"params": params}, _jax_feats(feats)))


def test_dpthead_matches_jax():
    dim = 16
    feats = _features(4, 4, 2, (4, 6), dim)
    theirs = J.DPTHead(embed_dim=dim, channels=24, min_depth=0.001, max_depth=10.0)
    params = _random_params(theirs, _jax_feats(feats), 1)
    ours = T.DPTHead(dim, channels=24, min_depth=0.001, max_depth=10.0)
    ours.load_state_dict(params_from_jax(params, ours), strict=True)
    with torch.no_grad():
        got = ours(_torch_feats(feats))
    assert tuple(got.shape) == (2, 64, 96, 1)
    _close(got, jax.jit(theirs.apply)({"params": params}, _jax_feats(feats)))


def reference_depth_head(kind, dim, channels=256, seed=0):
    """A released head's state dict with random values, in the reference
    layout (dinov2/hub/depth/decode_heads.py:223-296, 528-747) under the
    ``decode_head.`` prefix of its DepthEncoderDecoder, with one backbone key
    that the converter drops: "linear" is the 4-level BNHead's 1x1 conv
    (256 bins), "dpt" the DPTHead tree of `channels` at `dim`. Weights have
    std 1 / sqrt(fan-in), biases 0.1."""
    rs = np.random.RandomState(seed)
    sd = {"backbone.cls_token": rs.randn(1, 1, dim)}

    def conv(prefix, o, i, k, bias=True):
        sd[f"decode_head.{prefix}.weight"] = rs.randn(o, i, k, k) / np.sqrt(i * k * k)
        if bias:
            sd[f"decode_head.{prefix}.bias"] = 0.1 * rs.randn(o)

    if kind == "linear":
        conv("conv_depth", 256, 8 * dim, 1)
    else:
        ppc = [dim // 2 ** (3 - i) for i in range(4)]
        rb = "reassemble_blocks"
        for i in range(4):
            sd[f"decode_head.{rb}.readout_projects.{i}.0.weight"] = rs.randn(dim, 2 * dim) / np.sqrt(
                2 * dim)
            sd[f"decode_head.{rb}.readout_projects.{i}.0.bias"] = 0.1 * rs.randn(dim)
            conv(f"{rb}.projects.{i}.conv", ppc[i], dim, 1)
            conv(f"convs.{i}.conv", channels, ppc[i], 3, bias=False)
            conv(f"fusion_blocks.{i}.project.conv", channels, channels, 1)
            for u in (1, 2) if i else (2,):
                for j in (1, 2):
                    conv(f"fusion_blocks.{i}.res_conv_unit{u}.conv{j}.conv", channels, channels,
                         3, bias=False)
        for i, s in ((0, 4), (1, 2)):  # ConvTranspose2d weights are [I, O, s, s]
            conv(f"{rb}.resize_layers.{i}", ppc[i], ppc[i], s)
        conv(f"{rb}.resize_layers.3", ppc[3], ppc[3], 3)
        conv("project.conv", channels, channels, 3)
        conv("conv_depth.head.0", channels // 2, channels, 3)
        conv("conv_depth.head.2", 32, channels // 2, 3)
        conv("conv_depth.head.4", 1, 32, 1)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["linear", "dpt"])
def test_convert_depth_head_matches_jax(kind):
    """One reference-layout state dict through both converters: the same flax
    tree bitwise, and the port's head loaded from it computes JAX's."""
    dim = 16
    sd = reference_depth_head(kind, dim, channels=24)
    params = J_conv.convert_depth_head(sd)
    _tree_equal(T_conv.convert_depth_head({k: _t(v) for k, v in sd.items()}), params)
    if kind == "linear":
        theirs, ours = J.BNHead(n_bins=256), T.BNHead(dim, n_bins=256)
    else:
        theirs = J.DPTHead(embed_dim=dim, channels=24)
        ours = T.DPTHead(dim, channels=24)
    ours.load_state_dict(params_from_jax(T_conv.convert_depth_head(sd), ours), strict=True)
    feats = _features(5, 4, 2, (3, 4), dim)
    with torch.no_grad():
        got = ours(_torch_feats(feats))
    _close(got, jax.jit(theirs.apply)({"params": jax.tree.map(jnp.asarray, params)},
                                      _jax_feats(feats)))


def test_center_padding_matches_jax():
    """JAX's own case (tests/test_depth.py:157): 30 x 33 pads (6, 6) x (4, 5) to 42 x 42."""
    x = np.random.RandomState(6).rand(2, 30, 33, 3).astype(np.float32) + 1.0
    got = T.center_padding(_t(x), 14)
    assert tuple(got.shape) == (2, 42, 42, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.center_padding(jnp.asarray(x), 14)))
    g = got.numpy()
    assert g[0, 5, 20, 0] == 0.0 and g[0, 6, 20, 0] != 0.0 and g[0, 36, 20, 0] == 0.0
    assert g[0, 20, 3, 0] == 0.0 and g[0, 20, 4, 0] != 0.0 and g[0, 20, 37, 0] == 0.0


def reference_dinov2(depth=12, dim=384, patch=14, grid=4, seed=7, scale=0.05):
    """An upstream DINOv2 ViT-S/14 state dict (`depth` blocks of `dim`, pos
    embed for a `grid` x `grid` image) with random values."""
    rs = np.random.RandomState(seed)
    sd = {"cls_token": rs.randn(1, 1, dim), "pos_embed": rs.randn(1, grid * grid + 1, dim),
          "mask_token": rs.randn(1, dim), "patch_embed.proj.weight": scale * rs.randn(
              dim, 3, patch, patch), "patch_embed.proj.bias": scale * rs.randn(dim),
          "norm.weight": 1 + 0.1 * rs.randn(dim), "norm.bias": 0.1 * rs.randn(dim)}
    for i in range(depth):
        p = f"blocks.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{p}.{nm}.weight"] = 1 + 0.1 * rs.randn(dim)
            sd[f"{p}.{nm}.bias"] = 0.1 * rs.randn(dim)
        for nm, (o, n) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                           ("mlp.fc1", (4 * dim, dim)), ("mlp.fc2", (dim, 4 * dim))):
            sd[f"{p}.{nm}.weight"] = scale * rs.randn(o, n)
            sd[f"{p}.{nm}.bias"] = scale * rs.randn(o)
        sd[f"{p}.ls1.gamma"] = 0.3 * rs.randn(dim)
        sd[f"{p}.ls2.gamma"] = 0.3 * rs.randn(dim)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("depth")
    paths = {"backbone": str(d / "dinov2_vits14_pretrain.pth")}
    torch.save({"model": reference_dinov2()}, paths["backbone"])
    for kind in ("linear", "dpt"):
        paths[kind] = str(d / f"dinov2_vits14_{kind}_head.pth")
        sd = {k: torch.from_numpy(v) for k, v in reference_depth_head(kind, 384).items()}
        torch.save({"state_dict": sd} if kind == "dpt" else sd, paths[kind])
    return paths


def _images(seed, hw=(30, 44)):
    return np.random.RandomState(seed).randn(2, *hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def depther_pair(checkpoints):
    """The DPT depther of dinov2_vits14 (pos embed for 56^2) loaded by both hubs
    from the same reference checkpoints."""
    kw = dict(head_type="dpt", weights="NYU", backbone_checkpoint=checkpoints["backbone"],
              head_checkpoint=checkpoints["dpt"], img_size=56)
    theirs, variables = J_hub.load_depther("dinov2_vits14", **kw)
    # one compile per crop shape: JAX's whole and slide paths call encode_decode
    theirs.encode_decode = jax.jit(theirs.encode_decode, static_argnums=2)
    ours = hub.load_depther("dinov2_vits14", device="cpu", **kw)
    return ours, theirs, variables


# the clamp's floor, less the rounding of the bilinear resize that follows it
F32_MIN = 0.001 * (1 - 1e-6)


@pytest.mark.parametrize("mode,flip", [("whole", False), ("slide", False), ("whole", True)])
def test_encoder_decoder_matches_jax(depther_pair, mode, flip):
    """30 x 44 frames, center-padded to 42 x 56 (a 3 x 4 grid from the 4 x 4
    pos embed); slide windows of 20 x 26 at stride (10, 9), each padded to
    28 x 28, six of them overlapping."""
    ours, theirs, variables = depther_pair
    img = _images(8)
    kw = dict(mode=mode, flip=flip, stride=(10, 9), crop_size=(20, 26))
    got = ours.predict(_t(img), **kw)
    want = theirs.predict(variables, jnp.asarray(img), **kw)
    assert tuple(got.shape) == (2, 30, 44, 1) and got.dtype == torch.float32
    assert float(got.min()) >= F32_MIN and float(got.max()) <= 10.0
    assert float(got.std()) > 0.01  # a depth map, not a clamped constant
    _close(got, want)
    if mode == "slide":
        assert ours.slide_windows(30, 44, (10, 9), (20, 26)) == [
            (0, 0), (0, 9), (0, 18), (10, 0), (10, 9), (10, 18)]


def test_flip_flips_the_output_only(depther_pair):
    """JAX's predict(flip=True) flips the depth map, not the input
    (models/depth.py:422-423); the reference's mmseg pipeline flips the input
    first. The port copies JAX."""
    ours = depther_pair[0]
    img = _t(_images(9))
    whole = ours.predict(img)
    torch.testing.assert_close(ours.predict(img, flip=True), whole.flip(2), rtol=0, atol=0)
    assert not torch.allclose(ours.predict(img.flip(2)).flip(2), whole, atol=1e-3)


@pytest.mark.parametrize("head_type,layers,weights", [("linear", 4, "NYU"), ("linear", 1, "KITTI"),
                                                      ("dpt", 4, "KITTI")])
def test_load_depther_matches_jax(checkpoints, head_type, layers, weights):
    """JAX's smoke size (tests/test_depth.py:188): dinov2_vits14 at img_size 56,
    both heads from converted checkpoints (the linear-1 head reads the last
    block: 2 * 384 channels, the first 768 of the released 4-level conv)."""
    head_ckpt = checkpoints["linear" if head_type == "linear" else "dpt"]
    if layers == 1:
        sd = torch.load(head_ckpt)
        sd["decode_head.conv_depth.weight"] = sd["decode_head.conv_depth.weight"][:, :768]
        head_ckpt = head_ckpt.replace(".pth", "_1.pth")
        torch.save(sd, head_ckpt)
    kw = dict(head_type=head_type, layers=layers, weights=weights,
              backbone_checkpoint=checkpoints["backbone"], head_checkpoint=head_ckpt,
              img_size=56)
    theirs, variables = J_hub.load_depther("dinov2_vits14", **kw)
    theirs.encode_decode = jax.jit(theirs.encode_decode, static_argnums=2)
    ours = hub.load_depther("dinov2_vits14", device="cpu", **kw)
    assert not ours.training and ours.out_index == (
        [2, 5, 8, 11] if layers == 4 else [11])
    img = _images(10, (56, 56))
    got = ours.predict(_t(img))
    assert tuple(got.shape) == (2, 56, 56, 1)
    _close(got, theirs.predict(variables, jnp.asarray(img)))


@pytest.mark.parametrize("kwargs,err", [
    (dict(name="dinov2_vitx14"), KeyError), (dict(weights="Make3D"), KeyError),
    (dict(head_type="linear", layers=2), ValueError), (dict(head_type="bts"), ValueError)])
def test_load_depther_errors_match_jax(kwargs, err):
    kwargs = {"name": "dinov2_vits14", "img_size": 28, **kwargs}
    with pytest.raises(err):
        J_hub.load_depther(**kwargs)
    with pytest.raises(err):
        hub.load_depther(device="cpu", **kwargs)


def test_load_depther_without_head_checkpoint_is_seeded():
    """Without a head checkpoint the head is drawn from a generator seeded 0
    as flax's lecun_normal draws it: drawn again from seed 0 it is the same
    head, from seed 1 another; the spread is JAX's, but JAX's PRNGKey(0)
    head (the linear-4 head's 1x1 conv, 256 x 3072) cannot be reproduced bit
    for bit."""
    import copy

    ours = hub.load_depther("dinov2_vits14", head_type="linear", img_size=28, device="cpu")
    b, c = copy.deepcopy(ours.head), copy.deepcopy(ours.head)
    T.lecun_normal_(b, torch.Generator().manual_seed(0))  # what load_depther draws
    T.lecun_normal_(c, torch.Generator().manual_seed(1))
    for (k, x), y, z in zip(ours.head.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
        assert k.endswith("bias") or not torch.equal(x, z), k
    assert bool(ours.predict(_t(_images(11, (28, 28)))).isfinite().all())

    _, variables = J_hub.load_depther("dinov2_vits14", head_type="linear", img_size=28)
    w, jw = ours.head.conv_depth.weight.detach(), params_from_jax(variables["head"], ours.head)[
        "conv_depth.weight"]
    assert w.shape == jw.shape == (256, 3072, 1, 1)
    assert not torch.equal(w, jw)
    assert abs(float(w.std() / jw.std()) - 1.0) < 0.02
    assert abs(float(w.std()) * np.sqrt(3072) - 1.0) < 0.02  # lecun: std 1 / sqrt(fan-in)
