"""Parity of the port's checkpoint converters and hub with the JAX package on
the CPU. Reference-layout state_dicts are drawn at random (the function below
follows tests/test_convert_and_utils.py:_fake_octic_state_dict), written to
temporary ``.pth`` files and loaded by both hubs; tiny models stand in for
the full-size entries (the hybrid and invariant-early octic DINOv2 backbones,
the upstream DINOv2 with registers and SwiGLU) through extra hub and
registry entries set with monkeypatch. f32 on both sides, tolerance 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octic_vits_tpu.hub as J_hub
import octic_vits_tpu.models.registry as J_reg
from octic_vits_tpu.models import DinoVisionTransformer as JDino
from octic_vits_tpu.models import OcticDinoVisionTransformer as JOcticDino
from octic_vits_tpu.utils import convert as J_conv
from octic_vits_tpu_torch import create_model, hub
from octic_vits_tpu_torch.models import DinoVisionTransformer, OcticDinoVisionTransformer
from octic_vits_tpu_torch.models import registry as T_reg
from octic_vits_tpu_torch.utils import convert as T_conv
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
TOL = 1e-5
DINO_TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
                 init_scale=1e-5)  # the port's registry.py:hybrid_dinov2_vit_tiny_test


def _fake_octic_state_dict(depth=2, dim=32, patch=8, grid=4, ncls=10, hidden=None,
                           style="deit", seed=0, scale=0.2):
    """Reference-layout state dict with random values (names per
    octic_vits/model.py + d8_layers.py): `style` "deit" has AffineD8
    ``gamma_1`` / ``gamma_2`` and a head, "dinov2" LayerScaleD8 ``ls1`` /
    ``ls2``, ``ls*.gamma`` in the standard blocks, a mask token and no
    head. Products are scaled by `scale`."""
    rng = np.random.RandomState(seed)
    c8 = dim // 8
    hidden = hidden or 4 * dim
    sd = {}

    def rand(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)

    for i in range(6):
        sd[f"pos_embed.{i}"] = rand(grid // 2, grid // 2, c8)
    sd["cls_token.0"] = rand(1, 1, c8)
    if style == "dinov2":
        sd["mask_token.0"] = rand(1, c8)
    for name in ["A1", "A2", "B1", "B2", "E_left", "E_right"]:
        sd[f"patch_embed.lift8.conv_{name}.weight"] = rand(c8, 3, patch // 2, patch // 2, s=scale)
    sd["patch_embed.lift8.conv_A1.bias"] = rand(c8)

    def lin_d8(prefix, cin, cout, bias=True):
        for irr in ["A1", "A2", "B1", "B2"]:
            sd[f"{prefix}.lin_{irr}.weight"] = rand(cout // 8, cin // 8, s=scale)
        sd[f"{prefix}.lin_E.weight"] = rand(cout // 4, cin // 4, s=scale)
        if bias:
            sd[f"{prefix}.lin_A1.bias"] = rand(cout // 8)

    def affine(prefix, with_beta):
        for irr in ["A1", "A2", "B1", "B2"]:
            sd[f"{prefix}.alpha_{irr}"] = rand(c8)
        sd[f"{prefix}.alpha_E"] = rand(dim // 4)
        if with_beta:
            sd[f"{prefix}.beta"] = rand(c8)

    brk = depth // 2
    for i in range(depth):
        p = f"blocks.{i}"
        if i < brk:
            affine(f"{p}.norm1.scaling", True)
            affine(f"{p}.norm2.scaling", True)
            lin_d8(f"{p}.attn.qkv", dim, 3 * dim)
            lin_d8(f"{p}.attn.proj", dim, dim)
            lin_d8(f"{p}.mlp.fc1", dim, hidden)
            lin_d8(f"{p}.mlp.fc2", hidden, dim)
            g1, g2 = ("gamma_1", "gamma_2") if style == "deit" else ("ls1", "ls2")
            affine(f"{p}.{g1}", False)
            affine(f"{p}.{g2}", False)
        else:
            for nm in ["norm1", "norm2"]:
                sd[f"{p}.{nm}.weight"] = rand(dim)
                sd[f"{p}.{nm}.bias"] = rand(dim)
            sd[f"{p}.attn.qkv.weight"] = rand(3 * dim, dim, s=scale)
            sd[f"{p}.attn.qkv.bias"] = rand(3 * dim)
            sd[f"{p}.attn.proj.weight"] = rand(dim, dim, s=scale)
            sd[f"{p}.attn.proj.bias"] = rand(dim)
            sd[f"{p}.mlp.fc1.weight"] = rand(hidden, dim, s=scale)
            sd[f"{p}.mlp.fc1.bias"] = rand(hidden)
            sd[f"{p}.mlp.fc2.weight"] = rand(dim, hidden, s=scale)
            sd[f"{p}.mlp.fc2.bias"] = rand(dim)
            if style == "deit":
                sd[f"{p}.gamma_1"] = rand(dim)
                sd[f"{p}.gamma_2"] = rand(dim)
            else:
                sd[f"{p}.ls1.gamma"] = rand(dim)
                sd[f"{p}.ls2.gamma"] = rand(dim)
    sd["norm.weight"] = rand(dim)
    sd["norm.bias"] = rand(dim)
    if style == "deit":
        sd["head.weight"] = rand(ncls, dim, s=scale)
        sd["head.bias"] = rand(ncls)
    return sd


def _fake_dinov2_state_dict(depth=2, dim=32, patch=8, grid=4, seed=1, scale=0.2):
    """Upstream DINOv2 ``DinoVisionTransformer`` layout."""
    rng = np.random.RandomState(seed)
    sd = {"cls_token": rng.randn(1, 1, dim), "pos_embed": rng.randn(1, grid * grid + 1, dim),
          "mask_token": rng.randn(1, dim), "patch_embed.proj.weight": scale * rng.randn(
              dim, 3, patch, patch), "patch_embed.proj.bias": rng.randn(dim),
          "norm.weight": rng.randn(dim), "norm.bias": rng.randn(dim)}
    for i in range(depth):
        p = f"blocks.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{p}.{nm}.weight"], sd[f"{p}.{nm}.bias"] = rng.randn(dim), rng.randn(dim)
        for nm, (o, n) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                           ("mlp.fc1", (2 * dim, dim)), ("mlp.fc2", (dim, 2 * dim))):
            sd[f"{p}.{nm}.weight"], sd[f"{p}.{nm}.bias"] = scale * rng.randn(o, n), rng.randn(o)
        sd[f"{p}.ls1.gamma"], sd[f"{p}.ls2.gamma"] = rng.randn(dim), rng.randn(dim)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _save(path, blob):
    torch.save({k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                    else torch.from_numpy(v)) for k, v in blob.items()}, path)
    return str(path)


def _images(seed, size):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


def _assert_trees_equal(ours, theirs, path=""):
    assert set(ours) == set(theirs), path
    for k in theirs:
        if isinstance(theirs[k], dict):
            _assert_trees_equal(ours[k], theirs[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=f"{path}/{k}")


@pytest.fixture
def tiny_entries(monkeypatch):
    """The tiny registry models as hub entries of both hubs (the JAX
    registry gains the DINOv2 one for the test's duration)."""
    entries = {"hybrid_dinov2_vit_tiny_test": hub.HubEntry("hybrid_dinov2_vit_tiny_test", 2,
                                                           "dinov2", 8),
               "hybrid_vit_small_test": hub.HubEntry("hybrid_vit_small_test", 4, "deit", 8)}
    for name, e in entries.items():
        monkeypatch.setitem(hub.HUB_ENTRIES, name, e)
        monkeypatch.setitem(J_hub.HUB_ENTRIES, name,
                            J_hub.HubEntry(e.arch, e.depth, e.style, e.patch_size))
    monkeypatch.setitem(J_reg._REGISTRY, "hybrid_dinov2_vit_tiny_test",
                        lambda img_size=32, **kw: JOcticDino(**dict(DINO_TINY, img_size=img_size),
                                                             **kw))
    return entries


# tiny stand-ins of the entries ported after the hub: an invariant-early octic
# DINOv2, and an upstream DINOv2 with 4 registers and the SwiGLU FFN
UPSTREAM_TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
                     mlp_ratio=2.0, num_register_tokens=4, ffn_layer="swiglu")
NEW_ENTRIES = {
    "d8_inv_early_dinov2_vit_tiny_test": (
        hub.HubEntry("d8_inv_early_dinov2_vit_tiny_test", 2, "dinov2", 8),
        dict(DINO_TINY, invariant=True), JOcticDino, OcticDinoVisionTransformer),
    "dinov2_vit_tiny_reg_test": (
        hub.HubEntry("dinov2_vit_tiny_reg_test", 2, "dinov2", 8, num_register_tokens=4,
                     family="dinov2_std", embed_dim=32),
        UPSTREAM_TINY, JDino, DinoVisionTransformer),
}


@pytest.fixture
def new_entries(monkeypatch):
    """The two stand-ins as entries of both hubs and both registries."""
    for name, (e, cfg, jcls, tcls) in NEW_ENTRIES.items():
        monkeypatch.setitem(hub.HUB_ENTRIES, name, e)
        monkeypatch.setitem(J_hub.HUB_ENTRIES, name, J_hub.HubEntry(
            e.arch, e.depth, e.style, e.patch_size, e.num_register_tokens, e.family,
            e.embed_dim))
        monkeypatch.setitem(J_reg._REGISTRY, name,
                            lambda img_size=32, _c=cfg, _k=jcls, **kw: _k(**dict(
                                _c, img_size=img_size), **kw))
        monkeypatch.setitem(T_reg._REGISTRY, name,
                            lambda img_size=32, _c=cfg, _k=tcls, **kw: _k(**dict(
                                _c, img_size=img_size), **kw))
    return NEW_ENTRIES


def _fake_new_entry_state_dict(name, seed):
    """The reference layout of a stand-in: the octic DINOv2 one with its
    ``invariant_proj``; the upstream one with ``register_tokens`` and the
    SwiGLU FFN's ``w12`` / ``w3`` in place of fc1 / fc2 (hidden 48)."""
    rng = np.random.RandomState(seed)
    if name.startswith("d8"):
        sd = _fake_octic_state_dict(2, 32, style="dinov2", hidden=64, seed=seed)
        sd["invariant_proj.weight"] = (0.2 * rng.randn(32, 24)).astype(np.float32)
        sd["invariant_proj.bias"] = rng.randn(32).astype(np.float32)
        return sd
    sd = _fake_dinov2_state_dict(seed=seed)
    sd["register_tokens"] = rng.randn(1, 4, 32).astype(np.float32)
    for i in range(2):
        for nm in ("fc1", "fc2"):
            del sd[f"blocks.{i}.mlp.{nm}.weight"], sd[f"blocks.{i}.mlp.{nm}.bias"]
        for nm, (o, n) in (("w12", (96, 32)), ("w3", (32, 48))):
            sd[f"blocks.{i}.mlp.{nm}.weight"] = (0.2 * rng.randn(o, n)).astype(np.float32)
            sd[f"blocks.{i}.mlp.{nm}.bias"] = rng.randn(o).astype(np.float32)
    return sd


@pytest.mark.parametrize("name", sorted(NEW_ENTRIES))
def test_load_new_entries_match_jax(new_entries, tmp_path, name):
    """The stand-ins of the invariant-early octic DINOv2 and of the upstream
    DINOv2 with registers and SwiGLU load through both hubs from one random
    reference-layout .pth file: the backbones' cls features, and the linear
    classifier (its get_intermediate_layers skips the registers), against
    JAX's."""
    sd = _fake_new_entry_state_dict(name, 11)
    path = _save(tmp_path / "ckpt.pth", {"teacher": {"module." + k: v for k, v in sd.items()}})
    img = _images(12, 32)
    jmodel, jparams = J_hub.load_backbone(name, path, img_size=32, dtype=jnp.float32)
    ours = hub.load_backbone(name, path, img_size=32, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(img))
    assert tuple(got.shape) == (2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.apply({"params": jparams},
                                                                    jnp.asarray(img))),
                               atol=TOL, rtol=TOL)
    classify_fn, variables = J_hub.load_linear_classifier(name, path, layers=1, img_size=32,
                                                          dtype=jnp.float32)
    model = hub.load_linear_classifier(name, path, layers=1, img_size=32, dtype=torch.float32,
                                       device="cpu")
    model.head.load_state_dict(params_from_jax(variables["head"], model.head), strict=True)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(classify_fn(variables, jnp.asarray(img))),
                               atol=TOL, rtol=TOL)


# ---- the converters ------------------------------------------------------------


@pytest.mark.parametrize("style", ["deit", "dinov2"])
def test_convert_octic_vit_matches_jax(style):
    sd = {"_orig_mod.module." + k: v for k, v in _fake_octic_state_dict(4, style=style).items()}
    _assert_trees_equal(T_conv.convert_octic_vit(sd, 4, style=style),
                        J_conv.convert_octic_vit(sd, 4, style=style))
    assert T_conv.normalize_keys(sd).keys() == J_conv.normalize_keys(sd).keys()


def test_convert_dinov2_and_linear_head_match_jax():
    sd = {"backbone." + k: v for k, v in _fake_dinov2_state_dict(3).items()}
    _assert_trees_equal(T_conv.convert_dinov2_vit(sd, 3), J_conv.convert_dinov2_vit(sd, 3))
    rng = np.random.RandomState(2)
    for prefix in ("", "linear_head."):
        head = {prefix + "weight": rng.randn(7, 5), prefix + "bias": rng.randn(7)}
        _assert_trees_equal(T_conv.convert_linear_head(head), J_conv.convert_linear_head(head))


def test_params_from_reference_standard_dinov2():
    sd = _fake_dinov2_state_dict()
    cfg = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0)
    jmodel = JDino(**cfg)
    img = _images(3, 32)
    theirs = jmodel.apply({"params": J_conv.convert_dinov2_vit(sd, 2)}, jnp.asarray(img))
    tmodel = DinoVisionTransformer(**cfg).eval()
    tmodel.load_state_dict(T_conv.params_from_reference(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tmodel), strict=True)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(img))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=TOL, rtol=TOL)


# ---- the hub ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hybrid_dinov2_vit_tiny_test", "hybrid_vit_small_test"])
def test_load_backbone_matches_jax(tiny_entries, tmp_path, name):
    entry = tiny_entries[name]
    dino = entry.style == "dinov2"
    sd = _fake_octic_state_dict(entry.depth, 32 if dino else 64, style=entry.style,
                                hidden=64 if dino else 128, grid=4 if dino else 8)
    key = "teacher" if dino else "model"
    path = _save(tmp_path / "ckpt.pth", {key: {"_orig_mod." + k: v for k, v in sd.items()}})
    size = 32 if dino else 64
    jmodel, jparams = J_hub.load_backbone(name, path, img_size=size, dtype=jnp.float32)
    img = _images(4, size)
    theirs = jmodel.apply({"params": jparams}, jnp.asarray(img))
    ours = hub.load_backbone(name, path, img_size=size, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(img))
    assert tuple(got.shape) == ((2, 32) if dino else (2, 10))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=TOL, rtol=TOL)


def test_load_linear_classifier_matches_jax(tiny_entries, tmp_path):
    name = "hybrid_dinov2_vit_tiny_test"
    sd = _fake_octic_state_dict(2, 32, style="dinov2", hidden=64, seed=5)
    backbone = _save(tmp_path / "backbone.pth", {"teacher": sd})
    rng = np.random.RandomState(6)
    head = _save(tmp_path / "head.pth", {"weight": (0.1 * rng.randn(1000, 64)).astype(np.float32),
                                         "bias": rng.randn(1000).astype(np.float32)})
    classify_fn, variables = J_hub.load_linear_classifier(name, backbone, head, layers=1,
                                                          img_size=32, dtype=jnp.float32)
    img = _images(7, 32)
    theirs = classify_fn(variables, jnp.asarray(img))
    model = hub.load_linear_classifier(name, backbone, head, layers=1, img_size=32,
                                       dtype=torch.float32, device="cpu")
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(img))
    assert tuple(ours.shape) == (2, 1000)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=TOL, rtol=TOL)
    # without a head file the head is drawn from a generator seeded 0, with
    # flax Dense's LeCun truncated normal
    a, b = (hub.load_linear_classifier(name, backbone, layers=1, img_size=32,
                                       dtype=torch.float32, device="cpu") for _ in range(2))
    assert torch.equal(a.head.weight, b.head.weight) and not a.head.bias.any()
    std = (1 / 64) ** 0.5 / 0.87962566103423978
    assert a.head.weight.abs().max() <= 2 * std and 0.7 * std < a.head.weight.std() < 1.1 * std


def test_hub_entries_and_unsupported(tmp_path):
    assert hub.HUB_ENTRIES.keys() == J_hub.HUB_ENTRIES.keys() and len(hub.HUB_ENTRIES) == 16
    for name, e in J_hub.HUB_ENTRIES.items():
        assert dataclasses_equal(hub.HUB_ENTRIES[name], e), name
    # every entry's model builds (the invariant-early and upstream DINOv2 ones
    # too, on the meta device), with the entry's depth and registers
    for name, e in hub.HUB_ENTRIES.items():
        model = create_model(e.arch, device="meta")
        assert len(model.blocks) == e.depth, name
        assert getattr(model, "num_register_tokens", 0) == e.num_register_tokens, name
    # an orbax checkpoint of the JAX package: the port reads only its own format
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "orbax"), {"w": np.ones(2, np.float32)})
    ckptr.wait_until_finished()
    with pytest.raises(NotImplementedError, match="orbax checkpoint of the JAX package needs JAX"):
        hub.load_backbone("hybrid_dinov2_vit_large_patch16", str(tmp_path / "orbax"),
                          device="cpu")
    with pytest.raises(ValueError, match="DeiT-style"):
        hub.load_linear_classifier("hybrid_deit_large_patch16", device="cpu")
    with pytest.raises(ValueError, match="layers"):
        hub.load_linear_classifier("hybrid_dinov2_vit_large_patch16", layers=2, device="cpu")
    with pytest.raises(KeyError):
        hub.load_backbone("no_such_model", device="cpu")


def test_load_backbone_from_port_checkpoints(tiny_entries, tmp_path):
    """A teacher export of the SSL loop (``utils.checkpoint.save_teacher``)
    and a DeiT train-state checkpoint load as the JAX hub's orbax branch does
    (octic_vits_tpu/hub.py:88-91), into the model the port builds."""
    from octic_vits_tpu_torch import init_weights
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch
    from octic_vits_tpu_torch.utils import checkpoint as C

    arch = SSLMetaArch(SSLConfig(arch="hybrid_dinov2_vit_tiny_test", img_size=32,
                                 local_crop_size=16, patch_size=8, dino_out_dim=64,
                                 dino_head_hidden_dim=32, dino_head_bottleneck_dim=16,
                                 ibot_out_dim=64, n_local_crops=2, compute_dtype=None),
                       device="cpu")
    state = arch.init(torch.Generator().manual_seed(3))
    export = C.save_teacher(str(tmp_path), 7, state.teacher_state_dict())
    img = torch.from_numpy(_images(5, 32))
    for source in (export, None):
        if source is None:  # the whole SSL state: its teacher's backbone
            source = C.save_tree(str(tmp_path / "state"), state.state_dict())
        model = hub.load_backbone("hybrid_dinov2_vit_tiny_test", source, img_size=32,
                                  dtype=torch.float32, device="cpu")
        for k, v in state.teacher["backbone"].state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k
        with torch.no_grad():
            torch.testing.assert_close(model.eval()(img), state.teacher["backbone"].eval()(img),
                                       rtol=0, atol=0)
    deit = create_model("hybrid_vit_small_test", img_size=64, device="cpu")
    init_weights(deit, torch.Generator().manual_seed(4))
    path = C.save_tree(str(tmp_path / "best"), {"step": 3, "model": deit.state_dict()})
    model = hub.load_backbone("hybrid_vit_small_test", path, checkpoint_key="model", img_size=64,
                              dtype=torch.bfloat16, device="cpu")
    for k, v in deit.state_dict().items():
        assert torch.equal(model.state_dict()[k], v.to(torch.bfloat16)), k


def dataclasses_equal(ours, theirs) -> bool:
    fields = ("arch", "depth", "style", "patch_size", "num_register_tokens", "family",
              "embed_dim")
    return all(getattr(ours, f) == getattr(theirs, f) for f in fields)


def test_hybrid_deit_large_patch16_registered():
    """The hub names it; built on the meta device (no memory), it has the
    JAX registry's shape: ViT-L/16, 24 blocks, the first 12 octic."""
    model = create_model("hybrid_deit_large_patch16", device="meta")
    jmodel = J_reg.create_model("hybrid_deit_large_patch16")
    assert (model.embed_dim, model.depth, model.patch_size, model.break_layer) == \
        (jmodel.embed_dim, jmodel.depth, jmodel.patch_size, 12) == (1024, 24, 16, 12)
    assert model.head.weight.shape == (1000, 1024)
