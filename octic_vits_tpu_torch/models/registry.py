"""Named model configurations of the ported slices (counterpart of the
matching entries of octic_vits_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from octic_vits_tpu_torch.models.dinov2_vit import DinoVisionTransformer, OcticDinoVisionTransformer
from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer
from octic_vits_tpu_torch.models.vit import VisionTransformer

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: `device` where the caller names
    one, else the CUDA card. Without a card and without a named device it
    raises: the port does not fall back to the CPU on its own; CPU callers
    (the tests) pass ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def create_model(name: str, **kwargs):
    """Build a registered model on ``kwargs["device"]``, the CUDA card when
    none is given (see :func:`resolve_device`); ``dtype`` and config
    overrides go through ``kwargs`` too. Parameters are uninitialised: fill
    them with ``init_weights(model, generator)`` or load them with
    ``params_from_jax``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    kwargs["device"] = resolve_device(kwargs.get("device"))
    return _REGISTRY[name](**kwargs)


@register_model
def hybrid_deit_huge_patch14(img_size=224, **kwargs):
    return OcticVisionTransformer(
        img_size=img_size, patch_size=14, embed_dim=1280, depth=32, num_heads=16,
        mlp_ratio=4.0, qkv_bias=True, **kwargs,
    )


@register_model
def deit_huge_patch14_LS(img_size=224, **kwargs):
    # every named reference DeiT factory uses LayerNorm eps 1e-6
    kwargs.setdefault("norm_eps", 1e-6)
    return VisionTransformer(
        img_size=img_size, patch_size=14, embed_dim=1280, depth=32, num_heads=16,
        mlp_ratio=4.0, qkv_bias=True, **kwargs,
    )


@register_model
def d8_inv_early_deit_large_patch16(img_size=224, **kwargs):
    return OcticVisionTransformer(
        img_size=img_size, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_ratio=4.0, qkv_bias=True, invariant=True, **kwargs,
    )


@register_model
def d8_inv_early_deit_huge_patch14(img_size=224, **kwargs):
    return OcticVisionTransformer(
        img_size=img_size, patch_size=14, embed_dim=1280, depth=32, num_heads=16,
        mlp_ratio=4.0, qkv_bias=True, invariant=True, **kwargs,
    )


@register_model
def hybrid_vit_small_test(img_size=64, **kwargs):
    return OcticVisionTransformer(
        img_size=img_size, patch_size=8, embed_dim=64, depth=4, num_heads=2,
        mlp_ratio=2.0, qkv_bias=True, num_classes=10, **kwargs,
    )


# DINOv2 backbones (the SSL recipe: LayerScale init 1e-5 unless the caller
# sets another, biases on)


@register_model
def hybrid_dinov2_vit_large_patch16(img_size=224, **kwargs):
    return OcticDinoVisionTransformer(
        img_size=img_size, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_ratio=4.0, **{"init_scale": 1e-5, **kwargs},
    )


@register_model
def hybrid_dinov2_vit_huge_patch16(img_size=224, **kwargs):
    return OcticDinoVisionTransformer(
        img_size=img_size, patch_size=16, embed_dim=1280, depth=32, num_heads=16,
        mlp_ratio=4.0, **{"init_scale": 1e-5, **kwargs},
    )


@register_model
def dinov2_vit_large_patch16(img_size=224, **kwargs):
    return DinoVisionTransformer(
        img_size=img_size, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_ratio=4.0, **{"layerscale_init": 1e-5, **kwargs},
    )


@register_model
def dinov2_vit_huge_patch16(img_size=224, **kwargs):
    return DinoVisionTransformer(
        img_size=img_size, patch_size=16, embed_dim=1280, depth=32, num_heads=16,
        mlp_ratio=4.0, **{"layerscale_init": 1e-5, **kwargs},
    )


@register_model
def hybrid_dinov2_vit_tiny_test(img_size=32, **kwargs):
    """The micro octic DINOv2 backbone of the SSL tests
    (tests/test_ssl_training.py:_test_octic_dinov2)."""
    kwargs.setdefault("drop_path_rate", 0.0)
    return OcticDinoVisionTransformer(
        img_size=img_size, patch_size=8, embed_dim=32, depth=2, num_heads=2,
        mlp_ratio=2.0, **{"init_scale": 1e-5, **kwargs},
    )
