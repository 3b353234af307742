"""Named model configurations of the inference slice (counterpart of the
matching entries of octic_vits_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Callable, Dict

from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer
from octic_vits_tpu_torch.models.vit import VisionTransformer

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def create_model(name: str, **kwargs):
    """Build a registered model; ``device``, ``dtype`` and config overrides
    go through ``kwargs``. Parameters are uninitialised: fill them with
    ``init_weights(model, generator)`` or load them with ``params_from_jax``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
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
def hybrid_vit_small_test(img_size=64, **kwargs):
    return OcticVisionTransformer(
        img_size=img_size, patch_size=8, embed_dim=64, depth=4, num_heads=2,
        mlp_ratio=2.0, qkv_bias=True, num_classes=10, **kwargs,
    )
