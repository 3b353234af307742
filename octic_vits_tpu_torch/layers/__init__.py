"""Equivariant and standard ViT layers (eval-mode forward)."""

from octic_vits_tpu_torch.layers.d8_layers import (
    AttentionD8,
    BlockD8,
    LayerNormD8,
    LinearD8,
    MlpD8,
    PatchEmbedD8,
    ScaleD8,
    layer_norm_d8_stats,
)
from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.layers.vit_layers import Attention, Block, Mlp, PatchEmbed

__all__ = [
    "Attention",
    "AttentionD8",
    "Block",
    "BlockD8",
    "LayerNormD8",
    "LinearD8",
    "Mlp",
    "MlpD8",
    "PatchEmbed",
    "PatchEmbedD8",
    "ScaleD8",
    "init_weights",
    "layer_norm_d8_stats",
]
