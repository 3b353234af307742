"""Equivariant and standard ViT layers."""

from octic_vits_tpu_torch.layers.common import drop_path_mask
from octic_vits_tpu_torch.layers.d8_layers import (
    AttentionD8,
    BlockD8,
    DropPathD8,
    GeluD8,
    LayerNormD8,
    LinearD8,
    MlpD8,
    PatchEmbedD8,
    ScaleD8,
    drop_path_d8,
    layer_norm_d8_stats,
)
from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.layers.vit_layers import (
    Attention,
    Block,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    drop_path,
)

__all__ = [
    "Attention",
    "AttentionD8",
    "Block",
    "BlockD8",
    "DropPath",
    "DropPathD8",
    "GeluD8",
    "LayerNormD8",
    "LayerNorm",
    "Linear",
    "LinearD8",
    "Mlp",
    "MlpD8",
    "PatchEmbed",
    "PatchEmbedD8",
    "ScaleD8",
    "drop_path",
    "drop_path_d8",
    "drop_path_mask",
    "init_weights",
    "layer_norm_d8_stats",
]
