"""Equivariant and standard ViT layers."""

from octic_vits_tpu_torch.layers.common import Dropout, drop_path_mask, dropout_mask
from octic_vits_tpu_torch.layers.d8_layers import (
    AttentionD8,
    BlockD8,
    DropoutD8,
    DropPathD8,
    GeluD8,
    IsotypicToPatchD8,
    LayerNormD8,
    LinearD8,
    MlpD8,
    PatchEmbedD8,
    ScaleD8,
    drop_path_d8,
    layer_norm_d8_stats,
    octic_attention_eager,
)
from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.layers.invariants import INVARIANTS, InvariantHead, make_invariant
from octic_vits_tpu_torch.layers.vit_layers import (
    Attention,
    Block,
    DropPath,
    HMLPStem,
    LayerNorm,
    Linear,
    Mlp,
    ParallelBlockx2,
    PatchEmbed,
    SwiGLUFFN,
    attention_eager,
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
