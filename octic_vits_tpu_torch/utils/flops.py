"""Analytic FLOP (MAC) counting for octic and standard ViTs (counterpart of
octic_vits_tpu/utils/flops.py, a copy: the port imports nothing of the JAX
package).

Replaces the reference's fvcore handle table (reference: utils/fvcore.py:
110-181) with closed-form counts; convention = MACs (like fvcore/DeiT
tables, so standard ViT-H/14 ~ 167 G and hybrid ~ 102 G, README.md:112).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ViTSpec:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    num_register_tokens: int = 0

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2 + 1 + self.num_register_tokens


def _standard_block_macs(n: int, d: int, mlp_ratio: float) -> float:
    linear = n * (3 * d * d + d * d + 2 * mlp_ratio * d * d)
    attn = 2 * n * n * d  # QK^T + AV
    return linear + attn


def _octic_block_macs(n: int, d: int, mlp_ratio: float) -> float:
    # every equivariant linear costs 1/8 of its dense counterpart:
    # 4 blocks of (d/8)^2 plus one (d/4)^2 block == d^2/8 MACs per token
    linear = n * (3 * d * d + d * d + 2 * mlp_ratio * d * d) / 8.0
    attn = 2 * n * n * d  # attention runs at full width (scores invariant)
    return linear + attn


def _patch_embed_macs(spec: ViTSpec) -> float:
    n_patches = (spec.img_size // spec.patch_size) ** 2
    return n_patches * spec.embed_dim * spec.patch_size**2 * 3


def standard_vit_macs(spec: ViTSpec) -> float:
    n, d = spec.tokens, spec.embed_dim
    total = _patch_embed_macs(spec)
    total += spec.depth * _standard_block_macs(n, d, spec.mlp_ratio)
    total += d * spec.num_classes
    return total


def octic_vit_macs(
    spec: ViTSpec,
    break_layer: int | None = None,
    invariant: bool = False,
) -> float:
    n, d = spec.tokens, spec.embed_dim
    brk = spec.depth // 2 if break_layer is None else break_layer
    total = _patch_embed_macs(spec)  # lift convs: 8 x (d/8) outputs == dense
    total += brk * _octic_block_macs(n, d, spec.mlp_ratio)
    total += (spec.depth - brk) * _standard_block_macs(n, d, spec.mlp_ratio)
    if invariant:
        total += n * (6 * d // 8) * d  # power-spectrum projection
    total += d * spec.num_classes
    return total


def gmacs(x: float) -> float:
    return x / 1e9
