"""Model FLOPs per image, a frozen copy of the program's analytic MAC counts
(``utils/flops.py``): an octic linear map costs an eighth of its dense
counterpart, attention runs at full width, the lifting patch embedding
costs as a dense one. FLOPs are two per multiply-add."""

from __future__ import annotations


def standard_block_macs(n: int, d: int, mlp_ratio: float) -> float:
    return n * (3 * d * d + d * d + 2 * mlp_ratio * d * d) + 2 * n * n * d


def octic_block_macs(n: int, d: int, mlp_ratio: float) -> float:
    return n * (3 * d * d + d * d + 2 * mlp_ratio * d * d) / 8.0 + 2 * n * n * d


def vit_macs(cfg: dict) -> float:
    """MACs of one image through the model of configuration `cfg` (its
    ``break_layer`` octic blocks first; 0 for a standard ViT)."""
    grid = cfg["img_size"] // cfg["patch_size"]
    n, d = grid * grid + 1 + cfg.get("num_register_tokens", 0), cfg["embed_dim"]
    brk, depth, r = cfg.get("break_layer", 0), cfg["depth"], cfg["mlp_ratio"]
    total = grid * grid * d * cfg["patch_size"] ** 2 * 3
    total += brk * octic_block_macs(n, d, r) + (depth - brk) * standard_block_macs(n, d, r)
    return total + d * cfg.get("num_classes", 0)


def flops_per_image(cfg: dict) -> float:
    return 2.0 * vit_macs(cfg)


def dino_head_macs(cfg: dict) -> float:
    """MACs of one row through the DINO head: the MLP to the bottleneck, then
    the prototypes."""
    d, h, k = cfg["embed_dim"], cfg["dino_head_hidden_dim"], cfg["dino_out_dim"]
    bottleneck, layers = cfg["dino_head_bottleneck_dim"], cfg["dino_head_nlayers"]
    dims = [d] + [h] * (layers - 1) + [bottleneck]
    return sum(a * b for a, b in zip(dims, dims[1:])) + bottleneck * k
