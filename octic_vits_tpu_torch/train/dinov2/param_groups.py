"""Per-parameter learning-rate and weight-decay multipliers of the DINOv2
step (counterpart of octic_vits_tpu/train/dinov2/param_groups.py).

The port names its parameters after the flax tree (``blocks.3.attn...``
for ``blocks_3/attn/...``), so the JAX rules carry over with two spellings
changed: the block index follows ``blocks.`` and a LayerNorm's ``scale`` is
its ``weight``, which the "norm" rule already covers.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

_TOKEN_PAT = re.compile(r"blocks\.(\d+)")
_ZERO_LAYER_KEYS = ("pos_embed", "patch_embed", "mask_token", "cls_token", "register_tokens")
_NO_WD_LEAF = ("bias", "bias_a1", "beta_a1")
_NO_WD_SUBSTR = ("norm", "gamma", "alpha")


def vit_lr_decay_rate(name: str, decay: float, num_layers: int) -> float:
    """Layer-wise decay: the embeddings are layer 0, block i is layer i + 1,
    everything else (norm, heads) layer ``num_layers + 1``."""
    layer_id = num_layers + 1
    if any(k in name for k in _ZERO_LAYER_KEYS):
        layer_id = 0
    else:
        m = _TOKEN_PAT.search(name)
        if m is not None:
            layer_id = int(m.group(1)) + 1
    return decay ** (num_layers + 1 - layer_id)


def build_multiplier_trees(names: Iterable[str], num_layers: int, layerwise_decay: float = 0.9,
                           patch_embed_lr_mult: float = 0.2) -> Tuple[Dict, Dict, Dict]:
    """(lr_mult, wd_mult, is_last_layer) dicts over the student's parameter
    names (``backbone.blocks.0.attn.qkv.kernel_1d``, ``dino_head.mlp_0.weight``,
    ...)."""
    lr, wd, last = {}, {}, {}
    for name in names:
        mult = vit_lr_decay_rate(name, layerwise_decay, num_layers)
        if "patch_embed" in name:
            mult *= patch_embed_lr_mult
        leaf = name.rsplit(".", 1)[-1]
        lr[name] = mult
        wd[name] = 0.0 if leaf in _NO_WD_LEAF or any(s in name for s in _NO_WD_SUBSTR) else 1.0
        last[name] = 1.0 if "last_layer" in name else 0.0
    return lr, wd, last
