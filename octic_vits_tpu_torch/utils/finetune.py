"""Finetuning utilities (counterpart of octic_vits_tpu/utils/finetune.py).

* :func:`load_pretrained_for_finetune`: a pretrained checkpoint merged into a
  model's state_dict the way the reference's finetuning does
  (deit/main.py:282-338);
* :func:`interpolate_vit_pos_embed`: a standard ViT's per-patch pos-embed
  resized bicubically to another grid (deit/main.py:296-314). The octic
  models' quadrant pos-embed resizes inside their forward;
* :func:`attn_only_trainable_mask`: the attention-only finetuning mask
  (deit/main.py:318-338) as the name -> bool dict that
  ``train.deit.engine.make_deit_train_step`` takes.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import torch
from torch import nn

from octic_vits_tpu_torch.d8.posembed import resize_grid


def interpolate_vit_pos_embed(pos_embed: torch.Tensor, new_grid: int) -> torch.Tensor:
    """``[1, N, C]`` (no cls slot, N a square grid) -> ``[1, new_grid^2, C]``."""
    n, c = pos_embed.shape[1], pos_embed.shape[2]
    g = math.isqrt(n)
    if g * g != n:
        raise ValueError(f"pos embed of {n} tokens is not a square grid")
    out = resize_grid(pos_embed.reshape(g, g, c), (new_grid, new_grid))
    return out.reshape(1, new_grid * new_grid, c)


def load_pretrained_for_finetune(path: str, model: nn.Module,
                                 checkpoint_key: str = "model") -> Dict[str, torch.Tensor]:
    """`model`'s state_dict with a pretrained checkpoint merged in; load it
    with ``model.load_state_dict(sd, strict=True)``.

    `path` is a reference-layout torch ``.pth`` file (`checkpoint_key`
    selects its sub-dict, as the reference's ``checkpoint['model']``) or a
    checkpoint directory of this port (a DeiT or SSL train state, a ``best``
    export or a teacher export), of which the backbone is taken as
    ``hub.load_backbone`` takes it (``utils.checkpoint.backbone_state_dict``).
    The merge is the reference's: a tensor whose shape differs from the
    model's (a head for another class count) keeps the model's value; a standard ViT's ``pos_embed`` on another grid
    is bicubic-interpolated; what the checkpoint lacks keeps the model's
    value. A checkpoint of which no tensor is taken raises ``ValueError``."""
    merged, n_loaded = _merge(model.state_dict(), _load_state_dict(path, model, checkpoint_key))
    if not n_loaded:
        raise ValueError(f"{path}: no tensor of the checkpoint matches a parameter of the model "
                         f"by name and shape; finetuning from it would start from scratch")
    return merged


def _load_state_dict(path: str, model: nn.Module, checkpoint_key: str) -> Dict[str, torch.Tensor]:
    if os.path.isdir(path):
        from octic_vits_tpu_torch.utils.checkpoint import backbone_state_dict, load_tree

        return backbone_state_dict(load_tree(path), checkpoint_key)

    from octic_vits_tpu_torch.utils import convert as C

    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = C.normalize_keys(blob.get(checkpoint_key, blob.get("model", blob)))
    depth = 1 + max((int(k.split(".")[1]) for k in sd if k.startswith("blocks.")), default=0)
    if any(".lin_A1." in k or "cls_token.0" in k for k in sd):
        params = C.convert_octic_vit(sd, depth)
    else:
        params = C.convert_standard_vit(sd, depth)
    return C.params_from_jax(params, model)


def _merge(own: Dict[str, torch.Tensor], loaded: Dict[str, torch.Tensor]) -> tuple:
    """(the merged state_dict, the number of tensors taken from `loaded`)."""
    out, n_loaded = {}, 0
    for name, value in own.items():
        got = loaded.get(name)
        out[name] = value
        if got is None:
            continue
        if tuple(got.shape) == tuple(value.shape):
            out[name] = got.to(device=value.device, dtype=value.dtype)
            n_loaded += 1
        elif "pos_embed" in name and got.ndim == 3 and value.ndim == 3:
            grid = math.isqrt(value.shape[1])
            if grid * grid == value.shape[1]:
                resized = interpolate_vit_pos_embed(got.float(), grid)
                if tuple(resized.shape) == tuple(value.shape):
                    out[name] = resized.to(device=value.device, dtype=value.dtype)
                    n_loaded += 1
    return out, n_loaded


def attn_only_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """True = trainable: the attention, norm1, cls token and pos-embed."""
    return {name: any(s in name for s in ("attn", "norm1", "cls_token", "pos_embed"))
            for name, _ in model.named_parameters()}
