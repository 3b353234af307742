"""Hub entry points: named backbones and linear classifiers from reference
checkpoints (counterpart of octic_vits_tpu/hub.py; reference:
dinov2/hub/backbones.py:64-156, dinov2/hub/classifiers.py:52-268).

Each entry names a registered model and the layout of its released
checkpoint. A ``.pth`` file is read with ``torch.load(weights_only=True)``,
its `checkpoint_key` sub-dict converted by ``params_from_reference`` and
loaded strictly; a checkpoint directory of the port (``utils.checkpoint``)
is loaded as it is. Nothing is downloaded: the caller gives local files. The
orbax checkpoints of the JAX package need JAX and are refused. The depthers
(:func:`load_depther`, reference: dinov2/hub/depthers.py) put a depth head of
models/depth.py on a DINOv2 backbone.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import torch
from torch import nn

from octic_vits_tpu_torch.layers.d8_layers import trunc_normal_
from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.layers.vit_layers import Linear
from octic_vits_tpu_torch.models.registry import create_model
from octic_vits_tpu_torch.utils.convert import (
    convert_depth_head,
    convert_linear_head,
    params_from_jax,
    params_from_reference,
)
from octic_vits_tpu_torch.utils.checkpoint import backbone_state_dict, load_tree


@dataclasses.dataclass(frozen=True)
class HubEntry:
    arch: str
    depth: int
    style: str            # 'deit' | 'dinov2'
    patch_size: int
    num_register_tokens: int = 0
    # 'octic' = OcticVisionTransformer checkpoints (convert_octic_vit);
    # 'dinov2_std' = upstream DINOv2 DinoVisionTransformer checkpoints
    # (convert_dinov2_vit; reference: dinov2/hub/backbones.py:64-156)
    family: str = "octic"
    embed_dim: int = 0     # informational (dinov2_std head sizing)


HUB_ENTRIES: Dict[str, HubEntry] = {
    # DeiT III supervised releases (reference: README.md:100-143)
    "hybrid_deit_huge_patch14": HubEntry("hybrid_deit_huge_patch14", 32, "deit", 14),
    "hybrid_deit_large_patch16": HubEntry("hybrid_deit_large_patch16", 24, "deit", 16),
    "d8_inv_early_deit_huge_patch14": HubEntry("d8_inv_early_deit_huge_patch14", 32, "deit", 14),
    "d8_inv_early_deit_large_patch16": HubEntry("d8_inv_early_deit_large_patch16", 24, "deit", 16),
    # DINOv2 SSL teacher backbones (reference: README.md:150-208)
    "hybrid_dinov2_vit_huge_patch16": HubEntry("hybrid_dinov2_vit_huge_patch16", 32, "dinov2", 16),
    "hybrid_dinov2_vit_large_patch16": HubEntry("hybrid_dinov2_vit_large_patch16", 24, "dinov2",
                                                16),
    "d8_inv_early_dinov2_vit_huge_patch16": HubEntry("d8_inv_early_dinov2_vit_huge_patch16", 32,
                                                     "dinov2", 16),
    "d8_inv_early_dinov2_vit_large_patch16": HubEntry("d8_inv_early_dinov2_vit_large_patch16", 24,
                                                      "dinov2", 16),
}

# upstream DINOv2 backbones (reference: dinov2/hub/backbones.py:64-156);
# weights-file-driven: the released *_pretrain.pth path is `checkpoint`
for _tag, _depth, _dim in (("dinov2_vits14", 12, 384), ("dinov2_vitb14", 12, 768),
                           ("dinov2_vitl14", 24, 1024), ("dinov2_vitg14", 40, 1536)):
    HUB_ENTRIES[_tag] = HubEntry(_tag, _depth, "dinov2", 14, family="dinov2_std", embed_dim=_dim)
    HUB_ENTRIES[_tag + "_reg"] = HubEntry(_tag + "_reg", _depth, "dinov2", 14,
                                          num_register_tokens=4, family="dinov2_std",
                                          embed_dim=_dim)


def load_backbone(name: str, checkpoint: Optional[str] = None, checkpoint_key: str = "teacher",
                  img_size: int = 224, dtype: torch.dtype = torch.bfloat16, device=None,
                  **model_kwargs) -> nn.Module:
    """Build a named backbone (parameters in `dtype`, on the card unless
    `device` names another) and load `checkpoint`: a torch ``.pth`` file,
    from its `checkpoint_key` sub-dict ('teacher' / 'model', else the whole
    file: the reference's load_pretrained_weights, dinov2/utils/utils.py:20-33),
    or a checkpoint directory of the port (a teacher export of the SSL loop,
    a train-state checkpoint or a ``best`` export, ``utils.checkpoint``); an
    orbax directory of the JAX package raises ``NotImplementedError``.
    Without a checkpoint the parameters are drawn by ``init_weights`` from a
    generator seeded 0, so the model is always callable."""
    if name not in HUB_ENTRIES:
        raise KeyError(f"unknown hub entry {name}; known: {sorted(HUB_ENTRIES)}")
    tree = None
    if checkpoint is not None and os.path.isdir(checkpoint):
        tree = load_tree(checkpoint)  # the port's format; an orbax directory raises
    model = create_model(name, img_size=img_size, dtype=dtype, device=device, **model_kwargs)
    if checkpoint is None:
        init_weights(model, torch.Generator(model.pos_embed.device).manual_seed(0))
        return model
    if tree is not None:
        model.load_state_dict(backbone_state_dict(tree, checkpoint_key), strict=True)
        return model
    blob = torch.load(checkpoint, map_location="cpu", weights_only=True)
    sd = blob.get(checkpoint_key, blob.get("model", blob))
    model.load_state_dict(params_from_reference(sd, model), strict=True)
    return model


class HubLinearClassifier(nn.Module):
    """Backbone + IN1K linear head (the reference's ``*_lc`` entries): the
    head reads cat(cls of the last `layers` blocks, mean patch token of the
    last block) from ``get_intermediate_layers``."""

    def __init__(self, backbone: nn.Module, head: nn.Module, layers: int):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.layers = layers

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        outs = self.backbone.get_intermediate_layers(images, self.layers, reshape=False,
                                                     return_class_token=True)
        feats = torch.cat([c for _, c in outs] + [outs[-1][0].mean(dim=1)], dim=-1)
        return self.head(feats)


def load_linear_classifier(name: str, backbone_checkpoint: Optional[str] = None,
                           head_checkpoint: Optional[str] = None, layers: int = 4,
                           img_size: int = 224, dtype: torch.dtype = torch.bfloat16, device=None,
                           **model_kwargs) -> HubLinearClassifier:
    """Backbone + IN1K linear head (reference: dinov2/hub/classifiers.py:52-268),
    `layers` in (1, 4). The head comes from `head_checkpoint` (``{weight,
    bias}`` or ``linear_head.*``), else it is drawn as flax's ``Dense``
    starts (LeCun truncated normal, zero bias) from a generator seeded 0.
    DeiT-style entries have no ``get_intermediate_layers`` and raise."""
    if layers not in (1, 4):
        raise ValueError(f"unsupported layers={layers}")
    if name in HUB_ENTRIES and HUB_ENTRIES[name].style != "dinov2":
        raise ValueError(f"{name} is a DeiT-style backbone without get_intermediate_layers; "
                         f"the linear classifiers read DINOv2 backbones")
    backbone = load_backbone(name, backbone_checkpoint, img_size=img_size, dtype=dtype,
                             device=device, **model_kwargs)
    p = backbone.pos_embed
    head = Linear((layers + 1) * backbone.embed_dim, 1000, device=p.device, dtype=dtype)
    if head_checkpoint is not None:
        blob = torch.load(head_checkpoint, map_location="cpu", weights_only=True)
        sd = {k: v.float().numpy() for k, v in blob.items()}
        head.load_state_dict(params_from_jax(convert_linear_head(sd), head), strict=True)
    else:
        std = math.sqrt(1.0 / head.in_features) / 0.87962566103423978
        trunc_normal_(head.weight, std, torch.Generator(p.device).manual_seed(0))
        nn.init.zeros_(head.bias)
    return HubLinearClassifier(backbone, head, layers)


# depther out_index per arch (reference: dinov2/hub/depthers.py:103-119)
_DEPTH_OUT_INDEX = {
    "dinov2_vits14": [2, 5, 8, 11],
    "dinov2_vitb14": [2, 5, 8, 11],
    "dinov2_vitl14": [4, 11, 17, 23],
    "dinov2_vitg14": [9, 19, 29, 39],
}
_DEPTH_RANGES = {"NYU": (0.001, 10.0), "KITTI": (0.001, 80.0)}


def load_depther(name: str, head_type: str = "dpt", weights: str = "NYU", layers: int = 4,
                 backbone_checkpoint: Optional[str] = None, head_checkpoint: Optional[str] = None,
                 img_size: int = 224, dtype: torch.dtype = torch.float32, device=None,
                 **model_kwargs):
    """Backbone + depth head, the reference's ``*_ld`` / ``*_dd`` hub entries
    (reference: dinov2/hub/depthers.py:70-140 linear, 180-246 DPT), as a
    ``models.depth.DepthEncoderDecoder`` in eval mode whose ``predict(images
    [B, H, W, 3], mode="whole" | "slide", flip=...)`` returns ``[B, H, W, 1]``
    depth. The backbone comes through :func:`load_backbone`
    (`backbone_checkpoint`, else seeded weights), the head from
    `head_checkpoint` (a released ``*_head.pth``, its ``state_dict`` sub-dict
    or the whole file) through ``utils.convert.convert_depth_head``. Both are
    built with parameters in `dtype` on `device` (the card unless it names
    another).

    `head_type` "linear" is a BNHead on the last block (`layers` 1) or on
    the four blocks of ``_DEPTH_OUT_INDEX`` (`layers` 4), its bins on (0.001,
    80) whatever the dataset, as the reference factory (depthers.py:53-67)
    and JAX (hub.py:221-222) have them; "dpt" a DPTHead on those four
    blocks. `weights` ("NYU" or "KITTI") sets the clamp range of the depth.
    Without a head checkpoint the head is drawn as flax's defaults draw it
    (``models.depth.lecun_normal_``) from a ``torch.Generator`` seeded 0: the
    same distribution as JAX's ``PRNGKey(0)`` init, not the same numbers."""
    from octic_vits_tpu_torch.models.depth import (
        BNHead,
        DepthEncoderDecoder,
        DPTHead,
        lecun_normal_,
    )

    base = name.removesuffix("_reg")
    if base not in _DEPTH_OUT_INDEX:
        raise KeyError(f"no depther for {name}; known: {sorted(_DEPTH_OUT_INDEX)}")
    if weights not in _DEPTH_RANGES:
        raise KeyError(f"unknown weights {weights}; known NYU, KITTI")
    min_depth, max_depth = _DEPTH_RANGES[weights]
    if head_type == "linear" and layers not in (1, 4):
        raise ValueError(f"unsupported layers={layers}")
    if head_type not in ("linear", "dpt"):
        raise ValueError(f"unknown head_type {head_type}")

    backbone = load_backbone(name, checkpoint=backbone_checkpoint, img_size=img_size,
                             dtype=dtype, device=device, **model_kwargs)
    entry = HUB_ENTRIES[name]
    kw = dict(device=backbone.pos_embed.device, dtype=dtype)
    if head_type == "linear":
        out_index = _DEPTH_OUT_INDEX[base] if layers == 4 else [entry.depth - 1]
        head = BNHead(entry.embed_dim, in_index=tuple(range(layers)), upsample=4,
                      min_depth=0.001, max_depth=80.0, **kw)
    else:
        out_index = _DEPTH_OUT_INDEX[base]
        head = DPTHead(entry.embed_dim, channels=256, min_depth=min_depth, max_depth=max_depth,
                       **kw)
    if head_checkpoint is not None:
        blob = torch.load(head_checkpoint, map_location="cpu", weights_only=True)
        sd = blob.get("state_dict", blob)
        head.load_state_dict(params_from_jax(convert_depth_head(sd), head), strict=True)
    else:
        lecun_normal_(head, torch.Generator(kw["device"]).manual_seed(0))
    return DepthEncoderDecoder(backbone, head, out_index, patch_size=entry.patch_size,
                               min_depth=min_depth, max_depth=max_depth).eval()
