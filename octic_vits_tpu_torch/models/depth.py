"""Monocular depth heads and the encoder-decoder around them: the hub depth stack
(counterpart of octic_vits_tpu/models/depth.py; reference:
dinov2/hub/depth/decode_heads.py, encoder_decoder.py, ops.py and
dinov2/hub/depthers.py).

Images come in as the port's backbones take them, NHWC ``[B, H, W, 3]``, and
depth maps go out NHWC ``[B, H', W', 1]``, as JAX's ``predict`` gives them.
The heads read the backbone's ``(patch map [B, h, w, C], cls [B, C])`` pairs
and compute NCHW inside, PyTorch's layout for the convolutions. Every
operation is a PyTorch call: the convolutions ``F.conv2d``, the
stride-equals-kernel upsamplers of the DPT reassemble stage
``nn.ConvTranspose2d`` (the reference's own layer; JAX's ``BlockExpand``
writes it as one product and a block reshape, exact for kernel == stride),
and every bilinear resize ``F.interpolate`` without antialias (JAX's two
separable interpolation matrices compute the same map). The JAX package
computes all of them outside any Pallas kernel; the card's time goes to the
backbone's kernels.

The modules carry the flax names (``conv_depth``, ``reassemble.readout_{i}``,
``fusion_{i}.res_conv_unit2.conv1``, ``head_conv3`` ...), so
``utils.convert.params_from_jax`` maps a flax head tree onto them, and a
released head goes through ``utils.convert.convert_depth_head`` first.

Only inference is provided, the reference hub's scope: its heads are built
with ``loss_decode=()`` and serve the released NYU / KITTI weights
(reference: dinov2/hub/depthers.py:36-67,167-177).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Features = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _resize(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW `x` (no antialias, ``F.interpolate``'s)."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize NHWC ``[B, H, W, C]`` -> ``[B, out_h, out_w, C]``
    (reference: dinov2/hub/depth/ops.py:resize -> F.interpolate)."""
    return _resize(x.permute(0, 3, 1, 2), out_hw, align_corners).permute(0, 2, 3, 1)


def _nchw(features: Features) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(p.permute(0, 3, 1, 2), c) for p, c in features]


def _cat_cls(patch: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """NCHW ``[B, C, h, w]`` patch map and its ``[B, C]`` cls -> ``[B, 2C, h, w]``."""
    return torch.cat([patch, cls[:, :, None, None].expand_as(patch)], dim=1)


# ---------------------------------------------------------------------------
# decode heads
# ---------------------------------------------------------------------------


def _depth_bins(strategy: str, min_depth: float, max_depth: float, n_bins: int,
                device=None) -> torch.Tensor:
    if strategy == "UD":
        return torch.linspace(min_depth, max_depth, n_bins, device=device)
    if strategy == "SID":  # torch.logspace semantics: 10**linspace
        return 10.0 ** torch.linspace(min_depth, max_depth, n_bins, device=device)
    raise ValueError(f"unknown bins_strategy {strategy}")


def _binned_depth(logit: torch.Tensor, bins: torch.Tensor, norm_strategy: str) -> torch.Tensor:
    """Adabins-style classification-regression depth: NCHW ``[B, n_bins, H,
    W]`` logits -> NHWC ``[B, H, W, 1]`` (reference: dinov2/hub/depth/
    decode_heads.py:149-172)."""
    if norm_strategy == "linear":
        logit = torch.relu(logit) + 0.1
        logit = logit / logit.sum(dim=1, keepdim=True)
    elif norm_strategy == "softmax":
        logit = torch.softmax(logit, dim=1)
    elif norm_strategy == "sigmoid":
        logit = torch.sigmoid(logit)
        logit = logit / logit.sum(dim=1, keepdim=True)
    else:
        raise ValueError(f"unknown norm_strategy {norm_strategy}")
    return torch.einsum("bkhw,k->bhw", logit, bins.to(logit.dtype))[..., None]


class BNHead(nn.Module):
    """The linear depth head: resize_concat of the (patch, cls) levels and a
    1x1 classification-regression conv (reference: dinov2/hub/depth/
    decode_heads.py:223-296 with the hub config of depthers.py:36-67). Each
    level of `embed_dim` channels becomes ``2 * embed_dim`` with its cls."""

    def __init__(self, embed_dim: int, in_index: Sequence[int] = (0, 1, 2, 3),
                 upsample: int = 4, n_bins: int = 256, bins_strategy: str = "UD",
                 norm_strategy: str = "linear", min_depth: float = 0.001,
                 max_depth: float = 80.0, align_corners: bool = False, *, device=None,
                 dtype=None):
        super().__init__()
        self.in_index = tuple(in_index)
        self.upsample = upsample
        self.n_bins = n_bins
        self.bins_strategy = bins_strategy
        self.norm_strategy = norm_strategy
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.align_corners = align_corners
        self.conv_depth = nn.Conv2d(2 * embed_dim * len(self.in_index), n_bins, 1,
                                    device=device, dtype=dtype)

    def forward(self, features: Features) -> torch.Tensor:
        dt = self.conv_depth.weight.dtype
        feats = _nchw(features)
        levels = [_cat_cls(*feats[i]).to(dt) for i in self.in_index]
        h, w = levels[0].shape[2:]
        out_hw = (h * self.upsample, w * self.upsample)
        x = torch.cat([_resize(lv, out_hw, self.align_corners) for lv in levels], dim=1)
        bins = _depth_bins(self.bins_strategy, self.min_depth, self.max_depth, self.n_bins,
                           x.device)
        return _binned_depth(self.conv_depth(x).float(), bins, self.norm_strategy)


class ReassembleBlocks(nn.Module):
    """ViT token maps -> 4 pyramid levels (reference: dinov2/hub/depth/
    decode_heads.py:528-597, readout_type='project'): the 'project' readout
    (Linear 2C -> C, exact GELU), a 1x1 project, then ConvTranspose2d x4,
    ConvTranspose2d x2, identity, and a 3x3 stride-2 conv."""

    def __init__(self, in_channels: int, out_channels: Sequence[int], *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        oc = list(out_channels)
        for i in range(4):
            setattr(self, f"readout_{i}", nn.Linear(2 * in_channels, in_channels, **kw))
            setattr(self, f"project_{i}", nn.Conv2d(in_channels, oc[i], 1, **kw))
        self.resize_0 = nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **kw)
        self.resize_1 = nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **kw)
        self.resize_3 = nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **kw)

    def forward(self, features: Features) -> List[torch.Tensor]:
        outs = []
        for i, (patch, cls) in enumerate(features):
            x = torch.cat([patch, cls[:, None, None, :].expand_as(patch)], dim=-1)
            x = F.gelu(getattr(self, f"readout_{i}")(x))             # NHWC [B, h, w, C]
            x = getattr(self, f"project_{i}")(x.permute(0, 3, 1, 2))  # NCHW from here on
            if i in (0, 1, 3):
                x = getattr(self, f"resize_{i}")(x)
            outs.append(x)
        return outs


class PreActResidualConvUnit(nn.Module):
    """act -> conv -> act -> conv + skip (reference: decode_heads.py:600-641;
    the hub config has norm_layer=None, so the convs have no bias)."""

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False, **kw)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(torch.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Merge one pyramid level into the running decode state (reference:
    decode_heads.py:644-687); the first block has no ``res_conv_unit1``."""

    def __init__(self, channels: int, first: bool = False, align_corners: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.align_corners = align_corners
        self.res_conv_unit1 = None if first else PreActResidualConvUnit(channels, **kw)
        self.res_conv_unit2 = PreActResidualConvUnit(channels, **kw)
        self.project = nn.Conv2d(channels, channels, 1, **kw)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None) -> torch.Tensor:
        if res is not None:
            res = _resize(res, x.shape[2:], align_corners=False)
            x = x + self.res_conv_unit1(res)
        x = self.res_conv_unit2(x)
        x = _resize(x, (x.shape[2] * 2, x.shape[3] * 2), self.align_corners)
        return self.project(x)


class DPTHead(nn.Module):
    """Dense Prediction Transformer decode head (reference:
    decode_heads.py:690-747 with the hub config of depthers.py:167-177:
    channels=256, readout 'project', norm None, classify=False)."""

    def __init__(self, embed_dim: int, channels: int = 256,
                 post_process_channels: Optional[Sequence[int]] = None,
                 min_depth: float = 0.001, max_depth: float = 10.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ppc = list(post_process_channels or [embed_dim // 2 ** (3 - i) for i in range(4)])
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.reassemble = ReassembleBlocks(embed_dim, ppc, **kw)
        for i in range(4):
            setattr(self, f"conv_{i}", nn.Conv2d(ppc[i], channels, 3, padding=1, bias=False,
                                                 **kw))
            setattr(self, f"fusion_{i}", FeatureFusionBlock(channels, first=i == 0, **kw))
        self.project = nn.Conv2d(channels, channels, 3, padding=1, **kw)
        # HeadDepth (reference: decode_heads.py:512-525)
        self.head_conv1 = nn.Conv2d(channels, channels // 2, 3, padding=1, **kw)
        self.head_conv2 = nn.Conv2d(channels // 2, 32, 3, padding=1, **kw)
        self.head_conv3 = nn.Conv2d(32, 1, 1, **kw)

    def forward(self, features: Features) -> torch.Tensor:
        dt = self.project.weight.dtype
        x = self.reassemble([(p.to(dt), c.to(dt)) for p, c in features])
        x = [getattr(self, f"conv_{i}")(f) for i, f in enumerate(x)]
        out = self.fusion_0(x[-1])
        for i in range(1, 4):
            out = getattr(self, f"fusion_{i}")(out, x[-(i + 1)])
        out = self.head_conv1(torch.relu(self.project(out)))
        out = _resize(out, (out.shape[2] * 2, out.shape[3] * 2), align_corners=True)
        out = self.head_conv3(torch.relu(self.head_conv2(out)))
        # depth_pred, classify=False, scale_up=False (decode_heads.py:173-177)
        return (torch.relu(out.float()) + self.min_depth).permute(0, 2, 3, 1)


def lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of `module` as flax's default ``lecun_normal`` (a
    normal truncated at 2 std, std ``sqrt(1 / fan_in)`` before truncation)
    and zero every bias. The fan-in is the flax kernel's: ``I * kh * kw``
    for a conv, ``I * s * s`` for a transposed conv (JAX's ``BlockExpand``),
    ``I`` for a linear."""
    from octic_vits_tpu_torch.layers.d8_layers import trunc_normal_

    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
        else:
            continue
        trunc_normal_(m.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
        if m.bias is not None:
            nn.init.zeros_(m.bias)


# ---------------------------------------------------------------------------
# the encoder-decoder
# ---------------------------------------------------------------------------


def center_padding(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Center-pad H and W of NHWC `x` with zeros up to a multiple of the patch
    size (reference: dinov2/hub/utils.py:CenterPadding)."""
    pads = []
    for size in (x.shape[2], x.shape[1]):  # F.pad lists the last padded axis first
        new = math.ceil(size / multiple) * multiple
        lo = (new - size) // 2
        pads += [lo, new - size - lo]
    return F.pad(x, [0, 0] + pads)


class DepthEncoderDecoder(nn.Module):
    """Backbone + decode head for inference (reference: dinov2/hub/depth/
    encoder_decoder.py:34-216). The head reads the backbone's
    ``get_intermediate_layers(out_index, reshape=True, return_class_token=True,
    norm=False)``; :meth:`predict` (and ``forward``) takes NHWC images
    ``[B, H, W, 3]`` and returns ``[B, H', W', 1]`` depth, whole or
    sliding-window. Use it in ``eval()`` mode: the backbone then runs its
    inference kernels on the card."""

    def __init__(self, backbone: nn.Module, head: nn.Module, out_index: Sequence[int],
                 patch_size: int, min_depth: float, max_depth: float,
                 align_corners: bool = False):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.out_index = list(out_index)
        self.patch_size = patch_size
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.align_corners = align_corners

    def features(self, x: torch.Tensor) -> tuple:
        return self.backbone.get_intermediate_layers(x, self.out_index, reshape=True,
                                                     return_class_token=True, norm=False)

    def encode_decode(self, img: torch.Tensor,
                      out_size: Optional[Tuple[int, int]]) -> torch.Tensor:
        depth = self.head(self.features(center_padding(img, self.patch_size)))
        depth = depth.clamp(self.min_depth, self.max_depth)
        if out_size is None:
            out_size = (img.shape[1], img.shape[2])
        return resize_bilinear(depth, out_size, self.align_corners)

    def whole_inference(self, img: torch.Tensor,
                        out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return self.encode_decode(img, out_size)

    @staticmethod
    def slide_windows(h: int, w: int, stride: Tuple[int, int],
                      crop_size: Tuple[int, int]) -> List[Tuple[int, int]]:
        """The crop grid's top-left corners, de-duplicated in order: JAX's grid
        (reference: encoder_decoder.py:119-151), whose last row and column
        are pulled back inside the image."""
        h_st, w_st = stride
        h_cr, w_cr = min(crop_size[0], h), min(crop_size[1], w)
        grids = [(min(y, h - h_cr), min(x, w - w_cr))
                 for y in range(0, max(h - h_cr, 0) + h_st, h_st)
                 for x in range(0, max(w - w_cr, 0) + w_st, w_st)]
        return list(dict.fromkeys(grids))

    def slide_inference(self, img: torch.Tensor, stride: Tuple[int, int],
                        crop_size: Tuple[int, int]) -> torch.Tensor:
        """Overlap-averaged sliding-window inference: each window through
        :meth:`encode_decode` at the crop's size, the sums divided by each
        pixel's count of windows."""
        b, h, w, _ = img.shape
        h_cr, w_cr = min(crop_size[0], h), min(crop_size[1], w)
        preds = torch.zeros(b, h, w, 1, device=img.device, dtype=torch.float32)
        count = torch.zeros(1, h, w, 1, device=img.device, dtype=torch.float32)
        for y1, x1 in self.slide_windows(h, w, stride, crop_size):
            crop = img[:, y1:y1 + h_cr, x1:x1 + w_cr]
            preds[:, y1:y1 + h_cr, x1:x1 + w_cr] += self.encode_decode(crop, (h_cr, w_cr))
            count[:, y1:y1 + h_cr, x1:x1 + w_cr] += 1.0
        return preds / count

    @torch.no_grad()
    def predict(self, img: torch.Tensor, mode: str = "whole",
                stride: Tuple[int, int] = (171, 171), crop_size: Tuple[int, int] = (352, 352),
                flip: bool = False, out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``[B, H, W, 3]`` -> ``[B, H', W', 1]`` depth map. `flip` flips the
        output's width axis only, as JAX does (models/depth.py:422-423); the
        reference's pipeline flips the input too."""
        if mode not in ("whole", "slide"):
            raise ValueError(f"unknown mode {mode!r}: 'whole' or 'slide'")
        if mode == "slide":
            out = self.slide_inference(img, stride, crop_size)
        else:
            out = self.whole_inference(img, out_size)
        return out.flip(2) if flip else out

    forward = predict
