"""Checkpoint conversion into the port: a JAX (flax) parameter tree -> port
``state_dict`` (:func:`params_from_jax`), and a reference PyTorch
checkpoint -> that flax layout (the port's own copy of the numpy converters
of octic_vits_tpu/utils/convert.py: :func:`convert_octic_vit`,
:func:`convert_dinov2_vit`, :func:`convert_linear_head`), the two composed
by :func:`params_from_reference`; and a released depth head -> the flax
layout of models/depth.py (:func:`convert_depth_head`).

The port names its parameters after the flax tree, so the mapping is
mechanical:

* ``blocks_{i}/...`` (unscanned trunk) -> ``blocks.{i}....``;
* the scanned trunk (``octic_blocks/block/...``, ``standard_blocks/block/...``
  or ``blocks/block/...``, a leading depth axis on every leaf; see
  octic_vits_tpu/models/scan_blocks.py) is unstacked, the standard stack of a
  hybrid model continuing after ``model.break_layer``;
* flax ``Dense.kernel [in, out]`` -> torch ``Linear.weight [out, in]``;
* flax ``Conv.kernel [kh, kw, in, out]`` -> ``Conv2d.weight [out, in, kh, kw]``,
  and JAX's ``BlockExpand.kernel [s, s, in, out]`` (models/depth.py) ->
  the ``ConvTranspose2d.weight [in, out, s, s]`` in its place;
* flax ``LayerNorm.scale`` -> ``weight`` (``bias`` keeps its name);
* every other leaf (the D8 parameters, pos-embed, cls, mask and register
  tokens, LayerScale gammas, the invariants' ``references`` and
  ``reference``, the DINO head's ``last_layer`` ``v`` and ``g``) keeps its
  name and layout.

The modules carry the flax names, so the newer layers map the same way: the
SwiGLU FFN's ``mlp.w12`` / ``mlp.w3``, the hMLP stem's ``proj{i}`` /
``norm{i}``, the parallel block's ``norm1_a`` ... ``gamma_2_b``,
``IsotypicToPatchD8``'s ``lin8`` and ``InvariantHead``'s ``LayerNorm_0``,
``Dense_0``, ``Dense_1``.

A tree of several models (the DINOv2 student ``{"backbone": ..., "dino_head":
...}``) maps onto an ``nn.ModuleDict`` with the same keys.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_SCANNED = {"octic_blocks": False, "standard_blocks": True, "blocks": False}


def _flatten(tree: Mapping, prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _unstack(flat: Dict[tuple, np.ndarray], model: nn.Module) -> Dict[tuple, np.ndarray]:
    """Trunk paths -> ``blocks.{i}``; the trunk may sit below a prefix (the
    ``backbone`` of an SSL student), whose module gives the break layer."""
    out = {}
    for path, arr in flat.items():
        for k, head in enumerate(path):
            if head in _SCANNED and len(path) > k + 2 and path[k + 1] == "block":
                trunk = model.get_submodule(".".join(path[:k]))
                offset = getattr(trunk, "break_layer", 0) if _SCANNED[head] else 0
                for i in range(arr.shape[0]):
                    out[path[:k] + ("blocks", str(i + offset)) + path[k + 2:]] = arr[i]
                break
            if head.startswith("blocks_"):
                out[path[:k] + ("blocks", head[len("blocks_"):]) + path[k + 1:]] = arr
                break
        else:
            out[path] = arr
    return out


def params_from_jax(flax_params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a flax param tree (nested dicts of arrays, with or without the
    top-level ``"params"`` collection) onto `model`'s ``state_dict`` keys,
    in the dtype and on the device of the model's own parameters. Load the
    result with ``model.load_state_dict(sd, strict=True)``."""
    tree = flax_params.get("params", flax_params)
    own = model.state_dict()
    sd = {}
    for path, arr in _unstack(_flatten(tree), model).items():
        leaf = path[-1]
        if leaf == "kernel" and arr.ndim == 4:
            # a flax conv [kh, kw, I, O] -> [O, I, kh, kw]; JAX's BlockExpand [s, s, I, O]
            # -> the ConvTranspose2d that the port has in its place, [I, O, s, s]
            owner = model.get_submodule(".".join(path[:-1]))
            perm = (2, 3, 0, 1) if isinstance(owner, nn.ConvTranspose2d) else (3, 2, 0, 1)
            path, arr = path[:-1] + ("weight",), arr.transpose(perm)
        elif leaf == "kernel":
            path, arr = path[:-1] + ("weight",), arr.T
        elif leaf == "scale":
            path = path[:-1] + ("weight",)
        key = ".".join(path)
        t = torch.from_numpy(np.array(arr, order="C"))  # a copy: JAX arrays are read-only
        if key in own:
            t = t.to(device=own[key].device, dtype=own[key].dtype)
        sd[key] = t
    return sd


# ---- reference (PyTorch) checkpoint -> flax layout --------------------------
#
# The reference state_dict layouts (reference: octic_vits/model.py for the
# OcticVisionTransformer, ParameterList pos_embed.0-5 / cls_token.0, LinearD8
# sub-linears lin_A1..lin_E, AffineD8/LayerScaleD8 alphas, LiftIrrepD8Conv2d
# quadrant weights; dinov2/models/vision_transformer.py for DINOv2) mapped
# onto the flax trees of the JAX package. Conventions: torch Linear weight
# [out,in] -> kernel [in,out]; conv weight [O,I,kh,kw] -> [kh,kw,I,O];
# ``_orig_mod.`` compile prefixes and ``module.``/``backbone.`` wrappers are
# stripped (reference: deit/main.py:417-423, dinov2/utils/utils.py:20-33).

_STRIP_PREFIXES = ("_orig_mod.", "module.", "backbone.")


def normalize_keys(state_dict: Mapping) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state_dict.items():
        changed = True
        while changed:
            changed = False
            for p in _STRIP_PREFIXES:
                if k.startswith(p):
                    k = k[len(p):]
                    changed = True
        out[k] = np.asarray(v)
    return out


def _t(w):  # torch linear -> flax kernel
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):  # [O, I, kh, kw] -> [kh, kw, I, O]
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _linear_d8(sd, prefix, has_bias):
    out = {
        "kernel_1d": np.stack([_t(sd[f"{prefix}.lin_{irr}.weight"])
                               for irr in ("A1", "A2", "B1", "B2")]),
        "kernel_e": _t(sd[f"{prefix}.lin_E.weight"]),
    }
    if has_bias and f"{prefix}.lin_A1.bias" in sd:
        out["bias_a1"] = np.asarray(sd[f"{prefix}.lin_A1.bias"])
    return out


def _scale_d8(sd, prefix, with_bias=False):
    out = {
        "alpha_1d": np.stack([np.asarray(sd[f"{prefix}.alpha_{irr}"])
                              for irr in ("A1", "A2", "B1", "B2")]),
        "alpha_e": np.asarray(sd[f"{prefix}.alpha_E"]),
    }
    if with_bias and f"{prefix}.beta" in sd:
        out["beta_a1"] = np.asarray(sd[f"{prefix}.beta"])
    return out


def _norm_d8(sd, prefix):
    return {"affine": _scale_d8(sd, f"{prefix}.scaling", with_bias=True)}


def _layer_norm(sd, prefix):
    return {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def _dense(sd, prefix):
    out = {"kernel": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def _attn_mlp(sd, p, linear):
    return {
        "attn": {"qkv": linear(sd, f"{p}.attn.qkv"), "proj": linear(sd, f"{p}.attn.proj")},
        "mlp": {"fc1": linear(sd, f"{p}.mlp.fc1"), "fc2": linear(sd, f"{p}.mlp.fc2")},
    }


def _octic_block(sd, p, style: str):
    """style: 'deit' (gamma_1/gamma_2 AffineD8) or 'dinov2' (ls1/ls2)."""
    g1, g2 = (f"{p}.gamma_1", f"{p}.gamma_2") if style == "deit" else (f"{p}.ls1", f"{p}.ls2")
    return {
        "norm1": _norm_d8(sd, f"{p}.norm1"),
        "norm2": _norm_d8(sd, f"{p}.norm2"),
        **_attn_mlp(sd, p, lambda sd_, q: _linear_d8(sd_, q, True)),
        "ls1": _scale_d8(sd, g1),
        "ls2": _scale_d8(sd, g2),
    }


def _standard_block(sd, p):
    gamma = {i: np.asarray(sd[f"{p}.gamma_{i}"] if f"{p}.gamma_{i}" in sd
                           else sd[f"{p}.ls{i}.gamma"]) for i in (1, 2)}
    return {
        "norm1": _layer_norm(sd, f"{p}.norm1"),
        "norm2": _layer_norm(sd, f"{p}.norm2"),
        **_attn_mlp(sd, p, _dense),
        "gamma_1": gamma[1],
        "gamma_2": gamma[2],
    }


def convert_octic_vit(state_dict: Mapping, depth: int, break_layer: Optional[int] = None,
                      style: str = "deit") -> Dict:
    """Reference OcticVisionTransformer state_dict -> flax params dict."""
    sd = normalize_keys(state_dict)
    brk = depth // 2 if break_layer is None else break_layer
    lift = "patch_embed.lift8.conv_"
    params: Dict = {
        "pos_embed": np.stack([np.asarray(sd[f"pos_embed.{i}"]) for i in range(6)]),
        "patch_embed": {
            **{f"w_{k.lower()}": _conv(sd[f"{lift}{k}.weight"])
               for k in ("A1", "A2", "B1", "B2", "E_left", "E_right")},
            "bias_a1": np.asarray(sd[f"{lift}A1.bias"]),
        },
        "norm": _layer_norm(sd, "norm"),
    }
    for ref, name in (("cls_token.0", "cls_token_a1"), ("mask_token.0", "mask_token_a1"),
                      ("register_tokens.0", "register_tokens_a1")):
        if ref in sd:
            params[name] = np.asarray(sd[ref])
    for i in range(depth):
        p = f"blocks.{i}"
        params[f"blocks_{i}"] = _octic_block(sd, p, style) if i < brk else _standard_block(sd, p)
    for name in ("head", "invariant_proj"):
        if f"{name}.weight" in sd:
            params[name] = _dense(sd, name)
    return params


def convert_standard_vit(state_dict: Mapping, depth: int) -> Dict:
    """Reference deit/vit.py ``vit_models`` state_dict -> flax params dict."""
    sd = normalize_keys(state_dict)
    w = sd["patch_embed.proj.weight"]
    params: Dict = {
        "pos_embed": np.asarray(sd["pos_embed"]),
        "cls_token": np.asarray(sd["cls_token"]),
        "patch_embed": {"proj": {"kernel": _conv(w).reshape(-1, w.shape[0]),
                                 "bias": np.asarray(sd["patch_embed.proj.bias"])}},
        "norm": _layer_norm(sd, "norm"),
    }
    for i in range(depth):
        params[f"blocks_{i}"] = _standard_block(sd, f"blocks.{i}")
    if "head.weight" in sd:
        params["head"] = _dense(sd, "head")
    return params


def _dinov2_block(sd, p):
    """DINOv2-layout standard block: ls1/ls2 LayerScale, Mlp or SwiGLU FFN
    (reference: dinov2/layers/block.py:43-130, swiglu_ffn.py:14-33)."""
    if f"{p}.mlp.w12.weight" in sd:
        mlp = {"w12": _dense(sd, f"{p}.mlp.w12"), "w3": _dense(sd, f"{p}.mlp.w3")}
    else:
        mlp = {"fc1": _dense(sd, f"{p}.mlp.fc1"), "fc2": _dense(sd, f"{p}.mlp.fc2")}
    return {
        "norm1": _layer_norm(sd, f"{p}.norm1"),
        "norm2": _layer_norm(sd, f"{p}.norm2"),
        "attn": {"qkv": _dense(sd, f"{p}.attn.qkv"), "proj": _dense(sd, f"{p}.attn.proj")},
        "mlp": mlp,
        "gamma_1": np.asarray(sd[f"{p}.ls1.gamma"]),
        "gamma_2": np.asarray(sd[f"{p}.ls2.gamma"]),
    }


def convert_dinov2_vit(state_dict: Mapping, depth: int) -> Dict:
    """Upstream DINOv2 ``DinoVisionTransformer`` state_dict -> flax params
    (reference: dinov2/models/vision_transformer.py:57-165). Handles
    +-register tokens and the giant's fused-SwiGLU FFN."""
    sd = normalize_keys(state_dict)
    w = sd["patch_embed.proj.weight"]
    params: Dict = {
        "cls_token": np.asarray(sd["cls_token"]),
        "pos_embed": np.asarray(sd["pos_embed"]),
        "mask_token": np.asarray(sd["mask_token"]),
        "patch_embed": {"proj": {"kernel": _conv(w).reshape(-1, w.shape[0]),
                                 "bias": np.asarray(sd["patch_embed.proj.bias"])}},
        "norm": _layer_norm(sd, "norm"),
    }
    if "register_tokens" in sd:
        params["register_tokens"] = np.asarray(sd["register_tokens"])
    for i in range(depth):
        params[f"blocks_{i}"] = _dinov2_block(sd, f"blocks.{i}")
    return params


def convert_linear_head(state_dict: Mapping) -> Dict:
    """Upstream linear-classifier head ``{weight, bias}`` -> flax Dense params
    (reference: dinov2/hub/classifiers.py:20-50)."""
    sd = normalize_keys(state_dict)
    key = "linear_head." if "linear_head.weight" in sd else ""
    return {"kernel": _t(sd[f"{key}weight"]), "bias": np.asarray(sd[f"{key}bias"])}


def params_from_reference(state_dict: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """A reference PyTorch checkpoint (tensors or arrays, wrapper prefixes
    allowed) -> `model`'s ``state_dict``: the octic models through
    :func:`convert_octic_vit` (the DINOv2 backbone's blocks in the ``ls1`` /
    ``ls2`` layout, the DeiT ones in ``gamma_1`` / ``gamma_2``), the standard
    DINOv2 backbone through :func:`convert_dinov2_vit`, then
    :func:`params_from_jax`."""
    from octic_vits_tpu_torch.models.dinov2_vit import (
        DinoVisionTransformer,
        OcticDinoVisionTransformer,
    )
    from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer

    sd = {k: v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in state_dict.items()}
    if isinstance(model, OcticVisionTransformer):
        style = "dinov2" if isinstance(model, OcticDinoVisionTransformer) else "deit"
        params = convert_octic_vit(sd, model.depth, model.break_layer, style)
    elif isinstance(model, DinoVisionTransformer):
        params = convert_dinov2_vit(sd, model.depth)
    else:
        raise TypeError(f"no reference layout for {type(model).__name__}")
    return params_from_jax(params, model)


def _conv_head(sd, prefix, bias=True):
    out = {"kernel": _conv(sd[prefix + ".weight"])}
    if bias:
        out["bias"] = np.asarray(sd[prefix + ".bias"])
    return out


def _rcu(sd, prefix):
    return {f"conv{j}": _conv_head(sd, f"{prefix}.conv{j}.conv", bias=False) for j in (1, 2)}


def convert_depth_head(state_dict: Mapping) -> Dict:
    """A released depth head's state_dict -> the flax params of JAX's
    models/depth.py, which :func:`params_from_jax` maps onto the port's
    ``BNHead`` / ``DPTHead`` (reference: dinov2/hub/depthers.py:131-138,
    220-226 load ``*_linear{,4}_head.pth`` / ``*_dpt_head.pth`` into
    ``decode_head.*`` of a DepthEncoderDecoder). ``decode_head.`` prefixes
    are stripped and ``backbone.`` keys dropped.

    * BNHead: ``conv_depth.{weight,bias}`` (a 1x1 conv);
    * DPTHead: the reassemble / convs / fusion / project / ``conv_depth.head``
      tree (reference: dinov2/hub/depth/decode_heads.py:528-747). The
      ConvTranspose2d reassemble upsamplers ``[I, O, s, s]`` become flax
      ``BlockExpand`` kernels ``[s, s, I, O]``."""
    sd = {(k[len("decode_head."):] if k.startswith("decode_head.") else k):
          (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in state_dict.items() if not k.startswith("backbone.")}
    if "reassemble_blocks.projects.0.conv.weight" not in sd:
        return {"conv_depth": _conv_head(sd, "conv_depth")}  # BNHead: the 1x1 conv alone

    rb = "reassemble_blocks"
    reassemble: Dict = {}
    for i in range(4):
        reassemble[f"readout_{i}"] = {
            "kernel": _t(sd[f"{rb}.readout_projects.{i}.0.weight"]),
            "bias": np.asarray(sd[f"{rb}.readout_projects.{i}.0.bias"])}
        reassemble[f"project_{i}"] = _conv_head(sd, f"{rb}.projects.{i}.conv")
    for i in (0, 1):
        reassemble[f"resize_{i}"] = {
            "kernel": np.ascontiguousarray(np.transpose(sd[f"{rb}.resize_layers.{i}.weight"],
                                                        (2, 3, 0, 1))),
            "bias": np.asarray(sd[f"{rb}.resize_layers.{i}.bias"])}
    reassemble["resize_3"] = _conv_head(sd, f"{rb}.resize_layers.3")

    params: Dict = {"reassemble": reassemble}
    for i in range(4):
        params[f"conv_{i}"] = _conv_head(sd, f"convs.{i}.conv", bias=False)
    for i in range(4):
        fb = f"fusion_blocks.{i}"
        params[f"fusion_{i}"] = {"project": _conv_head(sd, f"{fb}.project.conv"),
                                 "res_conv_unit2": _rcu(sd, f"{fb}.res_conv_unit2")}
        if i > 0:
            params[f"fusion_{i}"]["res_conv_unit1"] = _rcu(sd, f"{fb}.res_conv_unit1")
    params["project"] = _conv_head(sd, "project.conv")
    for name, idx in (("head_conv1", 0), ("head_conv2", 2), ("head_conv3", 4)):
        params[name] = _conv_head(sd, f"conv_depth.head.{idx}")
    return params
