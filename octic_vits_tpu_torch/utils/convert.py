"""JAX (flax) parameter tree -> port ``state_dict``.

The port names its parameters after the flax tree, so the mapping is
mechanical:

* ``blocks_{i}/...`` (unscanned trunk) -> ``blocks.{i}....``;
* the scanned trunk (``octic_blocks/block/...``, ``standard_blocks/block/...``
  or ``blocks/block/...``, a leading depth axis on every leaf; see
  octic_vits_tpu/models/scan_blocks.py) is unstacked, the standard stack of a
  hybrid model continuing after ``model.break_layer``;
* flax ``Dense.kernel [in, out]`` -> torch ``Linear.weight [out, in]``;
* flax ``LayerNorm.scale`` -> ``weight`` (``bias`` keeps its name);
* every other leaf (the D8 parameters, pos-embed, cls token, LayerScale
  gammas) keeps its name and layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
    out = {}
    for path, arr in flat.items():
        head = path[0]
        if head in _SCANNED and len(path) > 2 and path[1] == "block":
            offset = getattr(model, "break_layer", 0) if _SCANNED[head] else 0
            for i in range(arr.shape[0]):
                out[("blocks", str(i + offset)) + path[2:]] = arr[i]
        elif head.startswith("blocks_"):
            out[("blocks", head[len("blocks_"):]) + path[1:]] = arr
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
        if leaf == "kernel":
            path, arr = path[:-1] + ("weight",), arr.T
        elif leaf == "scale":
            path = path[:-1] + ("weight",)
        key = ".".join(path)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if key in own:
            t = t.to(device=own[key].device, dtype=own[key].dtype)
        sd[key] = t
    return sd
