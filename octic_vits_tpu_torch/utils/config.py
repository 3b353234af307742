"""Config system: YAML tree with default <- file <- dotlist merge (the port's
own copy of octic_vits_tpu/utils/config.py).

Replaces the reference's OmegaConf stack (reference:
dinov2/configs/__init__.py:14-26, dinov2/utils/config.py:21-73) with a small
attribute-dict and the same merge semantics, env-var interpolation
(`${IMAGENET_PATH}`) and the sqrt lr scaling applied at setup. PyYAML is
imported where a file or a dotlist value is parsed. The port's YAML files
live in `octic_vits_tpu_torch/configs/` (:data:`CONFIG_DIR`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

_ENV_PAT = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")


class ConfigNode(dict):
    """dict with attribute access, recursive."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def from_dict(d: Dict) -> "ConfigNode":
        node = ConfigNode()
        for k, v in d.items():
            node[k] = ConfigNode.from_dict(v) if isinstance(v, dict) else v
        return node

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()}


def _interpolate_env(value):
    if isinstance(value, str):
        return _ENV_PAT.sub(lambda m: os.environ.get(m.group(1), ""), value)
    return value


def _merge(base: ConfigNode, override: Dict) -> ConfigNode:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), ConfigNode):
            _merge(base[k], v)
        else:
            base[k] = ConfigNode.from_dict(v) if isinstance(v, dict) else _interpolate_env(v)
    return base


def load_yaml(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def apply_dotlist(cfg: ConfigNode, opts: List[str]) -> ConfigNode:
    """["optim.lr=0.004", "train.batch_size_per_gpu=32"] overrides."""
    import yaml

    for opt in opts:
        key, _, raw = opt.partition("=")
        value = yaml.safe_load(raw)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigNode):
                node[p] = ConfigNode()
            node = node[p]
        node[parts[-1]] = _interpolate_env(value)
    return cfg


def _interpolate_tree(node: ConfigNode) -> ConfigNode:
    for k, v in node.items():
        if isinstance(v, ConfigNode):
            _interpolate_tree(v)
        else:
            node[k] = _interpolate_env(v)
    return node


def build_config(default: Dict, config_file: Optional[str] = None,
                 opts: Optional[List[str]] = None) -> ConfigNode:
    cfg = ConfigNode.from_dict(default)
    if config_file:
        cfg = _merge(cfg, load_yaml(config_file))
    if opts:
        cfg = apply_dotlist(cfg, opts)
    return _interpolate_tree(cfg)


def write_config(cfg: ConfigNode, output_dir: str, name: str = "config.yaml") -> str:
    import yaml

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return path
