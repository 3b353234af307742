"""A tiny hybrid model, configuration and mixes for the CPU tests: the cells'
entries at a size a test run holds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
NAME = "portbench_tiny_hybrid"

CONFIG = {
    "name": "tiny", "registry": NAME, "reference": "octic_vit", "weights": "vit_seeded",
    "img_size": 32, "patch_size": 4, "embed_dim": 64, "depth": 4, "break_layer": 2,
    "num_heads": 2, "mlp_ratio": 2.0, "qkv_bias": True, "num_classes": 10,
}


DINO = "portbench_tiny_dino"
DINO_CONFIG = dict(CONFIG, name="tiny_dino", registry=DINO, num_classes=0,
                   train_file="hybrid_vitl16.yaml", dino_out_dim=64, dino_head_hidden_dim=32,
                   dino_head_bottleneck_dim=16, dino_head_nlayers=3,
                   train_overrides=[f"student.arch={DINO}", "student.patch_size=4",
                                    "crops.global_crops_size=32", "crops.local_crops_size=16",
                                    "dino.head_n_prototypes=64", "ibot.head_n_prototypes=64",
                                    "dino.head_hidden_dim=32", "dino.head_bottleneck_dim=16",
                                    "compute_precision.compute_dtype=float32"])


def register() -> None:
    """Add the tiny hybrids to the program's model registry (once)."""
    from octic_vits_tpu_torch.models import registry
    from octic_vits_tpu_torch.models.dinov2_vit import OcticDinoVisionTransformer
    from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer

    if NAME in registry.list_models():
        return
    widths = dict(patch_size=4, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2.0)

    def portbench_tiny_hybrid(img_size=32, num_classes=10, **kwargs):
        return OcticVisionTransformer(img_size=img_size, qkv_bias=True,
                                      num_classes=num_classes, **widths, **kwargs)

    def portbench_tiny_dino(img_size=32, **kwargs):
        return OcticDinoVisionTransformer(img_size=img_size, **widths, **kwargs)

    registry.register_model(portbench_tiny_hybrid)
    registry.register_model(portbench_tiny_dino)


def mix(name: str, **changes) -> dict:
    """A mix of the benchmark's, at the tiny size."""
    m = copy.deepcopy(json.loads((BENCH / "mixes" / f"{name}.json").read_text()))
    m.update({"batch": 4, "img_size": 32, "pool": 3, "reference_chunk": 2, "trace_steps": 2})
    if "local_size" in m:
        m.update({"local_size": 16, "reference_local_chunk": 8})
    if "sync_every" in m:
        m["sync_every"] = 2
    m.update(changes)
    return m


def cell_names() -> list:
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    return [w["name"] for w in manifest["workloads"]]


def spec(mix_name: str, limits: dict, **changes) -> harness.CellSpec:
    register()
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    real = next(w["name"] for w in manifest["workloads"] if w["traffic"] == mix_name)
    cell = harness.find_cell(real, manifest)
    config = dict(DINO_CONFIG if mix_name.startswith("ssl") else CONFIG)
    return harness.CellSpec(real, 1, config, mix(mix_name, **changes), limits,
                            cell.end_to_end, cell.per_layer)
