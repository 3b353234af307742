"""Evaluation suites: k-NN, linear-probe grid, attention-pool probe,
segmentation probing, metrics (counterpart of octic_vits_tpu/eval).

Functional analogs of the reference wrapper modules
(reference: dinov2/eval/utils.py:21-45): `with_normalize(fn)` L2-normalizes
features; `with_intermediate_layers(model, n)` returns the frozen
n-last-blocks feature extractor the linear probe uses. The suites compute
where their input tensors live; ``eval.distributed`` extracts a dataset's
features over processes and merges them on every process, and
``knn_classify_sharded`` splits the k-NN bank over a mesh.
"""

import torch

from octic_vits_tpu_torch.eval.attnpool import (
    AttnPoolClassifier,
    LinearClassifier,
    train_attnpool_probe,
    train_probe_grid,
)
from octic_vits_tpu_torch.eval.distributed import (
    extract_features_sharded,
    gather_features_across_processes,
)
from octic_vits_tpu_torch.eval.knn import (
    evaluate_knn,
    extract_features,
    knn_classify,
    knn_classify_sharded,
)
from octic_vits_tpu_torch.eval.linear import (
    LinearProbeBank,
    ProbeVariant,
    build_probe_features,
    train_and_eval_linear_probes,
)
from octic_vits_tpu_torch.eval.metrics import (
    confusion_matrix,
    miou_from_confusion,
    real_labels_accuracy,
    topk_accuracy,
)
from octic_vits_tpu_torch.eval.segmentation import (
    KNNSegProbe,
    LogregSegProbe,
    evaluate_seg_probes,
    extract_patch_features,
)


def with_normalize(feature_fn):
    """L2-normalize extracted features as ``x / (||x|| + 1e-12)``
    (reference: eval/utils.py:21-27)."""

    def fn(x):
        f = feature_fn(x)
        return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)

    return fn


def with_intermediate_layers(model, n: int = 4):
    """Frozen ``get_intermediate_layers`` extractor (reference:
    eval/utils.py:30-45): the model in eval mode under ``torch.no_grad()``,
    ``(patch tokens, cls)`` of the last `n` blocks through the final norm."""

    def fn(x):
        model.eval()
        with torch.no_grad():
            return model.get_intermediate_layers(x, n, reshape=False, return_class_token=True)

    return fn


__all__ = [
    "AttnPoolClassifier", "KNNSegProbe", "LinearClassifier", "LinearProbeBank", "LogregSegProbe",
    "ProbeVariant", "build_probe_features", "confusion_matrix", "evaluate_knn",
    "evaluate_seg_probes", "extract_features", "extract_features_sharded",
    "extract_patch_features", "gather_features_across_processes", "knn_classify",
    "knn_classify_sharded", "miou_from_confusion", "real_labels_accuracy", "topk_accuracy", "train_and_eval_linear_probes",
    "train_attnpool_probe", "train_probe_grid", "with_intermediate_layers", "with_normalize",
]
