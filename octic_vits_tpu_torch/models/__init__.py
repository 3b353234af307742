"""Models of the inference slice and their registry."""

from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer
from octic_vits_tpu_torch.models.registry import create_model
from octic_vits_tpu_torch.models.vit import VisionTransformer

__all__ = ["OcticVisionTransformer", "VisionTransformer", "create_model"]
