"""Models of the ported slices and their registry."""

from octic_vits_tpu_torch.models.dino_head import DINOHead, WeightNormDense
from octic_vits_tpu_torch.models.dinov2_vit import DinoVisionTransformer, OcticDinoVisionTransformer
from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer
from octic_vits_tpu_torch.models.registry import create_model
from octic_vits_tpu_torch.models.vit import VisionTransformer

__all__ = ["DINOHead", "DinoVisionTransformer", "OcticDinoVisionTransformer",
           "OcticVisionTransformer", "VisionTransformer", "WeightNormDense", "create_model"]
