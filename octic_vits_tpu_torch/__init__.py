"""octic_vits_tpu_torch — the PyTorch + CUDA port of octic_vits_tpu.

The inference slice of the hybrid octic ViT: the D8 group algebra, the
equivariant and standard layers, the hybrid and standard models, and the
four hand-written Hopper kernels the main path runs (``csrc/``, built and
bound by ``kernels/``). The JAX package stays the reference; this package
imports torch and never jax.

    from octic_vits_tpu_torch import create_model, init_weights
    model = create_model("hybrid_deit_huge_patch14", device="cuda",
                         dtype=torch.bfloat16).eval()
    init_weights(model, torch.Generator("cuda").manual_seed(0))
    logits = model(images_nhwc)
"""

from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.models.registry import create_model
from octic_vits_tpu_torch.utils.convert import params_from_jax

__version__ = "0.1.0"

__all__ = ["create_model", "init_weights", "params_from_jax"]
