"""octic_vits_tpu_torch — the PyTorch + CUDA port of octic_vits_tpu.

The inference, DeiT III and DINOv2 training slices of the hybrid octic ViT:
the D8 group algebra, the equivariant and standard layers, the hybrid and
standard models with the DINOv2 backbones and head, mixup/cutmix
(``data``), the train state, LAMB, the DeiT III train step and the DINOv2
SSL step (``train``), and the hand-written Hopper kernels those paths run
(``csrc/``, built and bound by ``kernels/``). The JAX package stays the
reference; this package imports torch and never jax.

    from octic_vits_tpu_torch import create_model, init_weights
    model = create_model("hybrid_deit_huge_patch14", device="cuda",
                         dtype=torch.bfloat16).eval()
    init_weights(model, torch.Generator("cuda").manual_seed(0))
    logits = model(images_nhwc)

Training (f32 parameters, bf16 compute, remat; see train/deit/engine.py):

    model = create_model("hybrid_deit_huge_patch14",
                         remat=True, drop_path_rate=cfg.drop_path,
                         compute_dtype=torch.bfloat16, device="cuda")
    opt = build_optimizer(cfg, model)
    state, step = create_train_state(model, opt, ema=True), make_deit_train_step(model, cfg, opt)
    state, metrics = step(state, images, labels, torch.Generator().manual_seed(0))
"""

from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.models.registry import create_model
from octic_vits_tpu_torch.utils.convert import params_from_jax

__version__ = "0.1.0"

__all__ = ["create_model", "init_weights", "params_from_jax"]
