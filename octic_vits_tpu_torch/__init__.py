"""octic_vits_tpu_torch — the PyTorch + CUDA port of octic_vits_tpu.

The inference, DeiT III and DINOv2 training slices of the hybrid octic ViT:
the D8 group algebra, the equivariant and standard layers, the hybrid and
standard models with the DINOv2 backbones and head, mixup/cutmix
(``data``), the train state, LAMB, the DeiT III train step and the DINOv2
SSL step (``train``), and the hand-written Hopper kernels those paths run
(``csrc/``, built and bound by ``kernels/``). The JAX package stays the
reference; this package imports torch and never jax.

The entry points (``create_model``, ``SSLMetaArch``) build on the CUDA card
unless the caller names another device; without a card they raise rather
than fall back to the CPU. CPU callers pass ``device="cpu"``, where every
kernel op runs its plain PyTorch version.

    from octic_vits_tpu_torch import create_model, init_weights
    model = create_model("hybrid_deit_huge_patch14", dtype=torch.bfloat16).eval()
    init_weights(model, torch.Generator("cuda").manual_seed(0))
    logits = model(images_nhwc)

Training (f32 parameters, bf16 compute, remat; see train/deit/engine.py):

    model = create_model("hybrid_deit_huge_patch14",
                         remat=True, drop_path_rate=cfg.drop_path,
                         compute_dtype=torch.bfloat16)
    opt = build_optimizer(cfg, model)
    state, step = create_train_state(model, opt, ema=True), make_deit_train_step(model, cfg, opt)
    state, metrics = step(state, images, labels, torch.Generator().manual_seed(0))

The octic block's fused-glue configurations (the JAX flags of the same
names; the D8 LayerNorm kernel also needs ``OCTIC_PALLAS_LN=1`` in the
environment, or ``layers.d8_layers.OCTIC_PALLAS_LN = True``):

    create_model(name, fuse_mlp_branch=True)      # norm2 ... ls2 + residual in one op (eval)
    create_model(name, fuse_block_epilogues=True)  # LayerScale + residual in proj and fc2
    create_model(name, use_pallas_linear=False, use_pallas_gelu=True)  # plain linears, D8-GELU kernel
"""

from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.models.registry import create_model
from octic_vits_tpu_torch.utils.convert import params_from_jax

__version__ = "0.1.0"

__all__ = ["create_model", "init_weights", "params_from_jax"]
