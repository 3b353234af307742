"""DINOv2 SSL training CLI (counterpart of octic_vits_tpu/train/dinov2/cli.py;
reference: dinov2/train/train.py:30-64 + utils/config.py setup):
``--config-file`` and dotlist opts over the port's default YAML, plus
``--device`` (the card by default).

    python -m octic_vits_tpu_torch.train.dinov2.cli \\
        --config-file octic_vits_tpu_torch/configs/train/hybrid_vitl16.yaml \\
        --output-dir OUT train.dataset_path=ImageFolder:root=DIR
"""

from __future__ import annotations

import argparse
import os
import random
from typing import List, Optional


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DINOv2 SSL training", add_help=False)
    p.add_argument("--config-file", default="")
    p.add_argument("--output-dir", default="./out_ssl")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card)")
    p.add_argument("opts", nargs="*", default=[])
    return p


def setup(args):
    """default <- yaml <- dotlist merge + sqrt lr scaling
    (reference: dinov2/utils/config.py:21-73). One process: the global batch
    is one device's."""
    from octic_vits_tpu_torch.train.dinov2.schedules import sqrt_lr_scaling
    from octic_vits_tpu_torch.utils.config import CONFIG_DIR, build_config, load_yaml, write_config

    cfg = build_config(load_yaml(os.path.join(CONFIG_DIR, "ssl_default_config.yaml")),
                       args.config_file or None, args.opts)
    if not cfg.optim.lr:
        cfg.optim.lr = sqrt_lr_scaling(cfg.optim.base_lr, cfg.train.batch_size_per_gpu)
    os.makedirs(args.output_dir, exist_ok=True)
    write_config(cfg, args.output_dir)
    return cfg


def main(argv: Optional[List[str]] = None):
    import torch

    from octic_vits_tpu_torch.data.loaders import make_dataset
    from octic_vits_tpu_torch.data.samplers import ShardedInfiniteSampler
    from octic_vits_tpu_torch.data.transforms import DataAugmentationDINO
    from octic_vits_tpu_torch.train.dinov2.masking import MaskingGenerator
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch
    from octic_vits_tpu_torch.train.dinov2.train import do_train, ssl_batch_iterator

    # get_args_parser() is add_help=False so that it can serve as a parent
    # parser (reference: dinov2/train/train.py:335 wraps it the same way)
    parser = argparse.ArgumentParser("DINOv2 SSL training", parents=[get_args_parser()])
    args = parser.parse_args(argv)
    cfg = setup(args)

    arch = SSLMetaArch(
        SSLConfig(
            arch=cfg.student.arch,
            img_size=cfg.crops.global_crops_size,
            local_crop_size=cfg.crops.local_crops_size,
            patch_size=cfg.student.patch_size,
            drop_path_rate=cfg.student.drop_path_rate,
            dino_out_dim=cfg.dino.head_n_prototypes,
            dino_head_hidden_dim=cfg.dino.head_hidden_dim,
            dino_head_bottleneck_dim=cfg.dino.head_bottleneck_dim,
            dino_head_nlayers=cfg.dino.head_nlayers,
            dino_loss_weight=cfg.dino.loss_weight,
            koleo_loss_weight=cfg.dino.koleo_loss_weight,
            ibot_out_dim=cfg.ibot.head_n_prototypes,
            ibot_separate_head=cfg.ibot.separate_head,
            ibot_loss_weight=cfg.ibot.loss_weight,
            centering=cfg.train.centering,
            n_local_crops=cfg.crops.local_crops_number,
            clip_grad=cfg.optim.clip_grad,
            layerwise_decay=cfg.optim.layerwise_decay,
            patch_embed_lr_mult=cfg.optim.patch_embed_lr_mult,
            compute_dtype=torch.bfloat16
            if cfg.compute_precision.compute_dtype == "bfloat16" else None,
            # the port never scans its trunk (student.scan_blocks is a TPU knob)
            backbone_remat=bool(cfg.student.get("remat", True)),
        ),
        device=args.device,
    )

    augmenter = DataAugmentationDINO(
        global_crops_scale=tuple(cfg.crops.global_crops_scale),
        local_crops_scale=tuple(cfg.crops.local_crops_scale),
        local_crops_number=cfg.crops.local_crops_number,
        global_crops_size=cfg.crops.global_crops_size,
        local_crops_size=cfg.crops.local_crops_size,
    )
    dataset = make_dataset(cfg.train.dataset_path)
    n_tokens = (cfg.crops.global_crops_size // cfg.student.patch_size) ** 2
    gen = MaskingGenerator(cfg.crops.global_crops_size // cfg.student.patch_size,
                           num_masking_patches=n_tokens // 2)
    batch = cfg.train.batch_size_per_gpu

    def make_batch_iter(start_iter: int):
        # deterministic data resume: the stream has consumed `batch` indices
        # per completed iteration, so the sampler skips them (reference:
        # dinov2/data/samplers.py:174-182). The augmentation's Random starts
        # again at the seed, as the JAX CLI's does.
        sampler = iter(ShardedInfiniteSampler(len(dataset), seed=cfg.train.seed,
                                              advance=start_iter * batch))
        return ssl_batch_iterator(dataset, sampler, augmenter, batch_size=batch,
                                  n_tokens=n_tokens, mask_generator=gen,
                                  mask_probability=cfg.ibot.mask_sample_probability,
                                  mask_ratio_tuple=tuple(cfg.ibot.mask_ratio_min_max),
                                  rng=random.Random(cfg.train.seed))

    return do_train(arch, cfg, None, args.output_dir, max_iter=args.max_iter,
                    seed=cfg.train.seed, make_batch_iter=make_batch_iter,
                    resume=not args.no_resume, eval_only=args.eval_only)


if __name__ == "__main__":
    main()
