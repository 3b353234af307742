"""DeiT III CLI (counterpart of octic_vits_tpu/train/deit/cli.py: the same
flags, defaults and choices, reference deit/main.py:37-204 with the paper
defaults of experiments/train_deit.py:31-66), plus ``--device``: the card by
default, ``cpu`` for the plain f32 path.

    python -m octic_vits_tpu_torch.train.deit.cli --model hybrid_deit_huge_patch14 \\
        --data-set IMAGEFOLDER --data-path DIR --batch-size 32 --output_dir OUT
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DeiT III training/eval", add_help=False)
    p.add_argument("--model", default="hybrid_deit_huge_patch14")
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=2048, help="global batch")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--unscale-lr", action="store_true", default=True)
    p.add_argument("--weight-decay", type=float, default=0.02)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--drop-path", type=float, default=0.45)
    p.add_argument("--drop", type=float, default=0.0,
                   help="backbone dropout rate (recipes use 0.0)")
    p.add_argument("--smoothing", type=float, default=0.0)
    p.add_argument("--bce-loss", action="store_true", default=True)
    p.add_argument("--cosub", action="store_true", default=False)
    p.add_argument("--opt", default="lamb", choices=["lamb", "adamw"],
                   help="pretraining recipe: lamb; finetuning: adamw")
    p.add_argument("--opt-eps", type=float, default=1e-8)
    p.add_argument("--opt-betas", type=float, nargs="+", default=None)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--color-jitter", type=float, default=0.3)
    p.add_argument("--ThreeAugment", action="store_true", default=True)
    p.add_argument("--src", action="store_true", default=False,
                   help="simple random crop instead of RRC")
    p.add_argument("--reprob", type=float, default=0.0,
                   help="random-erasing probability (recipes use 0.0)")
    p.add_argument("--remode", default="pixel", choices=["pixel", "const"])
    p.add_argument("--recount", type=int, default=1)
    p.add_argument("--repeated-aug", action="store_true", dest="repeated_aug", default=True)
    p.add_argument("--no-repeated-aug", action="store_false", dest="repeated_aug")
    p.add_argument("--model-ema", action="store_true", dest="model_ema", default=True)
    p.add_argument("--no-model-ema", action="store_false", dest="model_ema")
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    # apex FusedLAMB's default max_grad_norm=1.0 (what the reference recipe
    # runs with through timm create_optimizer('fusedlamb'))
    p.add_argument("--clip-grad", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--data-path", default="")
    p.add_argument("--data-set", default="IMNET",
                   choices=["IMNET", "CIFAR", "IMAGEFOLDER", "INAT", "INAT19"])
    p.add_argument("--inat-category", default="name")
    p.add_argument("--eval-crop-ratio", type=float, default=1.0)
    p.add_argument("--output_dir", default="./out")
    p.add_argument("--resume", default="")
    p.add_argument("--eval", action="store_true", help="eval only")
    p.add_argument("--rot-eval", action="store_true",
                   help="rot90 the val images (equivariance stress)")
    p.add_argument("--flop-eval", action="store_true",
                   help="hflip the val images (equivariance stress)")
    p.add_argument("--finetune", default="", help="checkpoint to finetune from")
    p.add_argument("--attn-only", action="store_true")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--distillation-type", default="none", choices=["none", "soft", "hard"])
    p.add_argument("--distillation-alpha", type=float, default=0.5)
    p.add_argument("--distillation-tau", type=float, default=1.0)
    p.add_argument("--teacher-model", default="",
                   help="registered model name for the distillation teacher")
    p.add_argument("--teacher-path", default="",
                   help="teacher checkpoint (torch .pth or a port checkpoint directory)")
    p.add_argument("--num-workers", type=int, default=10)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card; 'cpu' for the "
                        "plain f32 path)")
    return p


def main(argv: Optional[List[str]] = None):
    import dataclasses
    import functools

    from octic_vits_tpu_torch.data.datasets import build_deit_dataset
    from octic_vits_tpu_torch.data.transforms import (
        PerSampleRng,
        eval_transform,
        hflip,
        rotate90,
        three_augment,
    )
    from octic_vits_tpu_torch.train.deit.engine import DeiTConfig
    from octic_vits_tpu_torch.train.deit.main import train

    # get_args_parser() is add_help=False so that it can serve as a parent
    # parser (reference: deit/main.py:790 wraps it the same way)
    parser = argparse.ArgumentParser("DeiT III training/eval", parents=[get_args_parser()])
    args = parser.parse_args(argv)
    cfg = DeiTConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr, unscale_lr=args.unscale_lr,
        weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
        warmup_lr=args.warmup_lr, min_lr=args.min_lr,
        loss_type="bce" if args.bce_loss else "ce", smoothing=args.smoothing, cosub=args.cosub,
        opt=args.opt, opt_eps=args.opt_eps,
        opt_betas=tuple(args.opt_betas) if args.opt_betas else None,
        mixup_alpha=args.mixup, cutmix_alpha=args.cutmix, mixup_prob=args.mixup_prob,
        mixup_switch_prob=args.mixup_switch_prob, drop_path=args.drop_path, drop=args.drop,
        model_ema=args.model_ema, ema_decay=args.model_ema_decay,
        repeated_aug=args.repeated_aug, clip_grad=args.clip_grad, attn_only=args.attn_only,
        accum_steps=args.accum_steps, distillation_type=args.distillation_type,
        distillation_alpha=args.distillation_alpha, distillation_tau=args.distillation_tau,
    )

    # per-sample derived RNG (seed, epoch, index): the same stream under any
    # worker scheduling and across preemption resumes
    train_tf = PerSampleRng(
        functools.partial(three_augment, size=args.input_size,
                          color_jitter_strength=args.color_jitter, src=args.src,
                          reprob=args.reprob, remode=args.remode, recount=args.recount),
        seed=args.seed,
    )

    def val_tf(img):
        arr = eval_transform(img, args.input_size, args.eval_crop_ratio)
        if args.rot_eval:
            arr = rotate90(arr)
        if args.flop_eval:
            arr = hflip(arr)
        return arr

    train_ds, nb_classes = build_deit_dataset(args.data_set, args.data_path, True,
                                              transform=train_tf,
                                              inat_category=args.inat_category)
    val_ds, _ = build_deit_dataset(args.data_set, args.data_path, False, transform=val_tf,
                                   inat_category=args.inat_category)
    if nb_classes != cfg.num_classes:
        cfg = dataclasses.replace(cfg, num_classes=nb_classes)

    if args.eval:
        from octic_vits_tpu_torch.data.loaders import DataLoader
        from octic_vits_tpu_torch.data.samplers import EpochSampler
        from octic_vits_tpu_torch.hub import load_backbone
        from octic_vits_tpu_torch.train.deit.main import evaluate

        # the port's parameters have the shapes of the model they were built
        # for (flax applies whatever shapes the checkpoint holds), so the
        # model is built at the run's --input-size
        model = load_backbone(args.model, checkpoint=args.resume or None, checkpoint_key="model",
                              img_size=args.input_size, num_classes=nb_classes,
                              device=args.device)
        loader = DataLoader(val_ds, EpochSampler(len(val_ds)), batch_size=256,
                            num_workers=args.num_workers, drop_last=False)
        stats = evaluate(model, None, loader)
        print(f"* Acc@1 {stats['acc1']:.3f} Acc@5 {stats['acc5']:.3f} loss {stats['loss']:.3f}")
        return stats

    teacher = None
    if args.distillation_type != "none":
        if not args.teacher_model:
            raise SystemExit("--distillation-type needs --teacher-model")
        from octic_vits_tpu_torch.hub import load_backbone

        teacher = load_backbone(args.teacher_model, checkpoint=args.teacher_path or None,
                                checkpoint_key="model", img_size=args.input_size,
                                num_classes=nb_classes, device=args.device)

    return train(args.model, cfg, train_ds, val_ds, args.output_dir, img_size=args.input_size,
                 seed=args.seed, num_workers=args.num_workers, max_steps=args.max_steps,
                 finetune=args.finetune, teacher=teacher, device=args.device)


if __name__ == "__main__":
    main()
