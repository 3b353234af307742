"""Segmentation probing: patch features -> the k-NN and logistic-regression
probe grid -> mIoU (counterpart of the JAX package's
scripts/eval_segmentation.py; reference: experiments/
eval_dinov2_segmentation.py and the eval_segmentation.py command line). The
same flags and defaults, plus ``--device`` (the CUDA card by default, in
bf16 as JAX's default; ``cpu`` for the plain f32 path).

    python -m octic_vits_tpu_torch.scripts.eval_segmentation \\
        --model hybrid_dinov2_vit_large_patch16 --checkpoint <dir|pth> \\
        --dataset ade20k --root /data/ade20k

``--checkpoint`` is a teacher export or checkpoint directory of the port or
a reference ``.pth``, as ``hub.load_backbone`` reads them. Each probe's
result prints as one JSON line; ``main(argv)`` also returns them
(``eval.segmentation.SegEvalResult``). ``--grid-index`` / ``--grid-total``
take one slice of the grid, round-robin, as the reference splits it over
workers.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from octic_vits_tpu_torch.scripts.eval_dinov2 import load_eval_backbone


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("segmentation probing")
    ap.add_argument("--model", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--dataset", choices=["ade20k", "voc2012"], default="ade20k")
    ap.add_argument("--root", required=True)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--train-split", default="train",
                    help="'trainaug' selects the VOC mmseg SBD-augmented set")
    ap.add_argument("--grid-index", type=int, default=0)
    ap.add_argument("--grid-total", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, bf16; 'cpu' for the plain f32 "
                         "path)")
    return ap


def main(argv: Optional[List[str]] = None) -> list:
    from octic_vits_tpu_torch.data.seg_datasets import make_seg_dataset
    from octic_vits_tpu_torch.eval.segmentation import (
        evaluate_seg_probes,
        extract_patch_features,
    )

    args = get_args_parser().parse_args(argv)
    if args.checkpoint is None:
        raise SystemExit("--checkpoint required")
    model = load_eval_backbone(args.model, args.checkpoint, args.device)
    device = model.pos_embed.device

    def patch_feats(x):
        with torch.no_grad():
            return model.forward_features(torch.from_numpy(np.asarray(x)).to(device))[
                "x_norm_patchtokens"]

    train_ds = make_seg_dataset(args.dataset, args.root, args.train_split, args.image_size)
    val_ds = make_seg_dataset(args.dataset, args.root, "val", args.image_size)
    nc = train_ds.num_classes
    ignore = tuple(train_ds.ignore_labels)

    def pairs(ds):
        for i in range(len(ds)):
            yield ds[i]

    patch = model.patch_size
    tr_f, tr_y = extract_patch_features(patch_feats, pairs(train_ds), patch, nc,
                                        ignore_labels=ignore)
    va_f, va_y = extract_patch_features(patch_feats, pairs(val_ds), patch, nc,
                                        ignore_labels=ignore)
    results = evaluate_seg_probes(tr_f, tr_y, va_f, va_y, num_classes=nc,
                                  grid_slice=(args.grid_index, args.grid_total),
                                  ignore_labels=ignore)
    for r in results:
        print(json.dumps(dict(probe=r.probe, params=r.params, miou=r.miou, acc=r.acc)),
              flush=True)
    return results


if __name__ == "__main__":
    main()
