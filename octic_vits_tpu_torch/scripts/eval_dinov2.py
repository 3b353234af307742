"""DINOv2 classification eval: k-NN and the linear-probe grid on a frozen
backbone (counterpart of the JAX package's scripts/eval_dinov2.py; reference:
experiments/eval_dinov2_classification.py and the dinov2/eval/{knn,linear}.py
command lines). The same flags and defaults, plus ``--device`` (the CUDA card
by default, in bf16 as JAX's default; ``cpu`` for the plain f32 path) and
``--iters`` of the linear grid (the reference's 12,500).

    python -m octic_vits_tpu_torch.scripts.eval_dinov2 knn \\
        --model hybrid_dinov2_vit_large_patch16 --checkpoint <dir|pth> \\
        --train-data /data/in1k/train --val-data /data/in1k/val

``--checkpoint`` is a teacher export or checkpoint directory of the port
(``utils.checkpoint``) or a reference ``.pth``, as ``hub.load_backbone``
reads them. The results print as one JSON object, from process 0;
``main(argv)`` returns them on every process.

The k-NN mode extracts through ``eval.distributed.extract_features_sharded``
(reference: dinov2/eval/utils.py:86-146). Under a process group
(``torchrun ... -m octic_vits_tpu_torch.launch
octic_vits_tpu_torch.scripts.eval_dinov2 knn ...``) each process extracts
its shard of both folders and the shards are merged on every process, so
every process holds and scores the whole banks and returns the one-process
result; without one, the one process extracts both folders whole. The
linear mode trains the whole grid on every process, as JAX's script does (it
passes no mesh): every process returns the same results.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch


def eval_folder(path: str):
    """An ImageFolder of eval images at 224^2."""
    from octic_vits_tpu_torch.data.datasets import ImageFolder
    from octic_vits_tpu_torch.data.transforms import eval_transform

    return ImageFolder(path, transform=lambda im: eval_transform(im, 224))


def feature_loader(path: str, batch: int, workers: int):
    """The eval images of an ImageFolder at 224^2, in order, in thread workers
    (the linear mode's loaders)."""
    from octic_vits_tpu_torch.data.loaders import DataLoader
    from octic_vits_tpu_torch.data.samplers import EpochSampler

    ds = eval_folder(path)
    return DataLoader(ds, EpochSampler(len(ds)), batch_size=batch, num_workers=workers,
                      drop_last=False)


def load_eval_backbone(name: str, checkpoint: str, device=None):
    """`name` from `checkpoint` through ``hub.load_backbone``, in eval mode:
    in bf16 on the card (JAX's default dtype), in f32 on the CPU, the plain
    path the port's tests hold to JAX's."""
    from octic_vits_tpu_torch.hub import load_backbone

    on_cpu = device is not None and torch.device(device).type == "cpu"
    return load_backbone(name, checkpoint=checkpoint, device=device,
                         dtype=torch.float32 if on_cpu else torch.bfloat16).eval()


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("DINOv2 k-NN / linear-probe evaluation")
    ap.add_argument("mode", choices=["knn", "linear"])
    ap.add_argument("--model", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--train-data", required=True)
    ap.add_argument("--val-data", required=True)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n-per-class", type=int, default=None)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=12500,
                    help="linear mode: iterations of the probe grid")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, bf16; 'cpu' for the plain f32 "
                         "path)")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    from octic_vits_tpu_torch.eval.distributed import extract_features_sharded
    from octic_vits_tpu_torch.eval.knn import evaluate_knn
    from octic_vits_tpu_torch.eval.linear import train_and_eval_linear_probes
    from octic_vits_tpu_torch.parallel.mesh import process_index

    args = get_args_parser().parse_args(argv)
    if args.checkpoint is None:
        raise SystemExit("--checkpoint required (random weights are pointless here)")
    model = load_eval_backbone(args.model, args.checkpoint, args.device)
    device = model.pos_embed.device

    def on_device(x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x)).to(device)

    with torch.no_grad():
        if args.mode == "knn":
            def fwd(x):
                return model(on_device(x))

            # each process extracts its shard, merged on every process (without
            # a process group: the whole folder, in order)
            def extract(path):
                return extract_features_sharded(fwd, eval_folder(path), batch_size=args.batch,
                                                num_workers=args.workers)

            tr_f, tr_y = extract(args.train_data)
            va_f, va_y = extract(args.val_data)
            res = evaluate_knn(tr_f, tr_y, va_f, va_y, num_classes=args.num_classes,
                               n_per_class=args.n_per_class)
        else:
            # patch tokens [B, N, C], as the reference's ModelWithIntermediateLayers
            # gives them (the avgpool variants average over N). No mesh, as in
            # JAX: under a process group every process trains the whole grid
            # on the whole folders and returns the same results
            def feats_fn(x):
                return list(model.get_intermediate_layers(on_device(x), 4, reshape=False,
                                                          return_class_token=True))

            res = train_and_eval_linear_probes(
                feats_fn, lambda: feature_loader(args.train_data, args.batch, args.workers),
                feature_loader(args.val_data, args.batch, args.workers),
                num_classes=args.num_classes, iters=args.iters, batch_size=args.batch)
    if process_index() == 0:
        print(json.dumps(res, indent=2, default=str), flush=True)
    return res


if __name__ == "__main__":
    main()
