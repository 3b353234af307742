"""Segmentation probing datasets: ADE20K and PASCAL VOC2012 (the port's own
copy of octic_vits_tpu/data/seg_datasets.py: the same files give the same
items and arrays, bit for bit).

Layout parity with the reference's auto-downloading dataset factory
(reference: dinov2/eval/segmentation/data.py:70-205, 240-292) minus the
network fetch: `root` must already hold the extracted archives. Yields
(image [H,W,3] normalized float32, labels [H,W] int32), host numpy.

ADE20K layout (data.py:117-143): root[/ADEChallengeData2016]/
    images/{training,validation}/*.jpg
    annotations/{training,validation}/*.png
Labels are served RAW (0=background, 1..150 classes, 255 void) with
`num_classes=151` and `ignore_labels=(0, 255)`, the reference protocol
(eval_segmentation.py:363 "for ADE20K it's both 0 and 255").

VOC2012 layout (data.py:146-205), mmseg split convention:
    root/original/VOCdevkit/VOC2012/{JPEGImages,SegmentationClass,
        ImageSets/Segmentation/{train,val}.txt}
    root/aug/benchmark_RELEASE/dataset/{img,cls,train.txt,val.txt}
splits: train = original train; val = original val;
        trainaug = original train + aug train + aug val.
Aug targets are .mat files (GTcls.Segmentation), read with scipy. A flat
single-root layout (root/JPEGImages + root/SegmentationClass + ImageSets) is
also accepted for train/val.

PIL and scipy are imported where a file is read.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from octic_vits_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def _open_label(path: str) -> np.ndarray:
    """PNG or SBD .mat (reference: data.py:64-67 open_img_or_mat)."""
    if path.endswith(".mat"):
        import scipy.io

        seg = scipy.io.loadmat(path)["GTcls"]["Segmentation"]
        while isinstance(seg, np.ndarray) and seg.dtype == object:
            seg = seg[(0,) * seg.ndim]
        arr = np.asarray(seg)
        while arr.ndim > 2:
            arr = arr[0]
        return arr.astype(np.uint8)
    from PIL import Image

    with Image.open(path) as lm:
        return np.asarray(lm.convert("P") if lm.mode == "RGB" else lm)


def _load_pair(img_path: str, lab_path: str, image_size: int):
    from PIL import Image

    with Image.open(img_path) as im:
        im = im.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
        img = np.asarray(im, np.float32) / 255.0
    img = (img - IMAGENET_MEAN) / IMAGENET_STD
    lab = _open_label(lab_path)
    lab = np.asarray(Image.fromarray(lab.astype(np.uint8)).resize(
        (image_size, image_size), Image.NEAREST)).astype(np.int32)
    return img, lab


class ADE20K:
    """Raw labels: 0=background, 1..150 classes, 255 void. num_classes
    counts the background slot so raw labels index the confusion matrix
    directly; ignore_labels drops {0, 255} from the metrics (reference:
    data.py:117-143, eval_segmentation.py:363)."""

    num_classes = 151
    ignore_index = 255
    ignore_labels: Sequence[int] = (0, 255)

    def __init__(self, root: str, split: str = "training", image_size: int = 224):
        # the archive root or its ADEChallengeData2016 subdirectory
        if os.path.isdir(os.path.join(root, "ADEChallengeData2016")):
            root = os.path.join(root, "ADEChallengeData2016")
        sub = "training" if split in ("train", "training", "TRAIN") else "validation"
        img_dir = os.path.join(root, "images", sub)
        ann_dir = os.path.join(root, "annotations", sub)
        names = sorted(f[:-4] for f in os.listdir(img_dir) if f.endswith(".jpg"))
        self.items = [(os.path.join(img_dir, n + ".jpg"), os.path.join(ann_dir, n + ".png"))
                      for n in names]
        self.image_size = image_size

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        return _load_pair(*self.items[i], self.image_size)


class VOC2012:
    """21 classes (background = 0 among them); 255 = void / ignore."""

    num_classes = 21
    ignore_index = 255
    ignore_labels: Sequence[int] = (255,)

    def __init__(self, root: str, split: str = "train", image_size: int = 224):
        split = {"TRAIN": "train", "VAL": "val", "TRAINAUG": "trainaug"}.get(split, split)
        ori_root = os.path.join(root, "original", "VOCdevkit", "VOC2012")
        if not os.path.isdir(ori_root):
            ori_root = root  # flat single-root layout
        aug_root = os.path.join(root, "aug", "benchmark_RELEASE", "dataset")

        def ids(path: str) -> List[str]:
            with open(path) as f:
                return [line.strip() for line in f if line.strip()]

        def ori_pair(n: str) -> Tuple[str, str]:
            return (os.path.join(ori_root, "JPEGImages", n + ".jpg"),
                    os.path.join(ori_root, "SegmentationClass", n + ".png"))

        def aug_pair(n: str) -> Tuple[str, str]:
            return (os.path.join(aug_root, "img", n + ".jpg"),
                    os.path.join(aug_root, "cls", n + ".mat"))

        seg_sets = os.path.join(ori_root, "ImageSets", "Segmentation")
        if split in ("train", "val"):
            self.items = [ori_pair(n) for n in ids(os.path.join(seg_sets, f"{split}.txt"))]
        elif split == "trainaug":
            # mmseg convention: original train + aug train + aug val (reference: data.py:177-183)
            self.items = [ori_pair(n) for n in ids(os.path.join(seg_sets, "train.txt"))] + [
                aug_pair(n) for n in ids(os.path.join(aug_root, "train.txt"))
                + ids(os.path.join(aug_root, "val.txt"))]
        else:
            raise ValueError(f"unknown VOC split {split!r}")
        self.image_size = image_size

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        return _load_pair(*self.items[i], self.image_size)


def make_seg_dataset(name: str, root: str, split: str, image_size: int = 224):
    """'ade20k' | 'voc2012' factory (the reference URL-scheme factory's analog)."""
    name = name.lower()
    if name in ("ade20k", "ade"):
        return ADE20K(root, split, image_size)
    if name in ("voc2012", "voc"):
        return VOC2012(root, split, image_size)
    raise ValueError(f"unknown segmentation dataset {name}")
