"""Datasets (the port's own copy of octic_vits_tpu/data/datasets.py):
ImageFolder, the reference's precomputed-metadata ImageNet, ImageNet-22k
tarballs, CIFAR-100, iNaturalist, the DeiT ``--data-set`` dispatch and the
enumerated-targets adapter of the eval paths.

The reference ImageNet dataset reads "extra" numpy metadata (entries array
with per-sample class ids) so no directory walk happens at startup
(reference: dinov2/data/datasets/image_net.py:55-291). Both are supported:
`ImageFolder` walks class subdirectories; `ImageNetExtra` consumes the same
`{split}_entries.npy` format and can `dump_extra()` it.

Samples are numpy arrays (or PIL images without a transform): nothing here
touches torch, so the loader's forked workers never reach the card. PIL is
imported where an image is decoded.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _apply_transform(transform: Optional[Callable], img, index: int):
    """Pass the sample index to index-aware transforms (PerSampleRng), so
    that augmentation does not depend on which worker ran it."""
    if transform is None:
        return img
    if getattr(transform, "wants_index", False):
        return transform(img, index=index)
    return transform(img)


def _open_rgb(source, transform, index):
    from PIL import Image

    with Image.open(source) as img:
        img = img.convert("RGB")
        return _apply_transform(transform, img, index)


class ImageFolder:
    """torchvision-ImageFolder analog: root/<class>/<image>."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.classes = classes
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def get_target(self, index: int) -> int:
        return self.samples[index][1]

    def __getitem__(self, index: int):
        path, target = self.samples[index]
        return _open_rgb(path, self.transform, index), target


class ImageNetExtra:
    """ImageNet with precomputed entries metadata.

    Layout: `extra/{split}_entries.npy` — a 2-column object array (relative
    path, class id); images under `root`. `dump_extra` generates the
    metadata from an ImageFolder walk
    (reference: dinov2/data/datasets/image_net.py:200-291)."""

    def __init__(self, root: str, extra: str, split: str = "TRAIN",
                 transform: Optional[Callable] = None):
        self.root = root
        self.split = split
        self.transform = transform
        entries_path = os.path.join(extra, f"{split.lower()}_entries.npy")
        self.entries = np.load(entries_path, allow_pickle=True)

    @staticmethod
    def dump_extra(root: str, extra: str, split: str = "TRAIN") -> str:
        ds = ImageFolder(root)
        rel = [(os.path.relpath(p, root), t) for p, t in ds.samples]
        arr = np.array(rel, dtype=object)
        os.makedirs(extra, exist_ok=True)
        out = os.path.join(extra, f"{split.lower()}_entries.npy")
        np.save(out, arr)
        return out

    def __len__(self):
        return len(self.entries)

    def get_target(self, index: int) -> int:
        return int(self.entries[index][1])

    def __getitem__(self, index: int):
        relpath, target = self.entries[index]
        return _open_rgb(os.path.join(self.root, str(relpath)), self.transform, index), int(target)


class ImageNet22k:
    """ImageNet-22k stored as per-class tarballs `<class_id>.tar` under
    `root` (the layout of dinov2/data/datasets/image_net_22k.py).

    Each tarball is scanned once with `tarfile` (exact member offsets, no
    sidecar block logs) and the entries are cached to `extra/entries.npy` +
    `extra/class-ids.npy`, the reference's cache filenames. Reads go through
    per-class mmaps with an LRU of `mmap_cache_size` open maps; gzip members
    are detected by their magic bytes and decompressed."""

    def __init__(self, root: str, extra: str, transform: Optional[Callable] = None,
                 mmap_cache_size: int = 16):
        import functools
        import mmap as mmap_mod

        self.root = root
        self.extra = extra
        self.transform = transform
        entries_path = os.path.join(extra, "entries.npy")
        if not os.path.exists(entries_path):
            self.dump_extra(root, extra)
        self.entries = np.load(entries_path, mmap_mode="r")
        self.class_ids = np.load(os.path.join(extra, "class-ids.npy"))

        @functools.lru_cache(maxsize=mmap_cache_size)
        def _mmap_tarball(class_id: str):
            path = os.path.join(root, f"{class_id}.tar")
            with open(path, "rb") as f:
                return mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)

        self._mmap_tarball = _mmap_tarball

    @staticmethod
    def dump_extra(root: str, extra: str) -> str:
        """Scan every `<class_id>.tar` under `root` and cache member offsets
        and sizes (once)."""
        import tarfile

        class_ids = sorted(os.path.splitext(f)[0] for f in os.listdir(root)
                           if f.endswith(".tar"))
        rows = []
        for class_index, class_id in enumerate(class_ids):
            with tarfile.open(os.path.join(root, f"{class_id}.tar")) as tf:
                for m in tf:
                    if m.isfile():
                        rows.append((class_index, class_id, m.offset_data,
                                     m.offset_data + m.size, m.name))
        max_id = max((len(c) for c in class_ids), default=1)
        max_name = max((len(r[4]) for r in rows), default=1)
        arr = np.array(rows, dtype=np.dtype([
            ("class_index", "<u4"), ("class_id", f"U{max_id}"),
            ("start_offset", "<u8"), ("end_offset", "<u8"),
            ("filename", f"U{max_name}"),
        ]))
        os.makedirs(extra, exist_ok=True)
        np.save(os.path.join(extra, "entries.npy"), arr)
        np.save(os.path.join(extra, "class-ids.npy"), np.asarray(class_ids, dtype=f"U{max_id}"))
        return os.path.join(extra, "entries.npy")

    def __len__(self):
        return len(self.entries)

    def get_target(self, index: int) -> int:
        return int(self.entries[index]["class_index"])

    def get_targets(self) -> np.ndarray:
        return np.asarray(self.entries["class_index"])

    def get_image_data(self, index: int) -> bytes:
        e = self.entries[index]
        m = self._mmap_tarball(str(e["class_id"]))
        data = m[int(e["start_offset"]):int(e["end_offset"])]
        if len(data) >= 2 and data[:2] == b"\x1f\x8b":  # gzip magic
            import gzip
            import io

            with gzip.GzipFile(fileobj=io.BytesIO(data)) as g:
                data = g.read()
        return data

    def __getitem__(self, index: int):
        import io

        return (_open_rgb(io.BytesIO(self.get_image_data(index)), self.transform, index),
                self.get_target(index))


class CIFAR100:
    """CIFAR-100 from the standard `cifar-100-python` pickle files (the
    reference uses torchvision.datasets.CIFAR100, deit/datasets.py:70-72;
    same on-disk format). The files are unpickled: point this only at
    CIFAR's own files."""

    def __init__(self, root: str, train: bool = True, transform: Optional[Callable] = None):
        import pickle

        self.transform = transform
        base = os.path.join(root, "cifar-100-python")
        if not os.path.isdir(base):
            base = root  # allow pointing directly at the pickle dir
        with open(os.path.join(base, "train" if train else "test"), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        self.data = np.asarray(d["data"], np.uint8).reshape(-1, 3, 32, 32)
        self.data = self.data.transpose(0, 2, 3, 1)  # HWC for PIL
        self.targets = list(d["fine_labels"])
        self.nb_classes = 100

    def __len__(self):
        return len(self.targets)

    def get_target(self, index: int) -> int:
        return int(self.targets[index])

    def __getitem__(self, index: int):
        from PIL import Image

        img = Image.fromarray(self.data[index])
        return _apply_transform(self.transform, img, index), int(self.targets[index])


class INatDataset:
    """iNaturalist 2018/2019 from the official JSON annotations
    (reference: deit/datasets.py:13-60). Targets are re-indexed by the
    chosen taxonomy level (`category`) over the train-split categories."""

    def __init__(self, root: str, train: bool = True, year: int = 2018, category: str = "name",
                 transform: Optional[Callable] = None):
        import json

        self.transform = transform
        split = "train" if train else "val"
        with open(os.path.join(root, f"{split}{year}.json")) as f:
            data = json.load(f)
        with open(os.path.join(root, "categories.json")) as f:
            categories = json.load(f)
        with open(os.path.join(root, f"train{year}.json")) as f:
            train_data = json.load(f)

        # class index assignment follows train-split annotation order
        targeter = {}
        for ann in train_data["annotations"]:
            key = categories[int(ann["category_id"])][category]
            if key not in targeter:
                targeter[key] = len(targeter)
        self.nb_classes = len(targeter)

        ann_by_image = {a["image_id"]: int(a["category_id"]) for a in data["annotations"]}
        self.samples: List[Tuple[str, int]] = []
        for img in data["images"]:
            # images without an annotation are skipped
            cat_id = ann_by_image.get(img["id"])
            if cat_id is None:
                continue
            key = categories[cat_id][category]
            self.samples.append((os.path.join(root, img["file_name"]), targeter[key]))

    def __len__(self):
        return len(self.samples)

    def get_target(self, index: int) -> int:
        return self.samples[index][1]

    def __getitem__(self, index: int):
        path, target = self.samples[index]
        return _open_rgb(path, self.transform, index), target


def build_deit_dataset(data_set: str, data_path: str, is_train: bool,
                       transform: Optional[Callable] = None, inat_category: str = "name"):
    """`--data-set` dispatch like the reference (deit/datasets.py:66-86).
    Returns (dataset, nb_classes)."""
    if data_set == "CIFAR":
        return CIFAR100(data_path, train=is_train, transform=transform), 100
    if data_set == "IMNET":
        root = os.path.join(data_path, "train" if is_train else "val")
        return ImageFolder(root, transform=transform), 1000
    if data_set == "IMAGEFOLDER":
        root = os.path.join(data_path, "train" if is_train else "val")
        ds = ImageFolder(root, transform=transform)
        return ds, len(ds.classes)
    if data_set in ("INAT", "INAT19"):
        year = 2018 if data_set == "INAT" else 2019
        ds = INatDataset(data_path, train=is_train, year=year, category=inat_category,
                         transform=transform)
        return ds, ds.nb_classes
    raise ValueError(f"unknown --data-set {data_set!r}")


class DatasetWithEnumeratedTargets:
    """(image, (index, target)) wrapper for order-independent feature
    extraction (reference: dinov2/data/adapters.py:11-28)."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, index: int):
        image, target = self._dataset[index]
        return image, (index, target)
