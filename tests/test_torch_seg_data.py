"""The port's segmentation datasets (octic_vits_tpu_torch/data/seg_datasets.py)
against the JAX package's on seeded files: the ADE20K layout (archive root
and its subdirectory, PNG labels in L, P and RGB modes), the VOC2012
original + SBD aug layout (``.mat`` targets written with scipy) and the flat
single-root layout. Every item list and every array is held bitwise."""

import os

import numpy as np
import pytest
import scipy.io
from PIL import Image

from octic_vits_tpu.data import seg_datasets as J
from octic_vits_tpu_torch.data import seg_datasets as T


def _jpeg(path, rng, hw=(29, 37)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(path, quality=90)


def _labels(rng, hw=(29, 37), classes=151):
    lab = rng.integers(0, classes, hw).astype(np.uint8)
    lab[rng.random(hw) < 0.1] = 255
    return lab


def _png(path, lab, mode):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if mode == "RGB":  # a colour label map: _open_label converts it to a palette
        Image.fromarray(np.stack([lab, lab // 2, 255 - lab], -1)).save(path)
    elif mode == "P":
        im = Image.fromarray(lab, "L").convert("P")
        im.putpalette(list(np.arange(768) % 256))
        im.save(path)
    else:
        Image.fromarray(lab, "L").save(path)


def _assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    assert ours.items == theirs.items
    assert (ours.num_classes, ours.ignore_index, tuple(ours.ignore_labels)) == (
        theirs.num_classes, theirs.ignore_index, tuple(theirs.ignore_labels))
    for i in range(len(theirs)):
        for a, b in zip(ours[i], theirs[i]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ade_root(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("ade")
    base = root / "ADEChallengeData2016"
    for sub, n in (("training", 3), ("validation", 2)):
        for i in range(n):
            name = f"ADE_{sub}_{i:08d}"
            _jpeg(str(base / "images" / sub / f"{name}.jpg"), rng)
            _png(str(base / "annotations" / sub / f"{name}.png"), _labels(rng),
                 ("L", "P", "RGB")[i % 3])
    (base / "images" / "training" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("split", ["train", "training", "TRAIN", "val", "validation"])
@pytest.mark.parametrize("subdir", [False, True])
def test_ade20k_matches_jax_bitwise(ade_root, split, subdir):
    root = os.path.join(ade_root, "ADEChallengeData2016") if subdir else ade_root
    ours, theirs = T.ADE20K(root, split, 28), J.ADE20K(root, split, 28)
    assert len(ours) == (3 if split.lower().startswith("train") else 2)
    _assert_same(ours, theirs)
    img, lab = ours[0]
    assert img.shape == (28, 28, 3) and img.dtype == np.float32 and lab.dtype == np.int32


def _sbd_mat(path, lab):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    scipy.io.savemat(path, {"GTcls": {"Segmentation": lab, "Boundaries": np.zeros(1)}})


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    rng = np.random.default_rng(1)
    root = tmp_path_factory.mktemp("voc")
    ori = root / "original" / "VOCdevkit" / "VOC2012"
    sets = ori / "ImageSets" / "Segmentation"
    os.makedirs(sets)
    ids = {"train": ["2007_000032", "2007_000039"], "val": ["2007_000042"]}
    for split, names in ids.items():
        (sets / f"{split}.txt").write_text("\n".join(names) + "\n\n")
        for n in names:
            _jpeg(str(ori / "JPEGImages" / f"{n}.jpg"), rng)
            _png(str(ori / "SegmentationClass" / f"{n}.png"), _labels(rng, classes=21), "P")
    aug = root / "aug" / "benchmark_RELEASE" / "dataset"
    os.makedirs(aug)
    for split, names in (("train", ["2008_000002", "2008_000003"]), ("val", ["2008_000008"])):
        (aug / f"{split}.txt").write_text("\n".join(names) + "\n")
        for n in names:
            _jpeg(str(aug / "img" / f"{n}.jpg"), rng, hw=(31, 23))
            _sbd_mat(str(aug / "cls" / f"{n}.mat"), _labels(rng, hw=(31, 23), classes=21))
    return str(root)


@pytest.mark.parametrize("split,n", [("train", 2), ("TRAIN", 2), ("val", 1), ("VAL", 1),
                                     ("trainaug", 5), ("TRAINAUG", 5)])
def test_voc2012_original_and_aug_match_jax_bitwise(voc_root, split, n):
    ours, theirs = T.VOC2012(voc_root, split, 28), J.VOC2012(voc_root, split, 28)
    assert len(ours) == n
    _assert_same(ours, theirs)


def test_voc2012_mat_target_is_the_saved_labels(voc_root):
    """The SBD ``.mat`` reader unwraps scipy's struct arrays to the [H, W] map."""
    path = os.path.join(voc_root, "aug", "benchmark_RELEASE", "dataset", "cls",
                        "2008_000002.mat")
    ours = T._open_label(path)
    assert ours.shape == (31, 23) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, J._open_label(path))


@pytest.mark.parametrize("split", ["train", "val"])
def test_voc2012_flat_layout_matches_jax_bitwise(voc_root, split):
    flat = os.path.join(voc_root, "original", "VOCdevkit", "VOC2012")
    ours, theirs = T.VOC2012(flat, split, 20), J.VOC2012(flat, split, 20)
    _assert_same(ours, theirs)


def test_make_seg_dataset_names_and_errors(ade_root, voc_root):
    for name, root, cls in (("ade20k", ade_root, T.ADE20K), ("ADE", ade_root, T.ADE20K),
                            ("voc2012", voc_root, T.VOC2012), ("VOC", voc_root, T.VOC2012)):
        ours = T.make_seg_dataset(name, root, "train", 28)
        assert type(ours) is cls
        _assert_same(ours, J.make_seg_dataset(name, root, "train", 28))
    for mod in (T, J):
        with pytest.raises(ValueError, match="unknown segmentation dataset"):
            mod.make_seg_dataset("cityscapes", ade_root, "train")
        with pytest.raises(ValueError, match="unknown VOC split"):
            mod.VOC2012(voc_root, "test")


def test_ade20k_other_split_names_read_validation(ade_root):
    """Copied from JAX (data/seg_datasets.py:82): any split name other than
    train / training / TRAIN reads the validation images, "test" among them."""
    for split in ("test", "val2"):
        ours, theirs = T.ADE20K(ade_root, split, 28), J.ADE20K(ade_root, split, 28)
        assert ours.items == theirs.items == T.ADE20K(ade_root, "validation", 28).items
