"""Parity of the port's image data pipeline with the JAX package on the CPU:
the samplers' index streams, the transforms (3-Augment, eval, PerSampleRng,
the DINOv2 multi-crop in its native and PIL branches, colour jitter, random
erasing, the equivariance flips), the native host library's bindings, the
datasets and the ``make_dataset`` DSL, and the loader with thread and process
workers. Everything here is numpy, PIL and the native library on both sides,
so every comparison is bitwise."""

import io
import json
import os
import pickle
import random
import tarfile
import time

import numpy as np
import pytest
import torch
from PIL import Image

from octic_vits_tpu.data import datasets as jds
from octic_vits_tpu.data import loaders as jloaders
from octic_vits_tpu.data import native as jnative
from octic_vits_tpu.data import samplers as jsamplers
from octic_vits_tpu.data import transforms as jtf
from octic_vits_tpu_torch.data import datasets as tds
from octic_vits_tpu_torch.data import loaders as tloaders
from octic_vits_tpu_torch.data import native as tnative
from octic_vits_tpu_torch.data import samplers as tsamplers
from octic_vits_tpu_torch.data import transforms as ttf
from torch_time_limit import time_limit  # noqa: F401

# each test waits at most torch_time_limit.LIMIT_S seconds, then fails
pytestmark = pytest.mark.usefixtures("time_limit")


def _take(it, n):
    return [next(it) for _ in range(n)]


# ---- samplers ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [12, 255, 256, 300, 1000])
@pytest.mark.parametrize("shards", [(0, 1), (1, 2), (3, 4)])
@pytest.mark.parametrize("reps", [1, 3])
def test_ra_sampler_stream(length, shards, reps):
    shard, n = shards
    for seed, epoch in ((0, 0), (1337, 1), (7, 5)):
        ours = tsamplers.RASampler(length, shard, n, seed=seed, repetitions=reps)
        theirs = jsamplers.RASampler(length, shard, n, seed=seed, repetitions=reps)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) == len(theirs)
        assert list(ours) == list(theirs)
    plain = tsamplers.RASampler(length, shard, n, shuffle=False, repetitions=reps)
    assert list(plain) == list(jsamplers.RASampler(length, shard, n, shuffle=False,
                                                   repetitions=reps))


def test_ra_sampler_under_256_keeps_every_repeat():
    """The JAX rule (samplers.py:47-48), kept: below 256 samples the
    256-aligned selection is empty and the sampler yields all 3 repeats, so an
    epoch is 3x the dataset while the loops' steps_per_epoch counts it once."""
    s = tsamplers.RASampler(12, seed=0)
    assert len(s) == len(list(s)) == 36 == len(jsamplers.RASampler(12, seed=0))
    assert len(tsamplers.RASampler(256, seed=0)) == 256
    assert len(tsamplers.RASampler(300, seed=0)) == 256


@pytest.mark.parametrize("cls", ["InfiniteSampler", "ShardedInfiniteSampler"])
@pytest.mark.parametrize("count,shard,shards", [(10, 0, 1), (37, 1, 3), (64, 2, 4)])
@pytest.mark.parametrize("advance", [0, 5, 40, 130])
def test_infinite_sampler_streams(cls, count, shard, shards, advance):
    for seed, shuffle in ((0, True), (11, True), (3, False)):
        ours = getattr(tsamplers, cls)(count, shard, shards, shuffle=shuffle, seed=seed,
                                       advance=advance)
        theirs = getattr(jsamplers, cls)(count, shard, shards, shuffle=shuffle, seed=seed,
                                         advance=advance)
        assert _take(iter(ours), 3 * count) == _take(iter(theirs), 3 * count)


@pytest.mark.parametrize("cls", ["InfiniteSampler", "ShardedInfiniteSampler"])
def test_advance_continues_the_stream(cls):
    """advance(n) gives the stream from its n-th index: a resume continues
    where the run stopped."""
    whole = _take(iter(getattr(tsamplers, cls)(23, seed=4)), 100)
    for n in (0, 7, 23, 61):
        assert _take(iter(getattr(tsamplers, cls)(23, seed=4, advance=n)), 100 - n) == whole[n:]


@pytest.mark.parametrize("size,shard,shards", [(10, 0, 1), (37, 2, 3), (5, 3, 4)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_sampler_stream(size, shard, shards, shuffle):
    for epoch in (0, 3):
        ours = tsamplers.EpochSampler(size, shard, shards, shuffle=shuffle, seed=9)
        theirs = jsamplers.EpochSampler(size, shard, shards, shuffle=shuffle, seed=9)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) == len(theirs) and list(ours) == list(theirs)


# ---- transforms -------------------------------------------------------------------------


def _image(seed, w=64, h=48):
    """A seeded smooth-plus-noise RGB image (so that crops, blur and jitter
    all change it)."""
    rng = np.random.default_rng(seed)
    base = Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)).resize(
        (w, h), Image.BICUBIC)
    arr = np.asarray(base, np.int16) + rng.integers(-30, 31, (h, w, 3))
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


THREE_AUG = {"recipe": {}, "src": dict(src=True), "no_jitter": dict(color_jitter_strength=0.0),
             "erase_pixel": dict(reprob=1.0, remode="pixel", recount=2),
             "erase_const": dict(reprob=0.7, remode="const")}


@pytest.mark.parametrize("case", sorted(THREE_AUG))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_three_augment_bitwise(case, seed):
    img = _image(seed, 70, 50)
    kw = dict(size=32, **THREE_AUG[case])
    _same(ttf.three_augment(img, rng=random.Random(seed), **kw),
          jtf.three_augment(img, rng=random.Random(seed), **kw))


@pytest.mark.parametrize("size,ratio,wh", [(32, 0.875, (64, 48)), (24, 1.0, (40, 90)),
                                           (48, 0.9, (50, 50))])
def test_eval_transform_bitwise(size, ratio, wh):
    img = _image(5, *wh)
    _same(ttf.eval_transform(img, size, ratio), jtf.eval_transform(img, size, ratio))
    arr = ttf.eval_transform(img, size, ratio)
    _same(ttf.rotate90(arr), jtf.rotate90(arr))
    _same(ttf.rotate90(arr, 3), jtf.rotate90(arr, 3))
    _same(ttf.hflip(arr), jtf.hflip(arr))


def test_per_sample_rng_bitwise():
    import functools

    ours = ttf.PerSampleRng(functools.partial(ttf.three_augment, size=24), seed=1337)
    theirs = jtf.PerSampleRng(functools.partial(jtf.three_augment, size=24), seed=1337)
    img = _image(6)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for index in (0, 5, 255):
            _same(ours(img, index=index), theirs(img, index=index))
    # a pure function of (seed, epoch, index)
    _same(ours(img, index=3), ours(img, index=3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jitter_crop_and_erasing_bitwise(seed):
    img = _image(seed + 10, 80, 60)
    for args in ((0.4, 0.4, 0.2, 0.1), (0.3, 0.3, 0.3, 0.0)):
        assert ttf.sample_jitter(random.Random(seed), *args) == jtf.sample_jitter(
            random.Random(seed), *args)
        _same(np.asarray(ttf.color_jitter(img, random.Random(seed), *args)),
              np.asarray(jtf.color_jitter(img, random.Random(seed), *args)))
    _same(np.asarray(ttf.random_resized_crop(img, 16, (0.05, 0.3), random.Random(seed))),
          np.asarray(jtf.random_resized_crop(img, 16, (0.05, 0.3), random.Random(seed))))
    assert ttf.rrc_box(7, 9, (0.9, 1.0), random.Random(seed), (5.0, 6.0)) == jtf.rrc_box(
        7, 9, (0.9, 1.0), random.Random(seed), (5.0, 6.0))  # the fallback centre box
    arr = ttf.to_normalized_array(img)
    for mode in ("pixel", "const"):
        _same(ttf.random_erasing(arr, random.Random(seed), 1.0, mode, 3),
              jtf.random_erasing(arr, random.Random(seed), 1.0, mode, 3))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_dino_augmentation_bitwise(native, normalize):
    """Both branches: the native C++ crop pipeline and the PIL one."""
    if native:
        assert tnative.has_resize() and jnative.has_resize()
    img = _image(7, 90, 70)
    outs = []
    for mod in (ttf, jtf):
        aug = mod.DataAugmentationDINO(local_crops_number=3, global_crops_size=32,
                                       local_crops_size=16)
        aug.use_native, aug.normalize = native, normalize
        outs.append([aug(img, rng=random.Random(s)) for s in (0, 1)])
    _same(*outs)
    g = outs[0][0]["global_crops"][0]
    assert g.shape == (32, 32, 3) and g.dtype == (np.float32 if normalize else np.uint8)


def test_native_bindings_bitwise():
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    _same(tnative.normalize_batch(imgs), jnative.normalize_batch(imgs))
    f = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    for k, flip in ((0, False), (1, True), (3, False)):
        _same(tnative.rot90_flip_batch(f, k, flip), jnative.rot90_flip_batch(f, k, flip))
    arr = rng.integers(0, 256, (50, 40, 3), dtype=np.uint8)
    _same(tnative.resize_crop(arr, (3.5, 2.0, 40.0, 33.5), (16, 24)),
          jnative.resize_crop(arr, (3.5, 2.0, 40.0, 33.5), (16, 24)))
    a, b = arr.copy(), arr.copy()
    assert tnative.color_jitter_inplace(a, [1, 3, 0], [1.3, -0.07, 0.8])
    assert jnative.color_jitter_inplace(b, [1, 3, 0], [1.3, -0.07, 0.8])
    _same(a, b)
    assert tnative._LIB_PATH == jnative._LIB_PATH  # the repository's one native/ copy
    with pytest.raises(ValueError):
        tnative.normalize_batch(imgs.astype(np.float32))
    with pytest.raises(ValueError):
        tnative.color_jitter_inplace(arr, [0, 1], [1.0])


# ---- datasets ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder")
    for split, n in (("train", 5), ("val", 2)):
        for c in ("cat", "ant", "bee"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                _image(hash((split, c, i)) % 1000, 40, 36).save(d / f"{i}.jpg")
            (d / "notes.txt").write_text("not an image")
    return root


def test_image_folder_classes_and_targets(folder):
    ours, theirs = tds.ImageFolder(str(folder / "train")), jds.ImageFolder(str(folder / "train"))
    assert ours.classes == theirs.classes == ["ant", "bee", "cat"]
    assert ours.samples == theirs.samples and len(ours) == 15
    assert [ours.get_target(i) for i in range(15)] == [theirs.get_target(i) for i in range(15)]
    tf = lambda im: ttf.eval_transform(im, 24)  # noqa: E731
    a, b = tds.ImageFolder(str(folder / "train"), tf)[7], jds.ImageFolder(
        str(folder / "train"), lambda im: jtf.eval_transform(im, 24))[7]
    _same(a[0], b[0])
    assert a[1] == b[1]


def test_build_deit_dataset_and_make_dataset(folder, tmp_path):
    for train in (True, False):
        ours, n_ours = tds.build_deit_dataset("IMAGEFOLDER", str(folder), train)
        theirs, n_theirs = jds.build_deit_dataset("IMAGEFOLDER", str(folder), train)
        assert n_ours == n_theirs == 3 and ours.samples == theirs.samples
    assert tds.build_deit_dataset("IMNET", str(folder), True)[1] == 1000
    with pytest.raises(ValueError):
        tds.build_deit_dataset("NOPE", str(folder), True)
    ds = tloaders.make_dataset(f"ImageFolder:root={folder / 'val'}")
    assert ds.samples == jloaders.make_dataset(f"ImageFolder:root={folder / 'val'}").samples
    # the precomputed-metadata ImageNet: dump once, read by both
    extra = tmp_path / "extra"
    tds.ImageNetExtra.dump_extra(str(folder / "train"), str(extra))
    spec = f"ImageNet:split=TRAIN:root={folder / 'train'}:extra={extra}"
    ours, theirs = tloaders.make_dataset(spec), jloaders.make_dataset(spec)
    assert len(ours) == len(theirs) == 15
    _same(np.asarray(ours[4][0]), np.asarray(theirs[4][0]))
    assert ours[4][1] == theirs[4][1] == ours.get_target(4)
    with pytest.raises(ValueError):
        tloaders.make_dataset("Places:root=/x")
    enum = tds.DatasetWithEnumeratedTargets(ours)
    assert len(enum) == 15 and enum[3][1] == (3, ours.get_target(3))


def test_imagenet22k_cifar_inat_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    # ImageNet-22k: per-class tarballs, one member gzip-compressed
    root = tmp_path / "in22k"
    root.mkdir()
    for c, cls in enumerate(("n001", "n002")):
        with tarfile.open(root / f"{cls}.tar", "w") as tf:
            for i in range(3):
                buf = io.BytesIO()
                _image(c * 10 + i, 20, 20).save(buf, format="JPEG")
                data = buf.getvalue()
                if i == 1:
                    import gzip

                    data = gzip.compress(data)
                info = tarfile.TarInfo(f"{cls}_{i}.JPEG")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    ours = tds.ImageNet22k(str(root), str(tmp_path / "x1"))
    theirs = jds.ImageNet22k(str(root), str(tmp_path / "x2"))
    assert len(ours) == len(theirs) == 6
    np.testing.assert_array_equal(ours.get_targets(), theirs.get_targets())
    for i in range(6):
        _same(np.asarray(ours[i][0]), np.asarray(theirs[i][0]))
    # CIFAR-100 pickles
    cdir = tmp_path / "cifar" / "cifar-100-python"
    cdir.mkdir(parents=True)
    for split in ("train", "test"):
        with open(cdir / split, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         "fine_labels": [3, 1, 4, 1]}, f)
    tf = lambda im: ttf.eval_transform(im, 16)  # noqa: E731
    ours = tds.CIFAR100(str(tmp_path / "cifar"), train=False, transform=tf)
    theirs = jds.CIFAR100(str(tmp_path / "cifar"), train=False,
                          transform=lambda im: jtf.eval_transform(im, 16))
    assert len(ours) == 4 and ours.get_target(2) == 4
    _same(ours[2][0], theirs[2][0])
    # iNaturalist JSON annotations (an image without annotation is skipped)
    idir = tmp_path / "inat"
    idir.mkdir()
    cats = [{"name": f"sp{i}", "genus": f"g{i // 2}"} for i in range(4)]
    imgs = [{"id": i, "file_name": f"img{i}.jpg"} for i in range(5)]
    anns = [{"image_id": i, "category_id": (3 * i) % 4} for i in range(4)]
    for i in range(5):
        _image(i, 20, 20).save(idir / f"img{i}.jpg")
    (idir / "categories.json").write_text(json.dumps(cats))
    for split in ("train", "val"):
        (idir / f"{split}2018.json").write_text(json.dumps({"images": imgs, "annotations": anns}))
    for category in ("name", "genus"):
        ours, n1 = tds.build_deit_dataset("INAT", str(idir), True, inat_category=category)
        theirs, n2 = jds.build_deit_dataset("INAT", str(idir), True, inat_category=category)
        assert n1 == n2 and [(os.path.basename(p), t) for p, t in ours.samples] == [
            (os.path.basename(p), t) for p, t in theirs.samples] and len(ours) == 4


# ---- the loader -------------------------------------------------------------------------


class _Seeded:
    """A dataset of seeded arrays with an index-aware target."""

    def __len__(self):
        return 13

    def __getitem__(self, i):
        return np.random.default_rng(i).standard_normal((4, 4, 3)).astype(np.float32), i % 3


# Process workers fork. A process that has run JAX holds XLA's threads, and a
# fork there may deadlock the child (JAX warns so), which would hang the test
# instead of failing it. The checks that fork therefore run in a fresh
# interpreter that imports the port alone, under a time limit.
_FORKING_CHECKS = r"""
import sys

import numpy as np
import torch

from octic_vits_tpu_torch.data import datasets, loaders, samplers, transforms


def no_cuda():
    raise RuntimeError("a loader worker initialised CUDA")


# a child that reached torch.cuda's initialisation would fail the run
torch.cuda._lazy_init = no_cuda


class Seeded:
    def __len__(self):
        return 13

    def __getitem__(self, i):
        return np.random.default_rng(i).standard_normal((4, 4, 3)).astype(np.float32), i % 3


class Failing(Seeded):
    def __getitem__(self, i):
        if i == 6:
            raise KeyError("sample 6 is broken")
        return super().__getitem__(i)


def same(a, b):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and xa.shape == xb.shape and np.array_equal(xa, xb)
        assert np.array_equal(ya, yb)


mode, folder = sys.argv[1], sys.argv[2]
if mode == "batches":
    ds = datasets.ImageFolder(folder, transforms.PerSampleRng(
        lambda im, rng: transforms.three_augment(im, 24, rng), seed=3))
    sampler = list(samplers.RASampler(len(ds), seed=3))
    threads, procs = (list(loaders.DataLoader(ds, sampler, 4, num_workers=3, use_processes=p))
                      for p in (False, True))
    assert len(threads) == len(sampler) // 4
    same(threads, procs)
    # drop_last=False keeps the ragged tail
    tail = list(loaders.DataLoader(Seeded(), range(13), 5, num_workers=2, drop_last=False,
                                   use_processes=True))
    assert [len(y) for _, y in tail] == [5, 5, 3]
    same([(tail[2][0][:1], tail[2][1][:1])], [(Seeded()[10][0][None], np.asarray([10 % 3]))])
else:
    got = []
    try:
        for batch in loaders.DataLoader(Failing(), range(13), 2, num_workers=2,
                                        use_processes=True):
            got.append(batch)
    except RuntimeError as e:
        assert "producer failed" in str(e) and isinstance(e.__cause__, KeyError), repr(e)
    else:
        raise AssertionError("no error surfaced")
    assert len(got) == 3, len(got)  # the batches before the broken one
assert not any(m == "jax" or m.startswith(("jax.", "octic_vits_tpu.")) for m in sys.modules)
print("ok")
"""


def _forking_checks(mode: str, folder: str = "") -> None:
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FORKING_CHECKS, mode, folder], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_loader_threads_and_processes_give_the_same_batches(folder):
    """Same batches, same order, with threads and with forked processes, and
    equal to the JAX loader's. The children never touch the card: with
    torch.cuda's initialisation made to raise in the parent before the fork,
    a child that reached it would fail the run."""
    ds = tds.ImageFolder(str(folder / "train"),
                         ttf.PerSampleRng(lambda im, rng: ttf.three_augment(im, 24, rng), seed=3))
    jd = jds.ImageFolder(str(folder / "train"),
                         jtf.PerSampleRng(lambda im, rng: jtf.three_augment(im, 24, rng), seed=3))
    sampler = list(tsamplers.RASampler(len(ds), seed=3))
    ours = list(tloaders.DataLoader(ds, sampler, 4, num_workers=3))
    assert len(ours) == len(sampler) // 4
    _same(ours, list(jloaders.DataLoader(jd, sampler, 4, num_workers=3)))
    _forking_checks("batches", str(folder / "train"))


class _Failing(_Seeded):
    def __getitem__(self, i):
        if i == 6:
            raise KeyError("sample 6 is broken")
        return super().__getitem__(i)


@pytest.mark.parametrize("use_processes", [False, True])
def test_loader_surfaces_a_producer_error(use_processes):
    if use_processes:
        _forking_checks("error")
        return
    loader = tloaders.DataLoader(_Failing(), range(13), 2, num_workers=2)
    got = []
    with pytest.raises(RuntimeError, match="producer failed") as info:
        for batch in loader:
            got.append(batch)
    assert isinstance(info.value.__cause__, KeyError)
    assert len(got) == 3  # the batches before the broken one


def test_loader_consumer_may_stop_early():
    """A loop that stops mid-epoch (max_steps, preemption) leaves no
    producer blocked on a full queue."""
    import threading

    before = threading.active_count()
    t0 = time.perf_counter()
    for _ in range(3):
        it = iter(tloaders.DataLoader(_Seeded(), list(range(13)) * 20, 1, num_workers=2,
                                      prefetch=1))
        next(it)
        it.close()
    assert time.perf_counter() - t0 < 10
    deadline = time.perf_counter() + 5
    while threading.active_count() > before and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
