"""The port's eval command lines (octic_vits_tpu_torch/scripts/eval_dinov2.py
and eval_segmentation.py, run in-process through ``main(argv)`` with thread
loaders on the CPU) against the JAX package's scripts/eval_dinov2.py and
scripts/eval_segmentation.py on one reference-format ``.pth`` of
``dinov2_vits14`` and tiny seeded image folders.

Both sides run the backbone in f32: the port's CLIs do with ``--device cpu``,
the JAX scripts with their ``load_backbone`` given ``dtype=float32`` by
monkeypatch (their default is bf16, and bf16 features of two programs differ
in rounding). The k-NN mode evaluates k in (1, 3), as the folder has 6
training images (the default k reach 200); both scripts' ``evaluate_knn``
get ``ks=(1, 3)`` the same way. The scripts are loaded read-only with
importlib; each sets the JAX compilation-cache directory when it is imported,
and the loader restores the setting it found.

JAX's linear mode cannot run: it asks ``get_intermediate_layers`` for
reshaped patch maps (scripts/eval_dinov2.py:90, ``reshape=True``), and the
avgpool variants then average ``[B, h, w, D]`` over h and cannot be
concatenated with the class tokens. The port takes ``[B, N, D]`` tokens as
the reference does, and its linear mode is held to JAX's probe grid fed the
same way (``train_and_eval_linear_probes`` on JAX's model with
``reshape=False``)."""

import functools
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from octic_vits_tpu_torch.eval import knn as T_knn
from octic_vits_tpu_torch.scripts import eval_dinov2 as T_cli
from octic_vits_tpu_torch.scripts import eval_segmentation as T_seg_cli
from test_torch_depth import reference_dinov2
from torch_time_limit import time_limit  # noqa: F401

# each test waits at most torch_time_limit.LIMIT_S seconds, then fails
pytestmark = pytest.mark.usefixtures("time_limit")

torch.set_num_threads(1)
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
KS = (1, 3)
PROBE_TOL = 1e-6  # accuracies and mIoU: counts over a few patches or images

def _load_script(name):
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(f"_eval_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {n: _load_script(n) for n in ("eval_dinov2", "eval_segmentation")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The backbone's ``.pth`` (pos embed for 224^2), an ImageFolder of 2
    classes (3 train and 2 val JPEGs each) and an ADE20K-layout folder (4
    training and 2 validation frames of 56^2, blocky labels in 1..5 with 0
    and 255 regions)."""
    d = tmp_path_factory.mktemp("evalcli")
    pth = str(d / "dinov2_vits14_pretrain.pth")
    torch.save(reference_dinov2(grid=16, scale=0.02), pth)
    rng = np.random.default_rng(0)
    for split, per_class in (("train", 3), ("val", 2)):
        for c in range(2):
            os.makedirs(d / split / f"c{c}")
            for i in range(per_class):
                arr = np.clip(rng.normal(60 + 120 * c, 40, (48, 64, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / split / f"c{c}" / f"{i}.jpg", quality=90)
    ade = d / "ade" / "ADEChallengeData2016"
    for sub, n in (("training", 4), ("validation", 2)):
        os.makedirs(ade / "images" / sub)
        os.makedirs(ade / "annotations" / sub)
        for i in range(n):
            lab = np.kron(rng.integers(1, 6, (4, 4)), np.ones((14, 14), np.int64))
            lab[:7, :14] = 0
            lab[-3:, -20:] = 255
            img = np.clip(lab[..., None] * 40 + rng.normal(0, 20, (56, 56, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(ade / "images" / sub / f"{i}.jpg")
            Image.fromarray(lab.astype(np.uint8), "L").save(ade / "annotations" / sub / f"{i}.png")
    return {"pth": pth, "train": str(d / "train"), "val": str(d / "val"),
            "ade": str(d / "ade")}


def _run_jax(mod, argv, monkeypatch):
    monkeypatch.setattr(mod, "load_backbone",
                        functools.partial(mod.load_backbone, dtype=jnp.float32))
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py"] + argv)
    mod.main()


def test_eval_dinov2_knn_matches_jax(jax_scripts, files, monkeypatch, capsys):
    argv = ["knn", "--model", "dinov2_vits14", "--checkpoint", files["pth"], "--train-data",
            files["train"], "--val-data", files["val"], "--batch", "2", "--workers", "2",
            "--num-classes", "2", "--n-per-class", "2"]
    mod = jax_scripts["eval_dinov2"]
    monkeypatch.setattr(mod, "evaluate_knn", functools.partial(mod.evaluate_knn, ks=KS))
    _run_jax(mod, argv, monkeypatch)
    theirs = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(T_knn, "evaluate_knn", functools.partial(T_knn.evaluate_knn, ks=KS))
    ours = T_cli.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == ours
    assert sorted(ours) == sorted(f"knn_{k}_top{t}" for k in KS for t in (1, 5))
    assert ours == theirs


def test_eval_dinov2_linear_matches_jax_probe_grid(jax_scripts, files, monkeypatch, capsys):
    """--iters 2 at batch 2; the JAX side is its probe grid on its model's
    [B, N, D] tokens, since its CLI raises (pinned here)."""
    from octic_vits_tpu.eval.linear import train_and_eval_linear_probes
    from octic_vits_tpu.hub import load_backbone

    argv = ["linear", "--model", "dinov2_vits14", "--checkpoint", files["pth"], "--train-data",
            files["train"], "--val-data", files["val"], "--batch", "2", "--workers", "2",
            "--num-classes", "2"]
    mod = jax_scripts["eval_dinov2"]
    with pytest.raises((TypeError, ValueError), match="dimension"):
        _run_jax(mod, argv, monkeypatch)
    capsys.readouterr()

    model, params = load_backbone("dinov2_vits14", checkpoint=files["pth"], dtype=jnp.float32)
    feats = jax.jit(lambda v, x: model.apply(v, x, 4, False, True,
                                             method=model.get_intermediate_layers))
    theirs = train_and_eval_linear_probes(
        lambda x: list(feats({"params": params}, jnp.asarray(x))),
        lambda: mod.feature_loader(files["train"], 2, 2), mod.feature_loader(files["val"], 2, 2),
        num_classes=2, iters=2, batch_size=2)
    ours = T_cli.main(argv + ["--iters", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == ours
    assert ours.keys() == theirs.keys()
    assert ours["best_classifier"] == theirs["best_classifier"]
    for k, v in theirs.items():
        if k != "best_classifier":
            assert abs(ours[k] - v) <= PROBE_TOL, k


def test_eval_segmentation_matches_jax(jax_scripts, files, monkeypatch, capsys):
    """ADE20K at --image-size 56 (4 x 4 patches a frame), one slice of the
    probe grid (--grid-index 3 --grid-total 8): k-NN at k = 3 (L2) and the
    logistic regression at C = 0.052; one JSON line each, mIoU and accuracy
    within PROBE_TOL of JAX's. The
    grid's largest C (2.7e3, 1e5) are not taken: on these 384-wide features
    of a few dozen patches the classes are separable, the nearly
    unregularised loss has no finite minimiser, and JAX's sklearn and the
    port's L-BFGS stop at different points (at C = 1e5 one of 32 val patches
    was predicted differently). Nor are the smallest (1e-6, 3.7e-5), where
    sklearn takes ~5 s a fit here."""
    argv = ["--model", "dinov2_vits14", "--checkpoint", files["pth"], "--dataset", "ade20k",
            "--root", files["ade"], "--image-size", "56", "--grid-index", "3", "--grid-total", "8"]
    _run_jax(jax_scripts["eval_segmentation"], argv, monkeypatch)
    theirs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    results = T_seg_cli.main(argv + ["--device", "cpu"])
    ours = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(ours) == len(results) == 2
    assert [(r["probe"], r["params"]) for r in ours] == [(r["probe"], r["params"]) for r in theirs]
    assert [r.miou for r in results] == [r["miou"] for r in ours]
    for o, t in zip(ours, theirs):
        assert abs(o["miou"] - t["miou"]) <= PROBE_TOL and abs(o["acc"] - t["acc"]) <= PROBE_TOL, \
            "\n".join(f"{a} {b}" for a, b in zip(ours, theirs))
    assert any(r["miou"] > 0 for r in ours)


@pytest.mark.parametrize("name", ["eval_dinov2", "eval_segmentation"])
def test_cli_without_checkpoint_exits_as_jax(jax_scripts, files, monkeypatch, name):
    argv = (["knn", "--train-data", files["train"], "--val-data", files["val"]]
            if name == "eval_dinov2" else ["--root", files["ade"]])
    argv += ["--model", "dinov2_vits14"]
    with pytest.raises(SystemExit, match="--checkpoint required"):
        _run_jax(jax_scripts[name], argv, monkeypatch)
    ours = T_cli if name == "eval_dinov2" else T_seg_cli
    with pytest.raises(SystemExit, match="--checkpoint required"):
        ours.main(argv + ["--device", "cpu"])
