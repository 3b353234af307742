"""The port's two training CLIs on the CPU: their parsers against the JAX
package's (every action's flags, dest, default, choices, type and nargs; the
port adds only ``--device``), the DeiT III CLI end to end on a tiny image
folder and its ``--eval``, the DINOv2 CLI with dotlist opts, its resume and
``--eval-only``, its ``setup`` against JAX's, and ``python -m ... --help``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import octic_vits_tpu.train.deit.cli as jdeit_cli
import octic_vits_tpu.train.dinov2.cli as jssl_cli
from octic_vits_tpu_torch import hub
from octic_vits_tpu_torch.models import registry as T_reg
from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer
from octic_vits_tpu_torch.train.deit import cli as deit_cli
from octic_vits_tpu_torch.train.dinov2 import cli as ssl_cli
from octic_vits_tpu_torch.train.dinov2 import train as ssl_train
from octic_vits_tpu_torch.train.dinov2.schedules import sqrt_lr_scaling
from octic_vits_tpu_torch.utils import checkpoint as C
from torch_time_limit import time_limit  # noqa: F401

# each test waits at most torch_time_limit.LIMIT_S seconds, then fails
pytestmark = pytest.mark.usefixtures("time_limit")

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "_tiny_octic_cli"

def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs, a.const,
                     a.required) for a in parser._actions}


@pytest.mark.parametrize("ours,theirs", [(deit_cli, jdeit_cli), (ssl_cli, jssl_cli)],
                         ids=["deit", "dinov2"])
def test_parsers_match_jax(ours, theirs):
    mine, jax_ = _actions(ours.get_args_parser()), _actions(theirs.get_args_parser())
    assert mine.pop("device")[0] == ("--device",)
    assert mine == jax_
    # and they parse a command line alike
    argv = (["--model", "m", "--epochs", "3", "--opt-betas", "0.9", "0.95", "--no-model-ema",
             "--data-set", "IMAGEFOLDER"] if ours is deit_cli
            else ["--config-file", "x.yaml", "--eval-only", "optim.lr=1", "train.seed=3"])
    a = vars(ours.get_args_parser().parse_args(argv))
    assert a.pop("device") is None
    assert a == vars(theirs.get_args_parser().parse_args(argv))


@pytest.fixture
def tiny_entry(monkeypatch):
    """A tiny octic DeiT model, registered and in the hub, for the test's
    duration."""
    monkeypatch.setitem(T_reg._REGISTRY, NAME, lambda img_size=32, **kw: OcticVisionTransformer(
        img_size=img_size, patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
        qkv_bias=True, **kw))
    monkeypatch.setitem(hub.HUB_ENTRIES, NAME, hub.HubEntry(NAME, 2, "deit", 8))
    monkeypatch.setitem(hub.HUB_ENTRIES, "hybrid_dinov2_vit_tiny_test",
                        hub.HubEntry("hybrid_dinov2_vit_tiny_test", 2, "dinov2", 8))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        for c in ("a", "b"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                    d / f"{i}.jpg")
    return root


def _deit_argv(folder, out, *extra):
    return ["--model", NAME, "--data-set", "IMAGEFOLDER", "--data-path", str(folder),
            "--input-size", "32", "--batch-size", "4", "--epochs", "3", "--num-workers", "2",
            "--output_dir", str(out), "--device", "cpu", *extra]


def test_deit_cli_end_to_end_and_eval(tiny_entry, folder, tmp_path, capsys):
    """The paper recipe's defaults (LAMB, BCE, mixup/cutmix, drop path 0.45,
    EMA, RA sampler) through the CLI: 8 images with repeats are 6 batches of
    4 an epoch (2 by the schedule's count); max-steps stops after 4 with a
    checkpoint, a best export and the log; a rerun resumes; --eval reads the
    best export through the hub."""
    out = tmp_path / "out"
    state = deit_cli.main(_deit_argv(folder, out, "--max-steps", "4"))
    assert state.step == 4
    assert sorted(os.listdir(out / "ckpt")) == ["4"] and C.is_checkpoint(str(out / "best"))
    line = json.loads(open(out / "log.txt").read().splitlines()[-1])
    assert line["epoch"] == 0 and {"acc1", "acc5", "loss", "ema_acc1"} <= line.keys()
    state = deit_cli.main(_deit_argv(folder, out, "--max-steps", "5"))
    assert state.step == 5  # resumed at step 4 in epoch 4 // 2 = 2: one step
    capsys.readouterr()
    stats = deit_cli.main(_deit_argv(folder, out, "--eval", "--resume", str(out / "best")))
    assert "* Acc@1" in capsys.readouterr().out
    assert set(stats) == {"acc1", "acc5", "loss"} and 0 <= stats["acc1"] <= 100
    # the hub's bf16 copy of the raw weights scores the best export's raw loss
    best_line = [json.loads(x) for x in open(out / "log.txt").read().splitlines()
                 if x.startswith('{"epoch"')][0]
    assert stats["loss"] == pytest.approx(best_line["loss"], rel=5e-2)


SSL_OPTS = ["student.arch=hybrid_dinov2_vit_tiny_test", "student.patch_size=8",
            "crops.global_crops_size=32", "crops.local_crops_size=16",
            "crops.local_crops_number=2", "dino.head_n_prototypes=64", "dino.head_hidden_dim=32",
            "dino.head_bottleneck_dim=16", "ibot.head_n_prototypes=64",
            "train.batch_size_per_gpu=2", "train.OFFICIAL_EPOCH_LENGTH=2", "optim.epochs=2",
            "optim.warmup_epochs=1", "teacher.warmup_teacher_temp_epochs=1",
            "compute_precision.compute_dtype=float32", "train.saveckp_freq_iterations=2",
            "evaluation.eval_period_iterations=2"]


def _ssl_argv(folder, out, *extra):
    return ["--output-dir", str(out), "--device", "cpu", *extra,
            f"train.dataset_path=ImageFolder:root={folder / 'train'}", *SSL_OPTS]


def test_dinov2_cli_dotlist_resume_and_eval_only(tiny_entry, folder, tmp_path, monkeypatch):
    """Dotlist opts over the port's default YAML; config.yaml written with
    the sqrt-scaled lr; a resume continues the sampler's stream where it
    stopped, while the augmentation's Random starts again at the seed, as the
    JAX CLI's does (so an SSL resume is not bitwise: the resumed iteration
    sees the straight run's images with other crops); --eval-only re-exports
    the teacher, which the hub loads."""
    fed = []
    real_iter = ssl_train.ssl_batch_iterator

    def recording(dataset, sampler_iter, *args, **kw):
        def indices():
            for i in sampler_iter:
                fed.append(i)
                yield i
        return real_iter(dataset, indices(), *args, **kw)

    batches = []
    real_do_train = ssl_train.do_train

    def do_train(arch, cfg, batch_iter, output_dir, make_batch_iter=None, **kw):
        def make(start):
            for b in make_batch_iter(start):
                batches.append(b)
                yield b
        return real_do_train(arch, cfg, batch_iter, output_dir, make_batch_iter=make, **kw)

    monkeypatch.setattr(ssl_train, "ssl_batch_iterator", recording)
    monkeypatch.setattr(ssl_train, "do_train", do_train)
    straight = ssl_cli.main(_ssl_argv(folder, tmp_path / "straight", "--max-iter", "2"))
    assert straight.step == 2
    straight_fed, straight_batches = list(fed), list(batches)
    fed.clear()
    batches.clear()
    out = tmp_path / "split"
    assert ssl_cli.main(_ssl_argv(folder, out, "--max-iter", "1")).step == 1
    resumed = ssl_cli.main(_ssl_argv(folder, out, "--max-iter", "2"))
    assert resumed.step == 2
    assert fed == straight_fed  # the same images, in the same order
    assert not np.array_equal(batches[1]["global_crops"], straight_batches[1]["global_crops"])
    cfg = json.loads(json.dumps(__import__("yaml").safe_load(open(out / "config.yaml"))))
    assert cfg["optim"]["lr"] == pytest.approx(sqrt_lr_scaling(0.004, 2))
    assert cfg["student"]["arch"] == "hybrid_dinov2_vit_tiny_test"
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]
    export = out / "eval" / "2" / "teacher"
    first = C.to_host(C.load_teacher(str(export)))
    state = ssl_cli.main(_ssl_argv(folder, out, "--eval-only"))
    assert state.step == 2
    for k, v in C.load_teacher(str(export))["backbone"].items():
        assert torch.equal(v, first["backbone"][k]), k
    model = hub.load_backbone("hybrid_dinov2_vit_tiny_test", str(export), img_size=32,
                              dtype=torch.float32, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, first["backbone"][k]), k


def test_dinov2_setup_matches_jax(tmp_path, monkeypatch):
    """setup(): the same merged config as JAX's, but for the lr, which the
    port scales by one device's batch where JAX counts every local device."""
    argv = ["--config-file", os.path.join(REPO, "octic_vits_tpu_torch", "configs", "train",
                                          "hybrid_vitl16.yaml"), "optim.epochs=3"]
    ours = ssl_cli.setup(ssl_cli.get_args_parser().parse_args(
        argv + ["--output-dir", str(tmp_path / "o")]))
    theirs = jssl_cli.setup(jssl_cli.get_args_parser().parse_args(
        argv + ["--output-dir", str(tmp_path / "j")]))
    a, b = ours.to_dict(), theirs.to_dict()
    assert a["optim"].pop("lr") == pytest.approx(sqrt_lr_scaling(0.004, 32))
    b["optim"].pop("lr")
    assert a == b
    assert (tmp_path / "o" / "config.yaml").exists()


@pytest.mark.parametrize("module", ["octic_vits_tpu_torch.train.deit.cli",
                                    "octic_vits_tpu_torch.train.dinov2.cli"])
def test_cli_help_runs(module):
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--device" in out.stdout and "usage" in out.stdout
