"""Both training CLIs under ``python -m torch.distributed.run --nproc_per_node
2`` and the port's launcher, on the CPU over gloo: each run exits 0, process
0 alone writes the logs, checkpoints and exports, a second run resumes from
the checkpoint, and the hub loads the export. And a ZeRO-3 checkpoint:
written by process 0 of two, it holds the gathered state, loads in one
process bitwise, and restores into the sharded state of both processes
bitwise."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from octic_vits_tpu_torch import hub
from octic_vits_tpu_torch.utils import checkpoint as C

import torch_dist
from torch_time_limit import time_limit  # noqa: F401

# each test waits at most torch_time_limit.LIMIT_S seconds, then fails
pytestmark = pytest.mark.usefixtures("time_limit")

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 200


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 2)):
        for c in ("a", "b"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                    d / f"{i}.jpg")
    return root


def _torchrun(module, *args):
    """The module's main under the launcher in 2 CPU processes."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "octic_vits_tpu_torch.launch", module, *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return proc


def _no_temporaries(path):
    """Nothing half-written: every directory a whole checkpoint or plain."""
    left = [d for d, _, _ in os.walk(path) if ".tmp-" in os.path.basename(d)]
    assert not left, left


def _deit_argv(folder, out, *extra):
    return ["--model", "deit_tiny_patch16_LS", "--data-set", "IMAGEFOLDER", "--data-path",
            str(folder), "--input-size", "32", "--batch-size", "8", "--num-workers", "1",
            "--output_dir", str(out), "--device", "cpu", *extra]


def test_deit_cli_under_torchrun(folder, tmp_path, monkeypatch):
    """16 images at a global batch of 8 (4 a process), on the smallest
    registry model the CLI builds: the paper recipe for one epoch (under 256
    images RASampler keeps all 3 repeats, so the epoch is 6 steps while the
    schedule counts 2: tests/test_torch_data.py), then a run to epoch 4
    resumes at the first's checkpoint, in epoch 6 // 2 = 3, as the JAX loop
    does; one epoch line each in the log (two processes writing would double
    them), and the hub loads the best export."""
    out = tmp_path / "deit"
    _torchrun("octic_vits_tpu_torch.train.deit.cli", *_deit_argv(folder, out, "--epochs", "1"))
    first = sorted(os.listdir(out / "ckpt"))
    assert first == ["6"] and C.is_checkpoint(str(out / "best"))
    log = [json.loads(x) for x in open(out / "log.txt").read().splitlines()
           if x.startswith('{"epoch"')]
    assert [x["epoch"] for x in log] == [0]
    _torchrun("octic_vits_tpu_torch.train.deit.cli", *_deit_argv(folder, out, "--epochs", "4"))
    assert sorted(os.listdir(out / "ckpt")) == ["12", "6"]
    log = [json.loads(x) for x in open(out / "log.txt").read().splitlines()
           if x.startswith('{"epoch"')]
    assert [x["epoch"] for x in log] == [0, 3]
    assert C.load_tree(str(out / "ckpt" / "12"))["step"] == 12
    _no_temporaries(out)
    monkeypatch.setitem(hub.HUB_ENTRIES, "deit_tiny_patch16_LS",
                        hub.HubEntry("deit_tiny_patch16_LS", 12, "deit", 16))
    model = hub.load_backbone("deit_tiny_patch16_LS", str(out / "best"), checkpoint_key="model",
                              img_size=32, num_classes=2, dtype=torch.float32, device="cpu")
    best = C.load_tree(str(out / "best"))["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k


SSL_OPTS = ["student.arch=hybrid_dinov2_vit_tiny_test", "student.patch_size=8",
            "crops.global_crops_size=32", "crops.local_crops_size=16",
            "crops.local_crops_number=2", "dino.head_n_prototypes=64", "dino.head_hidden_dim=32",
            "dino.head_bottleneck_dim=16", "ibot.head_n_prototypes=64",
            "train.batch_size_per_gpu=2", "train.OFFICIAL_EPOCH_LENGTH=2", "optim.epochs=2",
            "optim.warmup_epochs=1", "teacher.warmup_teacher_temp_epochs=1",
            "compute_precision.compute_dtype=float32", "train.saveckp_freq_iterations=2",
            "evaluation.eval_period_iterations=2"]


def test_dinov2_cli_under_torchrun(folder, tmp_path, monkeypatch):
    """Two iterations of 2 images a process, then a resume to 4: the
    checkpoints at 1, 2 and 4, the teacher exports, one metrics line for the
    one logged iteration and one config (process 0's), the lr scaled by the
    global batch of 4; the hub loads the last teacher export."""
    from octic_vits_tpu_torch.train.dinov2.schedules import sqrt_lr_scaling

    out = tmp_path / "ssl"
    argv = ["--output-dir", str(out), "--device", "cpu",
            f"train.dataset_path=ImageFolder:root={folder / 'train'}", *SSL_OPTS]
    _torchrun("octic_vits_tpu_torch.train.dinov2.cli", "--max-iter", "2", *argv)
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]  # the first save always goes through
    _torchrun("octic_vits_tpu_torch.train.dinov2.cli", "--max-iter", "4", *argv)
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2", "4"]
    assert C.load_tree(str(out / "ckpt" / "4"))["step"] == 4
    lines = [json.loads(x) for x in open(out / "training_metrics.json").read().splitlines()]
    assert [x["iteration"] for x in lines] == [0]  # log_every 10: iteration 0 alone
    cfg = __import__("yaml").safe_load(open(out / "config.yaml"))
    assert cfg["optim"]["lr"] == pytest.approx(sqrt_lr_scaling(0.004, 4))
    assert sorted(os.listdir(out / "eval")) == ["2", "4"]
    _no_temporaries(out)
    monkeypatch.setitem(hub.HUB_ENTRIES, "hybrid_dinov2_vit_tiny_test",
                        hub.HubEntry("hybrid_dinov2_vit_tiny_test", 2, "dinov2", 8))
    export = out / "eval" / "4" / "teacher"
    model = hub.load_backbone("hybrid_dinov2_vit_tiny_test", str(export), img_size=32,
                              dtype=torch.float32, device="cpu")
    teacher = C.load_teacher(str(export))["backbone"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, teacher[k]), k


def test_zero3_checkpoint_is_the_gathered_state(tmp_path):
    """A DeiT state under ZeRO-3 over 2 processes takes a step and saves:
    process 0's checkpoint is each process's gathered state bitwise, a
    one-process state loads it bitwise, and both processes restore it into
    their shards bitwise."""
    from octic_vits_tpu_torch.train.deit import engine

    ckpt = tmp_path / "ckpt"
    out = torch_dist.run_processes(torch_dist.zero3_checkpoint_worker, 2, tmp_path, str(ckpt))
    assert sorted(os.listdir(ckpt)) == ["1"]
    tree = C.load_tree(str(ckpt / "1"))
    for rank, got in enumerate(out):
        assert torch_dist.tree_equal(got["gathered"], tree), f"rank {rank}"
        assert got["restored_equal"], f"rank {rank}"
    cfg, state = torch_dist.deit_state(None, torch_dist.ZERO3_CFG)
    state.load_state_dict(tree)
    assert torch_dist.tree_equal(C.to_host(state.state_dict()), tree)
    assert state.step == 1 and isinstance(cfg, engine.DeiTConfig)
