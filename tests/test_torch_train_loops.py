"""The port's training loops against the JAX package's on the CPU, in f32:
the DeiT III ``train()`` and the DINOv2 ``do_train()`` from one shared start
(a reference-layout ``.pth`` through ``finetune=`` for DeiT, the JAX initial
state through ``params_from_jax`` for SSL) on the same data, per step and at
the end; the DeiT loop's bitwise resume (a straight run against one resumed
at an epoch boundary, two resumes of one mid-epoch checkpoint) and its
SIGTERM save; the SSL loop's data-stream resume and its interval gate; and
finetuning (merge, head drop, pos-embed interpolation, the attention-only
mask) against JAX's ``load_pretrained_for_finetune``.

Bars: the step tests' (tests/test_torch_port_train.py,
tests/test_torch_port_ssl.py): losses within 1e-5; an adaptive optimizer's
first steps move each parameter by about lr * sign(g), so where a gradient is
zero up to f32 rounding (|g| < 1e-6) the two sides may step apart by up to
lr per step, and elsewhere they agree to 1e-2 lr per step."""

import os
import random
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import octic_vits_tpu.models.registry as J_reg
import octic_vits_tpu.train.deit.main as jmain
import octic_vits_tpu.train.dinov2.train as jssl_train
from octic_vits_tpu.data import datasets as jds
from octic_vits_tpu.data import transforms as jtf
from octic_vits_tpu.models import OcticVisionTransformer as JOctic
from octic_vits_tpu.models import VisionTransformer as JViT
from octic_vits_tpu.train.deit.engine import DeiTConfig as JDeiTConfig
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLConfig as JSSLConfig
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLMetaArch as JSSLMetaArch
from octic_vits_tpu.utils import config as jconfig
from octic_vits_tpu.utils import finetune as jfinetune
from octic_vits_tpu_torch import create_model, init_weights
from octic_vits_tpu_torch.data import datasets as tds
from octic_vits_tpu_torch.data import transforms as ttf
from octic_vits_tpu_torch.models import VisionTransformer
from octic_vits_tpu_torch.models import registry as T_reg
from octic_vits_tpu_torch.models.octic_vit import OcticVisionTransformer
from octic_vits_tpu_torch.train.deit import main as tmain
from octic_vits_tpu_torch.train.deit.engine import DeiTConfig
from octic_vits_tpu_torch.train.dinov2 import train as tssl_train
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch
from octic_vits_tpu_torch.utils import checkpoint as C
from octic_vits_tpu_torch.utils import config as tconfig
from octic_vits_tpu_torch.utils import finetune as tfinetune
from octic_vits_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_hub import _fake_octic_state_dict, _save
from torch_time_limit import time_limit  # noqa: F401

# each test waits at most torch_time_limit.LIMIT_S seconds, then fails
pytestmark = pytest.mark.usefixtures("time_limit")

torch.set_num_threads(1)
TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, qkv_bias=True)
NAME = "_tiny_octic_loop"


@pytest.fixture
def tiny_model(monkeypatch):
    """The JAX loop test's tiny octic ViT (tests/test_train_loops.py), in
    both registries for the test's duration."""
    monkeypatch.setitem(J_reg._REGISTRY, NAME,
                        lambda img_size=32, **kw: JOctic(img_size=img_size, **TINY, **kw))
    monkeypatch.setitem(T_reg._REGISTRY, NAME,
                        lambda img_size=32, **kw: OcticVisionTransformer(img_size=img_size,
                                                                         **TINY, **kw))
    return NAME


def _image(seed, w=40, h=40):
    rng = np.random.default_rng(seed)
    base = Image.fromarray(rng.integers(0, 256, (3, 3, 3), dtype=np.uint8)).resize(
        (w, h), Image.BICUBIC)
    arr = np.asarray(base, np.int16) + rng.integers(-25, 26, (h, w, 3))
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 classes x 4 train and 2 val JPEGs, 40 x 40."""
    root = tmp_path_factory.mktemp("loop_data")
    for split, n in (("train", 4), ("val", 2)):
        for c in range(3):
            d = root / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                _image(100 * c + 10 * i + (split == "val"), 40, 40).save(d / f"{i}.jpg")
    return root


def _datasets(mods, folder, seed=0):
    """train: PerSampleRng(3-Augment) at 32^2; val: eval_transform at 32^2."""
    ds_mod, tf_mod = mods
    train = ds_mod.ImageFolder(str(folder / "train"), tf_mod.PerSampleRng(
        lambda im, rng: tf_mod.three_augment(im, 32, rng), seed=seed))
    val = ds_mod.ImageFolder(str(folder / "val"), lambda im: tf_mod.eval_transform(im, 32, 1.0))
    return train, val


class _Recorder:
    """Records every metric dict a loop hands its logger."""

    def __init__(self, base):
        seen = self.seen = []

        class Logger(base):
            def update(self, **kw):
                seen.append(dict(kw))
                super().update(**kw)

        self.cls = Logger


def _log_lines(path):
    import json

    return [json.loads(x) for x in open(path).read().splitlines()]


def _close_steps(pairs, lr, steps):
    """The optimizer-step bar of the module docstring over (name, ours,
    theirs) arrays: every entry within lr per step, and all but a few
    percent (the noise-level gradients: the key biases' zero gradient and the
    like) within 1e-2 lr per step."""
    n_well = n_total = 0
    for name, ours, theirs in pairs:
        diff = np.abs(ours - theirs)
        assert diff.max(initial=0.0) <= lr * steps, name
        n_well += int((diff <= 1e-2 * lr * steps).sum())
        n_total += diff.size
    assert n_well >= 0.95 * n_total, (n_well, n_total)


# ---- DeiT III ---------------------------------------------------------------------------


def test_deit_loop_matches_jax(tiny_model, folder, tmp_path, monkeypatch):
    """Three steps of JAX's and the port's train() from one .pth, mixup off
    and drop path 0 (P6's deterministic step), the real data path
    (ImageFolder, PerSampleRng 3-Augment, RASampler, the loader): per-step
    losses, the epoch's raw and EMA accuracies, the final parameters and
    EMA."""
    pth = _save(tmp_path / "init.pth",
                {"model": _fake_octic_state_dict(2, 32, patch=8, grid=4, ncls=3, hidden=64)})
    kw = dict(num_classes=3, epochs=1, batch_size=4, lr=1e-3, warmup_epochs=1, mixup_alpha=0.0,
              cutmix_alpha=0.0, drop_path=0.0, ema_decay=0.9)
    jrec, trec = _Recorder(jmain.MetricLogger), _Recorder(tmain.MetricLogger)
    monkeypatch.setattr(jmain, "MetricLogger", jrec.cls)
    monkeypatch.setattr(tmain, "MetricLogger", trec.cls)
    jstate = jmain.train(NAME, JDeiTConfig(**kw), *_datasets((jds, jtf), folder),
                         str(tmp_path / "jax"), img_size=32, num_workers=2, max_steps=3,
                         finetune=pth)
    tstate = tmain.train(NAME, DeiTConfig(**kw), *_datasets((tds, ttf), folder),
                         str(tmp_path / "port"), img_size=32, num_workers=2, max_steps=3,
                         finetune=pth, device="cpu")
    assert int(jstate.step) == tstate.step == 3
    jl, tl = [r["loss"] for r in jrec.seen], [r["loss"] for r in trec.seen]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    jline, tline = _log_lines(tmp_path / "jax" / "log.txt")[-1], _log_lines(
        tmp_path / "port" / "log.txt")[-1]
    for k in ("acc1", "acc5", "ema_acc1", "ema_acc5"):
        assert tline[k] == jline[k], k
    for k in ("loss", "ema_loss"):
        assert tline[k] == pytest.approx(jline[k], abs=1e-5, rel=1e-5), k
    model = tstate.model
    params = params_from_jax({"params": jax.device_get(jstate.params)}, model)
    ema = params_from_jax({"params": jax.device_get(jstate.ema_params)}, model)
    named = list(model.named_parameters())
    _close_steps([(n, p.detach().numpy(), params[n].numpy()) for n, p in named], 1e-3, 3)
    _close_steps([(n, tstate.ema[n].numpy(), ema[n].numpy()) for n, _ in named], 1e-3, 3)
    # both wrote the same files: keep-2 checkpoints (one, at step 3), best, log
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == ["3"]
    assert C.is_checkpoint(str(tmp_path / "port" / "best"))
    assert os.path.isdir(tmp_path / "jax" / "best")


def _train(out, folder, epochs=2, max_steps=None, record=None, monkeypatch=None):
    cfg = DeiTConfig(num_classes=3, epochs=epochs, batch_size=4, lr=1e-3, warmup_epochs=1,
                     repeated_aug=False, ema_decay=0.9)  # the paper recipe otherwise
    return tmain.train(NAME, cfg, *_datasets((tds, ttf), folder, seed=5), str(out),
                       img_size=32, num_workers=2, max_steps=max_steps, seed=5, device="cpu")


def _assert_states_bitwise(a, b):
    def eq(x, y, path=""):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                eq(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                eq(u, v, f"{path}/{i}")
        else:
            assert x == y, path
    eq(a, b)


def test_deit_resume_is_bitwise(tiny_model, folder, tmp_path):
    """The paper recipe (mixup/cutmix, drop path 0.45, 3-Augment, LAMB, EMA):
    a straight 2-epoch run and one stopped after epoch 0 and resumed end in
    the same state, bit for bit (each step's generator is a function of
    (seed, step); each sample's augmentation of (seed, epoch, index))."""
    straight = _train(tmp_path / "straight", folder)
    assert straight.step == 6  # 12 images, B=4, no repeats: 3 steps an epoch
    first = _train(tmp_path / "split", folder, max_steps=3)
    assert first.step == 3
    resumed = _train(tmp_path / "split", folder)
    assert resumed.step == 6
    _assert_states_bitwise(resumed.state_dict(), straight.state_dict())
    assert sorted(os.listdir(tmp_path / "split" / "ckpt")) == ["3", "6"]


def test_deit_two_resumes_of_a_mid_epoch_checkpoint_agree(tiny_model, folder, tmp_path,
                                                          monkeypatch):
    """scripts/soak_deit_tpu.py's phase C: one mid-epoch checkpoint copied
    twice, each copy resumed for 2 steps: bitwise equal. The resume replays
    the epoch from its start with the step count carried on (the JAX loop's
    start_epoch = step // steps_per_epoch, main.py:160)."""
    _train(tmp_path / "a", folder, max_steps=2)
    for tag in ("b", "c"):
        shutil.copytree(tmp_path / "a", tmp_path / tag)
    epochs = []

    class Sampler(tmain.RASampler):
        def set_epoch(self, epoch):
            epochs.append(epoch)
            super().set_epoch(epoch)

    monkeypatch.setattr(tmain, "RASampler", Sampler)
    states = [_train(tmp_path / tag, folder, max_steps=4) for tag in ("b", "c")]
    assert [s.step for s in states] == [4, 4]
    assert epochs == [0, 0]  # each resume replays epoch 0 from its first batch
    _assert_states_bitwise(states[0].state_dict(), states[1].state_dict())
    fresh = _train(tmp_path / "d", folder, max_steps=4)
    # not the straight run's state: the replayed batches are not its 3rd and 4th
    assert not torch.equal(fresh.model.head.weight, states[0].model.head.weight)


def test_deit_sigterm_saves_and_stops(tiny_model, folder, tmp_path, capsys):
    """A real SIGTERM mid-epoch: the loop finishes its step, saves a
    checkpoint of that step and returns; the handlers are put back; a rerun
    resumes from it."""
    previous = signal.getsignal(signal.SIGTERM)
    train, val = _datasets((tds, ttf), folder, seed=5)
    sent = []

    class Killer:
        def __len__(self):
            return len(train)

        def __getitem__(self, i):
            if not sent:
                sent.append(i)
                os.kill(os.getpid(), signal.SIGTERM)
            return train[i]

    cfg = DeiTConfig(num_classes=3, epochs=3, batch_size=4, lr=1e-3, repeated_aug=False)
    state = tmain.train(NAME, cfg, Killer(), val, str(tmp_path / "out"), img_size=32,
                        num_workers=2, device="cpu")
    assert "preempted; checkpoint saved" in capsys.readouterr().out
    assert 1 <= state.step < 9
    assert sorted(os.listdir(tmp_path / "out" / "ckpt")) == [str(state.step)]
    assert signal.getsignal(signal.SIGTERM) is previous
    again = tmain.train(NAME, cfg, train, val, str(tmp_path / "out"), img_size=32,
                        num_workers=2, max_steps=state.step + 1, device="cpu")
    assert again.step == state.step + 1


def test_deit_loop_under_256_takes_every_repeat(tiny_model, folder, tmp_path):
    """The JAX rule, kept (samplers.py:47-48): below 256 images the RA
    sampler yields all 3 repeats, so an epoch of 12 images at B=4 takes 9
    steps while steps_per_epoch (the schedule's) is 3."""
    cfg = DeiTConfig(num_classes=3, epochs=1, batch_size=4, mixup_alpha=0.0, cutmix_alpha=0.0)
    state = tmain.train(NAME, cfg, *_datasets((tds, ttf), folder), str(tmp_path / "o"),
                        img_size=32, num_workers=2, device="cpu")
    assert state.step == 9


# ---- DINOv2 -----------------------------------------------------------------------------


SSL_CFG = dict(arch="hybrid_dinov2_vit_tiny_test", img_size=32, local_crop_size=16, patch_size=8,
               drop_path_rate=0.0, dino_out_dim=64, dino_head_hidden_dim=32,
               dino_head_bottleneck_dim=16, ibot_out_dim=64, n_local_crops=2)
LOOP_CFG = {
    "optim": {"epochs": 2, "lr": 1e-3, "min_lr": 1e-5, "warmup_epochs": 0,
              "weight_decay": 0.04, "weight_decay_end": 0.4, "freeze_last_layer_epochs": 0},
    "teacher": {"momentum_teacher": 0.9, "final_momentum_teacher": 1.0, "teacher_temp": 0.07,
                "warmup_teacher_temp": 0.04, "warmup_teacher_temp_epochs": 1},
    "train": {"OFFICIAL_EPOCH_LENGTH": 2, "saveckp_freq_iterations": 2},
    "evaluation": {"eval_period_iterations": 2},
}


def _ssl_batches(n, b=2):
    from octic_vits_tpu_torch.train.dinov2.masking import MaskingGenerator, collate_crops_and_masks

    out = []
    for seed in range(n):
        npr = np.random.RandomState(seed)
        out.append(collate_crops_and_masks(
            npr.randn(2 * b, 32, 32, 3).astype(np.float32),
            npr.randn(2 * b, 16, 16, 3).astype(np.float32), 16,
            MaskingGenerator(4, num_masking_patches=8), rng=random.Random(seed)))
    return out


@pytest.fixture
def jax_tiny_dino(monkeypatch):
    from tests.test_torch_port_ssl import hybrid_dinov2_vit_tiny_test as j_tiny

    monkeypatch.setitem(J_reg._REGISTRY, "hybrid_dinov2_vit_tiny_test", j_tiny)


def test_ssl_loop_matches_jax(jax_tiny_dino, tmp_path, monkeypatch):
    """Three iterations of JAX's and the port's do_train from JAX's initial
    state on the same batches: every iteration's loss terms, the schedules,
    the checkpoint at iteration 2, the teacher export and the final teacher."""
    jarch = JSSLMetaArch(JSSLConfig(**SSL_CFG, compute_dtype=jnp.float32))
    jstate = jax.jit(jarch.init)(jax.random.PRNGKey(0))
    arch = SSLMetaArch(SSLConfig(**SSL_CFG, compute_dtype=None), device="cpu")
    student = arch.build_student()
    student.load_state_dict(params_from_jax({"params": jax.device_get(jstate.student)}, student),
                            strict=True)
    state = arch.state_from_student(student)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jssl_train, "maybe_wandb_log", lambda m, step: seen["jax"].append(m))
    monkeypatch.setattr(tssl_train, "maybe_wandb_log", lambda m, step: seen["port"].append(m))
    batches = _ssl_batches(3)
    jout = jssl_train.do_train(jarch, jconfig.ConfigNode.from_dict(LOOP_CFG), iter(batches),
                               str(tmp_path / "jax"), max_iter=3, state=jstate, log_every=1)
    tout = tssl_train.do_train(arch, tconfig.ConfigNode.from_dict(LOOP_CFG), iter(batches),
                               str(tmp_path / "port"), max_iter=3, state=state, log_every=1)
    assert int(jout.step) == tout.step == 3
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for it, (ours, theirs) in enumerate(zip(seen["port"], seen["jax"])):
        assert ours.keys() == theirs.keys()
        for k in ours:
            if k.startswith("grad_norm"):
                assert ours[k] == pytest.approx(theirs[k], rel=1e-4), (it, k)
            else:
                assert ours[k] == pytest.approx(theirs[k], abs=1e-4, rel=1e-4), (it, k)
    teacher = params_from_jax({"params": jax.device_get(jout.teacher)}, student)
    _close_steps([(n, t.detach().numpy(), teacher[n].numpy())
                  for n, t in tout.teacher.named_parameters()], 1e-3, 3)
    # the files: the first save always, then the interval (2); the export at 2
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == ["1", "2"]
    assert C.is_checkpoint(str(tmp_path / "port" / "eval" / "2" / "teacher"))
    assert os.path.isdir(tmp_path / "jax" / "eval" / "2" / "teacher")


def test_ssl_resume_advances_the_data_stream(tmp_path, monkeypatch):
    """The counterpart of tests/test_train_loops.py:
    test_dinov2_resume_advances_data_stream: the resumed run continues the
    stream at the restored iteration; --eval-only never touches it;
    --no-resume restarts it; and the state is copied to the host only on save
    iterations."""
    copies = []
    real = C.to_host

    def to_host(tree):  # count the copies of whole trees, not to_host's recursion
        if isinstance(tree, dict) and ("step" in tree or "backbone" in tree):
            copies.append(sorted(tree))
        return real(tree)

    monkeypatch.setattr(C, "to_host", to_host)
    cfg = tconfig.ConfigNode.from_dict(LOOP_CFG)
    out = str(tmp_path / "ssl")
    calls = []

    def make_batch_iter(start_iter):
        calls.append(start_iter)
        return iter(_ssl_batches(8))

    def arch():
        return SSLMetaArch(SSLConfig(**SSL_CFG, compute_dtype=None), device="cpu")

    tssl_train.do_train(arch(), cfg, None, out, max_iter=2, log_every=10,
                        make_batch_iter=make_batch_iter)
    assert calls == [0] and len(copies) == 3  # the saves at 1 and 2, the export at 2
    state = tssl_train.do_train(arch(), cfg, None, out, max_iter=4, log_every=10,
                                make_batch_iter=make_batch_iter)
    assert calls == [0, 2] and state.step == 4
    state = tssl_train.do_train(arch(), cfg, None, out, max_iter=6, log_every=10,
                                eval_only=True, make_batch_iter=make_batch_iter)
    assert calls == [0, 2] and state.step == 4
    assert C.is_checkpoint(os.path.join(out, "eval", "4", "teacher"))
    state = tssl_train.do_train(arch(), cfg, None, str(tmp_path / "fresh"), max_iter=1,
                                log_every=10, resume=False, make_batch_iter=make_batch_iter)
    assert calls == [0, 2, 0] and state.step == 1
    # interval 100: the first save always goes through, then nothing for 3
    copies.clear()
    gated = tconfig.ConfigNode.from_dict(dict(LOOP_CFG, train={
        "OFFICIAL_EPOCH_LENGTH": 2, "saveckp_freq_iterations": 100}, evaluation={}))
    tssl_train.do_train(arch(), gated, iter(_ssl_batches(3)), str(tmp_path / "gated"),
                        max_iter=3, log_every=10)
    assert len(copies) == 1


# ---- finetune ---------------------------------------------------------------------------


def _fake_standard_vit(grid=4, dim=32, depth=2, ncls=4, patch=8, seed=0):
    """Reference deit/vit.py vit_models layout (pos_embed without a cls slot)."""
    rng = np.random.RandomState(seed)
    sd = {"pos_embed": rng.randn(1, grid * grid, dim), "cls_token": rng.randn(1, 1, dim),
          "patch_embed.proj.weight": 0.2 * rng.randn(dim, 3, patch, patch),
          "patch_embed.proj.bias": rng.randn(dim), "norm.weight": rng.randn(dim),
          "norm.bias": rng.randn(dim), "head.weight": 0.2 * rng.randn(ncls, dim),
          "head.bias": rng.randn(ncls)}
    for i in range(depth):
        p = f"blocks.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{p}.{nm}.weight"], sd[f"{p}.{nm}.bias"] = rng.randn(dim), rng.randn(dim)
        for nm, (o, n) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                           ("mlp.fc1", (2 * dim, dim)), ("mlp.fc2", (dim, 2 * dim))):
            sd[f"{p}.{nm}.weight"], sd[f"{p}.{nm}.bias"] = 0.2 * rng.randn(o, n), rng.randn(o)
        sd[f"{p}.gamma_1"], sd[f"{p}.gamma_2"] = rng.randn(dim), rng.randn(dim)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_finetune_standard_vit_matches_jax(tmp_path):
    """A standard ViT pretrained at grid 4 with 4 classes, finetuned at grid 5
    with 7: the head keeps its fresh init, the pos-embed is interpolated
    bicubically, everything else comes from the checkpoint; as JAX merges."""
    vit = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, qkv_bias=True,
               num_classes=7)
    path = _save(tmp_path / "vit.pth", {"model": {"module." + k: v for k, v in
                                                   _fake_standard_vit().items()}})
    jinit = jax.jit(JViT(img_size=40, **vit).init)(jax.random.PRNGKey(1),
                                                   jnp.zeros((1, 40, 40, 3)))
    merged = jfinetune.load_pretrained_for_finetune(path, jinit["params"])
    model = VisionTransformer(img_size=40, device="cpu", **vit)
    model.load_state_dict(params_from_jax(jinit, model), strict=True)
    ours = tfinetune.load_pretrained_for_finetune(path, model)
    theirs = params_from_jax({"params": jax.device_get(merged)}, model)
    assert ours.keys() == theirs.keys() == model.state_dict().keys()
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    torch.testing.assert_close(ours["head.weight"], model.head.weight.detach(), rtol=0, atol=0)
    assert tuple(ours["pos_embed"].shape) == (1, 25, 32)
    model.load_state_dict(ours, strict=True)


def test_finetune_octic_and_port_checkpoints(tmp_path):
    """An octic .pth with a 10-class head into a 3-class model (head kept,
    the rest loaded, as JAX does); then a port checkpoint directory (a train
    state, as the DeiT loop's ``best``) as the source."""
    sd = _fake_octic_state_dict(2, 32, patch=8, grid=4, ncls=10, hidden=64)
    path = _save(tmp_path / "octic.pth", {"model": sd})
    jmodel = JOctic(img_size=32, num_classes=3, **TINY)
    jinit = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    merged = jfinetune.load_pretrained_for_finetune(path, jinit["params"])
    model = OcticVisionTransformer(img_size=32, num_classes=3, device="cpu", **TINY)
    model.load_state_dict(params_from_jax(jinit, model), strict=True)
    ours = tfinetune.load_pretrained_for_finetune(path, model)
    theirs = params_from_jax({"params": jax.device_get(merged)}, model)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), err_msg=k)
    assert torch.equal(ours["head.weight"], model.head.weight.detach())
    # a port checkpoint directory: its "model" entry, head and all
    donor = OcticVisionTransformer(img_size=32, num_classes=3, device="cpu", **TINY)
    init_weights(donor, torch.Generator().manual_seed(9))
    C.save_tree(str(tmp_path / "best"), {"step": 4, "model": donor.state_dict()})
    got = tfinetune.load_pretrained_for_finetune(str(tmp_path / "best"), model)
    for k, v in donor.state_dict().items():
        assert torch.equal(got[k], v), k


def test_finetune_from_ssl_checkpoints(tmp_path):
    """A teacher export of the SSL loop and a whole SSL state: the teacher's
    backbone is what finetuning loads (as ``hub.load_backbone`` takes it),
    and a checkpoint of which nothing matches the model raises instead of
    leaving the model at its initialisation."""
    arch = SSLMetaArch(SSLConfig(arch="hybrid_dinov2_vit_tiny_test", img_size=32,
                                 local_crop_size=16, patch_size=8, dino_out_dim=64,
                                 dino_head_hidden_dim=32, dino_head_bottleneck_dim=16,
                                 ibot_out_dim=64, n_local_crops=2, compute_dtype=None),
                       device="cpu")
    state = arch.init(torch.Generator().manual_seed(3))
    export = C.save_teacher(str(tmp_path), 7, state.teacher_state_dict())
    whole = C.save_tree(str(tmp_path / "state"), state.state_dict())
    for source in (export, whole):
        model = create_model("hybrid_dinov2_vit_tiny_test", img_size=32, device="cpu")
        init_weights(model, torch.Generator().manual_seed(5))
        got = tfinetune.load_pretrained_for_finetune(source, model)
        assert got.keys() == model.state_dict().keys()
        for k, v in state.teacher["backbone"].state_dict().items():
            assert torch.equal(got[k], v), (source, k)
        model.load_state_dict(got, strict=True)
    other = create_model("hybrid_vit_small_test", img_size=32, device="cpu")
    with pytest.raises(ValueError, match="no tensor of the checkpoint"):
        tfinetune.load_pretrained_for_finetune(export, other)


def test_attn_only_mask_matches_jax():
    jmodel = J_reg.create_model("hybrid_vit_small_test", img_size=32)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    jmask = jfinetune.attn_only_trainable_mask(jparams)
    model = create_model("hybrid_vit_small_test", img_size=32, device="cpu")
    theirs = params_from_jax({"params": jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), jmask, jparams)}, model)
    ours = tfinetune.attn_only_trainable_mask(model)
    assert ours.keys() == dict(model.named_parameters()).keys()
    for name, flag in ours.items():
        assert flag == bool(theirs[name].reshape(-1)[0]), name
    assert 0 < sum(ours.values()) < len(ours)


def test_interpolate_vit_pos_embed_matches_jax():
    pos = np.random.default_rng(3).standard_normal((1, 36, 8)).astype(np.float32)
    for grid in (4, 6, 9):
        np.testing.assert_allclose(tfinetune.interpolate_vit_pos_embed(torch.from_numpy(pos),
                                                                       grid).numpy(),
                                   jfinetune.interpolate_vit_pos_embed(pos, grid),
                                   atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="square"):
        tfinetune.interpolate_vit_pos_embed(torch.zeros(1, 10, 8), 4)
