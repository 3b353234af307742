"""The port's checkpointing on the CPU: bitwise round trips of the DeiT III
train state (parameters, LAMB moments, EMA, step) and of the DINOv2 SSL state
(student, teacher, AdamW moments, centers, step); keep-N rotation and the
interval gate, held to the JAX package's orbax manager on the same steps; a
save followed by an in-place step keeping the saved copy; the teacher export;
failures that leave no partial checkpoint; and the preemption guard on a real
SIGTERM."""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.utils import checkpoint as jckpt
from octic_vits_tpu_torch import create_model, init_weights
from octic_vits_tpu_torch.train import common
from octic_vits_tpu_torch.train.deit import engine
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch, batch_to_device
from octic_vits_tpu_torch.utils import checkpoint as C
from torch_time_limit import time_limit  # noqa: F401

# each test waits at most torch_time_limit.LIMIT_S seconds, then fails
pytestmark = pytest.mark.usefixtures("time_limit")

torch.set_num_threads(1)
SSL_CFG = dict(arch="hybrid_dinov2_vit_tiny_test", img_size=32, local_crop_size=16, patch_size=8,
               drop_path_rate=0.0, dino_out_dim=64, dino_head_hidden_dim=32,
               dino_head_bottleneck_dim=16, ibot_out_dim=64, n_local_crops=2, compute_dtype=None)

def _equal_trees(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _deit_state(seed, opt="lamb"):
    model = create_model("hybrid_vit_small_test", img_size=32, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    cfg = engine.DeiTConfig(num_classes=10, opt=opt, steps_per_epoch=4, epochs=2,
                            warmup_epochs=1, drop_path=0.0)
    optimizer = engine.build_optimizer(cfg, model)
    return (common.create_train_state(model, optimizer, ema=True),
            engine.make_deit_train_step(model, cfg, optimizer))


def _deit_step(state, step, seed):
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(4, 32, 32, 3, generator=g)
    labels = torch.randint(0, 10, (4,), generator=g)
    return step(state, images, labels, g)[0]


@pytest.mark.parametrize("opt", ["lamb", "adamw"])
def test_deit_state_round_trip_bitwise(tmp_path, opt):
    state, step = _deit_state(0, opt)
    for i in range(2):
        state = _deit_step(state, step, i)
    mgr = C.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(state.step, state.state_dict()) is not None
    mgr.wait()
    fresh, fresh_step = _deit_state(1, opt)  # other weights, no moments yet
    fresh.load_state_dict(mgr.restore())
    mgr.close()
    assert fresh.step == state.step == 2
    _equal_trees(fresh.state_dict(), state.state_dict())
    # and the next step from each is the same, bit for bit
    state, fresh = _deit_step(state, step, 5), _deit_step(fresh, fresh_step, 5)
    _equal_trees(fresh.state_dict(), state.state_dict())


def _ssl_batch(b=2, seed=0):
    import random

    from octic_vits_tpu_torch.train.dinov2.masking import MaskingGenerator, collate_crops_and_masks

    npr = np.random.RandomState(seed)
    gen = MaskingGenerator(4, num_masking_patches=8)
    return collate_crops_and_masks(npr.randn(2 * b, 32, 32, 3).astype(np.float32),
                                   npr.randn(2 * b, 16, 16, 3).astype(np.float32), 16, gen,
                                   rng=random.Random(seed))


def test_ssl_state_round_trip_bitwise(tmp_path):
    arch = SSLMetaArch(SSLConfig(**SSL_CFG), device="cpu")
    state = arch.init(torch.Generator().manual_seed(0))
    sched = dict(lr=1e-3, wd=0.04, last_layer_lr=1e-3, momentum=0.9, teacher_temp=0.04)
    state, _ = arch.make_train_step()(state, batch_to_device(_ssl_batch(), "cpu"), sched,
                                      torch.Generator().manual_seed(1))
    mgr = C.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state.state_dict())
    fresh = arch.init(torch.Generator().manual_seed(7))
    fresh.load_state_dict(mgr.restore())
    mgr.close()
    assert fresh.step == 1
    _equal_trees(fresh.state_dict(), state.state_dict())
    assert state.dino_center.abs().max() > 0  # the centers moved and came back
    # the teacher export holds the teacher by submodule
    path = C.save_teacher(str(tmp_path), 1, state.teacher_state_dict())
    assert path == str(tmp_path / "eval" / "1" / "teacher")
    tree = C.load_teacher(path)
    assert set(tree) == {"backbone", "dino_head"}
    _equal_trees(tree, state.teacher_state_dict())


def test_keep_n_rotation_and_interval_gate_match_orbax(tmp_path):
    """The same saves through the port's manager and the JAX package's orbax
    one: the same should_save answers, the same steps kept."""
    tree = {"w": torch.arange(6.0), "step": 0}
    jtree = {"w": jnp.arange(6.0)}
    ours = C.CheckpointManager(str(tmp_path / "ours"), max_to_keep=2, save_interval_steps=3)
    theirs = jckpt.CheckpointManager(str(tmp_path / "jax"), max_to_keep=2, save_interval_steps=3)
    answers = []
    for step in (1, 2, 3, 4, 5, 6, 7, 9, 12):
        a, b = ours.should_save(step), theirs.should_save(step)
        answers.append((step, a, b))
        if a:
            ours.save(step, dict(tree, step=step))
        if b:
            theirs.save(step, jtree)
        ours.wait()
        theirs.wait()
    assert all(a == b for _, a, b in answers), answers
    assert [s for s, a, _ in answers if a] == [1, 3, 6, 9, 12]
    assert ours.all_steps() == [9, 12] and ours.latest_step() == theirs.latest_step() == 12
    assert ours.save(13, tree) is None  # gated: no host copy, nothing written
    assert ours.save(13, dict(tree, step=13), force=True) is not None
    assert ours.restore(step=12)["step"] == 12 and ours.restore()["step"] == 13
    assert ours.all_steps() == [12, 13]
    ours.close()
    theirs.close()


def test_save_keeps_the_state_of_its_step(tmp_path):
    """The host copy is taken before save returns: an in-place step right
    after it leaves the checkpoint holding the saved step's values."""
    state, step = _deit_state(0)
    state = _deit_step(state, step, 0)
    before = C.to_host(state.state_dict())
    mgr = C.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state.state_dict())
    state = _deit_step(state, step, 1)  # in place, while the write may still run
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    restored = mgr.restore(step=1)
    mgr.close()
    _equal_trees(restored, before)
    assert not torch.equal(restored["model"]["head.weight"], state.model.head.weight.detach())


def test_failed_writes_leave_no_partial_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="names"):
        C.save_tree(str(tmp_path / "bad"), {"a/b": torch.zeros(1)})
    mgr = C.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"w": torch.ones(2)})
    mgr.save(2, {"w": torch.ones(2), "fn": lambda x: x})  # torch.save cannot pickle it
    with pytest.raises(Exception):
        mgr.wait()  # the background write's error surfaces here
    assert mgr.all_steps() == [1]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1"]  # no temporary leftovers
    assert not (tmp_path / "bad").exists()
    mgr.close()
    # an existing export is replaced whole
    C.save_tree(str(tmp_path / "best"), {"w": torch.zeros(3)})
    C.save_tree(str(tmp_path / "best"), {"v": torch.ones(1)})
    assert set(C.load_tree(str(tmp_path / "best"))) == {"v"}
    assert sorted(os.listdir(tmp_path)) == ["best", "ckpt"]


def test_load_tree_refuses_orbax(tmp_path):
    import orbax.checkpoint as ocp

    path = str(tmp_path / "orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, {"w": np.ones(3, np.float32)})
    ckptr.wait_until_finished()
    assert not C.is_checkpoint(path)
    with pytest.raises(NotImplementedError, match="orbax checkpoint of the JAX package needs JAX"):
        C.load_tree(path)
    C.save_tree(str(tmp_path / "ours"), {"w": torch.ones(3)})
    assert C.is_checkpoint(str(tmp_path / "ours"))


def test_preemption_guard_on_a_real_sigterm():
    previous = signal.getsignal(signal.SIGTERM)
    guard = C.PreemptionGuard()
    try:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not guard.preempted and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.preempted
        os.kill(os.getpid(), signal.SIGUSR1)  # also recorded, not fatal
    finally:
        guard.close()
    assert signal.getsignal(signal.SIGTERM) is previous  # handlers put back
