"""The port's spans (``octic_vits_tpu_torch/utils/tracing.py``): off they are
one shared no-op; on, the DeiT III step, the DINOv2 step and an inference
forward record their span trees (step phases, the trunk's stages, each
op's forward and backward) and compute bitwise what they compute with
tracing off. The last test needs the card: a span and the profiler's
records of the launch inside it share one clock. This file imports no JAX;
run its card test as
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py
"""

import collections
import random
import threading

import numpy as np
import pytest
import torch

from octic_vits_tpu_torch import create_model, init_weights
from octic_vits_tpu_torch.train.common import create_train_state
from octic_vits_tpu_torch.train.deit import engine
from octic_vits_tpu_torch.train.dinov2 import masking
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch, batch_to_device
from octic_vits_tpu_torch.utils import tracing

IMG = 32
# the octic blocks' ops: eval mode's fused ones, the DeiT III step's, the
# DINOv2 student's (fused qkv)
EVAL_OPS = {"op._OcticAttentionFusedQKV.fwd", "op._MlpD8Fused.fwd"}
DEIT_OPS = {"op._OcticAttention.fwd", "op._LinearD8Fused.fwd"}
SSL_OPS = {"op._OcticAttentionFusedQKV.fwd", "op._LinearD8Fused.fwd"}


@pytest.fixture
def traced():
    """Tracing on for the test, off and emptied after it."""
    tracing.take()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.take()


def _children(spans):
    """Span id -> the spans whose parent it is, in the order they opened."""
    kids = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)
    return kids


def _names(spans):
    return {s.name for s in spans}


def _check_forward(vit, kids, octic_ops: set):
    """A ``vit.forward`` span holds the six stages in order, each op's
    forward span inside a stage of blocks."""
    stages = kids[vit.id]
    assert [s.name for s in stages] == ["vit.embed", "vit.masks", "vit.octic_blocks",
                                        "vit.break", "vit.standard_blocks", "vit.head"]
    for s in stages:
        assert vit.start <= s.start <= s.end <= vit.end and s.root == vit.root
    octic = {s.name for s in kids[stages[2].id]}
    standard = {s.name for s in kids[stages[4].id]}
    assert octic == octic_ops
    assert standard == {"op._StandardAttention.fwd", "op._DenseGelu.fwd"}


# ---- the switch --------------------------------------------------------------

def test_off_is_one_shared_noop():
    tracing.take()
    assert not tracing.enabled()
    first = tracing.span("deit.step", root=3)
    assert first is tracing.span("vit.forward") is tracing.span("x")
    with first, tracing.span("y"):
        pass
    model = create_model("hybrid_vit_small_test", img_size=IMG, device="cpu").eval()
    with torch.no_grad():
        model(torch.zeros(1, IMG, IMG, 3))
    assert tracing.take() == []


def test_take_empties_the_list(traced):
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    spans = tracing.take()
    assert [s.name for s in spans] == ["a", "b"]
    a, b = spans
    assert a.parent is None and b.parent == a.id and b.root == a.root
    assert a.start <= b.start <= b.end <= a.end
    assert tracing.take() == []


def test_roots_take_their_step_or_a_count(traced):
    with tracing.span("deit.step", root=41):
        pass
    with tracing.span("vit.forward"):
        pass
    with tracing.span("vit.forward"):
        pass
    step, f1, f2 = tracing.take()
    assert step.root == 41
    assert f2.root == f1.root + 1


def test_a_span_on_another_thread_joins_the_open_root(traced):
    """The backward's op spans run on autograd's device thread: a span
    opened where no span is open hangs under the innermost span of the
    thread that holds the open root, with its root id."""
    tids = []

    def other():
        with tracing.span("op.X.bwd"):
            tids.append(threading.get_native_id())

    with tracing.span("deit.step", root=5):
        with tracing.span("deit.backward"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    t2 = threading.Thread(target=other)  # no root open: its own root
    t2.start()
    t2.join(timeout=30)
    assert not t2.is_alive()
    step, backward, joined, alone = tracing.take()
    assert joined.parent == backward.id and joined.root == 5
    assert joined.tid == tids[0] != step.tid
    assert alone.parent is None and alone.root != 5


def test_a_span_is_a_profiler_range_under_a_host_profile(traced):
    """Under a profiler that records the host's ops, each span is a range of
    its name around the aten ops it ran."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("vit.head"):
            torch.mm(x, x)
    spans = tracing.take()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    rng, mm = events["vit.head"], events["aten::mm"]
    assert rng.start_ns() <= mm.start_ns() <= mm.end_ns() <= rng.end_ns()
    # the span's record lies inside the range of its name, on one clock
    assert rng.start_ns() <= spans[0].start <= spans[0].end <= rng.end_ns()


# ---- the program's spans -----------------------------------------------------

def _deit_state(seed=0):
    model = create_model("hybrid_vit_small_test", img_size=IMG, drop_path_rate=0.3,
                         device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    cfg = engine.DeiTConfig(num_classes=10, warmup_epochs=0, epochs=10, steps_per_epoch=10,
                            lr=1e-3)
    opt = engine.build_optimizer(cfg, model)
    state = create_train_state(model, opt, ema=True)
    return state, engine.make_deit_train_step(model, cfg, opt)


def _deit_steps(n=2):
    state, step = _deit_state()
    rng = torch.Generator().manual_seed(1)
    out = []
    for i in range(n):
        images = torch.randn(4, IMG, IMG, 3, generator=rng)
        labels = torch.randint(0, 10, (4,), generator=rng)
        state, metrics = step(state, images, labels, torch.Generator().manual_seed(100 + i))
        out.append(metrics)
    return state, out


def _assert_same_state(a, b):
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a.ema[n], b.ema[n]), f"ema {n}"


def test_deit_step_spans_and_bitwise_outputs():
    plain_state, plain = _deit_steps()
    tracing.enable()
    try:
        state, traced_metrics = _deit_steps()
    finally:
        tracing.disable()
    spans = tracing.take()
    for m0, m1 in zip(plain, traced_metrics):
        assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"],
                                                                   m1["grad_norm"])
    _assert_same_state(plain_state, state)

    kids = _children(spans)
    roots = [s for s in spans if s.parent is None]
    assert [(s.name, s.root) for s in roots] == [("deit.step", 0), ("deit.step", 1)]
    for root in roots:
        phases = kids[root.id]
        assert [s.name for s in phases] == ["deit.mixup", "deit.forward", "deit.backward",
                                            "deit.update"]
        assert [s.name for s in kids[phases[3].id]] == ["deit.clip", "deit.optimizer",
                                                        "deit.ema"]
        (vit,) = kids[phases[1].id]
        assert vit.name == "vit.forward"
        _check_forward(vit, kids, DEIT_OPS)
        tree = [s for s in spans if s.root == root.root]
        assert all(root.start <= s.start <= s.end <= root.end for s in tree)
        backward = {s.name for s in kids[phases[2].id]}
        assert backward == {"op._OcticAttention.bwd", "op._LinearD8Fused.bwd",
                            "op._StandardAttention.bwd", "op._DenseGelu.bwd"}


def _ssl_setup():
    cfg = dict(arch="hybrid_dinov2_vit_tiny_test", img_size=32, local_crop_size=16,
               patch_size=8, drop_path_rate=0.2, dino_out_dim=64, dino_head_hidden_dim=32,
               dino_head_bottleneck_dim=16, ibot_out_dim=64, n_local_crops=2)
    arch = SSLMetaArch(SSLConfig(**cfg, compute_dtype=None), device="cpu")
    state = arch.init(torch.Generator().manual_seed(0))
    grid = cfg["img_size"] // cfg["patch_size"]
    npr = np.random.RandomState(0)
    gc = npr.randn(4, 32, 32, 3).astype(np.float32)
    lc = npr.randn(4, 16, 16, 3).astype(np.float32)
    batch = masking.collate_crops_and_masks(
        gc, lc, grid * grid, masking.MaskingGenerator(grid, num_masking_patches=grid * grid // 2),
        rng=random.Random(0))
    return arch, state, batch_to_device(batch, "cpu")


def _ssl_step():
    arch, state, batch = _ssl_setup()
    sched = dict(lr=1e-3, wd=0.04, last_layer_lr=5e-4, momentum=0.9, teacher_temp=0.04)
    return arch.make_train_step()(state, batch, sched, torch.Generator().manual_seed(0))


def test_ssl_step_spans_and_bitwise_outputs():
    plain_state, plain = _ssl_step()
    tracing.enable()
    try:
        state, metrics = _ssl_step()
    finally:
        tracing.disable()
    spans = tracing.take()
    assert plain.keys() == metrics.keys()
    for k in plain:
        assert torch.equal(plain[k], metrics[k]), k
    for a, b in ((plain_state.student, state.student), (plain_state.teacher, state.teacher)):
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(p, q), n
    for n in plain_state.mu:
        assert torch.equal(plain_state.mu[n], state.mu[n]) and torch.equal(
            plain_state.nu[n], state.nu[n]), n

    kids = _children(spans)
    (root,) = [s for s in spans if s.parent is None]
    assert (root.name, root.root) == ("ssl.step", 0)
    phases = kids[root.id]
    assert [s.name for s in phases] == ["ssl.teacher", "ssl.student", "ssl.loss",
                                        "ssl.backward", "ssl.update"]
    assert [s.name for s in kids[phases[4].id]] == ["ssl.clip", "ssl.optimizer",
                                                    "ssl.teacher_ema"]
    (teacher,) = kids[phases[0].id]
    _check_forward(teacher, kids, EVAL_OPS)  # the teacher runs in eval mode
    student = [s for s in kids[phases[1].id] if s.name == "vit.forward"]
    assert len(student) == 2  # the global crops, then the local ones
    for vit in student:
        _check_forward(vit, kids, SSL_OPS)
    assert all(s.root == 0 for s in spans)
    assert _names(kids[phases[3].id]) == {"op._OcticAttentionFusedQKV.bwd", "op._LinearD8Fused.bwd",
                                          "op._StandardAttention.bwd", "op._DenseGelu.bwd"}


def test_inference_forward_spans_and_bitwise_outputs():
    model = create_model("hybrid_vit_small_test", img_size=IMG, device="cpu").eval()
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        plain = model(x)
        tracing.enable()
        try:
            first, second = model(x), model(x)
        finally:
            tracing.disable()
    spans = tracing.take()
    assert torch.equal(plain, first) and torch.equal(plain, second)
    kids = _children(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["vit.forward", "vit.forward"]
    assert roots[1].root == roots[0].root + 1
    for vit in roots:
        _check_forward(vit, kids, EVAL_OPS)


# ---- the card ----------------------------------------------------------------

@pytest.mark.gpu
def test_span_shares_the_profilers_clock_on_the_card(traced):
    """A span around one known launch holds that launch's runtime record and
    its kernel's start, in a profile of the device's activity alone; the span
    and the profiler's range of its name agree within 50 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(4096, 4096, device="cuda")
    torch.mul(a, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("probe.mul"):
            torch.mul(a, 2)
            torch.cuda.synchronize()
    (sp,) = tracing.take()
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if str(e.device_type()).endswith("CPU")
                and "LaunchKernel" in e.name()]
    assert len(launches) == 1
    assert sp.start <= launches[0].start_ns() <= launches[0].end_ns() <= sp.end
    (kernel,) = [e for e in events if not str(e.device_type()).endswith("CPU")
                 and e.correlation_id() == launches[0].correlation_id()]
    assert launches[0].start_ns() <= kernel.start_ns() <= sp.end

    # with the host's ops recorded the span is also the profiler's range
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span("probe.mul"):
            torch.mul(a, 2)
        torch.cuda.synchronize()
    (sp,) = tracing.take()
    (rng,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe.mul"]
    assert abs(rng.start_ns() - sp.start) < 50_000 and abs(rng.end_ns() - sp.end) < 50_000
