"""The trace reduction on synthetic profiler events: nesting, the op layer's
kernels and calls, busy time, the breakdown."""

from __future__ import annotations

import pytest

from benchmark import trace as T


class Ev:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, start, end, device="CPU", corr=0, link=0, tid=1, shapes=()):
        self._v = (name, start, end, device, corr, link, tid, list(shapes))

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def shapes(self):
        return self._v[7]


OPS = {"octic_attention": {"forward": "_OcticAttention", "backward": "_OcticAttentionBackward",
                           "fwd_arg": 1, "bwd_arg": 0}}


def events():
    return [
        Ev("forward", 0, 1000, corr=1),
        Ev("_OcticAttention", 100, 300, corr=2, shapes=([], [8, 257, 480], [8, 257, 480])),
        Ev("aten::empty", 110, 120, corr=3),
        Ev("cudaLaunchKernel", 150, 160, corr=90, link=2),
        Ev("aten::mul", 400, 500, corr=4),
        Ev("cudaLaunchKernel", 410, 420, corr=91, link=4),
        # the backward, on the autograd thread
        Ev("autograd::engine::evaluate_function: _OcticAttentionBackward", 2000, 2600, corr=5,
           tid=2),
        Ev("_OcticAttentionBackward", 2010, 2590, corr=6, tid=2, shapes=([8, 257, 160],)),
        Ev("aten::add", 2100, 2200, corr=7, tid=2),
        # device work: the forward's kernel, a plain one, the backward's plain kernel,
        # a hand-written kernel the profiler could not tie, a copy
        Ev("ovt::attn", 200, 700, device="CUDA", link=2),
        Ev("elementwise", 700, 900, device="CUDA", link=4),
        Ev("reduce", 2300, 2500, device="CUDA", link=7),
        Ev("ovt::attn_bwd", 2500, 3000, device="CUDA", link=0),
        Ev("Memcpy DtoH", 3000, 3100, device="CUDA", link=4),
        # a named range drawn over the device's timeline: no device work
        Ev("Optimizer.step#Lamb.step", 0, 3100, device="CUDA", link=0),
    ]


def test_nesting_and_attribution():
    tr = T.from_kineto(events(), wall_s=4e-6)
    by = {o.name: o for o in tr.host}
    assert by["_OcticAttention"].parent is by["forward"]
    assert by["aten::add"].parent is by["_OcticAttentionBackward"]
    assert by["_OcticAttentionBackward"].parent.name.startswith("autograd::engine")
    layer = T.op_layer(tr, OPS)
    assert layer["calls"] == {("octic_attention", "fwd", 8, 257): 1,
                              ("octic_attention", "bwd", 8, 257): 1}
    assert layer["op_ns"] == 500 + 200 + 500
    assert layer["other_ns"] == 200
    assert len(tr.kernels()) == 4  # the copy is device work, not a kernel


def test_busy_is_the_union_of_device_intervals():
    tr = T.from_kineto(events(), wall_s=4e-6)
    assert tr.busy_s() == pytest.approx((900 - 200 + 3100 - 2300) / 1e9)


def test_breakdown_ranks_device_ops_and_gaps_by_host_op():
    tr = T.from_kineto(events(), wall_s=4e-6)
    b = T.breakdown(tr)
    assert b["device_ops"][0] == ["ovt::attn", pytest.approx(5e-7)]
    assert b["idle_gaps"] == [["aten::add", pytest.approx(1400 / 1e9)]]


def test_breakdown_takes_the_gaps_from_the_host_window():
    device_only = T.from_kineto([e for e in events() if e.device_type().endswith("CUDA")],
                                wall_s=4e-6)
    assert device_only.busy_s() == T.from_kineto(events(), wall_s=4e-6).busy_s()
    alone = T.breakdown(device_only)
    assert alone["idle_gaps"] == [[T.OUTSIDE, pytest.approx(1400 / 1e9)]]
    b = T.breakdown(device_only, T.from_kineto(events(), wall_s=4e-6))
    assert b["device_ops"] == alone["device_ops"]
    assert b["idle_gaps"] == [["aten::add", pytest.approx(1400 / 1e9)]]


def test_idle_share_is_of_the_untraced_window():
    from types import SimpleNamespace

    from benchmark.metrics import idle_share
    from benchmark.window import Window

    tr = T.from_kineto(events(), wall_s=4e-6)  # 1.5 us busy over 2 images
    # 4 steps of 2 images in 8 us: 1 image a us, so busy 0.75 of the untraced wall
    ctx = SimpleNamespace(trace=tr, trace_images=2, images_per_step=2,
                          window=Window(4, 8e-6, [], []))
    assert idle_share.read(ctx) == pytest.approx(25.0)
    ctx.window = Window(0, 1.0, [], [])
    assert idle_share.read(ctx) is None
