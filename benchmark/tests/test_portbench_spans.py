"""The window with the program's spans: the span readers and the idle gaps
by span on synthetic traces, the span metrics' entries against the
manifest's rules, and whole runs of the tiny cells on the CPU, in which the
spans are off in the untraced and the two traced windows and on in the
third."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, span_run, spans
from benchmark.entries import deit_step, infer
from benchmark.tests import tiny
from benchmark.tests.test_portbench_manifest import MANIFEST, NAME, UNIT
from benchmark.tests.test_portbench_trace import Ev
from octic_vits_tpu_torch.utils import tracing


def S(id, name, start, end, parent=None, root=0, tid=1):
    return tracing.Span(id, name, start, end, tid, parent, root)


def train_trace():
    """One DeiT step (root id 7) from 0 to 10000 ns: a sync in the masks,
    the backward with an op span on autograd's thread, the update; a sync
    of the client's after the step."""
    program = [
        S(0, "deit.step", 0, 10000, root=7),
        S(1, "deit.forward", 100, 3000, parent=0, root=7),
        S(2, "vit.forward", 110, 2990, parent=1, root=7),
        S(3, "vit.masks", 200, 1000, parent=2, root=7),
        S(4, "deit.backward", 3000, 8000, parent=0, root=7),
        S(5, "op._OcticAttention.bwd", 4000, 6000, parent=4, root=7, tid=2),
        S(6, "deit.update", 8000, 9900, parent=0, root=7),
    ]
    events = [
        Ev("cudaLaunchKernel", 150, 160, corr=1),
        # a drop-path mask to the card: an Async copy from pageable memory, then the sync
        Ev("cudaMemcpyAsync", 300, 320, corr=2),
        Ev("cudaStreamSynchronize", 330, 900, corr=3),
        Ev("cudaLaunchKernel", 950, 960, corr=4),  # ends a gap, inside vit.masks
        Ev("cudaLaunchKernel", 3100, 3110, corr=5),  # the backward's plain part
        Ev("cudaLaunchKernel", 4100, 4110, corr=6),  # from autograd's thread, in the op
        Ev("cudaLaunchKernel", 8100, 8110, corr=7),  # the update
        Ev("cudaStreamSynchronize", 10100, 12000, corr=8),  # the client's, outside the root
        Ev("k_fwd", 170, 320, device="CUDA", corr=1),
        Ev("Memcpy HtoD (Pageable -> Device)", 890, 895, device="CUDA", corr=2),
        Ev("k_after_masks", 1000, 2000, device="CUDA", corr=4),
        Ev("k_bwd_plain", 3200, 3700, device="CUDA", corr=5),
        Ev("k_bwd_op", 4200, 5200, device="CUDA", corr=6),
        Ev("k_update", 8200, 8600, device="CUDA", corr=7),
        Ev("Optimizer.step#Lamb.step", 8000, 9000, device="CUDA"),  # a range, no work
    ]
    return spans.from_events(events, program, images=4, host_s=[10000e-9 / 0.99])


def ctx(st):
    return SimpleNamespace(spans=st)


def read(name, st):
    return harness.read_metric(name, ctx(st))


def test_calls_belong_to_the_innermost_span_by_time():
    st = train_trace()
    where = {c.start: (c.span.name if c.span else None) for c in st.calls}
    assert where[300] == where[330] == where[950] == "vit.masks"
    assert where[4100] == "op._OcticAttention.bwd"
    assert where[3100] == "deit.backward" and where[10100] is None
    assert [c.pageable for c in st.calls[:3]] == [False, True, False]


def test_blocking_calls_inside_the_root_only():
    st = train_trace()
    # the pageable copy and its sync; the client's sync after the step is outside
    assert read("host_wait_ms.train", st) == pytest.approx((20 + 570) / 1e6)
    assert read("syncs_per_step.train", st) == 1.0
    assert spans.window_info(st)["syncs"] == {"vit.masks": 1.0}


def test_backward_counts_kernels_launched_from_autograds_thread():
    st = train_trace()
    assert read("backward_ms_per_img.train", st) == pytest.approx((500 + 1000) / 1e6 / 4)
    assert read("update_ms_per_img.train", st) == pytest.approx(400 / 1e6 / 4)


def test_gap_ended_by_a_launch_inside_vit_masks():
    st = train_trace()
    gaps = dict(spans.idle_gaps_by_span(st))
    # 320 -> 890 before the copy, 895 -> 1000 before the kernel: both from vit.masks
    assert gaps["vit.masks"] == pytest.approx((570 + 105) / 1e9)
    assert gaps["deit.backward"] == pytest.approx(1200 / 1e9)
    assert gaps["op._OcticAttention.bwd"] == pytest.approx(500 / 1e9)
    assert gaps["deit.update"] == pytest.approx(3000 / 1e9)


def test_host_spans_and_coverage():
    program = [S(0, "vit.forward", 0, 1000), S(1, "vit.octic_blocks", 100, 600, parent=0),
               S(2, "op._MlpD8Fused.fwd", 150, 250, parent=1),
               S(3, "op._LnAffine.fwd", 160, 200, parent=2),  # nested: counted once
               S(4, "op._OcticAttentionFusedQKV.fwd", 300, 400, parent=1),
               S(5, "vit.forward", 2000, 3000, root=1),
               S(6, "vit.octic_blocks", 2100, 2500, parent=5, root=1)]
    events = [Ev("cudaLaunchKernel", 170, 180, corr=1),
              Ev("cudaLaunchKernel", 3500, 3510, corr=2),  # after the last root
              Ev("k1", 200, 400, device="CUDA", corr=1), Ev("k2", 3600, 3700, device="CUDA", corr=2)]
    st = spans.from_events(events, program, images=8, host_s=[1e-6, 1e-6])
    assert read("octic_host_ms.infer", st) == pytest.approx((500 + 400) / 2 / 1e6)
    assert read("ops_host_ms.infer", st) == pytest.approx((100 + 100) / 2 / 1e6)
    assert read("host_wait_ms.infer", st) == 0.0
    cov = spans.coverage(st)
    assert cov["root_host_share"] == pytest.approx(1.0)
    assert cov["root_kernel_share"] == pytest.approx(200 / 300)


def test_readers_read_nothing_without_spans():
    for name in ("host_wait_ms", "syncs_per_step", "octic_host_ms", "ops_host_ms",
                 "backward_ms_per_img", "update_ms_per_img"):
        assert read(f"{name}.train", None) is None
        assert harness.read_metric(f"{name}.train", SimpleNamespace()) is None


def test_span_metric_entries_follow_the_manifests_rules():
    entries = json.loads((tiny.BENCH / "span_metrics.json").read_text())["per_layer"]
    assert len(entries) == 16
    known = {m["name"] for m in MANIFEST["per_layer"]}
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    moves = {m["name"].split(".", 1)[1]: m["moves"] for m in MANIFEST["per_layer"]}
    for m in entries:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in known
        assert m["source"] == "program_span" and m["layer"] in layers
        assert moves[m["name"].split(".", 1)[1]] == m["moves"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]]["workloads"]
        harness.read_metric(m["name"], SimpleNamespace(spans=None))  # a reader exists


def flagged(cls):
    """The entry's cell, noting whether spans were on in each window."""

    class Flagged(cls):
        seen: list = []

        def window(self, seconds):
            self.seen.append(("window", tracing.enabled()))
            return super().window(seconds)

        def trace_window(self):
            self.seen.append(("traced", tracing.enabled()))
            return super().trace_window()

    Flagged.seen = []
    return Flagged


@pytest.mark.parametrize("mix_name,cls", [("infer_b64", infer.Cell),
                                          ("deit_b256", deit_step.Cell)])
def test_spans_are_on_in_the_third_window_alone(mix_name, cls):
    real = harness.find_cell(next(c for c in tiny.cell_names() if c.endswith(mix_name)))
    spec = tiny.spec(mix_name, real.limits)
    factory = flagged(cls)
    res = span_run.run_cell(spec, 2 ** 31 + 23, 0.3, "cpu", time.perf_counter(),
                            cell_factory=factory)
    assert factory.seen == [("window", False), ("traced", False), ("traced", False),
                            ("traced", True)]
    assert not tracing.enabled() and tracing.take() == []
    assert res["correct"], res["checks"]
    assert "idle_gaps_by_span" in res["breakdown"]
    if mix_name == "infer_b64":  # host spans read on the CPU too; device ones need the card
        assert res["metrics"]["octic_host_ms.infer"]["value"] > 0
        assert res["metrics"]["ops_host_ms.infer"]["value"] > 0
        assert res["span_coverage"]["root_host_share"] > 0.5
