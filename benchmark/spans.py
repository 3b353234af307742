"""The program's spans (``octic_vits_tpu_torch/utils/tracing.py``) in a third
traced window, reduced to what the span readers read.

The window follows the two traced windows of a ``--trace 1`` run and the
reading of the peak memory, and runs the cell's traced steps again with the
program's spans on. The profiler records the device's activity alone, as in
the first window, so the host runs near its untraced pace; with it come the
CUDA runtime's records of each call (launches, copies, synchronizing calls),
on the clock the spans carry.

A runtime call belongs to the innermost span open at its start, found by
time: a trace of the device alone gives the calls no thread of the
program's, and while autograd's thread runs the backward, the step's thread
waits inside ``*.backward``, which holds the spans of the backward's ops. A
kernel or copy belongs where its launch does (the profiler's correlation
ids). A call blocks the host when it synchronizes (a stream, the device or
an event), or copies without ``Async``, or copies to or from pageable host
memory, which CUDA makes synchronous: PyTorch's blocking copy is such an
``Async`` copy followed by a stream synchronize, and the device-to-host one
waits in the copy. A sync is a synchronizing call or a copy without
``Async``: one for each blocking copy of PyTorch's.

A program without spans (no ``utils/tracing.py``) has no such window.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

from benchmark import trace as T

OUTSIDE = "outside_any_span"


@dataclasses.dataclass
class Call:
    """One call of the CUDA runtime API (``cuda*``) or of the lower-level ``cu*`` one."""

    name: str
    start: int
    end: int
    span: object = None  # the innermost program span open at its start
    pageable: bool = False  # a copy to or from pageable host memory

    @property
    def sync(self) -> bool:
        return "Synchronize" in self.name or (
            "Memcpy" in self.name and "Async" not in self.name)

    @property
    def blocking(self) -> bool:
        return self.sync or ("Memcpy" in self.name and self.pageable)


@dataclasses.dataclass
class Work:
    """One operation on the device, and the call that launched it."""

    name: str
    start: int
    end: int
    call: Optional[Call]

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(T.COPY_PREFIXES)


@dataclasses.dataclass
class SpanTrace:
    spans: list  # the program's spans (``tracing.Span``), in the order they opened
    calls: List[Call]
    device: List[Work]
    images: int
    host_s: List[float]  # host seconds of each of the cell's calls (steps or forwards)

    def __post_init__(self):
        self.by_id = {s.id: s for s in self.spans}
        self.roots = [s for s in self.spans if s.parent is None]

    def ancestors(self, span):
        while span is not None:
            yield span
            span = self.by_id.get(span.parent)

    def inside(self, span, suffix: str) -> bool:
        """Whether `span` or a span around it is named ``*<suffix>``."""
        return any(a.name.endswith(suffix) for a in self.ancestors(span))

    def per_root(self, value: float) -> Optional[float]:
        return value / len(self.roots) if self.roots else None


def innermost(spans: list, times: List[int]) -> list:
    """For each of the ascending `times`, the innermost of the nested `spans`
    open then (None where none is)."""
    order = sorted(spans, key=lambda s: (s.start, -s.end))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i].start <= t:
            while stack and stack[-1].end < order[i].start:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def from_events(events, spans: list, images: int, host_s: List[float]) -> SpanTrace:
    """A :class:`SpanTrace` of the profiler's raw events and the spans of the
    same window."""
    calls, device, by_corr = [], [], {}
    for e in events:
        if str(e.device_type()).endswith("CPU"):
            if e.name().startswith(T.RUNTIME_PREFIXES):
                call = Call(e.name(), e.start_ns(), e.end_ns())
                calls.append(call)
                by_corr[e.correlation_id()] = call
        elif not T.annotation(e):
            device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    calls.sort(key=lambda c: c.start)
    for call, span in zip(calls, innermost(spans, [c.start for c in calls])):
        call.span = span
    work = []
    for name, s, t, corr in device:
        call = by_corr.get(corr)
        if call is not None and "Pageable" in name:
            call.pageable = True
        work.append(Work(name, s, t, call))
    return SpanTrace(spans, calls, work, images, host_s)


def span_window(cell, device) -> Optional[SpanTrace]:
    """The third traced window of `cell` (after its two traced windows and
    the peak memory's reading), or None for a program without spans."""
    try:
        from octic_vits_tpu_torch.utils import tracing
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    host_s: List[float] = []
    if hasattr(cell, "request"):  # a forward: the host time until it returned
        def request(i, out, _call=cell.request):
            host_s.append(_call(i, out))
            return host_s[-1]

        cell.request = request
    else:  # a train step: the host time of the call
        def step(i, _call=cell.step):
            t0 = time.perf_counter()
            _call(i)
            host_s.append(time.perf_counter() - t0)

        cell.step = step
    tracing.take()
    sync()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            images = cell.trace_window()
            sync()
    finally:
        tracing.disable()
        cell.__dict__.pop("request", None)
        cell.__dict__.pop("step", None)
    return from_events(prof.profiler.kineto_results.events(), tracing.take(), images, host_s)


def host_ms(st: SpanTrace, keep) -> Optional[float]:
    """Host ms a root inside the outermost spans whose name `keep` accepts."""
    def outermost(s):
        return not any(keep(a.name) for a in st.ancestors(st.by_id.get(s.parent)))

    ns = sum(s.end - s.start for s in st.spans if keep(s.name) and outermost(s))
    return st.per_root(ns / 1e6)


def device_ms_per_img(st: SpanTrace, suffix: str) -> Optional[float]:
    """Device ms an image of the kernels launched inside a span ``*<suffix>``."""
    if not st.device:
        return None
    ns = sum(w.end - w.start for w in st.device
             if w.is_kernel and w.call is not None and st.inside(w.call.span, suffix))
    return ns / 1e6 / st.images


def idle_gaps_by_span(st: SpanTrace, top: int = 10) -> list:
    """The device's idle gaps of the window summed by the innermost span open
    when the launch that ended each gap was made: ``[[span, seconds]]``."""
    gaps: Dict[str, float] = collections.Counter()
    end = None
    for w in sorted(st.device, key=lambda w: w.start):
        if end is not None and w.start > end:
            span = w.call.span if w.call is not None else None
            gaps[span.name if span is not None else OUTSIDE] += (w.start - end) / 1e9
        end = w.end if end is None else max(end, w.end)
    return [[n, s] for n, s in gaps.most_common(top)]


def window_info(st: SpanTrace, top: int = 8) -> dict:
    """The window at a glance: its kernels and busy seconds, the host ms a
    root inside each span name and inside the runtime calls that start in a
    root, by name (the `top` longest), and the syncs a root by the innermost
    span they start in."""
    spans_ms: Dict[str, float] = collections.Counter()
    for s in st.spans:
        spans_ms[s.name] += (s.end - s.start) / 1e6
    calls_ms: Dict[str, float] = collections.Counter()
    syncs: Dict[str, int] = collections.Counter()
    for c in st.calls:
        if c.span is not None:
            calls_ms[c.name] += (c.end - c.start) / 1e6
            syncs[c.span.name] += c.sync
    n = max(len(st.roots), 1)
    return {"roots": len(st.roots), "kernels": sum(w.is_kernel for w in st.device),
            "busy_s": T.Trace([], st.device, 0.0).busy_s(),
            "span_ms": {k: v / n for k, v in spans_ms.most_common()},
            "calls_ms": {k: v / n for k, v in calls_ms.most_common(top)},
            "syncs": {k: v / n for k, v in syncs.most_common() if v}}


def coverage(st: SpanTrace) -> dict:
    """The share of the cell's host time of its calls inside the root spans,
    and of the window's kernels' device time launched inside them."""
    roots_s = sum(s.end - s.start for s in st.roots) / 1e9
    kernels = [w for w in st.device if w.is_kernel]
    inside = sum(w.end - w.start for w in kernels if w.call is not None and w.call.span)
    total = sum(w.end - w.start for w in kernels)
    return {"root_host_share": roots_s / sum(st.host_s) if st.host_s else None,
            "root_kernel_share": inside / total if total else None}
