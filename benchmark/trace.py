"""The traced window: ``torch.profiler`` over a few steady steps, reduced to
what the per-layer readers read. Device work comes from the profiler's
device events (kernels, copies and fills, with their start and length); each
kernel is tied to the host op that launched it by the profiler's
correlation ids, and a host op to the ops around it by nesting on its
thread. An op of the op layer (``ops/<name>.json``) is found by its
autograd Function's name (the forward) or its backward node's name; the
kernels launched inside it, or inside an op nested in it, are its kernels.
A hand-written kernel (``ovt`` in its name) that the profiler could not tie
to a host op counts as the op layer's too."""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

RUNTIME_PREFIXES = ("cuda", "cu", "nccl")
COPY_PREFIXES = ("Memcpy", "Memset")
OUTSIDE = "host:outside_any_profiled_op"
NAME_CHARS = 120  # a kernel's name in the breakdown, cut


@dataclasses.dataclass
class HostOp:
    name: str
    start: int
    end: int
    tid: int
    shapes: tuple = ()
    parent: Optional["HostOp"] = None
    children: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    op: Optional[HostOp]  # the innermost host op that launched it

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(COPY_PREFIXES)


@dataclasses.dataclass
class Trace:
    host: List[HostOp]
    device: List[DeviceOp]
    wall_s: float  # the traced window by the host clock

    def kernels(self) -> List[DeviceOp]:
        return [d for d in self.device if d.is_kernel]

    def busy_s(self) -> float:
        """Seconds in which some device work ran (the union of intervals)."""
        busy, end = 0, None
        for d in sorted(self.device, key=lambda d: d.start):
            if end is None or d.start >= end:
                busy += d.end - d.start
                end = d.end
            elif d.end > end:
                busy += d.end - end
                end = d.end
        return busy / 1e9


def nest(ops: List[HostOp]) -> None:
    """Set each op's parent: the innermost op of its thread that encloses it."""
    by_tid = collections.defaultdict(list)
    for op in ops:
        by_tid[op.tid].append(op)
    for seq in by_tid.values():
        seq.sort(key=lambda o: (o.start, -o.end))
        stack: List[HostOp] = []
        for op in seq:
            while stack and stack[-1].end < op.end:
                stack.pop()
            op.parent = stack[-1] if stack else None
            if op.parent is not None:
                op.parent.children.append(op)
            stack.append(op)


def annotation(e) -> bool:
    """A range the program named (``record_function``, the optimizers' steps),
    drawn on the device's timeline over the kernels it holds: no device work."""
    user = getattr(e, "is_user_annotation", None)
    return bool(user and user()) or e.name().startswith(("Optimizer.", "ProfilerStep"))


def from_kineto(events, wall_s: float) -> Trace:
    """A :class:`Trace` of the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    host, device, by_corr = [], [], {}
    for e in events:
        if str(e.device_type()).endswith("CPU"):
            op = HostOp(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                        tuple(tuple(x) for x in e.shapes()))
            host.append(op)
            if e.correlation_id() > 0 and not e.name().startswith(RUNTIME_PREFIXES):
                by_corr[e.correlation_id()] = op
        elif not annotation(e):
            device.append((e.name(), e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    nest(host)
    dev = [DeviceOp(name, s, t, by_corr.get(link)) for name, s, t, link in device]
    return Trace(host, dev, wall_s)


def ancestors(op: Optional[HostOp]):
    while op is not None:
        yield op
        op = op.parent


def op_layer_names(table: Dict[str, dict]) -> Dict[str, Tuple[str, str]]:
    """Host-op name -> (op, "fwd" | "bwd") for every op of the table: the
    Function's name, its backward node's, and the autograd engine's range
    around that node."""
    names = {}
    for op, spec in table.items():
        names[spec["forward"]] = (op, "fwd")
        names[spec["backward"]] = (op, "bwd")
        names["autograd::engine::evaluate_function: " + spec["backward"]] = (op, "bwd")
    return names


def outermost_op(op: Optional[HostOp], names: dict) -> Optional[HostOp]:
    found = None
    for a in ancestors(op):
        if a.name in names:
            found = a
    return found


def call_shape(op: HostOp, table: Dict[str, dict], names: dict) -> Optional[tuple]:
    """(b, n) of one op call: the leading two sizes of the argument that its
    op file names (``fwd_arg`` of the forward's inputs, ``bwd_arg`` of the
    gradients the backward node takes), as the profiler recorded them. The
    engine's range around a backward node takes the node's shapes."""
    name, direction = names[op.name]
    if op.name.startswith("autograd::engine"):
        inner = [o for o in op.children if o.name == table[name]["backward"]]
        op = inner[0] if inner else op
    k = table[name][direction + "_arg"]
    shape = op.shapes[k] if len(op.shapes) > k else ()
    return tuple(shape[:2]) if len(shape) >= 2 else None


def op_layer(trace: Trace, table: Dict[str, dict]) -> dict:
    """The op layer's calls and kernels: ``calls`` (op, "fwd" | "bwd", b, n)
    -> count of outermost calls (b and n None where no shape was recorded);
    ``op_ns`` and ``other_ns`` the device time of the kernels inside and
    outside the op layer."""
    names = op_layer_names(table)
    calls = collections.Counter()
    for op in trace.host:
        if op.name in names and outermost_op(op.parent, names) is None:
            shape = call_shape(op, table, names) or (None, None)
            calls[names[op.name] + shape] += 1
    op_ns = other_ns = 0
    for k in trace.kernels():
        inside = (outermost_op(k.op, names) is not None if k.op is not None
                  else "ovt" in k.name)
        if inside:
            op_ns += k.end - k.start
        else:
            other_ns += k.end - k.start
    return {"calls": dict(calls), "op_ns": op_ns, "other_ns": other_ns}


def innermost_named(op: Optional[HostOp]) -> str:
    """The innermost host op that is not a runtime call, else the runtime call."""
    first = None
    for a in ancestors(op):
        first = first or a.name
        if not a.name.startswith(RUNTIME_PREFIXES):
            return a.name
    return first or OUTSIDE


def breakdown(trace: Trace, host: Optional[Trace] = None, top: int = 10) -> dict:
    """The device operations of `trace` that took most time, and the idle gaps
    of the device summed by what the host was doing: the host op that
    launched the work that ended the gap, in `host` (a window that recorded
    the host's ops; `trace` where none is given)."""
    ops = collections.Counter()
    for d in trace.device:
        ops[d.name] += (d.end - d.start) / 1e9
    gaps = collections.Counter()
    end = None
    for d in sorted((host or trace).device, key=lambda d: d.start):
        if end is not None and d.start > end:
            gaps[innermost_named(d.op)] += (d.start - end) / 1e9
        end = d.end if end is None else max(end, d.end)
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
