"""Spans of the program's phases: a train step, a forward and its stages,
each hand-written op's forward and backward.

Off (the default) ``span(name)`` reads one flag and returns one shared no-op
context manager: no record, no allocation. On (:func:`enable`), each span
that closes appends a record to an in-memory list that :func:`take` hands
over, as :class:`Span` objects, and clears. Start and end are ``time.time_ns()``, the clock that
``torch.profiler``'s events carry in ``start_ns()``, so a span lines up with
the runtime calls and kernels of a trace taken at the same time. While a
profiler that records the host's ops runs, a span is also a profiler range
of its name, so it nests with the aten ops in that trace.

A span opened with no span open on its thread is a root, unless a root is
open on another thread: then it hangs under the innermost span open on that
thread and takes its root id. That is how the backward's op spans, which
run on autograd's device thread, join the step whose ``backward()`` waits
for them. Spans are meant for one stepping thread at a time.

Turn them on around the work to look at, under a profiler or not::

    from octic_vits_tpu_torch.utils import tracing

    tracing.enable()
    try:
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, metrics = step_fn(state, images, labels, generator)
            torch.cuda.synchronize()
    finally:
        tracing.disable()
    spans = tracing.take()
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler

_on = False
_OFF = contextlib.nullcontext()
_records: List[tuple] = []  # closed spans as tuples, which the collector leaves alone
_ids = itertools.count()
_forwards = itertools.count()  # root ids of the roots opened without one
_local = threading.local()
_root: Optional[tuple] = None  # (the open root, its thread's stack)


@dataclasses.dataclass
class Span:
    id: int  # in the order the spans opened
    name: str
    start: int  # ns, the profiler's clock
    end: int
    tid: int  # the native id of the thread that ran it
    parent: Optional[int]  # id of the enclosing span, None for a root
    root: int  # the root's id: its step number, or a count of such roots


class _Open:
    __slots__ = ("name", "root", "id", "parent", "start", "range", "stack", "tid")

    def __init__(self, name: str, root: Optional[int]):
        self.name, self.root = name, root

    def __enter__(self):
        global _root
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        around = stack or (_root[1] if _root is not None else None)
        self.id = next(_ids)
        if around:
            self.parent, self.root = around[-1].id, around[-1].root
        else:
            self.parent = None
            if self.root is None:
                self.root = next(_forwards)
            _root = (self, stack)
        stack.append(self)
        self.stack, self.tid = stack, _local.tid
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.start = time.time_ns()

    def __exit__(self, *exc):
        global _root
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        if _root is not None and _root[0] is self:
            _root = None
        _records.append((self.id, self.name, self.start, end, self.tid, self.parent, self.root))
        return False


def span(name: str, root: Optional[int] = None):
    """A context manager that records `name` while tracing is on. `root`
    is the root id the span takes if it opens a root (a train step's
    number); other roots are counted."""
    if not _on:
        return _OFF
    return _Open(name, root)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> List[Span]:
    """The spans closed so far, in the order they opened; clears them."""
    global _records
    out, _records = _records, []
    return [Span(*r) for r in sorted(out)]


def op_spans(cls):
    """Class decorator of an autograd Function: its forward runs inside the
    span ``op.<class name>.fwd``, its backward inside ``op.<class name>.bwd``."""
    for method, tag in (("forward", "fwd"), ("backward", "bwd")):
        fn = getattr(cls, method)
        setattr(cls, method, staticmethod(_spanned(fn, f"op.{cls.__name__}.{tag}")))
    return cls


def _spanned(fn, name: str):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        with _Open(name, None):
            return fn(*args, **kwargs)

    return run
