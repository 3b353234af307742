"""CUDA-event timing of kernels whose differences are tens of microseconds.

``chip_smoke.time_ms`` brackets each call with its own event pair, so a
window holds the wrapper's host time too. Here one event pair brackets k
back-to-back calls: while the host enqueues faster than the card runs, the
window measures the card, and the host time of one call is spread over k.

    time_per_launch(fn)            median ms per call over several windows
    time_per_launch(fn, graph=True)  the same with the k calls captured once in
                                   a CUDA graph and each window one replay: the
                                   card's time alone, where the host's enqueue
                                   time per call would exceed the kernel's
    in_turns({"A": fa, "B": fb})   A B ... B A in one process, each time and
                                   each case's ratio to the first
    host_us_per_call(fn)           host microseconds to enqueue one call

Needs a CUDA device; nothing here runs at import.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def time_per_launch(fn: Callable[[], object], k: int = 20, windows: int = 7,
                    warmup: int = 3, graph: bool = False) -> float:
    """Median over `windows` windows of the ms per call of `fn`, each window
    k back-to-back calls between one pair of CUDA events. With `graph`, the k
    calls are captured once into a CUDA graph (after the warm-up, on a side
    stream as capture requires) and each window replays it: the kernels'
    arguments, tensor maps included, are fixed at capture, so the window holds
    no host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(k):
                fn()
        run = g.replay
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if run is not None:
            run()
        else:
            for _ in range(k):
                fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / k)
    return statistics.median(per_call)


def in_turns(cases: dict, rounds: int = 2, **kw) -> dict:
    """Time each case of `cases` (name -> callable) with
    :func:`time_per_launch` in turns: the names in order, then reversed, for
    `rounds` passes (A B C C B A ...), so that a drift of the card's clock or
    power moves every case alike. Returns ``{"ms": {name: [ms per turn]},
    "median": {name: ms}, "ratio": {name: median / median of the first}}``."""
    names = list(cases)
    order = []
    for r in range(rounds):
        order += names if r % 2 == 0 else names[::-1]
    ms = {name: [] for name in names}
    for name in order:
        ms[name].append(time_per_launch(cases[name], **kw))
    med = {name: statistics.median(t) for name, t in ms.items()}
    base = med[names[0]]
    return {"ms": ms, "median": med, "ratio": {name: m / base for name, m in med.items()}}


def host_us_per_call(fn: Callable[[], object], calls: int = 200) -> float:
    """Host microseconds to enqueue one call of `fn` (no synchronisation
    inside the window; at a small shape the card keeps up)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us
