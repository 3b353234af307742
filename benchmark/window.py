"""The measured window. A step (a train step, or one request of the
inference client) starts only while the window is open; the window then
closes when the last started step has finished, so a long step does not
quantize the rate. Rates are taken over all the work and all the time of
the window."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List


@dataclasses.dataclass
class Window:
    steps: int
    elapsed_s: float        # window start to the end of the last step
    dispatch_s: List[float]  # per step: host time until the call returned
    latency_s: List[float]  # per request: submit to answer on the host (closed loop)

    def rate(self, per_step: int) -> float:
        return self.steps * per_step / self.elapsed_s


def closed_loop(request: Callable[[int], float], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """One client: request i is sent when request i - 1 has been answered.
    ``request(i)`` runs request i to its answer on the host and returns the
    host seconds until the program's call returned."""
    t0 = clock()
    dispatch, latency = [], []
    while clock() - t0 < seconds:
        s = clock()
        dispatch.append(request(len(latency)))
        latency.append(clock() - s)
    return Window(len(latency), clock() - t0, dispatch, latency)


def paced_steps(step: Callable[[int], None], sync: Callable[[], None], seconds: float,
                sync_every: int, clock: Callable[[], float] = time.perf_counter) -> Window:
    """Train steps enqueued back to back, the host waiting for the device
    every `sync_every` steps (where the training loop reads its metrics) and
    once at the end."""
    t0 = clock()
    dispatch = []
    while clock() - t0 < seconds:
        s = clock()
        step(len(dispatch))
        dispatch.append(clock() - s)
        if len(dispatch) % sync_every == 0:
            sync()
    sync()
    return Window(len(dispatch), clock() - t0, dispatch, [])


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank `q`-th percentile (0 < q <= 100)."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
