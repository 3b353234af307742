"""The window's arithmetic on a fake clock: whole steps, the rate over the
window's time, the p95 over every request."""

from __future__ import annotations

import pytest

from benchmark.window import closed_loop, paced_steps, percentile


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_closed_loop_counts_whole_requests_and_ends_with_the_last():
    clock = Clock()

    def request(i):
        clock.t += 0.3  # each request takes 0.3 s, 0.1 s of it until the call returns
        return 0.1

    win = closed_loop(request, 1.0, clock)
    # requests start at 0, 0.3, 0.6, 0.9: the fourth starts inside and ends at 1.2
    assert win.steps == 4
    assert win.elapsed_s == pytest.approx(1.2)
    assert win.rate(64) == pytest.approx(4 * 64 / 1.2)
    assert win.latency_s == pytest.approx([0.3] * 4)
    assert win.dispatch_s == [0.1] * 4


def test_paced_steps_sync_where_the_loop_syncs():
    clock = Clock()
    syncs = []

    def step(i):
        clock.t += 0.25

    def sync():
        syncs.append(clock.t)
        clock.t += 1.0  # the device catches up

    win = paced_steps(step, sync, 2.0, 3, clock)
    # steps at 0, .25, .5 -> sync (+1 s) at .75; step at 1.75 starts inside the window
    assert win.steps == 4
    assert len(syncs) == 2  # once after 3 steps, once at the end
    assert win.elapsed_s == pytest.approx(3.0)
    assert win.rate(256) == pytest.approx(4 * 256 / 3.0)


def test_percentile_is_nearest_rank_over_every_sample():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile(values[:20], 95) == 19
    assert percentile([5.0], 95) == 5.0
    assert percentile([3, 1, 2], 100) == 3
