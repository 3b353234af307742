"""A per-test time limit for the port's tests that run loader threads,
checkpoint writers, real signals or subprocesses (pytest-timeout is not
installed, and the pytest settings stay as they are).

``time_limit`` sets a real-time alarm for each test: past ``LIMIT_S``
seconds SIGALRM raises ``TimeoutError`` in the main thread, which runs the
test, whether it is computing or waiting (a lock, a queue, an event, a
sleep), so the test fails and the worker goes on with the next one. Should
the main thread be stuck where Python cannot run the handler, faulthandler
prints every thread's stack to the real stderr a minute later, to show where.
The slowest of these tests takes ~41 s in a worker of the six-worker run."""

import contextlib
import faulthandler
import signal
import sys

import pytest

LIMIT_S = 300


@contextlib.contextmanager
def alarm(limit_s: float = LIMIT_S):
    """The limit as a context, for a module-scoped fixture that starts
    processes once for several tests."""
    def expire(signum, frame):  # noqa: ARG001
        raise TimeoutError(f"the test ran past its {limit_s} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit_s)
    faulthandler.dump_traceback_later(limit_s + 60, file=sys.__stderr__)
    try:
        yield limit_s
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def time_limit():
    with alarm(LIMIT_S) as limit:
        yield limit
