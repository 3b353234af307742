"""Metric logging (the port's own copy of octic_vits_tpu/utils/logging.py):
windowed smoothing, a json-lines dump and iteration timing, replacing the
reference's three near-identical stacks (deit/util.py:18-159,
dinov2/logging/helpers.py:20-195). Values are host floats: a loop hands in
``.item()``s, which wait for the card, only where it means to.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Optional


class SmoothedValue:
    """Track a series over a sliding window (reference: deit/util.py:18-63)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", output_file: Optional[str] = None):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.output_file = output_file

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def dump_in_output_file(self, iteration: int, iter_time: float, data_time: float):
        if self.output_file is None:
            return
        entry = dict(iteration=iteration, iter_time=iter_time, data_time=data_time,
                     **{k: m.median for k, m in self.meters.items()})
        with open(self.output_file, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def log_every(self, iterable, print_freq: int, header: str = "",
                  n_iterations: Optional[int] = None, start_iteration: int = 0):
        """Timing wrapper matching the reference's generator
        (reference: dinov2/logging/helpers.py:66-131)."""
        i = start_iteration
        if n_iterations is None:
            try:
                n_iterations = len(iterable)
            except TypeError:
                n_iterations = None
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (n_iterations and i == n_iterations - 1):
                self.dump_in_output_file(i, iter_time.avg, data_time.avg)
                eta = ""
                if n_iterations:
                    secs = iter_time.global_avg * (n_iterations - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(secs))}  "
                print(f"{header}  [{i}{'/' + str(n_iterations) if n_iterations else ''}]  "
                      f"{eta}{self}  time: {iter_time}  data: {data_time}", flush=True)
            i += 1
            end = time.time()
            if n_iterations and i >= n_iterations + start_iteration:
                break


# optional wandb: the reference logs epochs and iterations to wandb when
# configured (deit/main.py:455-461, dinov2/train/train.py:223-242); here it
# is a no-op unless the package is installed and WANDB_ENTITY or
# WANDB_PROJECT is set, so machines without network run unchanged

_WANDB_RUN = None


def maybe_wandb_init(project: str, config: Optional[dict] = None, name: Optional[str] = None):
    """Start a wandb run if wandb is importable and configured; else no-op."""
    global _WANDB_RUN
    if not (os.environ.get("WANDB_ENTITY") or os.environ.get("WANDB_PROJECT")):
        return None
    try:
        import wandb
    except ImportError:
        return None
    _WANDB_RUN = wandb.init(project=os.environ.get("WANDB_PROJECT", project),
                            entity=os.environ.get("WANDB_ENTITY"), name=name,
                            config=config or {})
    return _WANDB_RUN


def maybe_wandb_log(metrics: dict, step: Optional[int] = None) -> None:
    if _WANDB_RUN is not None:
        _WANDB_RUN.log(metrics, step=step)
