"""Dataset DSL + prefetching data loader (the port's own copy of
octic_vits_tpu/data/loaders.py).

`make_dataset` parses the reference's string DSL
("ImageNet:split=TRAIN:root=...:extra=...", reference:
dinov2/data/loaders.py:44-97). `DataLoader` decodes and augments on the host
in worker threads or forked processes while the card runs the steps, and
hands the loop numpy batches; the loop copies them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from octic_vits_tpu_torch.data.datasets import ImageFolder, ImageNet22k, ImageNetExtra


def _parse_dsl(spec: str):
    name, _, rest = spec.partition(":")
    kwargs = {}
    for tok in rest.split(":"):
        if tok:
            k, _, v = tok.partition("=")
            kwargs[k] = v
    return name, kwargs


def make_dataset(spec: str, transform: Optional[Callable] = None):
    """e.g. "ImageNet:split=TRAIN:root=/data/in1k:extra=/data/extra" or
    "ImageFolder:root=/data/train"."""
    name, kw = _parse_dsl(spec)
    if name == "ImageNet":
        return ImageNetExtra(root=kw["root"], extra=kw["extra"], split=kw.get("split", "TRAIN"),
                             transform=transform)
    if name == "ImageNet22k":
        return ImageNet22k(root=kw["root"], extra=kw["extra"], transform=transform)
    if name == "ImageFolder":
        return ImageFolder(root=kw["root"], transform=transform)
    raise ValueError(f"unknown dataset '{name}'")


def default_collate(samples):
    """Stack (array, target) pairs into batch arrays."""
    xs = np.stack([s[0] for s in samples])
    ys = np.asarray([s[1] for s in samples])
    return xs, ys


# fork-inherited dataset for process workers: the children get the dataset
# object through fork (no pickling of transforms or closures)
_FORK_DATASET = None
_FORK_LOCK = threading.Lock()


def _proc_fetch(idx):
    return _FORK_DATASET[idx]


def _proc_init(seed_base):
    # decorrelate per-worker randomness: forked children inherit identical
    # RNG state, which would replicate augmentations across workers
    import os
    import random as _random
    import signal as _signal

    import numpy as _np

    # pool.terminate() SIGTERMs the workers; leaving without interpreter
    # finalization avoids teardown noise from children killed mid-GC
    _signal.signal(_signal.SIGTERM, lambda *_: os._exit(0))

    wid = os.getpid()
    _random.seed(seed_base ^ wid)
    _np.random.seed((seed_base ^ wid) % (2 ** 31))


class DataLoader:
    """Prefetching loader with thread or process workers.

    Threads suffice for light eval transforms (PIL and numpy release the
    GIL for part of the work). The DINOv2 multi-crop augmentation is
    GIL-bound, so `use_processes=True` forks worker processes (the dataset
    inherited by fork, each worker's RNG reseeded), in place of the
    reference's torch DataLoader workers (dinov2/data/loaders.py:166-222).

    The fork happens in a process that has already initialised CUDA (the
    model is on the card by then). A forked child must therefore never
    touch ``torch.cuda``, which cannot be re-initialised after a fork: the
    dataset and its transform run PIL and numpy only and return numpy
    arrays, and the batches reach the device in the parent. Thread workers
    have no such limit. The batches of both kinds are the same, in the same
    order (``pool.map`` keeps the sampler's order)."""

    def __init__(self, dataset, sampler: Iterable[int], batch_size: int,
                 collate_fn: Callable = default_collate, num_workers: int = 8,
                 drop_last: bool = True, prefetch: int = 4, use_processes: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.seed = seed

    def _make_pool(self):
        if not self.use_processes:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            return pool.map, pool.shutdown
        import multiprocessing as mp

        global _FORK_DATASET
        # set-global-then-fork is atomic: two loaders creating their
        # iterators at once could otherwise fork workers bound to the wrong
        # dataset
        with _FORK_LOCK:
            _FORK_DATASET = self.dataset
            pool = mp.get_context("fork").Pool(self.num_workers, initializer=_proc_init,
                                               initargs=(self.seed,))

        def pmap(_fn, idxs):
            # chunked map over the fork-shared dataset; _fn is ignored
            return pool.map(_proc_fetch, idxs, chunksize=2)

        def shutdown(wait=False):  # noqa: ARG001
            pool.terminate()
            pool.join()

        return pmap, shutdown

    def __iter__(self) -> Iterator[Any]:
        pmap, shutdown = self._make_pool()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            # a consumer that stopped early takes nothing more: give up
            # instead of blocking on a full queue forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            batch_idx = []
            try:
                for idx in self.sampler:
                    if stop.is_set():
                        return
                    batch_idx.append(idx)
                    if len(batch_idx) == self.batch_size:
                        samples = list(pmap(self.dataset.__getitem__, batch_idx))
                        if not put(self.collate_fn(samples)):
                            return
                        batch_idx = []
                if batch_idx and not self.drop_last:
                    samples = list(pmap(self.dataset.__getitem__, batch_idx))
                    put(self.collate_fn(samples))
            except Exception as e:  # noqa: BLE001
                # surfaced in the consumer: a swallowed producer error would
                # end the epoch with no batches and "succeed" doing nothing
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                yield item
            if err:
                raise RuntimeError("DataLoader producer failed") from err[0]
        finally:
            stop.set()
            t.join(timeout=60)
            shutdown(wait=False)
