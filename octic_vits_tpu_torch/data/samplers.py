"""Index samplers, in numpy (the port's own copy of
octic_vits_tpu/data/samplers.py; the index streams are the same, bit for
bit).

* `RASampler` — repeated-augmentation distributed sampler of DeiT III
  (3 repeats, 256-aligned selection; reference: deit/samplers.py:8-64).
* `InfiniteSampler` / `ShardedInfiniteSampler` — DINOv2 infinite streams
  with cheap `advance` for deterministic resume
  (reference: dinov2/data/samplers.py:17-229).
* `EpochSampler` — a finite per-epoch order for the eval loaders.

"shard" is the data-loading process (its rank), which feeds its device a
slice of the global batch.
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


class RASampler:
    """Repeated augmentation: each epoch draws a shuffled index list, repeats
    each index 3x, pads to an even multiple, shards round-robin, then keeps
    only the first `len(dataset) // world` 256-aligned entries.

    Below 256 samples the 256-aligned count is 0, and the sampler keeps all
    `repetitions` copies (3x the dataset an epoch), as the JAX package does;
    the loops' `steps_per_epoch` still counts the dataset once."""

    def __init__(self, dataset_len: int, shard: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0, repetitions: int = 3):
        self.dataset_len = dataset_len
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.repetitions = repetitions
        self.num_samples = int(np.ceil(dataset_len * repetitions / num_shards))
        self.total_size = self.num_samples * num_shards
        self.num_selected_samples = int(np.floor(dataset_len // 256 * 256 / num_shards))
        if repetitions == 1:
            # --no-repeated-aug: plain DistributedSampler semantics (every
            # sample once per epoch, padded to shards); the 256-multiple
            # truncation is RA-specific (reference: deit/samplers.py:33-38)
            self.num_selected_samples = self.num_samples
        if self.num_selected_samples == 0:  # tiny datasets
            self.num_selected_samples = self.num_samples
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_selected_samples

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.shuffle:
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        indices = np.repeat(indices, self.repetitions)
        pad = self.total_size - len(indices)
        indices = np.concatenate([indices, indices[:pad]])
        indices = indices[self.shard: self.total_size: self.num_shards]
        return iter(indices[: self.num_selected_samples].tolist())


class InfiniteSampler:
    """Endless uniform stream; `advance(n)` skips n draws for resume."""

    def __init__(self, sample_count: int, shard: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0, advance: int = 0):
        self.sample_count = sample_count
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self._advance = advance

    def _iterator(self):
        rng = np.random.RandomState(self.seed)
        while True:
            if self.shuffle:
                perm = rng.permutation(self.sample_count)
            else:
                perm = np.arange(self.sample_count)
            yield from perm[self.shard:: self.num_shards].tolist()

    def __iter__(self):
        return itertools.islice(self._iterator(), self._advance, None)


class ShardedInfiniteSampler:
    """Infinite stream where each epoch-window is re-seeded and the shard
    slice is shuffled independently, so resume skips whole windows in O(1)
    (reference: dinov2/data/samplers.py:165-229)."""

    def __init__(self, sample_count: int, shard: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0, advance: int = 0):
        self.sample_count = sample_count
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self._advance = advance

    def _iterator(self):
        per_window = (self.sample_count + self.num_shards - 1) // self.num_shards
        epoch, remainder = divmod(self._advance, per_window)
        while True:
            rng = np.random.RandomState((self.seed * 2971 + epoch) % (2**31))
            perm = (rng.permutation(self.sample_count) if self.shuffle
                    else np.arange(self.sample_count))
            window = perm[self.shard:: self.num_shards]
            if remainder:
                window = window[remainder:]
                remainder = 0
            yield from window.tolist()
            epoch += 1

    def __iter__(self):
        return self._iterator()


class EpochSampler:
    """Finite per-epoch sampler (eval paths;
    reference: dinov2/data/samplers.py:17-63)."""

    def __init__(self, size: int, shard: int = 0, num_shards: int = 1,
                 shuffle: bool = False, seed: int = 0):
        self.size = size
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return (self.size - self.shard + self.num_shards - 1) // self.num_shards

    def __iter__(self):
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(self.size)
        else:
            order = np.arange(self.size)
        return iter(order[self.shard:: self.num_shards].tolist())
