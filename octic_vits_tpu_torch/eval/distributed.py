"""Multi-process feature extraction and merge (counterpart of
octic_vits_tpu/eval/distributed.py; reference: dinov2/eval/utils.py:86-146,
the all_gather of per-rank feature shards and their index_copy into dataset
order).

Each process extracts the features of its round-robin shard of the dataset
(``EpochSampler(n, shard=rank, num_shards=world)``), then one all-gather over
the default process group ships every shard to every process, and a scatter
by the dataset indices restores the order. The collectives run where the
tensors live: NCCL for features on the card, gloo for features on the CPU.
With one process, or with no process group, the merge is the pure scatter
(no collective), as in JAX.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from octic_vits_tpu_torch.eval.knn import extract_features
from octic_vits_tpu_torch.eval.metrics import as_tensor
from octic_vits_tpu_torch.parallel.mesh import all_gather_rows, process_count, process_index


def gather_features_across_processes(
    features,       # [n_local, D] this process's shard
    labels,         # [n_local]
    indices,        # [n_local] dataset positions of each row
    total_n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-process feature shards into the full dataset-ordered
    ``(features [total_n, D], labels [total_n])`` on EVERY process, on the
    features' device, in their dtype and the labels'.

    Shards may differ in length by one (round-robin sampling); each is padded
    to ``ceil(total_n / world)`` rows with index -1, which the scatter drops
    (the reference pads the sampler instead and relies on index_copy
    overwrites, dinov2/eval/utils.py:120-146)."""
    features = as_tensor(features)
    dev = features.device
    labels = as_tensor(labels, dev).to(dev)
    indices = as_tensor(indices, dev).to(dev, torch.int64)
    d = features.shape[1]
    out_f = features.new_zeros(total_n, d)
    out_y = labels.new_zeros(total_n)

    world = process_count()
    if world == 1:
        out_f[indices] = features
        out_y[indices] = labels
        return out_f, out_y

    cap = -(-total_n // world)
    pad = cap - len(indices)
    if pad < 0:
        raise ValueError(f"a shard of {len(indices)} rows, more than ceil({total_n} / {world}) = "
                         f"{cap}")
    features = torch.cat([features, features.new_zeros(pad, d)])
    # labels and positions travel together: one int64 gather
    meta = torch.stack([labels.to(torch.int64), indices], dim=1)
    meta = torch.cat([meta, meta.new_tensor([[0, -1]]).expand(pad, 2)])
    gf = all_gather_rows(features).reshape(world * cap, d)
    gm = all_gather_rows(meta).reshape(world * cap, 2)
    valid = gm[:, 1] >= 0
    out_f[gm[valid, 1]] = gf[valid]
    out_y[gm[valid, 1]] = gm[valid, 0].to(out_y.dtype)
    return out_f, out_y


def extract_features_sharded(
    apply_fn: Callable,
    dataset,
    batch_size: int = 256,
    num_workers: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Process-sharded ``extract_features``: this process runs `apply_fn`
    over its EpochSampler shard only, then the shards are merged into the
    full dataset-ordered feature matrix on every process
    (reference: dinov2/eval/utils.py:86-146). The single-process case is
    exactly ``extract_features`` plus a reorder.

    Raises ``ValueError`` where the dataset has fewer items than there are
    processes: a process with an empty shard has no features to give the
    gather its width and dtype (JAX's ``np.concatenate([])`` raises there
    too, on that process alone). Every process sees the same condition, so
    every one raises, and none waits in a collective."""
    from octic_vits_tpu_torch.data.loaders import DataLoader
    from octic_vits_tpu_torch.data.samplers import EpochSampler

    world = process_count()
    if len(dataset) < world:
        raise ValueError(f"{len(dataset)} items cannot be shared by {world} processes: each "
                         "process needs at least one")
    sampler = EpochSampler(len(dataset), shard=process_index(), num_shards=world)
    indices = np.fromiter(iter(sampler), np.int64)
    loader = DataLoader(dataset, sampler, batch_size=batch_size, num_workers=num_workers,
                        drop_last=False)
    feats, labels = extract_features(apply_fn, loader)
    return gather_features_across_processes(feats, labels, torch.from_numpy(indices),
                                            len(dataset))
