"""k-NN classification on frozen features (counterpart of
octic_vits_tpu/eval/knn.py, reference: dinov2/eval/knn.py:100-406).

Protocol: features L2-normalized, cosine similarity, exp(sim/T) weighted
class vote, k in {10, 20, 100, 200}, T = 0.07; optional few-shot
`n_per_class` subsampling. Everything runs where the train bank lives: a
tensor stays on its device, an array goes to the card. The
similarities and their top-k are in the features' dtype, as in JAX; the
votes are f32 sums of the neighbours' weights, scattered into ``[B, C]``
(the JAX one-hot einsum's sum without its ``[B, max_k, C]`` intermediate).

``knn_classify_sharded`` splits the bank over the processes of a mesh: each
ranks its own block, and the blocks' candidates are merged on every process
(JAX's shard_map with a tiled all-gather and a second top-k).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from octic_vits_tpu_torch.eval.metrics import as_tensor, to_numpy, topk_accuracy
from octic_vits_tpu_torch.parallel.mesh import all_gather_rows, batch_sharding

DEFAULT_KS = (10, 20, 100, 200)
DEFAULT_T = 0.07


def l2_normalize(x: torch.Tensor, eps: float = 1e-12, out=None) -> torch.Tensor:
    """``x / (||x|| + eps)`` over the last axis (not ``F.normalize``, which
    divides by ``max(||x||, eps)``), into `out` if given. The norm is
    ``jnp.linalg.norm``'s: the squares and their sum rounded to `x`'s dtype
    (the sum accumulated in f32), then the root."""
    return torch.div(x, torch.sqrt((x * x).sum(dim=-1, keepdim=True)) + eps, out=out)


def padded_rows(n: int) -> int:
    """`n` rounded up to a multiple of 8: a bank of that many rows keeps the
    rows of its ``[B, rows]`` similarities 16-byte aligned in bf16, where
    cuBLAS's fast kernels need them (an unaligned 1,281,167-column product
    took 7.6x as long on an H100)."""
    return n + (-n) % 8


def topk_lowest_index_first(sims: torch.Tensor, k: int) -> tuple:
    """``lax.top_k`` over the last axis of ``[B, N]`` `sims`: the k largest
    values in descending order, and among equal values the lower index
    first. ``torch.topk`` leaves both orders of ties open, and bf16
    similarities tie often. Where a row's k-th value ties with values
    outside its top k, the row's elements at or above the k-th value are
    listed in index order (``nonzero``) and the lowest-index ones of those
    equal to it fill the row."""
    vals, idx = torch.topk(sims, k, dim=-1)
    kth = vals[:, -1:]
    ge = sims >= kth
    n_ge = ge.sum(-1)
    if bool((n_ge > k).any()):
        rows, cols = ge.nonzero(as_tuple=True)                  # row by row, index order
        eq = (sims[rows, cols] == kth[rows, 0]).long()
        rank = eq.cumsum(0) - eq                                # tied elements before, in all rows
        rank -= rank[n_ge.cumsum(0) - n_ge][rows]               # ... in the element's own row
        n_gt = n_ge - torch.zeros_like(n_ge).index_add_(0, rows, eq)
        idx = cols[(eq == 0) | (rank < (k - n_gt)[rows])].view(-1, k)
        vals = sims.gather(-1, idx)
    idx, order = torch.sort(idx, dim=-1)
    vals, order = torch.sort(vals.gather(-1, order), dim=-1, descending=True, stable=True)
    return vals, idx.gather(-1, order)


def knn_classify(
    train_features,             # [Ntr, D] (normalized or not)
    train_labels,               # [Ntr]
    test_features,              # [Nte, D]
    num_classes: int,
    ks: Sequence[int] = DEFAULT_KS,
    temperature: float = DEFAULT_T,
    batch_size: int = 1024,
) -> Dict[int, torch.Tensor]:
    """Returns {k: [Nte, num_classes] f32 vote scores} on the bank's device
    (reference KnnModule semantics, dinov2/eval/knn.py:100-185):
    :func:`knn_classify_sharded` of one process, the whole bank one block."""
    return knn_classify_sharded(train_features, train_labels, test_features, num_classes, None,
                                ks, temperature, batch_size)


def knn_classify_sharded(
    train_features,             # [Ntr, D], whole on every process
    train_labels,               # [Ntr]
    test_features,              # [Nte, D], whole on every process
    num_classes: int,
    mesh,
    ks: Sequence[int] = DEFAULT_KS,
    temperature: float = DEFAULT_T,
    batch_size: int = 1024,
) -> Dict[int, torch.Tensor]:
    """Mesh-sharded k-NN: the bank is split over the mesh's processes, rank r
    taking its contiguous block of ``ceil(Ntr / world)`` rows (the block
    JAX's ``P(axis_names)`` gives device r); each process takes its block's
    top-k, the candidates ``(similarity, label)`` of every process are
    all-gathered in rank order and the top-k is taken again, the lower
    position first among ties (JAX's ``lax.top_k`` over its tiled gather:
    the lower device, then the lower row). Every process returns the votes
    of every query (reference: dinov2/eval/knn.py:100-185). Without a mesh
    the bank is one block (:func:`knn_classify`).

    Three differences from JAX (eval/knn.py:69), each pinned by a test: JAX
    pads the bank to a multiple of the devices with zero rows labelled -1,
    whose similarity 0 displaces a real neighbour wherever a query's k-th
    similarity is below 0 (and then votes 0); here no padding ranks. Where a
    block has fewer rows than ``max(ks)`` JAX's ``lax.top_k`` raises; here
    the block gives all its rows and the merge picks the top k. And JAX's
    sharded weights ``exp(s / T)`` are f32 where its single-device ones are
    in the features' dtype; here both are in the features' dtype, so one
    process's votes are :func:`knn_classify`'s, bitwise."""
    shard = batch_sharding(mesh)
    world, rank = shard.count, shard.index
    train = as_tensor(train_features)
    dev = train.device
    test = as_tensor(test_features, dev).to(dev)
    dt = torch.promote_types(train.dtype, test.dtype)
    n, max_k = train.shape[0], max(ks)
    if n < max_k:
        raise ValueError(f"k up to {max_k} over a bank of {n} rows")
    per = -(-n // world)
    lo, hi = min(rank * per, n), min((rank + 1) * per, n)
    rows, local_k = hi - lo, min(max_k, hi - lo)
    bank = torch.zeros(padded_rows(rows), train.shape[1], device=dev, dtype=dt)
    l2_normalize(train[lo:hi].to(dt), out=bank[:rows])
    labels = as_tensor(train_labels, dev).to(dev, torch.int64)[lo:hi]
    test = l2_normalize(test.to(dt))

    out = {k: [] for k in ks}
    for start in range(0, test.shape[0], batch_size):
        chunk = test[start: start + batch_size]
        b = chunk.shape[0]
        # a block's candidates, filled up to max_k with -inf of label -1 so
        # that every process gives the gather one shape; at least max_k
        # finite candidates come from all blocks together, so no filler ranks
        cand = torch.full((b, max_k), float("-inf"), device=dev, dtype=dt)
        cand_labels = torch.full((b, max_k), -1, device=dev, dtype=torch.int64)
        if local_k:
            sims = chunk @ bank.T
            sims[:, rows:] = float("-inf")  # the padding rows never rank
            sims, idx = topk_lowest_index_first(sims, local_k)
            cand[:, :local_k] = sims
            cand_labels[:, :local_k] = labels[idx]
        if mesh is not None:  # rank-major along the candidates, as JAX's tiled gather
            cand = all_gather_rows(cand).permute(1, 0, 2).reshape(b, world * max_k)
            cand_labels = all_gather_rows(cand_labels).permute(1, 0, 2).reshape(b, world * max_k)
            cand, pos = topk_lowest_index_first(cand, max_k)
            cand_labels = cand_labels.gather(1, pos)
        # the temperature in the features' dtype, as JAX's weakly typed scalar
        weights = torch.exp(cand / torch.tensor(temperature, dtype=cand.dtype)).float()
        for k in ks:
            votes = torch.zeros(b, num_classes, device=dev)
            out[k].append(votes.scatter_add_(1, cand_labels[:, :k], weights[:, :k]))
    return {k: torch.cat(v, dim=0) for k, v in out.items()}


def filter_n_per_class(features, labels, n_per_class: int, seed: int = 0) -> Tuple:
    """Few-shot filtering (reference: dinov2/eval/knn.py:199-238): the indices
    come from ``np.random.RandomState(seed)`` on the host, as in JAX; the
    features and labels are indexed where they live."""
    rng = np.random.RandomState(seed)
    host_labels = to_numpy(labels)
    keep = []
    for c in np.unique(host_labels):
        idx = np.nonzero(host_labels == c)[0]
        rng.shuffle(idx)
        keep.append(idx[:n_per_class])
    keep = np.concatenate(keep)

    def take(x):
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(keep, device=x.device)]
        return np.asarray(x)[keep]

    return take(features), take(labels)


def extract_features(apply_fn, data_iter: Iterable,
                     feature_dim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``apply_fn(images) -> [B, D]`` over an iterator of ``(images,
    labels)`` batches; returns the stacked features on the device where
    `apply_fn` put them and the labels as int64 on that device, for THIS
    process's stream. The multi-process extraction (the reference's
    all_gather + index_copy, dinov2/eval/utils.py:86-146) lives in
    ``eval.distributed``: ``extract_features_sharded`` shards the dataset by
    process index and merges the shards on every process."""
    feats, labels = [], []
    for images, ys in data_iter:
        f = apply_fn(images)
        feats.append(f)
        labels.append(as_tensor(ys, f.device).to(f.device, torch.int64))
    return torch.cat(feats), torch.cat(labels)


def evaluate_knn(train_features, train_labels, test_features, test_labels, num_classes: int,
                 ks: Sequence[int] = DEFAULT_KS, temperature: float = DEFAULT_T,
                 n_per_class: Optional[int] = None) -> Dict[str, float]:
    if n_per_class is not None:
        train_features, train_labels = filter_n_per_class(train_features, train_labels,
                                                          n_per_class)
    votes = knn_classify(train_features, train_labels, test_features, num_classes, ks,
                         temperature)
    results = {}
    for k, v in votes.items():
        acc = topk_accuracy(v, test_labels, ks=(1, 5))
        results[f"knn_{k}_top1"] = acc["top1"]
        results[f"knn_{k}_top5"] = acc["top5"]
    return results
