"""Joint grid-search linear probe (counterpart of octic_vits_tpu/eval/linear.py,
reference: dinov2/eval/linear.py:173-628).

The |blocks in {1,4}| x |avgpool| x |13 lr| classifier grid trains at once:
each (blocks, avgpool) feature variant owns a bank of 13 classifiers stacked
as ``[n_lr, D, C]`` tensors, one batched product a variant a step.

Protocol: SGD momentum 0.9, no weight decay, cosine lr over `iters` (12500 =
10 ep x 1250 it), feature = concat of the cls tokens of the last n blocks,
optionally + the mean-pooled patch tokens of the last block; best classifier
selected by top-1.

With a mesh the grid trains data parallel over its processes, the SPMD
analog of the reference's DDP-wrapped AllClassifiers
(dinov2/eval/linear.py:254-258): each process feeds its own rows of the
global batch, the classifiers are replicated, and the gradients are summed
over the processes, so every process takes JAX's step on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from octic_vits_tpu_torch.eval.metrics import as_tensor
from octic_vits_tpu_torch.models.registry import resolve_device
from octic_vits_tpu_torch.parallel.mesh import batch_sharding

# The reference's 13-lr grid, verbatim (dinov2/eval/linear.py:147):
# (1,2,5) x decades 1e-5..5e-2, plus 1e-1.
DEFAULT_LRS = (
    1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4,
    1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 1e-1,
)


def scale_lr(lr: float, batch_size: int, world_size: int = 1) -> float:
    """Linear lr scaling by global batch (dinov2/eval/linear.py:233-234)."""
    return lr * (batch_size * world_size) / 256.0


@dataclasses.dataclass
class ProbeVariant:
    name: str
    use_n_blocks: int
    use_avgpool: bool


DEFAULT_VARIANTS = (
    ProbeVariant("1_blocks_noavg", 1, False),
    ProbeVariant("1_blocks_avg", 1, True),
    ProbeVariant("4_blocks_noavg", 4, False),
    ProbeVariant("4_blocks_avg", 4, True),
)


def build_probe_features(intermediate_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                         variant: ProbeVariant) -> torch.Tensor:
    """intermediate_outputs: list over blocks of (patch_tokens [B,N,D],
    cls [B,D]), last block last (reference create_linear_input,
    dinov2/eval/linear.py:80-92). Returns f32 ``[B, D']``."""
    picked = intermediate_outputs[-variant.use_n_blocks:]
    feats = torch.cat([cls for _, cls in picked], dim=-1)
    if variant.use_avgpool:
        feats = torch.cat([feats, picked[-1][0].mean(dim=1)], dim=-1)
    return feats.float()


class LinearProbeBank:
    """A bank of linear classifiers ``w [n, D, C]``, ``b [n, C]`` with one lr
    each. The step is written out: the loss is the sum over classifiers of
    each one's mean cross-entropy, its gradient is taken in closed form
    (softmax - one-hot, over the batch), and ``m = 0.9 m + g; p -= lr_i s(it)
    m`` is SGD with momentum without dampening, which ``torch.optim.SGD``
    cannot do with a learning rate per slice.

    With `mesh` (the port's ``parallel.create_mesh()``) each process passes
    :meth:`train_step` its own rows of the global batch; each process sums
    its rows' gradients and losses, one all-reduce sums them and the row
    counts over the processes, and the sums are divided by the global count:
    the loss is the mean over the global batch (JAX's step with the batch
    sharded over the mesh and the classifiers replicated), also where the
    processes hold different numbers of rows, a split that JAX's sharded
    batch refuses. An all-reduce leaves the same sum on every process, so
    the classifiers stay bitwise equal everywhere."""

    def __init__(self, dim: int, num_classes: int, lrs: Sequence[float],
                 momentum: float = 0.9, iters: int = 12500, device=None, mesh=None):
        device = resolve_device(device)
        self.shard = batch_sharding(mesh)
        self.dim = dim
        self.num_classes = num_classes
        self.lrs = torch.tensor(lrs, dtype=torch.float32, device=device)
        self.momentum = momentum
        self.iters = iters
        n = len(lrs)
        self.w = torch.zeros(n, dim, num_classes, device=device)
        self.b = torch.zeros(n, num_classes, device=device)
        self.mw = torch.zeros_like(self.w)
        self.mb = torch.zeros_like(self.b)

    def lr_scale(self, it: int) -> float:
        return 0.5 * (1 + np.cos(np.pi * it / max(self.iters, 1)))

    @torch.no_grad()
    def train_step(self, feats: torch.Tensor, labels: torch.Tensor, it: int) -> torch.Tensor:
        """One step on f32 `feats` ``[B, D]`` (with a mesh, this process's
        rows of the global batch, which may differ in number from the other
        processes'); returns each classifier's loss (the global batch's)."""
        logits = self.predict(feats)                                  # [n, B, C]
        logp = torch.log_softmax(logits, dim=-1)
        labels = labels.to(logits.device, torch.int64)
        idx = labels.view(1, -1, 1).expand(logits.shape[0], -1, 1)
        loss = -logp.gather(-1, idx).squeeze(-1).sum(dim=-1)
        g = logp.exp_().scatter_add_(-1, idx, torch.full_like(idx, -1, dtype=logp.dtype))
        # contiguous: einsum may return a permuted view, and its layout (which
        # the all-reduce sums element by element) depends on the row count
        gw = torch.einsum("bd,nbc->ndc", feats, g).contiguous()
        gb = g.sum(dim=1)
        rows = float(feats.shape[0])
        if self.shard.count > 1:  # the processes' sums of their rows, and their row count
            small = torch.cat([gb.flatten(), loss, loss.new_tensor([rows])])
            dist.all_reduce(gw)
            dist.all_reduce(small)
            gb, loss, rows = small[:gb.numel()].view_as(gb), small[gb.numel():-1], small[-1]
        gw /= rows  # the global batch's mean
        gb /= rows
        per_clf = loss / rows
        lr = self.lrs * np.float32(self.lr_scale(it))
        self.mw.mul_(self.momentum).add_(gw)
        self.mb.mul_(self.momentum).add_(gb)
        self.w -= lr[:, None, None] * self.mw
        self.b -= lr[:, None] * self.mb
        return per_clf

    @torch.no_grad()
    def predict(self, feats: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bd,ndc->nbc", feats.float(), self.w) + self.b[:, None, :]


def train_and_eval_linear_probes(
    train_feature_fn,
    train_iter_factory,
    eval_iter,
    num_classes: int,
    iters: int = 12500,
    lrs: Sequence[float] = DEFAULT_LRS,
    variants: Sequence[ProbeVariant] = DEFAULT_VARIANTS,
    batch_size: int = 256,
    mesh=None,
) -> Dict[str, float]:
    """Full grid training + best-classifier selection
    (reference: dinov2/eval/linear.py:465-628).

    train_feature_fn(images) -> list of (patch_tokens, cls) per block;
    train_iter_factory() -> iterator of (images, labels) (repeats as
    needed); eval_iter -> finite iterator for the val set. Grid lrs are
    scaled by global batch / 256 (reference :233-243). The banks live where
    the features do.

    With `mesh`, `batch_size` is the global batch: both iterators yield this
    process's rows (``batch_size / world`` a training batch), the banks
    train data parallel (:class:`LinearProbeBank`) and the validation hits
    are summed over the processes, so every process returns the same
    results, those of the whole validation set. A world that does not
    divide `batch_size` raises ``ValueError``."""
    shard = batch_sharding(mesh)
    if batch_size % shard.count:
        raise ValueError(f"a global batch of {batch_size} does not split over {shard.count} "
                         "processes")
    lrs = tuple(scale_lr(lr, batch_size) for lr in lrs)
    banks: Dict[str, LinearProbeBank] = {}
    it = 0
    src = iter(train_iter_factory())
    while it < iters:
        try:
            images, labels = next(src)
        except StopIteration:
            src = iter(train_iter_factory())
            continue
        outs = train_feature_fn(images)
        for v in variants:
            feats = build_probe_features(outs, v)
            if v.name not in banks:
                banks[v.name] = LinearProbeBank(feats.shape[-1], num_classes, lrs, iters=iters,
                                                device=feats.device, mesh=mesh)
            banks[v.name].train_step(feats, as_tensor(labels, feats.device), it)
        it += 1

    # evaluation: accumulate top-1 per classifier
    correct = {v.name: None for v in variants}
    total = 0
    for images, labels in eval_iter:
        outs = train_feature_fn(images)
        total += len(labels)
        for v in variants:
            feats = build_probe_features(outs, v)
            y = as_tensor(labels, feats.device).to(feats.device, torch.int64)
            hits = (banks[v.name].predict(feats).argmax(-1) == y[None, :]).sum(-1)
            correct[v.name] = hits if correct[v.name] is None else correct[v.name] + hits
    if shard.count > 1:  # every process's hits: one all-reduce after the last batch
        w = banks[variants[0].name].w
        counts = torch.stack([torch.zeros(len(lrs), dtype=torch.int64, device=w.device)
                              if correct[v.name] is None else correct[v.name] for v in variants]
                             + [torch.full((len(lrs),), total, device=w.device)])
        dist.all_reduce(counts)
        correct = {v.name: counts[i] for i, v in enumerate(variants)}
        total = int(counts[-1, 0])
    correct = {k: c.cpu().numpy() for k, c in correct.items()}

    results = {}
    best_name, best_acc = None, -1.0
    for v in variants:
        for i, lr in enumerate(lrs):
            acc = float(correct[v.name][i]) / max(total, 1)
            results[f"{v.name}_lr{lr:g}_top1"] = acc
            if acc > best_acc:
                best_acc, best_name = acc, f"{v.name}_lr{lr:g}"
    results["best_classifier"] = best_name
    results["best_top1"] = best_acc
    return results
