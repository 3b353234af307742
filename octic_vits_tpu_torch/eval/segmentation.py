"""Segmentation probing (capi-style): per-patch features -> kNN / logistic
regression probes -> mIoU (counterpart of octic_vits_tpu/eval/segmentation.py;
reference: dinov2/eval/segmentation/eval_segmentation.py:50-446).

Patch labels are majority-downsampled per patch; the probes are a kNN
(majority vote, cosine or L2 — KNNClassifier, :172-278) and a multinomial
logistic regression (:281-337). The grids default to the reference protocol
grids — knn: num_neighbors (1,3,10,30) x distance (cosine, L2); logreg: C =
10**linspace(-6,5,8) — evaluated in order and split across workers
round-robin by `grid_slice` (:104-133). `ignore_labels` follows :363: (0,
255) for ADE20K raw labels, (255,) otherwise.

Unlike the JAX probes, both keep their memory bounded at ADE20K scale (~4M
patch features): the kNN tiles the train bank as well as the queries and
merges the tiles' top-k; the device logistic regression sums its loss and
gradient chunk by chunk over views of the bank and makes no padded copy.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from octic_vits_tpu_torch.eval.knn import padded_rows, topk_lowest_index_first
from octic_vits_tpu_torch.eval.metrics import (
    as_tensor,
    confusion_matrix,
    miou_from_confusion,
    to_numpy,
)

# the reference protocol grids (eval_segmentation.py:184-187 knn ctor
# defaults; :292-296 logreg ctor defaults), expanded itertools.product-style
DEFAULT_KNN_GRID: Tuple[Dict, ...] = tuple(
    {"k": n, "distance": d}
    for n, d in itertools.product((1, 3, 10, 30), ("cosine", "L2"))
)
DEFAULT_LOGREG_GRID: Tuple[Dict, ...] = tuple(
    {"C": float(c), "max_iter": 1000, "tol": 1e-12}
    for c in 10 ** np.linspace(-6, 5, 8)
)


def downsample_labels(label_map: np.ndarray, patch_size: int, num_classes: int,
                      ignore_labels: Sequence[int] = (255,)) -> np.ndarray:
    """[H, W] pixel labels -> [h, w] per-patch majority label (ignoring
    `ignore_labels`; a patch fully ignored -> 255 sentinel). Among equally
    frequent labels the smallest wins, as ``np.bincount(...).argmax()``."""
    label_map = np.asarray(label_map)
    h, w = label_map.shape
    gh, gw = h // patch_size, w // patch_size
    crop = label_map[: gh * patch_size, : gw * patch_size]
    patches = crop.reshape(gh, patch_size, gw, patch_size).transpose(0, 2, 1, 3)
    patches = patches.reshape(gh * gw, -1).astype(np.int64)
    valid = ~np.isin(patches, np.asarray(ignore_labels))
    vals = patches[valid]
    if vals.size and vals.min() < 0:
        raise ValueError("labels outside the ignore set must be non-negative")
    width = max(num_classes, int(vals.max()) + 1 if vals.size else 0)
    rows = np.nonzero(valid)[0]
    counts = np.bincount(rows * width + vals, minlength=gh * gw * width).reshape(gh * gw, width)
    out = np.where(valid.any(1), counts.argmax(1), 255).astype(np.int32)
    return out.reshape(gh, gw)


def extract_patch_features(
    feature_fn: Callable,
    images: Iterable[Tuple[np.ndarray, np.ndarray]],
    patch_size: int,
    num_classes: int,
    ignore_labels: Sequence[int] = (255,),
) -> Tuple[torch.Tensor, np.ndarray]:
    """feature_fn(batch NHWC) -> [B, N, D] patch features; images yields
    (image [H,W,3] normalized, label_map [H,W]). Patches whose majority
    label is ignored are dropped (reference Classifier.fit isin-mask,
    eval_segmentation.py:78-85). The features stay on the device where
    `feature_fn` put them; the labels are host numpy."""
    feats, labels = [], []
    drop = sorted(set(ignore_labels) | {255})
    for img, lab in images:
        f = as_tensor(feature_fn(np.asarray(img)[None]))[0]
        pl = downsample_labels(lab, patch_size, num_classes, ignore_labels).flatten()
        keep = ~np.isin(pl, drop)
        feats.append(f.reshape(-1, f.shape[-1])[torch.as_tensor(keep, device=f.device)])
        labels.append(pl[keep])
    return torch.cat(feats), np.concatenate(labels)


class KNNSegProbe:
    """Majority vote of the k nearest train patches under cosine or L2
    distance (reference: eval_segmentation.py:172-278 KNNClassifier). Queries
    go `chunk` rows at a time and the bank `bank_tile` rows at a time, so
    only a ``[chunk, bank_tile]`` f32 block of similarities exists at once;
    each tile's top-k merges into the running top-k with the lower bank index
    first among equal similarities, so the neighbours are those of one
    ``lax.top_k`` over the whole bank. The bank lives where `feats` did (an
    array goes to the card), in f32 as in JAX."""

    def __init__(self, k: int = 10, distance: str = "cosine", num_classes: int = 150,
                 chunk: int = 4096, bank_tile: int = 262144):
        if distance not in ("cosine", "L2"):
            raise ValueError(f"unsupported distance {distance!r}")
        self.k = k
        self.distance = distance
        self.num_classes = num_classes
        self.chunk = chunk
        self.bank_tile = bank_tile

    def _prepare(self, feats) -> torch.Tensor:
        t = as_tensor(feats)
        f = t.float()
        if self.distance == "cosine":
            norm = torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12
            f = f / norm if f is t else f.div_(norm)
        return f

    def fit(self, feats, labels):
        self.train_feats = self._prepare(feats)
        dev = self.train_feats.device
        self.train_labels = as_tensor(labels, dev).to(dev, torch.int64)
        # -||q - t||^2 = 2 q.t - ||t||^2 (+ const in q): its top-k orders like
        # the smallest L2 distance
        self.train_sq = (self.train_feats ** 2).sum(-1) if self.distance == "L2" else None
        return self

    @torch.no_grad()
    def _neighbours(self, q: torch.Tensor, k: int) -> torch.Tensor:
        best_v = best_i = None
        for s in range(0, self.train_feats.shape[0], self.bank_tile):
            t = self.train_feats[s: s + self.bank_tile]
            rows = t.shape[0]
            if padded_rows(rows) != rows:  # a ragged last tile: copied, padded
                t = torch.nn.functional.pad(t, (0, 0, 0, padded_rows(rows) - rows))
            sims = q @ t.T
            if self.train_sq is not None:
                sims[:, :rows].mul_(2.0).sub_(self.train_sq[s: s + rows])
            sims[:, rows:] = float("-inf")  # the padding rows never rank
            v, i = topk_lowest_index_first(sims, min(k, rows))
            i += s
            del sims
            if best_v is not None:
                # the running k hold lower bank indices than this tile's, so a
                # stable sort of [running | tile] keeps the lower index first
                v, order = torch.sort(torch.cat((best_v, v), -1), dim=-1, descending=True,
                                      stable=True)
                v, i = v[:, :k], torch.cat((best_i, i), -1).gather(-1, order[:, :k])
            best_v, best_i = v, i
        return best_i

    @torch.no_grad()
    def predict(self, feats) -> np.ndarray:
        f = self._prepare(as_tensor(feats, self.train_feats.device).to(self.train_feats.device))
        k = min(self.k, self.train_feats.shape[0])
        out = []
        for s in range(0, f.shape[0], self.chunk):
            q = f[s: s + self.chunk]
            top_i = self._neighbours(q, k)
            votes = torch.zeros(q.shape[0], self.num_classes, device=q.device)
            votes.scatter_add_(1, self.train_labels[top_i],
                               torch.ones_like(top_i, dtype=votes.dtype))
            out.append(votes.argmax(-1))  # majority vote, the smallest class among ties
        return torch.cat(out).cpu().numpy()


class LogregSegProbe:
    """Multinomial logistic regression probe with the objective of the
    reference's cuML L-BFGS and of sklearn, ``min_W 0.5 ||W||^2 + C * sum_i
    CE_i`` with the intercept not penalised (reference:
    eval_segmentation.py:281-337; grid C, max_iter=1000, tol=1e-12).
    Backends:

    * "host": scipy L-BFGS-B in float64 on the host (the CPU path);
    * "device": full-batch ``torch.optim.LBFGS`` (strong-Wolfe line search,
      history 10) where the features live, on the bank in bf16 and W in f32.
      The objective and its gradient are computed in f64 and summed over
      `chunk_size`-row views of the bank, so one chunk widened to f64 and its
      ``[chunk, C]`` logits exist at a time (~1.3 GB at 131072 x 1024 x 150);
      the last chunk is a narrower view and no padded copy is made. It stops
      at ``max|g| <= tol``, when the line search makes no step, or after
      `max_iter` iterations (``n_iter_``); ``objective_`` holds the objective
      at the start and at the end. The JAX backend instead rounds W to bf16
      and sums in f32; on that objective (a step function along any line, its
      noise above the last steps' decrease) L-BFGS stops short of the minimum.
    * "auto": "host" for a CPU tensor, else "device" (an array goes to the
      card, see ``as_tensor``, which raises where there is none).

    Labels are remapped to ``0..n_classes-1`` with ``np.unique`` and mapped
    back in `predict`, as sklearn does."""

    def __init__(self, C: float = 1.0, max_iter: int = 1000, tol: float = 1e-12,
                 num_classes: int = 150, backend: str = "auto", chunk_size: int = 131072):
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.C = float(C)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.num_classes = num_classes
        self.chunk_size = int(chunk_size)

    def fit(self, feats, labels):
        classes, dense = np.unique(to_numpy(labels), return_inverse=True)
        if len(dense) == 0:
            raise ValueError("LogregSegProbe.fit needs at least one labelled feature")
        self._classes = classes
        self.backend_ = self.backend
        if self.backend == "auto":
            on_host = isinstance(feats, torch.Tensor) and feats.device.type == "cpu"
            self.backend_ = "host" if on_host else "device"
        if self.backend_ == "host":
            self._fit_host(to_numpy(feats).astype(np.float64), dense, len(classes))
        else:
            self._fit_device(as_tensor(feats), dense, len(classes))
        return self

    def _fit_host(self, x: np.ndarray, y: np.ndarray, c: int) -> None:
        """scipy's L-BFGS-B in f64 on the objective divided by ``C n``, as
        sklearn's lbfgs solver runs it (the same minimiser; the scale sets
        where its stopping rules, ``gtol`` and ``ftol``, fall)."""
        from scipy.optimize import minimize

        n, d = x.shape
        onehot = np.zeros((n, c))
        onehot[np.arange(n), y] = 1.0
        reg = 1.0 / (self.C * n)

        def loss_grad(p):
            w, b = p[: d * c].reshape(d, c), p[d * c:]
            logits = x @ w + b
            logits -= logits.max(1, keepdims=True)
            lse = np.log(np.exp(logits).sum(1, keepdims=True))
            g = (np.exp(logits - lse) - onehot) / n
            loss = 0.5 * reg * np.sum(w * w) + np.mean(lse[:, 0] - logits[np.arange(n), y])
            return loss, np.concatenate([(reg * w + x.T @ g).ravel(), g.sum(0)])

        res = minimize(loss_grad, np.zeros(d * c + c), method="L-BFGS-B", jac=True,
                       options={"maxiter": self.max_iter, "maxls": 50, "gtol": self.tol,
                                "ftol": 64 * np.finfo(float).eps})
        self._w, self._b = res.x[: d * c].reshape(d, c), res.x[d * c:]
        self.n_iter_ = int(res.nit)

    def _loss_grad(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> tuple:
        """The objective and its gradient in f64, summed over `chunk_size`-row
        views of the bf16 bank, each widened to f64 in turn. Each row's
        cross-entropy is taken from its logits less the true class's, ``m +
        log(e^-m + sum_{c != y} e^(d_c - m))`` with ``m = max(d) >= 0``, and
        its gradient at the true class as ``-sum_{c != y} p_c``, so the well
        classified rows keep their precision."""
        w64, b64 = w.double(), b.double()
        total = torch.zeros((), device=x.device, dtype=torch.float64)
        gw = torch.zeros_like(w64)
        gb = torch.zeros_like(b64)
        for s in range(0, x.shape[0], self.chunk_size):
            xc = x[s: s + self.chunk_size].double()
            yc = y[s: s + self.chunk_size, None]
            d = torch.addmm(b64, xc, w64)
            d -= d.gather(1, yc)
            m = d.amax(1, keepdim=True)
            p = d.sub_(m).exp_()
            e_y = p.gather(1, yc)
            other = p.scatter_(1, yc, 0.0).sum(1, keepdim=True)
            total += torch.where(m == 0, torch.log1p(other), m + torch.log(e_y + other)).sum()
            p /= e_y + other
            p.scatter_(1, yc, -other / (e_y + other))
            gw.addmm_(xc.T, p)
            gb += p.sum(0)
            del xc, d, p
        loss = 0.5 * (w64 * w64).sum() + self.C * total
        return loss, (w64 + self.C * gw).float(), (self.C * gb).float()

    @torch.no_grad()
    def _fit_device(self, feats: torch.Tensor, dense: np.ndarray, c: int) -> None:
        x = feats.to(torch.bfloat16)
        y = torch.as_tensor(dense, device=x.device, dtype=torch.int64)
        w = torch.zeros(x.shape[1], c, device=x.device, requires_grad=True)
        b = torch.zeros(c, device=x.device, requires_grad=True)
        # torch's default budget of evaluations (1.25 an iteration) would end
        # the fit before `max_iter`; 25 an iteration leaves the strong-Wolfe
        # searches their room
        opt = torch.optim.LBFGS([w, b], lr=1.0, max_iter=self.max_iter,
                                max_eval=25 * self.max_iter, tolerance_grad=self.tol,
                                tolerance_change=0.0, history_size=10,
                                line_search_fn="strong_wolfe")

        def closure():
            loss, w.grad, b.grad = self._loss_grad(x, y, w.detach(), b.detach())
            return loss

        start = float(opt.step(closure))
        self.n_iter_ = int(opt.state[w].get("n_iter", 0))
        self.objective_ = (start, float(closure()))
        self._w, self._b = w.detach(), b.detach()

    @torch.no_grad()
    def _logits(self, feats):
        """The logits in f64: numpy on the host backend, else where the fit
        ran, from the bf16 features."""
        if self.backend_ == "host":
            return to_numpy(feats).astype(np.float64) @ self._w + self._b
        x = as_tensor(feats, self._w.device).to(self._w.device, torch.bfloat16)
        w64, b64 = self._w.double(), self._b.double()
        return torch.cat([torch.addmm(b64, x[s: s + self.chunk_size].double(), w64)
                          for s in range(0, x.shape[0], self.chunk_size)])

    @torch.no_grad()
    def predict(self, feats) -> np.ndarray:
        return self._classes[to_numpy(self._logits(feats).argmax(-1))]


@dataclasses.dataclass
class SegEvalResult:
    probe: str
    params: Dict
    miou: float
    acc: float


def evaluate_seg_probes(
    train_feats,
    train_labels,
    val_feats,
    val_labels,
    num_classes: int,
    knn_grid: Sequence[Dict] = DEFAULT_KNN_GRID,
    logreg_grid: Sequence[Dict] = DEFAULT_LOGREG_GRID,
    grid_slice: Tuple[int, int] = (0, 1),  # (index, total) for multi-host split
    ignore_labels: Sequence[int] = (255,),
) -> List[SegEvalResult]:
    """Run the probe grid; `grid_slice` reproduces the reference's
    round-robin split of hyper-parameters across workers
    (reference: eval_segmentation.py:104-133). Val patches whose label is
    in `ignore_labels` are excluded from the metrics (:50-62)."""
    val_labels = to_numpy(val_labels)
    keep = ~np.isin(val_labels, np.asarray(ignore_labels))
    if isinstance(val_feats, torch.Tensor):
        val_feats = val_feats[torch.as_tensor(keep, device=val_feats.device)]
    else:
        val_feats = np.asarray(val_feats)[keep]
    val_labels = val_labels[keep]
    jobs: List[Tuple[str, Dict]] = [("knn", g) for g in knn_grid] + [
        ("logreg", g) for g in logreg_grid
    ]
    idx, total = grid_slice
    results = []
    for j, (kind, g) in enumerate(jobs):
        if j % total != idx:
            continue
        if kind == "knn":
            probe = KNNSegProbe(num_classes=num_classes, **g)
        else:
            probe = LogregSegProbe(num_classes=num_classes, **g)
        probe.fit(train_feats, train_labels)
        pred = probe.predict(val_feats)
        cm = confusion_matrix(pred, val_labels, num_classes)
        m = miou_from_confusion(cm, exclude=ignore_labels)
        results.append(SegEvalResult(kind, g, m["miou"], m["acc"]))
    return results
