"""The product-cost law (kernel row 14b, ``scripts/r3_matmul_law.py``): the
time of one bf16 product with f32 accumulators at the attention's product
shapes, as K-attn issues them (``mma.sync`` from shared memory), through
``csrc/mma_law.cu``.

:func:`matmul_law` ports ``_mm_kernel``: for each batch row b, `reps`
products ``max(a_b, -10 - i) . b_b`` ("nt": ``[M, K] x [L, K]^T``, the
scores; "nn": ``[M, K] x [K, L]``, P.V), each reduced to its f32 max, the
maxima summed into ``out[b] [8, 128]``. :func:`matmul_law_batched` ports
``main``'s ``batched_kernel``: the 16 heads' products of ``a [B, 16, M,
K]`` at once with ``max(a, -10)``, ``out[b]`` their max. The perturbation
keeps a compiler from factoring the repeated product out and the maxima
keep the stores out of the time. CPU tensors take the reference; CUDA
tensors launch the kernel. The ops run on no model path.
"""

from __future__ import annotations

import torch

from octic_vits_tpu_torch import kernels
from octic_vits_tpu_torch.ops._dispatch import check_kernel_arg, on_cuda

MODES = ("nt", "nn")
MAX_M = 384  # rows of A: 8 warps x 3 tiles of 16 (csrc/mma_law.cu)


def _dims(a, b, mode, batched):
    if mode not in MODES:
        raise ValueError(f"matmul law: mode {mode!r} is not one of {MODES}")
    nd = 4 if batched else 3
    if a.ndim != nd or b.ndim != nd or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul law: a {tuple(a.shape)}, b {tuple(b.shape)} are not "
                         f"[B, {'16, ' if batched else ''}M, K] and a matching b")
    m, k = a.shape[-2:]
    kb, l = (b.shape[-1], b.shape[-2]) if mode == "nt" else b.shape[-2:]
    if kb != k:
        raise ValueError(f"matmul law: contraction {k} vs {kb} ({mode})")
    return m, k, l


def _product(a, b, mode, floor):
    """f32 max(a, floor) . b (nt: b^T) of the operands as they are."""
    ai = torch.maximum(a, torch.tensor(floor, dtype=a.dtype, device=a.device)).float()
    bf = b.float()
    return ai @ (bf.transpose(-1, -2) if mode == "nt" else bf)


def matmul_law_reference(a, b, mode: str, reps: int = 16) -> torch.Tensor:
    _dims(a, b, mode, False)
    acc = None
    for i in range(reps):
        m = _product(a, b, mode, -10.0 - i).amax(dim=(-2, -1))
        acc = m if acc is None else acc + m
    return acc[:, None, None].expand(a.shape[0], 8, 128).contiguous()


def matmul_law_batched_reference(a, b, mode: str) -> torch.Tensor:
    _dims(a, b, mode, True)
    m = _product(a, b, mode, -10.0).amax(dim=(-3, -2, -1))
    return m[:, None, None].expand(a.shape[0], 8, 128).contiguous()


def _launch(op, a, b, mode, reps, batched):
    m, k, l = _dims(a, b, mode, batched)
    if m > MAX_M:
        raise ValueError(f"matmul law: M={m} rows, at most {MAX_M}")
    check_kernel_arg(a, "a", tuple(a.shape))
    check_kernel_arg(b, "b", tuple(b.shape))
    bsz, heads = a.shape[0], a.shape[1] if batched else 1
    out = torch.empty(bsz, 8, 128, device=a.device, dtype=torch.float32)
    op.launches += 1
    kernels.launch("ovt_mma_law", a, b, out, bsz, heads, m, k, l, int(mode == "nn"), reps)
    return out


def matmul_law(a: torch.Tensor, b: torch.Tensor, mode: str, reps: int = 16) -> torch.Tensor:
    """``r3_matmul_law.py:_mm_kernel`` on a ``[B, M, K]`` and b ``[B, L, K]``
    ("nt") or ``[B, K, L]`` ("nn"), bf16 -> ``[B, 8, 128]`` f32: the sum over
    i < reps of the max of ``max(a_b, -10 - i) . b_b``."""
    if not on_cuda((a, b)):
        return matmul_law_reference(a, b, mode, reps)
    if reps < 1:
        raise ValueError(f"matmul law: reps={reps}")
    return _launch(matmul_law, a, b, mode, reps, False)


def matmul_law_batched(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``r3_matmul_law.py:main``'s ``batched_kernel`` on a ``[B, H, M, K]``
    and b ``[B, H, L, K]`` ("nt") or ``[B, H, K, L]`` ("nn") -> ``[B, 8,
    128]`` f32: the max over the H products ``max(a_bh, -10) . b_bh``."""
    if not on_cuda((a, b)):
        return matmul_law_batched_reference(a, b, mode)
    return _launch(matmul_law_batched, a, b, mode, 1, True)


for _op in (matmul_law, matmul_law_batched):
    _op.launches = 0
    _op.reference = globals()[f"{_op.__name__}_reference"]
del _op
