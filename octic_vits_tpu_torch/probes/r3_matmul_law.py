"""H100 counterpart of ``scripts/r3_matmul_law.py``: the cost of one bf16
product with f32 accumulators at the attention's two product shapes (the
scores ``[N, dh] x [N, dh]^T`` and P.V ``[N, N] x [N, dh]``), and at wider,
deeper and square shapes around them, as K-attn issues its products
(``mma.sync`` m16n8k16 from shared memory; ``ops.matmul_law``,
``csrc/mma_law.cu``). A grid of B = 64 CTAs, each running 16 products
(8 for the two largest), or the 16 heads' products at once (batched).

For each of the script's twelve shapes it prints the time of one launch,
the ns per product and the TFLOP/s of one product, and beside them
``torch.bmm`` of the same products (cuBLAS, its own kernel and layout; no
one PyTorch call computes the sum of maxima, so the kernels line's library
column stays empty). Run on the card from the repository root:

    python3 -m octic_vits_tpu_torch.probes.r3_matmul_law
"""

from __future__ import annotations

import json

import torch

B, N = 64, 257
# r3_matmul_law.py:main (:89-159): (label, a per batch row, b per batch row,
# mode, reps); reps None: the batched kernel (16 heads, one max)
LAW_SHAPES = (
    ("scores  [257,80]x[257,80]^T", (N, 80), (N, 80), "nt", 16),
    ("AV      [257,257]x[257,80]", (N, N), (N, 80), "nn", 16),
    ("AV wide [257,257]x[257,256]", (N, N), (N, 256), "nn", 16),
    ("AV wide [257,257]x[257,384]", (N, N), (N, 384), "nn", 16),
    ("AV wide [257,257]x[257,512]", (N, N), (N, 512), "nn", 8),
    ("nn      [257,257]x[257,128]", (N, N), (N, 128), "nn", 16),
    ("nn      [257,128]x[128,128]", (N, 128), (128, 128), "nn", 16),
    ("nn      [257,512]x[512,128]", (N, 512), (512, 128), "nn", 16),
    ("nt      [257,128]x[257,128]^T", (N, 128), (N, 128), "nt", 16),
    ("nn      [256,512]x[512,512]", (256, 512), (512, 512), "nn", 8),
    ("BATCH16 scores [16,257,128]nt", (16, N, 128), (16, N, 128), "nt", None),
    ("BATCH16 AV [16,257,257]x[16,257,128]", (16, N, N), (16, N, 128), "nn", None),
)


def products(a_shape, b_shape, mode, reps) -> tuple:
    """(products per batch row, FLOPs of one product)."""
    m, k = a_shape[-2:]
    l = b_shape[-2] if mode == "nt" else b_shape[-1]
    return (16 if reps is None else reps), 2 * m * k * l


def law_call(a, b, mode, reps):
    """The kernel op of one shape, and torch.bmm of the same products."""
    from octic_vits_tpu_torch import ops

    if reps is None:
        bmm_a, bmm_b = a.flatten(0, 1), b.flatten(0, 1)
        bt = bmm_b.transpose(1, 2) if mode == "nt" else bmm_b
        return (lambda: ops.matmul_law_batched(a, b, mode)), (lambda: torch.bmm(bmm_a, bt))
    bt = b.transpose(1, 2) if mode == "nt" else b

    def bmm():
        for _ in range(reps):
            torch.bmm(a, bt)
    return (lambda: ops.matmul_law(a, b, mode, reps)), bmm


def main() -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes import card_or_exit, check
    from octic_vits_tpu_torch.tools.timing import in_turns

    cs, card = card_or_exit("r3_matmul_law")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    print(f"B={B} CTAs x 16 products each (8 for two shapes), bf16, f32 accumulators; "
          f"in turns on {card}", flush=True)
    rows = {}
    with torch.no_grad():
        for label, a_shape, b_shape, mode, reps in LAW_SHAPES:
            a, b = cs.law_inputs(gen, B, a_shape, b_shape, mode)
            kern, bmm = law_call(a, b, mode, reps)
            op = ops.matmul_law_batched if reps is None else ops.matmul_law
            args = (a, b, mode) if reps is None else (a, b, mode, reps)
            check(cs, label, kern(), op.reference(*args), tol=cs.tol_of(op))
            res = in_turns({"mma.sync law": kern, "cuBLAS, same products": bmm})
            per_b, flop = products(a_shape, b_shape, mode, reps)
            ms, ms_bmm = res["median"]["mma.sync law"], res["median"]["cuBLAS, same products"]
            bound_ms, bound_by = cs.bound_of(*cs.law_work(B, a_shape, b_shape, mode, reps))
            ns = ms * 1e6 / (B * per_b)
            rows[label] = {"ms": ms, "ns_per_product": ns, "tflops": flop / ns * 1e-3,
                           "bmm_ms": ms_bmm, "bmm_tflops": B * per_b * flop / ms_bmm * 1e-9,
                           "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"{label:40s} {ms * 1e3:9.1f} us {ns:8.0f} ns/product "
                  f"{rows[label]['tflops']:7.1f} TFLOP/s | cuBLAS, same products "
                  f"{ms_bmm * 1e3:9.1f} us {rows[label]['bmm_tflops']:7.1f} TFLOP/s | bound "
                  f"{bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    print(json.dumps({"card": card, "law": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
