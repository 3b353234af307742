"""H100 counterpart of ``scripts/profile_attn_kernel.py``: the octic
attention's time split into its load side, its store side and its compute
floor with aligned "fake" slices (probes a-d of ``ops/attention_probe.py``),
and the interleaved wide qkv (probe e: ``ops.octic_attention_wide``, kernel
row 13a), at ViT-H/14 B=64 bf16:

    octic kernel (current)   ops.octic_attention (row 5): 6-piece gather, octic scatter
    standard whole-head core ops.full_attention (probe h): the core the octic rows run,
                             on the standard layout; ops.standard_attention (the TMA +
                             wgmma standard forward) is timed beside it under its name
    aligned loads (a)        one 80-column slice per q, k, v; octic scatter
    aligned everything (b)   the same loads, one store per head
    aligned, NO softmax (c)  out = bf16(s) v
    aligned, cheap softmax (d) the exp in bf16
    interleave only          the six arrays -> one [B, N, 3C] (plain torch)
    interleave + wide (e)    that, then row 13a

with the script's "perturb floor" (six adds of the inputs, plain torch) as a
leg of its own: CUDA launches need no perturbation to run again. Run on the
card from the repository root:

    python3 -m octic_vits_tpu_torch.probes.profile_attn_kernel
"""

from __future__ import annotations

import torch

B, H, N, C = 64, 16, 257, 1280
C8 = C // 8


def interleave_wide(arrs: tuple, heads: int = H) -> torch.Tensor:
    """The six per-irrep qkv arrays (a1..b2 ``[B, N, 3C/8]``, e0, e1 ``[B, N,
    3C/4]``) -> one ``[B, N, 3C]`` with columns (s, head, [a1|a2|b1|b2|e0|e1])
    (``profile_attn_kernel.py:_interleave_wide``)."""
    b, n, _ = arrs[0].shape
    parts = [a.view(b, n, 3, heads, -1) for a in arrs]
    return torch.cat(parts, dim=-1).view(b, n, -1)


def main() -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes import card_or_exit, check, report
    from octic_vits_tpu_torch.tools.timing import in_turns

    cs, card = card_or_exit("profile_attn_kernel")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    ones = tuple(cs.randn(gen, B, N, 3 * C8) for _ in range(4))
    es = tuple(cs.randn(gen, B, N, 6 * C8) for _ in range(2))
    arrs = ones + es
    qkv = cs.randn(gen, B, N, 3 * C)
    written = (torch.arange(128 * H, device="cuda") % 128) < C // H
    with torch.no_grad():
        check(cs, "a aligned loads", ops.aligned_loads_attention(*arrs, H),
              ops.aligned_loads_attention.reference(*arrs, H))
        # c's output is an unnormalised sum of bf16-rounded scores: the
        # backward bar (chip_smoke.probe_cases)
        for label, op, scaled in (("b aligned all", ops.aligned_all_attention, False),
                                  ("c aligned nosm", ops.aligned_nosm_attention, True),
                                  ("d aligned cheap", ops.aligned_cheap_attention, False)):
            check(cs, label, op(*arrs, H), op.reference(*arrs, H), scaled, cols=written)
        check(cs, "e interleave + wide", ops.octic_attention_wide(interleave_wide(arrs), H),
              ops.octic_attention_wide_reference(interleave_wide(arrs), H))
        check(cs, "e vs octic_attention", ops.octic_attention_wide(interleave_wide(arrs), H),
              ops.octic_attention(*arrs, H))
        res = in_turns({
            "perturb floor (6 adds)": lambda: tuple(a + 1.0 for a in arrs),
            "standard whole-head core (probe h)": lambda: ops.full_attention(qkv, H),
            "standard TMA + wgmma (ops.standard_attention)":
                lambda: ops.standard_attention(qkv, H),
            "octic kernel (current)": lambda: ops.octic_attention(*arrs, H),
            "aligned loads, octic stores (a)": lambda: ops.aligned_loads_attention(*arrs, H),
            "aligned everything (b)": lambda: ops.aligned_all_attention(*arrs, H),
            "aligned, NO softmax (c)": lambda: ops.aligned_nosm_attention(*arrs, H),
            "aligned, cheap softmax (d)": lambda: ops.aligned_cheap_attention(*arrs, H),
            "interleave only": lambda: interleave_wide(arrs),
            "interleave + wide kernel (e)":
                lambda: ops.octic_attention_wide(interleave_wide(arrs), H),
        })
    shape = (B, N, C, H, True)
    bounds = {"standard whole-head core (probe h)": cs.bound("full_attention", shape),
              "standard TMA + wgmma (ops.standard_attention)":
                  cs.bound("standard_attention", shape),
              "octic kernel (current)": cs.bound("octic_attention", shape),
              "aligned loads, octic stores (a)": cs.bound("aligned_loads_attention", shape),
              "aligned everything (b)": cs.bound("aligned_all_attention", shape),
              "aligned, NO softmax (c)": cs.bound("aligned_nosm_attention", shape),
              "aligned, cheap softmax (d)": cs.bound("aligned_cheap_attention", shape),
              "interleave + wide kernel (e)": cs.bound("octic_attention_wide", shape)}
    m = res["median"]
    split = {
        "load-side cost (octic)": m["octic kernel (current)"]
        - m["aligned loads, octic stores (a)"],
        "store-side cost": m["aligned loads, octic stores (a)"] - m["aligned everything (b)"],
        "compute floor (b, with its aligned gather)": m["aligned everything (b)"],
        "softmax share (b - c)": m["aligned everything (b)"] - m["aligned, NO softmax (c)"],
        "cheap softmax saving (b - d)": m["aligned everything (b)"]
        - m["aligned, cheap softmax (d)"],
        "interleave + wide - octic": m["interleave + wide kernel (e)"]
        - m["octic kernel (current)"],
        "octic - standard (whole-head core)": m["octic kernel (current)"]
        - m["standard whole-head core (probe h)"],
    }
    report(card, res, bounds, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
