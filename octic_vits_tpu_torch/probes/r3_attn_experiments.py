"""H100 counterpart of ``scripts/r3_attn_experiments.py``: two levers of the
forward attention against the shipped K-attn, at ViT-H/14 B=64 bf16 on the
standard qkv ``[B, N, 3C]`` and the six octic arrays (the ``ops`` of kernel
row 14b in ``ops/attention_probe.py``), in the script's order:

    std current          K-attn's whole-head core on the standard layout (probe h,
                         ops.full_attention): the core these levers change
    std TMA + wgmma      ops.standard_attention, row 1's redesigned forward, under its
                         own name
    std nb=2             two images a CTA (ops.multi_image_attention)
    octic nb=2           the same on the octic layout
    std cls-split        keys [N-1 | 1]: the 64-key blocks stop at key 256,
                         key 256 a rank-1 f32 update (ops.cls_split_attention)
    octic current        ops.octic_attention (K-attn's octic gather, row 5)
    octic cls-split      the cls-split on the octic layout
    octic hoist          the assembly of every (s, head) slice into the
                         128-padded qkv in HBM, then probe l on it
    octic hoist+split    the same with the cls-split

with SDPA beside the standard cases, and the hoist's two phases timed alone
(the assembly; probe l with and without the split) beside the floor of
K-attn (stage LOADS: the gather and store alone, standard layout). All in
turns (``tools/timing.py``). Run on the card from the repository root:

    python3 -m octic_vits_tpu_torch.probes.r3_attn_experiments
"""

from __future__ import annotations

import torch

B, H, N, C = 64, 16, 257, 1280
C8, DH = C // 8, C // H


def main() -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes import card_or_exit, check, report
    from octic_vits_tpu_torch.tools.timing import in_turns

    cs, card = card_or_exit("r3_attn_experiments")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    arrs = tuple(cs.randn(gen, B, N, 3 * C8) for _ in range(4)) + tuple(
        cs.randn(gen, B, N, 6 * C8) for _ in range(2))
    qkv = cs.randn(gen, B, N, 3 * C)
    with torch.no_grad():
        qkvp = ops.hoist_assembly(*arrs, H)
        for label, op, args, kw in (
                ("std nb=2", ops.multi_image_attention, (qkv, H), {}),
                ("octic nb=2", ops.multi_image_octic_attention, arrs + (H,), {}),
                ("std cls-split", ops.cls_split_attention, (qkv, H), {}),
                ("octic cls-split", ops.cls_split_octic_attention, arrs + (H,), {}),
                ("hoist assembly", ops.hoist_assembly, arrs + (H,), {}),
                ("octic hoist", ops.hoist_octic_attention, arrs + (H,), {}),
                ("octic hoist+split", ops.hoist_octic_attention, arrs + (H,), {"split": True}),
                ("hoist+split phase 2", ops.padded_octic_attention, (qkvp, H, DH),
                 {"split": True})):
            check(cs, label, op(*args, **kw), op.reference(*args, **kw))
        check(cs, "std cls-split vs the whole-head core (h)", ops.cls_split_attention(qkv, H),
              ops.full_attention(qkv, H))
        cases = {
            "std current (K-attn)": lambda: ops.full_attention(qkv, H),
            "std TMA + wgmma (ops.standard_attention)": lambda: ops.standard_attention(qkv, H),
            "SDPA (library)": cs.library_sdpa(qkv, H),
            "std nb=2": lambda: ops.multi_image_attention(qkv, H),
            "octic nb=2": lambda: ops.multi_image_octic_attention(*arrs, H),
            "std cls-split": lambda: ops.cls_split_attention(qkv, H),
            "octic current (K-attn, row 5)": lambda: ops.octic_attention(*arrs, H),
            "octic cls-split": lambda: ops.cls_split_octic_attention(*arrs, H),
            "octic hoist": lambda: ops.hoist_octic_attention(*arrs, H),
            "octic hoist+split": lambda: ops.hoist_octic_attention(*arrs, H, split=True),
            "hoist assembly alone": lambda: ops.hoist_assembly(*arrs, H),
            "hoist phase 2 (probe l)": lambda: ops.padded_octic_attention(qkvp, H, DH),
            "hoist+split phase 2": lambda: ops.padded_octic_attention(qkvp, H, DH, split=True),
            "loads only (K-attn's floor, std)": lambda: ops.scores_only_attention(qkv, H,
                                                                                  "loads"),
        }
        res = in_turns(cases)
    shape = (B, N, C, H)
    work = {"std current (K-attn)": ("standard_attention", False),
            "std TMA + wgmma (ops.standard_attention)": ("standard_attention", False),
            "std nb=2": ("multi_image_attention", False),
            "octic nb=2": ("multi_image_octic_attention", False),
            "std cls-split": ("cls_split_attention", True),
            "octic current (K-attn, row 5)": ("octic_attention", False),
            "octic cls-split": ("cls_split_octic_attention", True),
            "octic hoist": ("hoist_octic_attention", False),
            "octic hoist+split": ("hoist_octic_attention", True),
            "hoist assembly alone": ("hoist_assembly", False)}
    bounds = {k: cs.bound_of(*cs.experiment_work(name, split, *shape))
              for k, (name, split) in work.items()}
    m = res["median"]
    split = {
        "257th key's block, std (current - cls-split)":
            m["std current (K-attn)"] - m["std cls-split"],
        "257th key's block, octic (current - cls-split)":
            m["octic current (K-attn, row 5)"] - m["octic cls-split"],
        "two images a CTA, std (nb=2 - current)": m["std nb=2"] - m["std current (K-attn)"],
        "two images a CTA, octic (nb=2 - current)":
            m["octic nb=2"] - m["octic current (K-attn, row 5)"],
        "hoist - octic current": m["octic hoist"] - m["octic current (K-attn, row 5)"],
        "hoist+split - octic current":
            m["octic hoist+split"] - m["octic current (K-attn, row 5)"],
        "assembly + phase 2 - hoist":
            m["hoist assembly alone"] + m["hoist phase 2 (probe l)"] - m["octic hoist"],
        "assembly - K-attn's gather floor (LOADS)":
            m["hoist assembly alone"] - m["loads only (K-attn's floor, std)"],
        "K-attn - SDPA": m["std current (K-attn)"] - m["SDPA (library)"],
    }
    report(card, res, bounds, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
