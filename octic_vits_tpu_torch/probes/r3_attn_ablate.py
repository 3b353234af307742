"""H100 counterpart of ``scripts/r3_attn_ablate.py``: K-attn cut down stage by
stage, restructured, and fed the 128-padded qkv, at ViT-H/14 B=64 bf16
(probes f-l of ``ops/attention_probe.py``):

    loads only        the gather and the store (out = v; the H100 floor)
    scores only (f)   + q k^T and the online row max
    scores+softmax (g) + exp and the row sum
    full (h)          + P.V: K-attn's whole-head core, built from the probe source
    interleave2 (i)   two heads a CTA, their chains advancing together
    phased (j)        a two-pass softmax through shared memory
    PADDED ... (k, l) the padded qkv [B, N, 3 H 128], 80 real channels

timed in turns with SDPA (the library call of ``chip_smoke.library_sdpa``)
and with ``ops.standard_attention``, which is K-attn's TMA + wgmma standard
forward (csrc/attention_std.cu) and no longer the whole-head core these
probes cut down: probe h is that core as it was. The split of the
whole-head core's time is taken as differences of these times, as the TPU
script derives its own (``profile_attn_kernel.py:258-272``). Run on the card from the repository
root:

    python3 -m octic_vits_tpu_torch.probes.r3_attn_ablate
"""

from __future__ import annotations

import torch

from octic_vits_tpu_torch.probes.r3_attn_bh import pad_qkv

B, H, N, C = 64, 16, 257, 1280
DH = C // H


def main() -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes import card_or_exit, check, report
    from octic_vits_tpu_torch.tools.timing import in_turns

    cs, card = card_or_exit("r3_attn_ablate")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    qkv = cs.randn(gen, B, N, 3 * C)
    qkvp = pad_qkv(qkv)
    cases = {
        "std TMA + wgmma (ops.standard_attention)": (lambda: ops.standard_attention(qkv, H),
                                                     "standard_attention"),
        "SDPA (library)": (cs.library_sdpa(qkv, H), None),
        "loads only": (lambda: ops.scores_only_attention(qkv, H, "loads"), "loads_only"),
        "scores only (f)": (lambda: ops.scores_only_attention(qkv, H), "scores_only_attention"),
        "scores+softmax (g)": (lambda: ops.scores_softmax_attention(qkv, H),
                               "scores_softmax_attention"),
        "full (h)": (lambda: ops.full_attention(qkv, H), "full_attention"),
        "interleave2 (i)": (lambda: ops.interleave2_attention(qkv, H), "interleave2_attention"),
        "phased (j)": (lambda: ops.phased_attention(qkv, H), "phased_attention"),
        "PADDED scores only (k)": (lambda: ops.padded_attention(qkvp, H, DH, "scores"),
                                   "scores_only_attention"),
        "PADDED full (k)": (lambda: ops.padded_attention(qkvp, H, DH), "full_attention"),
        "PADDED + octic scatter (l)": (lambda: ops.padded_octic_attention(qkvp, H, DH),
                                       "padded_octic_attention"),
    }
    with torch.no_grad():
        for label, op, args in (
                ("loads only", ops.scores_only_attention, (qkv, H, "loads")),
                ("f", ops.scores_only_attention, (qkv, H)),
                ("g", ops.scores_softmax_attention, (qkv, H)),
                ("h", ops.full_attention, (qkv, H)),
                ("i", ops.interleave2_attention, (qkv, H)),
                ("j", ops.phased_attention, (qkv, H)),
                ("k scores", ops.padded_attention, (qkvp, H, DH, "scores")),
                ("k full", ops.padded_attention, (qkvp, H, DH)),
                ("l", ops.padded_octic_attention, (qkvp, H, DH))):
            check(cs, label, op(*args), op.reference(*args))
        res = in_turns({k: fn for k, (fn, _) in cases.items()})
    shape = (B, N, C, H, True)
    bounds = {k: cs.bound(w, shape) for k, (_, w) in cases.items() if w}
    m = res["median"]
    split = {
        "gather + store (loads only)": m["loads only"],
        "scores: q k^T + row max (f - loads)": m["scores only (f)"] - m["loads only"],
        "softmax: exp + sum (g - f)": m["scores+softmax (g)"] - m["scores only (f)"],
        "P.V + normalise (h - g)": m["full (h)"] - m["scores+softmax (g)"],
        "TMA + wgmma - whole-head core (std - h)":
            m["std TMA + wgmma (ops.standard_attention)"] - m["full (h)"],
        "two heads a CTA (i - h)": m["interleave2 (i)"] - m["full (h)"],
        "two-pass softmax (j - h)": m["phased (j)"] - m["full (h)"],
        "padded layout, scores (k - f)": m["PADDED scores only (k)"] - m["scores only (f)"],
        "padded layout, full (k - h)": m["PADDED full (k)"] - m["full (h)"],
        "octic scatter on padded (l - k)": m["PADDED + octic scatter (l)"] - m["PADDED full (k)"],
        "whole-head core - SDPA (h - SDPA)": m["full (h)"] - m["SDPA (library)"],
        "TMA + wgmma - SDPA": m["std TMA + wgmma (ops.standard_attention)"]
        - m["SDPA (library)"],
    }
    report(card, res, bounds, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
