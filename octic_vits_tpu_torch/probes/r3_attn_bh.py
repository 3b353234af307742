"""H100 counterpart of ``scripts/r3_attn_bh.py``: attention on the 128-padded
qkv ``[B, N, 3 H 128]`` on a grid of (batch, head), with the padded store
(probe m, ``ops.bh_std_attention``) and with the octic scatter (probe n,
``ops.bh_octic_attention``), against K-attn's whole-head core on the natural
qkv (probe h, ``ops.full_attention``), whose grid is already (head, batch):
these are the padded-layout cases of probe k and l, timed on their own. The
TMA + wgmma standard forward (``ops.standard_attention``) is timed beside
them under its own name. Run on the card from the repository root:

    python3 -m octic_vits_tpu_torch.probes.r3_attn_bh
"""

from __future__ import annotations

import torch

B, H, N, C = 64, 16, 257, 1280
DH = C // H
DHP = 128  # the TPU lane width: each head's slot in the padded layout


def pad_qkv(qkv: torch.Tensor, heads: int = H, slot: int = DHP) -> torch.Tensor:
    """``[B, N, 3 H dh]`` in (3, H, dh) order -> ``[B, N, 3 H slot]``, each
    head's dh channels at the start of its slot, zeros after them."""
    b, n, w = qkv.shape
    dh = w // (3 * heads)
    out = qkv.new_zeros(b, n, 3, heads, slot)
    out[..., :dh] = qkv.view(b, n, 3, heads, dh)
    return out.view(b, n, 3 * heads * slot)


def main() -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes import card_or_exit, check, report
    from octic_vits_tpu_torch.tools.timing import in_turns

    cs, card = card_or_exit("r3_attn_bh")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    qkv = cs.randn(gen, B, N, 3 * C)
    qkvp = pad_qkv(qkv)
    shape = (B, N, C, H, True)
    with torch.no_grad():
        ref = ops.full_attention(qkv, H)
        got = ops.bh_std_attention(qkvp, H, DH)
        check(cs, "bh_std_attention", got, ops.bh_std_attention.reference(qkvp, H, DH))
        check(cs, "bh_std_attention real columns vs the whole-head core (h)",
              got.view(B, N, H, DHP)[..., :DH].reshape(B, N, C), ref)
        check(cs, "bh_octic_attention", ops.bh_octic_attention(qkvp, H, DH),
              ops.bh_octic_attention.reference(qkvp, H, DH))
        res = in_turns({
            "std whole-head core (h, natural)": lambda: ops.full_attention(qkv, H),
            "std TMA + wgmma (natural)": lambda: ops.standard_attention(qkv, H),
            "std grid-(b,h) padded (m)": lambda: ops.bh_std_attention(qkvp, H, DH),
            "octic grid-(b,h) padded (n)": lambda: ops.bh_octic_attention(qkvp, H, DH),
            "pad_qkv (plain torch)": lambda: pad_qkv(qkv),
        })
    med = res["median"]
    bounds = {"std whole-head core (h, natural)": cs.bound("full_attention", shape),
              "std TMA + wgmma (natural)": cs.bound("standard_attention", shape),
              "std grid-(b,h) padded (m)": cs.bound("bh_std_attention", shape),
              "octic grid-(b,h) padded (n)": cs.bound("bh_octic_attention", shape)}
    split = {"padded layout, padded store - natural":
             med["std grid-(b,h) padded (m)"] - med["std whole-head core (h, natural)"],
             "octic scatter - padded store":
             med["octic grid-(b,h) padded (n)"] - med["std grid-(b,h) padded (m)"]}
    report(card, res, bounds, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
