"""H100 counterpart of ``scripts/r3_attn_headmajor.py``: attention on a
head-major qkv ``[B, 3, H, N, dh]`` (probe o, ``ops.headmajor_attention``)
and its backward (probe p, ``ops.headmajor_attention_bwd``), K-attn and
K-attn-bwd with batch strides, timed as the script's ``bench()`` does: the
kernel alone, with the transpose in front, with the transpose back after,
the transpose alone; the backward at B=32 against K-attn-bwd on the natural
qkv. The natural forward is K-attn's whole-head core (probe h), which the
head-major kernel reuses; row 1's TMA + wgmma forward is timed beside it.
Run on the card from the repository root:

    python3 -m octic_vits_tpu_torch.probes.r3_attn_headmajor
"""

from __future__ import annotations

import torch

B, H, N, C = 64, 16, 257, 1280
DH = C // H
B_BWD = 32  # r3_attn_headmajor.py:163


def to_headmajor(qkv: torch.Tensor, heads: int = H) -> torch.Tensor:
    """``[B, N, 3C]`` in (3, H, dh) order -> ``[B, 3, H, N, dh]`` (a copy)."""
    b, n, w = qkv.shape
    return qkv.view(b, n, 3, heads, w // (3 * heads)).permute(0, 2, 3, 1, 4).contiguous()


def from_headmajor(o_hm: torch.Tensor) -> torch.Tensor:
    """``[B, H, N, dh]`` -> ``[B, N, H dh]`` (a copy)."""
    b, nh, n, dh = o_hm.shape
    return o_hm.transpose(1, 2).reshape(b, n, nh * dh)


def main() -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes import card_or_exit, check, report
    from octic_vits_tpu_torch.tools.timing import in_turns

    cs, card = card_or_exit("r3_attn_headmajor")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    qkv = cs.randn(gen, B, N, 3 * C)
    hm = to_headmajor(qkv)
    qkv32, hm32 = qkv[:B_BWD], hm[:B_BWD]
    g32 = cs.randn(gen, B_BWD, N, C)
    g_hm32 = g32.view(B_BWD, N, H, DH).transpose(1, 2).contiguous()
    with torch.no_grad():
        check(cs, "headmajor_attention", ops.headmajor_attention(hm, H),
              ops.headmajor_attention.reference(hm, H))
        check(cs, "headmajor_attention vs standard_attention",
              from_headmajor(ops.headmajor_attention(hm, H)), ops.standard_attention(qkv, H))
        check(cs, "headmajor_attention_bwd", ops.headmajor_attention_bwd(hm32, g_hm32, H),
              ops.headmajor_attention_bwd.reference(hm32, g_hm32, H), scaled=True)
        fwd = in_turns({
            "std fwd kernel (K-attn)": lambda: ops.full_attention(qkv, H),
            "std fwd TMA + wgmma (ops.standard_attention)": lambda: ops.standard_attention(qkv, H),
            "headmajor fwd kernel (o)": lambda: ops.headmajor_attention(hm, H),
            "transpose+hm fwd": lambda: ops.headmajor_attention(to_headmajor(qkv), H),
            "transpose+hm+untranspose":
                lambda: from_headmajor(ops.headmajor_attention(to_headmajor(qkv), H)),
            "transpose alone": lambda: to_headmajor(qkv),
        })
        bwd = in_turns({
            "std bwd kernel (K-attn-bwd, B=32)":
                lambda: ops.standard_attention_bwd(qkv32, g32, H),
            "headmajor bwd kernel (p)": lambda: ops.headmajor_attention_bwd(hm32, g_hm32, H),
            "T+hm bwd+unT": lambda: ops.headmajor_attention_bwd(
                to_headmajor(qkv32), g_hm32, H).permute(0, 3, 1, 2, 4).reshape(B_BWD, N, 3 * C),
        })
    shape, shape32 = (B, N, C, H, True), (B_BWD, N, C, H, True)
    report(card, fwd, {"std fwd kernel (K-attn)": cs.bound("full_attention", shape),
                       "std fwd TMA + wgmma (ops.standard_attention)":
                           cs.bound("standard_attention", shape),
                       "headmajor fwd kernel (o)": cs.bound("headmajor_attention", shape)},
           {"head-major - natural, fwd": fwd["median"]["headmajor fwd kernel (o)"]
            - fwd["median"]["std fwd kernel (K-attn)"]})
    report(card, bwd, {"std bwd kernel (K-attn-bwd, B=32)":
                       cs.bound("standard_attention_bwd", shape32),
                       "headmajor bwd kernel (p)": cs.bound("headmajor_attention_bwd", shape32)},
           {"head-major - natural, bwd": bwd["median"]["headmajor bwd kernel (p)"]
            - bwd["median"]["std bwd kernel (K-attn-bwd, B=32)"]})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
