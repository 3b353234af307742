"""H100 counterpart of ``scripts/r3_attn_bwd_ablate.py``: the attention
backward's scatter and cotangent assembly, heads in groups, and the qkv
product inside the attention, against the shipped kernels, at ViT-H/14 bf16
(forwards B=64, backwards B=32, as the script runs them; the ``ops`` of kernel
row 14c in ``ops/attention_bwd_probe.py``). Its three modes are the script's:

    default         std fwd: current (K-attn's whole-head core, probe h; row 1's
                    TMA + wgmma forward beside it), pack G=1, 2, 4 (one row
                    max shared by the group), maskpair; octic fwd: current
                    (row 5), groups G=1, 2 (maskpair), 4 (maskquad); std bwd
                    (B=32): current (row 1b), pack G=1, 2, 4, maskpair; octic
                    bwd (B=32): current (row 5's), wide-store, wide-g, groups
                    G=1, 2
    --quad-only     octic fwd and bwd: current, groups G=1, 2, 4
    --fuseqkv-only  current (row 2: K-lin-d8 then K-attn), the fused qkv +
                    attention, the fused one then torch.matmul's proj, the
                    fused qkv + attention + proj

SDPA and its backward sit beside the standard cases. Each variant is first
checked against its plain version; each family is then timed in turns
(``tools/timing.py``) with the case the script calls "current" first, so each
ratio is to it. The split the differences give: the scatter tax (octic bwd -
wide-store), the g-assembly tax (octic bwd - wide-g), pairs and quads
against one head a CTA (the same kernel at G = 1), key-tiled against
whole-head staging (G = 1 - current), and the qkv round trip through device
memory (row 2 - fused). Run on the card from the repository root:

    python3 -m octic_vits_tpu_torch.probes.r3_attn_bwd_ablate [--quad-only|--fuseqkv-only]
"""

from __future__ import annotations

import sys

import torch

B, B_BWD, H, N, C = 64, 32, 16, 257, 1280
C8 = C // 8


def _inputs(cs, gen):
    arrs = tuple(cs.randn(gen, B, N, 3 * C8) for _ in range(4)) + tuple(
        cs.randn(gen, B, N, 6 * C8) for _ in range(2))
    gs = tuple(cs.randn(gen, B_BWD, N, C8) for _ in range(4)) + tuple(
        cs.randn(gen, B_BWD, N, 2 * C8) for _ in range(2))
    qkv, g, gw = cs.randn(gen, B, N, 3 * C), cs.randn(gen, B_BWD, N, C), cs.randn(
        gen, B_BWD, N, C)
    return arrs, gs, qkv, g, gw


def _fused_inputs(cs, gen):
    """The script's --fuseqkv-only inputs: x at 0.1, weights and biases at 0.05."""
    xs = tuple(cs.randn(gen, B, N, C8, scale=0.1) for _ in range(4)) + (
        cs.randn(gen, B, N, 4 * C8, scale=0.1),)
    w = (cs.randn(gen, 4, C8, 3 * C8, scale=0.05), cs.randn(gen, 2 * C8, 6 * C8, scale=0.05),
         cs.randn(gen, 3 * C8, scale=0.05))
    wp = (cs.randn(gen, 4, C8, C8, scale=0.05), cs.randn(gen, 2 * C8, 2 * C8, scale=0.05),
          cs.randn(gen, C8, scale=0.05))
    return xs, w, wp


def proj_matmul(outs, w1p, wep, biasp):
    """The script's ``qkvattn_then_xla_proj`` proj: batched products of the
    six attention outputs (torch.matmul, bf16), the bias on the A1 output ->
    o1..o4, oef."""
    ones = torch.matmul(torch.stack(outs[:4]), w1p.unsqueeze(1))
    e = torch.cat([torch.matmul(outs[4], wep), torch.matmul(outs[5], wep)], dim=-1)
    return (ones[0] + biasp, ones[1], ones[2], ones[3], e)


def _families(mode, ops, cs, arrs, gs, qkv, g, gw, fused):
    """{family: {case: (callable, work key or None)}}, "current" first in each."""
    ab, qb = tuple(t[:B_BWD] for t in arrs), qkv[:B_BWD]
    fwd = lambda name, grp=1, m=False: cs.probe_14c_work(name, B, N, C, grp, m)  # noqa: E731
    bwd = lambda name, grp=1, m=False: cs.probe_14c_work(name, B_BWD, N, C, grp, m)  # noqa: E731
    if mode == "fuseqkv":
        xs, (w1, we, bq), (w1p, wep, bp) = fused
        return {"fused qkv": {
            "row 2 current (K-lin-d8 + K-attn)": (
                lambda: ops.octic_attention_fused_qkv(*xs, w1, we, bq, H),
                fwd("octic_qkv_attention")),
            "FUSED qkv+attn": (lambda: ops.octic_qkv_attention(*xs, w1, we, bq, H),
                               fwd("octic_qkv_attention")),
            "fused qkv+attn -> matmul proj": (
                lambda: proj_matmul(ops.octic_qkv_attention(*xs, w1, we, bq, H), w1p, wep, bp),
                fwd("octic_qkv_attention_proj")),
            "FUSED qkv+attn+proj": (
                lambda: ops.octic_qkv_attention_proj(*xs, w1, we, bq, w1p, wep, bp, H),
                fwd("octic_qkv_attention_proj")),
        }}
    octic_fwd = {"octic fwd current (row 5)": (lambda: ops.octic_attention(*arrs, H),
                                               fwd("octic_attention"))}
    octic_bwd = {"octic bwd current (row 5's)": (lambda: ops.octic_attention_bwd(ab, gs, H),
                                                 bwd("octic_attention_bwd"))}
    groups = (1, 2, 4) if mode == "quad" else (1, 2)
    for grp in (1, 2, 4):
        octic_fwd[f"octic fwd G={grp}"] = (
            lambda grp=grp: ops.octic_group_attention(*arrs, H, grp),
            fwd("octic_group_attention", grp, True))
    for grp in groups:
        octic_bwd[f"octic bwd G={grp}"] = (
            lambda grp=grp: ops.octic_group_attention_bwd(ab, gs, H, grp),
            bwd("octic_group_attention_bwd", grp, True))
    if mode == "quad":
        return {"octic fwd": octic_fwd, "octic bwd": octic_bwd}
    std_fwd = {"std fwd current (K-attn)": (lambda: ops.full_attention(qkv, H),
                                            fwd("standard_attention")),
               "std fwd TMA + wgmma (ops.standard_attention)":
                   (lambda: ops.standard_attention(qkv, H), fwd("standard_attention")),
               "SDPA (library)": (cs.library_sdpa(qkv, H), None)}
    std_bwd = {"std bwd current (K-attn-bwd)": (lambda: ops.standard_attention_bwd(qb, g, H),
                                                bwd("standard_attention_bwd")),
               "SDPA bwd (library)": (cs.library_sdpa_bwd(qb, g, H), None)}
    for grp in (1, 2, 4):
        std_fwd[f"std fwd pack G={grp}"] = (lambda grp=grp: ops.std_pack_attention(qkv, H, grp),
                                            fwd("std_pack_attention"))
        std_bwd[f"std bwd pack G={grp}"] = (
            lambda grp=grp: ops.std_pack_attention_bwd(qb, g, H, grp),
            bwd("std_pack_attention_bwd"))
    std_fwd["std fwd maskpair"] = (lambda: ops.std_maskpair_attention(qkv, H),
                                   fwd("std_maskpair_attention", 2, True))
    std_bwd["std bwd maskpair"] = (lambda: ops.std_maskpair_attention_bwd(qb, g, H),
                                   bwd("std_maskpair_attention_bwd", 2, True))
    octic_bwd["octic bwd wide-store"] = (lambda: ops.octic_attention_bwd_widestore(ab, gs, H),
                                         bwd("octic_attention_bwd_widestore"))
    octic_bwd["octic bwd wide-g"] = (lambda: ops.octic_attention_bwd_wideg(ab, gw, H),
                                     bwd("octic_attention_bwd_wideg"))
    return {"std fwd": std_fwd, "octic fwd": octic_fwd, "std bwd": std_bwd,
            "octic bwd": octic_bwd}


def _checks(mode, ops, cs, arrs, gs, qkv, g, gw, fused):
    ab, qb = tuple(t[:B_BWD] for t in arrs), qkv[:B_BWD]
    if mode == "fuseqkv":
        xs, (w1, we, bq), (w1p, wep, bp) = fused
        return [("fused qkv+attn", ops.octic_qkv_attention, xs + (w1, we, bq, H), False),
                ("fused qkv+attn+proj", ops.octic_qkv_attention_proj,
                 xs + (w1, we, bq, w1p, wep, bp, H), False)]
    cases = [(f"octic fwd G={grp}", ops.octic_group_attention, arrs + (H, grp), False)
             for grp in (1, 2, 4)]
    cases += [(f"octic bwd G={grp}", ops.octic_group_attention_bwd, (ab, gs, H, grp), True)
              for grp in (1, 2, 4)]
    if mode == "quad":
        return cases
    cases += [(f"std fwd pack G={grp}", ops.std_pack_attention, (qkv, H, grp), False)
              for grp in (1, 2, 4)]
    cases += [(f"std bwd pack G={grp}", ops.std_pack_attention_bwd, (qb, g, H, grp), True)
              for grp in (1, 2, 4)]
    return cases + [
        ("std fwd maskpair", ops.std_maskpair_attention, (qkv, H), False),
        ("std bwd maskpair", ops.std_maskpair_attention_bwd, (qb, g, H), True),
        ("octic bwd wide-store", ops.octic_attention_bwd_widestore, (ab, gs, H), True),
        ("octic bwd wide-g", ops.octic_attention_bwd_wideg, (ab, gw, H), True),
    ]


def _split(mode, m):
    if mode == "fuseqkv":
        return {
            "qkv round trip (row 2 - fused)":
                m["row 2 current (K-lin-d8 + K-attn)"] - m["FUSED qkv+attn"],
            "proj in the kernel (fused + matmul proj - fused proj)":
                m["fused qkv+attn -> matmul proj"] - m["FUSED qkv+attn+proj"],
            "proj in the kernel, cost (fused proj - fused)":
                m["FUSED qkv+attn+proj"] - m["FUSED qkv+attn"],
        }
    out = {
        "octic fwd: pair - one head (G=2 - G=1)": m["octic fwd G=2"] - m["octic fwd G=1"],
        "octic fwd: key-tiled - whole-head staging (G=1 - current)":
            m["octic fwd G=1"] - m["octic fwd current (row 5)"],
        "octic bwd: pair - one head (G=2 - G=1)": m["octic bwd G=2"] - m["octic bwd G=1"],
        "octic bwd: key-tiled - whole-head staging (G=1 - current)":
            m["octic bwd G=1"] - m["octic bwd current (row 5's)"],
    }
    out["octic fwd: quad - one head (G=4 - G=1)"] = m["octic fwd G=4"] - m["octic fwd G=1"]
    if mode == "quad":
        out["octic bwd: quad - one head (G=4 - G=1)"] = m["octic bwd G=4"] - m["octic bwd G=1"]
        return out
    out.update({
        "scatter tax (octic bwd - wide-store)":
            m["octic bwd current (row 5's)"] - m["octic bwd wide-store"],
        "g-assembly tax (octic bwd - wide-g)":
            m["octic bwd current (row 5's)"] - m["octic bwd wide-g"],
        "std fwd: pair - one head (pack G=2 - G=1)": m["std fwd pack G=2"] - m["std fwd pack G=1"],
        "std fwd: quad - one head (pack G=4 - G=1)": m["std fwd pack G=4"] - m["std fwd pack G=1"],
        "std fwd: zero products (maskpair - pack G=2)":
            m["std fwd maskpair"] - m["std fwd pack G=2"],
        "std fwd: key-tiled - whole-head staging (pack G=1 - current)":
            m["std fwd pack G=1"] - m["std fwd current (K-attn)"],
        "std bwd: pair - one head (pack G=2 - G=1)": m["std bwd pack G=2"] - m["std bwd pack G=1"],
        "std bwd: quad - one head (pack G=4 - G=1)": m["std bwd pack G=4"] - m["std bwd pack G=1"],
        "std bwd: zero products (maskpair - pack G=2)":
            m["std bwd maskpair"] - m["std bwd pack G=2"],
        "std bwd: key-tiled - whole-head staging (pack G=1 - current)":
            m["std bwd pack G=1"] - m["std bwd current (K-attn-bwd)"],
    })
    return out


def main(argv=None) -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.probes import card_or_exit, check, report
    from octic_vits_tpu_torch.tools.timing import in_turns

    argv = sys.argv[1:] if argv is None else argv
    mode = "quad" if "--quad-only" in argv else "fuseqkv" if "--fuseqkv-only" in argv else ""
    cs, card = card_or_exit("r3_attn_bwd_ablate")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    data = _inputs(cs, gen) + (_fused_inputs(cs, gen) if mode == "fuseqkv" else None,)
    res, bounds, extra = {"ms": {}, "median": {}, "ratio": {}}, {}, {}
    with torch.no_grad():
        for label, op, args, scaled in _checks(mode, ops, cs, *data):
            check(cs, label, op(*args), op.reference(*args), scaled)
        if mode == "fuseqkv":
            xs, w, (w1p, wep, bp) = data[-1]
            check(cs, "fused qkv+attn -> matmul proj",
                  proj_matmul(ops.octic_qkv_attention(*xs, *w, H), w1p, wep, bp),
                  ops.octic_qkv_attention_proj(*xs, *w, w1p, wep, bp, H))
        for family, cases in _families(mode, ops, cs, *data).items():
            r = in_turns({k: fn for k, (fn, _) in cases.items()})
            for key in res:
                res[key].update(r[key])
            for k, (_, wk) in cases.items():
                if wk is not None:
                    bounds[k] = cs.bound_of(*wk[:3])
                    if wk[3]:
                        extra[k] = wk[3] / 1e9
            print(f"{family}: timed in turns, ratios to its first case", flush=True)
    if extra:
        print("extra products of the masked cases (GFLOP, outside the bound): "
              + ", ".join(f"{k} {v:.2f}" for k, v in extra.items()), flush=True)
    report(card, res, bounds, _split(mode, res["median"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
