"""H100 counterpart of ``scripts/profile_lin_tiles.py``: the qkv K-lin-d8 at
hybrid ViT-H/14 B=64 (M = 16448 tokens, C = 160, F = 480, bf16) with the
tuple store and the grouped-column wide store (row 13b) at every CTA tile
that ``csrc/lin_d8_probe.cu`` builds (``ops.lin_d8_tiled``, K-lin-d8's
mma.sync core), in turns with that core's 64 x 32 instantiation
(``ops.lin_d8_sync``, what the model paths ran before the TMA + wgmma
redesign) and with the redesigned K-lin-d8 (``ops.linear_d8_fused`` and
``ops.linear_d8_qkv_wide``). Each tile is first held bitwise equal to the
64 x 32 core's output: the tile changes no summation order (the redesign
sums in another order, and is held to the forward bar instead). The TPU
script sweeps the token tile tm = 128 ... 1024 of a row block with every
channel; an H100 tile has a token side BM and a channel side BN. Run on the
card from the repository root:

    python3 -m octic_vits_tpu_torch.probes.profile_lin_tiles
"""

from __future__ import annotations

import torch

B, H, N, C = 64, 16, 257, 1280
C8 = C // 8
F = 3 * C8
M = B * N


def lin_inputs(cs, gen, m: int = M, c8: int = C8):
    """x1 [4, M, C8], xef [M, 4 C8], w1 [4, C8, 3 C8], we [2 C8, 6 C8] at the
    script's scales (0.2 and 0.05)."""
    f = 3 * c8
    return (cs.randn(gen, 4, m, c8, scale=0.2), cs.randn(gen, m, 4 * c8, scale=0.2),
            cs.randn(gen, 4, c8, f, scale=0.05), cs.randn(gen, 2 * c8, 2 * f, scale=0.05))


def shipped(store: str, x1, xef, w1, we, heads: int = H):
    """The mma.sync core at 64 x 32 (``ops.lin_d8_sync``) in
    ``ops.lin_d8_tiled``'s layout: the wide qkv [M, 8F], or the tuple store
    as (y1 [4, M, F], yef [M, 4F])."""
    from octic_vits_tpu_torch import ops

    xs = tuple(x1) + (xef,)
    if store == "wide":
        return ops.lin_d8_sync(xs, w1, we, None, num_heads=heads)
    y = ops.lin_d8_sync(xs, w1, we, None)
    return torch.stack(y[:4]), y[4]


def main() -> int:
    from octic_vits_tpu_torch import ops
    from octic_vits_tpu_torch.ops.linear_probe import STORES, TILES
    from octic_vits_tpu_torch.probes import card_or_exit, check, report
    from octic_vits_tpu_torch.tools.timing import in_turns

    cs, card = card_or_exit("profile_lin_tiles")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    xs = lin_inputs(cs, gen)
    x1, xef, w1, we = xs
    # the 64 x 32 core's launches alone (shipped() stacks the tuple store),
    # and the redesigned K-lin-d8's
    xs5 = tuple(x1) + (xef,)
    names = {"tuple": "tuple store, mma.sync core 64x32",
             "wide": "WIDE store, mma.sync core 64x32 (13b)"}
    cases = {names["tuple"]: lambda: ops.lin_d8_sync(xs5, w1, we, None),
             names["wide"]: lambda: ops.lin_d8_sync(xs5, w1, we, None, num_heads=H),
             "tuple store, K-lin-d8 TMA + wgmma": lambda: ops.linear_d8_fused(xs5, w1, we, None),
             "WIDE store, K-lin-d8 TMA + wgmma": lambda: ops.linear_d8_qkv_wide(x1, xef, w1, we,
                                                                                None, H)}
    with torch.no_grad():
        for store in STORES:
            want = shipped(store, *xs)
            for bm, bn in TILES:
                kw = dict(bm=bm, bn=bn, store=store, num_heads=H)
                got = ops.lin_d8_tiled(*xs, **kw)
                same = all(torch.equal(g, w) for g, w in zip(cs.flat(got), cs.flat(want)))
                print(f"check {store} {bm}x{bn} bitwise equal to the 64x32 core: {same}",
                      flush=True)
                if not same:
                    raise AssertionError(f"{store} {bm}x{bn}: not the 64x32 core's bits")
                check(cs, f"{store} {bm}x{bn}", got, ops.lin_d8_tiled.reference(*xs, **kw))
                cases[f"{store} store  {bm}x{bn}"] = (
                    lambda kw=kw: ops.lin_d8_tiled(*xs, **kw))
        res = in_turns(cases)
    bound = cs.bound("linear_d8_qkv_wide", (B, N, C, H, False))
    bounds = {k: bound for k in cases}
    m = res["median"]
    split = {}
    for store in STORES:
        for bm, bn in TILES:
            split[f"{store} {bm}x{bn} - core 64x32"] = (m[f"{store} store  {bm}x{bn}"]
                                                        - m[names[store]])
    report(card, res, bounds, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
