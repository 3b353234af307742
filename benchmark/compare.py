"""The numbers of a train cell: each step's loss, each parameter's gradient
as the optimizer got it at the first step, each parameter's change after the
last step (and the EMA's, or the EMA teacher's, where the step keeps one).
A leaf's gap is the gap between the two sides' norms, not the norm of their
difference, over the larger of the reference's norm of that leaf and of the
median leaf, since some gradients are all but nought."""

from __future__ import annotations

import statistics

# leaves whose reference gradient lies under this share of the median leaf's
# move by round-off alone (as a key's bias under the softmax) and are left out
# of the change gaps
GRAD_FLOOR = 1e-3


def leaf_gap(got: dict, ref: dict, names) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def train_gaps(prog: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = list(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in names)
    moving = [n for n in names if ref["grad"][n] >= GRAD_FLOOR * med]
    out = {"loss_gap": loss, "grad_gap": leaf_gap(prog["grad"], ref["grad"], names),
           "change_gap": leaf_gap(prog["change"], ref["change"], moving)}
    for key, name in (("teacher_change", "teacher_gap"), ("ema_change", "ema_gap")):
        if key in ref:
            # a program that keeps no such state moved nothing
            got = prog.get(key, dict.fromkeys(ref[key], 0.0))
            out[name] = leaf_gap(got, ref[key], moving)
    return out


def worst_leaves(got: dict, ref: dict, top: int = 3) -> list:
    """The leaves of the largest gaps, [name, gap, reference norm], for a look
    at where a gap comes from."""
    med = statistics.median(ref.values())
    gaps = sorted(((abs(got[n] - ref[n]) / max(ref[n], med, 1e-30), n) for n in ref),
                  reverse=True)
    return [[n, g, ref[n]] for g, n in gaps[:top]]
