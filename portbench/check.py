"""The output check: the program's first training steps against the
reference's, at the timed sizes.

The numbers; a cell compares those its ``cells/<cell>.json`` gives a
limit, each against it:

  * ``loss_gap``: the largest of the steps' |loss - reference loss| /
    |reference loss|; ``first_loss_gap``: the first step's alone;
  * ``grad_gap``: over the leaves, the largest |norm of the program's first
    gradient - the reference's| / max(the reference's, the median leaf's);
  * ``change_gap``: the same of each leaf's change over the steps, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (a leaf with no gradient moves under Adam by round-off);
  * ``change_median_gap``: the median leaf's gap of the change, for a
    model whose worst leaf swings from seed to seed;
  * ``grad_weights_median_gap``: the median gap of the first gradient over
    the weights that products read (the leaves of two or more dimensions),
    leaving out the normalisations' scales and biases, whose gradients are
    sums that cancel and carry rounding far up.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Tuple

import torch

NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "change_gap",
           "change_median_gap", "grad_weights_median_gap")


def leaf_norms(pairs: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, float]:
    """``{name: float64 norm}``, one leaf at a time, read back in one copy."""
    names, norms = [], []
    for name, t in pairs:
        names.append(name)
        norms.append(t.double().norm())
    return dict(zip(names, torch.stack(norms).tolist()))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep):
    floor = statistics.median(ref[n] for n in keep)
    return [abs(prog[n] - ref[n]) / max(ref[n], floor) for n in keep]


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    leaves = list(ref["grad"])
    small = 1e-3 * statistics.median(ref["grad"].values())
    moved = [n for n in leaves if ref["grad"][n] >= small]
    grad = _leaf_gaps(prog["grad"], ref["grad"], leaves)
    weights = dict(zip(leaves, grad))
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": max(loss), "first_loss_gap": loss[0],
            "grad_gap": max(grad), "change_gap": max(change),
            "change_median_gap": statistics.median(change),
            "grad_weights_median_gap": statistics.median(
                weights[n] for n in ref["weights"])}


def compare(prog: dict, ref: dict, limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers that ``limits`` names, in its order, beside their limits."""
    found = gaps(prog, ref)
    return {name: {"value": found[name], "limit": limit}
            for name, limit in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
