"""The numbers that decide ``correct``, each against its limit
(``portbench/limits/<workload>.json``).

Training: ``loss_gap``, the largest relative gap of a check step's loss;
``grad_gap``, the worst leaf's gap between the program's and the
reference's norm of the first gradient as AdamW takes it; ``change_gap``,
the worst leaf's gap between the two norms of the change after the check
steps; ``grad_gap_median`` and ``change_gap_median``, the median leaf's
(steady from seed to seed where one small leaf's noise moves the worst).
A cell compares the numbers its limits file names.  A leaf's gap is
measured against the reference's norm of that leaf or of the median
leaf, whichever is larger.  The masks (which AdamW
never updates) are left out of both; leaves whose first gradient in the
reference is under a thousandth of the median leaf's are left out of the
change (round-off alone moves them under Adam).

Prefill: ``token_gap``, the widest gap by which a served token's logit
(the greedy token of the program's last-position logits) lies below the
reference's best logit at that position.
"""

from __future__ import annotations

import math
import statistics

from portbench.reference.adamw import frozen

TINY_GRADIENT = 1e-3


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's gap between the two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``{name: value}`` from the program's and the reference's readings
    (``losses``, ``grads``, ``changes``)."""
    if len(prog["losses"]) != len(ref["losses"]):
        return dict.fromkeys(("loss_gap", "grad_gap", "grad_gap_median",
                              "change_gap", "change_gap_median"), math.inf)
    names = [n for n in ref["grads"] if not frozen(n)]
    g_med = statistics.median(ref["grads"][n] for n in names)
    moving = [n for n in names
              if ref["grads"][n] >= TINY_GRADIENT * g_med]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grads = leaf_gaps(prog["grads"], ref["grads"], names)
    changes = leaf_gaps(prog["changes"], ref["changes"], moving)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grads.values()),
            "grad_gap_median": statistics.median(grads.values()),
            "change_gap": max(changes.values()),
            "change_gap_median": statistics.median(changes.values())}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> list:
    """The ``n`` leaves of the largest first-gradient gaps, for a look."""
    names = [k for k in ref["grads"] if not frozen(k)]
    gaps = leaf_gaps(prog["grads"], ref["grads"], names)
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every
    number is finite and at most its limit."""
    compared = {k: {"value": values[k], "limit": limits[k]}
                for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
