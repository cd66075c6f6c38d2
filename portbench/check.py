"""How ``correct`` is decided: the program's first three steps against the
plain reference's.

Three numbers, each with its limit in ``portbench/limits/<config>.json``:

  - ``loss_gap``: the largest of the three steps' |loss - reference| /
    |reference|;
  - ``grad_gap``: over the leaves, the largest gap between the norm of the
    program's first gradient and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf;
  - ``update_gap``: the same for the norm of each leaf's change after the
    three steps. A leaf whose reference gradient is under a thousandth of
    the median leaf's moves by round-off alone under Adam and is left out.
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "update_gap")
FLAT_FRACTION = 1e-3  # a leaf's gradient under this share of the median leaf's is flat


def _gaps(prog: dict, ref: dict, keys: list) -> dict:
    """{leaf: |program norm - reference norm| / max(its reference norm, the
    median leaf's)} over ``keys``."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def _leaf_gaps(prog: dict, ref: dict) -> dict:
    """grad_gap's and update_gap's gaps a leaf; the change leaves out the
    leaves whose reference gradient is flat."""
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    moving = [k for k, g in grads.items() if g >= FLAT_FRACTION * med]
    return {"grad_gap": _gaps(prog["grad_norms"], grads, list(grads)),
            "update_gap": _gaps(prog["changes"], ref["changes"], moving)}


def compare(prog: dict, ref: dict) -> dict:
    """``prog``, ``ref``: {"losses", "grad_norms", "changes"} -> the three numbers."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"], strict=True))
    return {"loss_gap": loss, **{n: max(g.values(), default=math.nan)
                                 for n, g in _leaf_gaps(prog, ref).items()}}


def judge(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[n]) and numbers[n] <= limits[n] for n in NUMBERS)


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf that sets ``grad_gap`` and the one that sets ``update_gap``,
    with both sides' norms (for the readings the limits are set from)."""
    out = {}
    for (number, gaps), key in zip(_leaf_gaps(prog, ref).items(), ("grad_norms", "changes")):
        leaf = max(gaps, key=gaps.get)
        out[number] = {"leaf": leaf, "gap": gaps[leaf], "program": prog[key][leaf],
                       "reference": ref[key][leaf]}
    return out
