"""The numbers that decide ``correct``, each held against its limit.

Training: the gap of each of the first steps' losses (``loss_gap``, the
worst of them; ``loss1_gap``, the first step's alone); of the first
gradient's norm, leaf by leaf; of the parameters' change after the first
steps, leaf by leaf. A leaf's gap is ``|program's norm - reference's
norm|`` over the larger of the reference's norm of that leaf and of the
median leaf. Leaves whose first reference gradient is under a thousandth
of the median leaf's (a key's bias under softmax: nought but for rounding)
move under Adam by round-off alone and are left out of the change.

Serving: a sample of the window's answers against the reference's
outputs of the same inputs: the widest ``|served - reference|`` in units
of the label range.

A cell compares the numbers its workload file gives limits; the others
are printed beside them, not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, Sequence

import numpy as np

QUIET_LEAF = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str]) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def leaf_detail(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str]) -> dict:
    """The worst leaf of a leaf gap and the median leaf's gap (for the look
    behind a reading; not compared)."""
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return {"worst": worst, "prog": prog[worst], "ref": ref[worst], "median_ref": med,
            "median_gap": statistics.median(gaps.values())}


def train_detail(prog: dict, ref: dict) -> dict:
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in names)
    moving = [n for n in names if ref["grad1"][n] >= QUIET_LEAF * med]
    return {"losses_prog": prog["losses"], "losses_ref": ref["losses"],
            "grad_norm_ref": ref.get("grad_norm"), "quiet_leaves": sorted(set(names) - set(moving)),
            "grad1": leaf_detail(prog["grad1"], ref["grad1"], names),
            "change3": leaf_detail(prog["change"], ref["change"], moving)}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (first steps), ``grad1`` and
    ``change`` (name -> norm)."""
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in names)
    moving = [n for n in names if ref["grad1"][n] >= QUIET_LEAF * med]
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not gaps:
        gaps = [float("inf")]
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad1_gap": leaf_gap(prog["grad1"], ref["grad1"], names),
            "change3_gap": leaf_gap(prog["change"], ref["change"], moving)}


def regression_gap(served: np.ndarray, ref: np.ndarray, lo: float, hi: float) -> float:
    return float(np.max(np.abs(served.reshape(-1) - ref.reshape(-1))) / (hi - lo))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each limited number beside its limit; a number that is missing or
    not finite fails."""
    out = {}
    for name, limit in limits.items():
        value = float(numbers.get(name, float("inf")))
        out[name] = {"value": value, "limit": limit,
                     "ok": bool(np.isfinite(value) and value <= limit)}
    return out
