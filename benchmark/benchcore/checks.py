"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``limits/<workload>.json``, each set from the program's
readings over a dozen seeds and the control's; PERF.md gives both).

Training (the first three steps, which set-up drives through the
window's own call):

* ``loss``: the widest gap of a step's loss, |program − reference| over
  |reference|;
* ``grad``: the worst leaf's gap of the first gradient's norm (the
  program's as Adam got it), over the larger of the reference leaf's
  norm and the median leaf's;
* ``change``: the same of each leaf's change after the three steps
  (weights and BN running statistics).

A trained leaf whose reference gradient is under a thousandth of the
median leaf's (a conv bias that a BatchNorm follows: its gradient is
nought but for rounding) is left out of both: its gradient is each
side's round-off, and Adam moves it by round-off alone.

Serving: ``output``, the worst sampled request's max |Z − Z_ref| over
max |Z_ref|.
"""

from __future__ import annotations

import math
import statistics

__all__ = ["NEGLIGIBLE", "train_numbers", "compared_leaves", "serve_gap",
           "judge"]

NEGLIGIBLE = 1e-3


def _worst_gap(prog: dict, ref: dict, names) -> float:
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def compared_leaves(ref: dict) -> tuple:
    """``(trained, changed)``: the trained leaves whose reference gradient
    reaches a thousandth of the median leaf's, and those with every BN
    running statistic."""
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    trained = [k for k, g in grads.items() if g >= NEGLIGIBLE * med]
    return trained, [k for k in ref["change_norms"]
                     if k not in grads or k in trained]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (one a step), ``grad_norms`` and
    ``change_norms`` (one a leaf)."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]) \
            or set(prog["change_norms"]) != set(ref["change_norms"]):
        raise KeyError("the program's leaves are not the reference's")
    loss = (max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                     ref["losses"]))
            if len(prog["losses"]) == len(ref["losses"]) else math.inf)
    trained, changed = compared_leaves(ref)
    return {"loss": loss,
            "grad": _worst_gap(prog["grad_norms"], ref["grad_norms"], trained),
            "change": _worst_gap(prog["change_norms"], ref["change_norms"],
                                 changed)}


def serve_gap(Z, Z_ref) -> float:
    """max |Z − Z_ref| over max |Z_ref| of one request."""
    Z, Z_ref = Z.double().to(Z_ref.device), Z_ref.double()
    return float((Z - Z_ref).abs().max() / Z_ref.abs().max())


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, rows)``: each limit beside its number; correct when
    every limit has a finite number within it.  A limit with no number
    reads inf, and a number with no limit makes the run not correct."""
    rows = {}
    ok = set(numbers) <= set(limits)
    for name, entry in limits.items():
        value = float(numbers.get(name, math.inf))
        limit = float(entry["limit"])
        rows[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    for name in sorted(set(numbers) - set(limits)):
        rows[name] = {"value": float(numbers[name]), "limit": None}
    return ok, rows
