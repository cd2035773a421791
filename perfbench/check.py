"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, number by number, each against its
limit in ``limits/<cell>.json``.

Both sides give a :class:`Record` of the same steps from the same weights,
graphs and order, the reference applying the dropout masks the program
applied (``masks``, which the program's side keeps):

- ``losses``: each step's loss;
- ``grad1``: each leaf's norm of the first gradient as the optimizer gets
  it (with the coupled weight decay), the program's worked out from
  Adam's state after one step (``exp_avg / (1 - beta1)``);
- ``change``: each leaf's norm of its change over the steps.

The readings (each a share):

- ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps;
  ``loss1_gap`` the first step's;
- ``grad_gap``: over the leaves, the largest ``|g_prog - g_ref| / max(g_ref,
  median g_ref)``, g a leaf's norm: the gap of two norms, not the norm of
  a difference; ``grad_median_gap`` the median leaf's gap;
- ``change_gap``, ``change_median_gap``: the same over the change's norms,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (round-off alone moves those under Adam);
- ``grad_diff_gap``, ``grad_diff_median_gap``: over the leaves, the
  largest and the median ``|g_prog - g_ref| / max(|g_ref|, median
  |g_ref|)``, the norm of the first gradients' difference (``grad1_vec``,
  each side's first gradient on the host). A gap of two norms moves with
  a rounding error only in second order or where the errors line up with
  the gradient; a norm of the difference moves with every error, so it
  separates a precision from the next where the gaps of norms do not.

A cell compares those its limits file gives a limit.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
READINGS = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap",
            "change_gap", "change_median_gap", "grad_diff_gap",
            "grad_diff_median_gap")
QUIET_LEAF = 1e-3   # a leaf's reference gradient under this share of the
                    # median leaf's: left out of change_gap


@dataclasses.dataclass
class Record:
    """What one side's first steps gave (module docstring)."""
    losses: list[float]
    grad1: dict[str, float]
    change: dict[str, float]
    masks: list = dataclasses.field(default_factory=list)
    grad1_vec: dict = dataclasses.field(default_factory=dict)


def _rel(a: float, b: float, scale: float) -> float:
    gap = abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)
    return gap if math.isfinite(a) else math.inf


def readings(prog: Record, ref: Record | None) -> dict[str, float]:
    """The numbers compared (module docstring); inf where the program
    gave a number that is not finite or a leaf the reference lacks, and
    where the reference could not follow it (``ref`` None: the masks the
    program applied do not fit the configuration's dropout)."""
    if ref is None or len(prog.losses) < len(ref.losses):
        return {k: math.inf for k in READINGS}
    steps = [_rel(p, r, abs(r)) for p, r in zip(prog.losses, ref.losses)]

    def gaps(prog_n, ref_n, names):
        if not names:
            return [0.0]
        med = float(np.median([ref_n[k] for k in names]))
        return [_rel(prog_n.get(k, math.inf), ref_n[k], max(ref_n[k], med))
                for k in names]

    names = sorted(ref.grad1)
    med_g = float(np.median([ref.grad1[k] for k in names]))
    moving = [k for k in names if ref.grad1[k] >= QUIET_LEAF * med_g]
    grad = gaps(prog.grad1, ref.grad1, names)
    change = gaps(prog.change, ref.change, moving)
    diff = [_rel(_diff_norm(prog.grad1_vec.get(k), ref.grad1_vec[k]), 0.0,
                 max(ref.grad1[k], med_g)) for k in names]
    return {"loss_gap": max(steps), "loss1_gap": steps[0],
            "grad_gap": max(grad), "grad_median_gap": _median(grad),
            "change_gap": max(change), "change_median_gap": _median(change),
            "grad_diff_gap": max(diff), "grad_diff_median_gap": _median(diff)}


def _diff_norm(a, b) -> float:
    """``|a - b|`` of two host tensors; inf where ``a`` is missing, of
    another shape or not finite."""
    if a is None or a.shape != b.shape:
        return math.inf
    return float((a.double() - b.double()).norm())


def _median(xs: list[float]) -> float:
    return math.inf if any(math.isinf(x) for x in xs) else \
        float(np.median(xs))


def limits(workload: str) -> dict[str, float]:
    """The cell's limits, ``limits/<workload>.json``'s ``limits``: a limit
    for each number the cell compares, any of :data:`READINGS`."""
    data = json.loads((LIMITS_DIR / f"{workload}.json").read_text())
    lim = {k: float(v) for k, v in data["limits"].items()}
    unknown = set(lim) - set(READINGS)
    if not lim or unknown:
        raise ValueError(f"limits/{workload}.json: limits of {READINGS}, "
                         f"not {sorted(unknown)}")
    return lim


def judge(read: dict[str, float], lim: dict[str, float]) -> tuple[bool, dict]:
    """Whether every number compared is within its limit, and those
    numbers with their limits, in the result line's form."""
    compared = {k: {"value": read[k], "limit": lim[k]} for k in lim}
    ok = all(math.isfinite(read[k]) and read[k] <= lim[k] for k in lim)
    return ok, compared
