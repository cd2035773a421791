"""Bixby-style crash basis (counterpart of ``lp_gnn_tpu/solver/crash.py``).

The reference evaluates a crash-basis warm-start baseline (``highs-ca-bas``,
run_solver.py:56) from precomputed ``highs-ca-init-bas-m1/*.bas`` files that
do not ship with the snapshot; this module regenerates that capability.

The heuristic follows Bixby (1992) in simplified form: prefer structural
variables that are "free-est" (wide bounds) and sparse/well-scaled; assign
each chosen variable to an uncovered row (its largest-|a_ij| uncovered row);
rows left uncovered keep their slack basic. The result is always a valid
basis: #basic == m and each basic structural displaces exactly one slack.
"""
from __future__ import annotations

import numpy as np

from ..io.mps import LPData
from ..io.bas import LL, BS, UL, FZ


def bixby_crash_basis(lp: LPData):
    """Return (col_status (n,), row_status (m,)) int arrays."""
    A = lp.A.tocsc()
    m, n = A.shape
    lb, ub, c = lp.lb, lp.ub, lp.c
    cmax = np.abs(c).max()
    if cmax == 0:
        cmax = 1.0

    # Bixby preference order: free > one-sided > boxed > fixed
    free = ~np.isfinite(lb) & ~np.isfinite(ub)
    one_sided = np.isfinite(lb) ^ np.isfinite(ub)
    boxed = np.isfinite(lb) & np.isfinite(ub) & (lb != ub)
    q = np.zeros(n)
    q[free] = 0.0
    q[one_sided] = 1.0
    q[boxed] = 2.0
    q[~(free | one_sided | boxed)] = 3.0   # fixed
    nnz_col = np.diff(A.indptr)
    # penalty: denser columns and costlier columns are less attractive
    score = q + 1e-3 * nnz_col + 1e-6 * np.abs(c) / cmax
    order = np.argsort(score, kind="stable")

    row_covered = np.zeros(m, dtype=bool)
    col_status = np.full(n, LL, dtype=np.int64)
    row_status = np.full(m, BS, dtype=np.int64)
    # nonbasic columns rest at their finite bound (lower preferred); a free
    # column that stays nonbasic has no bound to rest on -> FZ (HiGHS kZero)
    at_upper = ~np.isfinite(lb) & np.isfinite(ub)
    col_status[at_upper] = UL
    col_status[free] = FZ

    # row max |a_ij| for pivot-quality check
    Ar = lp.A.tocsr()
    row_absmax = np.zeros(m)
    for i in range(m):
        s, e = Ar.indptr[i], Ar.indptr[i + 1]
        if e > s:
            row_absmax[i] = np.abs(Ar.data[s:e]).max()

    for j in order:
        if q[j] >= 3.0:
            continue   # fixed variables never enter the crash basis
        s, e = A.indptr[j], A.indptr[j + 1]
        if e == s:
            continue
        rows_j = A.indices[s:e]
        vals_j = np.abs(A.data[s:e])
        cand = ~row_covered[rows_j]
        if not cand.any():
            continue
        k = np.argmax(np.where(cand, vals_j, -1.0))
        # pivot-stability guard: Bixby (1992) uses 0.99 of the row max; the
        # relaxed 0.01 factor deliberately admits more structural columns —
        # on the LP families here the 0.99 guard leaves most rows slack-
        # covered, collapsing the crash basis toward all-slack
        i = rows_j[k]
        if vals_j[k] < 0.01 * row_absmax[i]:
            continue
        row_covered[i] = True
        col_status[j] = BS
        # displaced slack goes to a finite row bound (FZ for a free row —
        # there is no bound for it to rest on)
        if np.isfinite(lp.b_l[i]):
            row_status[i] = LL
        elif np.isfinite(lp.b_u[i]):
            row_status[i] = UL
        else:
            row_status[i] = FZ
    return col_status, row_status
