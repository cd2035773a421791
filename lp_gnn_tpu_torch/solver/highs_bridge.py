"""HiGHS through scipy's vendored highspy bindings (counterpart of
``lp_gnn_tpu/solver/highs_bridge.py``: the same options, the same log text).

Replicates the capabilities of the reference's *customized HiGHS fork CLI*
(scripts/run_solver.py:30, run_solver_from_basis.py:27): basis-out (-bo),
basis-in (-bi), simplex strategy selection (-ss 1=dual / 4=primal), presolve
off, fixed random seed — exposed as Python functions instead of a subprocess.
Logs are written in the HiGHS format the reference's parsers expect
(utils.py:621-660).

scipy >= 1.15 vendors the complete highspy ``_core`` module, which this
bridge uses. ``HAVE_HIGHS`` says whether it imports (a solve without it
raises) and ``HIGHS_VERSION`` which HiGHS it is. The log's banner names
that version; the JAX package's always says 1.8.0 (scipy 1.15-1.17's).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np

from ..io.mps import LPData, read_mps
from ..io.bas import read_bas_highs, write_bas_highs

try:
    from scipy.optimize._highspy import _core as _hs
    HAVE_HIGHS = True
    HIGHS_VERSION = (f"{_hs.HIGHS_VERSION_MAJOR}.{_hs.HIGHS_VERSION_MINOR}."
                     f"{_hs.HIGHS_VERSION_PATCH}")
except ImportError:  # pragma: no cover
    _hs = None
    HAVE_HIGHS = False
    HIGHS_VERSION = None


@dataclasses.dataclass
class SolveResult:
    status: str                 # "Optimal" | "Infeasible" | ...
    niter: int
    run_time: float
    objective: float
    col_status: np.ndarray      # (n,) int 0/1/2 (3->kZero mapped to 0)
    row_status: np.ndarray      # (m,) int
    log: str
    basis_rejected: bool = False  # warm basis refused -> solve ran cold
    # only with solve_lp(want_solution=True), for the degeneracy probe
    # (lp_gnn_tpu_torch/degeneracy_probe.py)
    col_value: np.ndarray | None = None
    col_dual: np.ndarray | None = None   # reduced costs


def _lp_to_highs(lp: LPData):
    h = _hs.HighsLp()
    m, n = lp.shape
    h.num_col_ = n
    h.num_row_ = m
    h.col_cost_ = np.asarray(lp.c, dtype=np.float64)
    h.col_lower_ = np.asarray(lp.lb, dtype=np.float64)
    h.col_upper_ = np.asarray(lp.ub, dtype=np.float64)
    h.row_lower_ = np.asarray(lp.b_l, dtype=np.float64)
    h.row_upper_ = np.asarray(lp.b_u, dtype=np.float64)
    A = lp.A.tocsc()
    h.a_matrix_.format_ = _hs.MatrixFormat.kColwise
    h.a_matrix_.start_ = A.indptr.astype(np.int32)
    h.a_matrix_.index_ = A.indices.astype(np.int32)
    h.a_matrix_.value_ = A.data.astype(np.float64)
    h.offset_ = lp.obj_const
    return h


def _statuses_to_ints(stats) -> np.ndarray:
    # HighsBasisStatus: kLower=0 kBasic=1 kUpper=2 kZero=3 kNonbasic=4
    out = np.array([int(s) for s in stats], dtype=np.int64)
    out[out >= 3] = 0
    return out


def solve_lp(lp: LPData, method: int = 1, basis_in=None,
             random_seed: int = 0,
             want_solution: bool = False) -> SolveResult:
    """Solve an LP with simplex, presolve off (reference run_solver.py:30).

    method: 1 = dual simplex, 4 = primal simplex (the fork's -ss flag).
    basis_in: optional (col_status, row_status) int arrays for warm start.
    want_solution: also return the primal values and reduced costs.
    """
    if not HAVE_HIGHS:
        raise RuntimeError("scipy.optimize._highspy._core does not import: "
                           "the HiGHS engine is unavailable")
    h = _hs._Highs()
    h.setOptionValue("output_flag", False)
    h.setOptionValue("presolve", "off")
    h.setOptionValue("solver", "simplex")
    h.setOptionValue("random_seed", random_seed)
    h.setOptionValue("simplex_strategy", int(method))
    h.passModel(_lp_to_highs(lp))
    rejected = False
    if basis_in is not None:
        col_in, row_in = basis_in
        b = _hs.HighsBasis()
        b.col_status = [_hs.HighsBasisStatus(int(s)) for s in col_in]
        b.row_status = [_hs.HighsBasisStatus(int(s)) for s in row_in]
        b.valid = True
        st = h.setBasis(b)
        if st != _hs.HighsStatus.kOk:
            # a rejected basis means HiGHS solves COLD — recording that as
            # a warm-start result would corrupt the iteration-reduction
            # metric, so mark the run as failed (the log sentinel parses to
            # the reference's -1 error code, utils.py:621-626, and the impr
            # columns mask it out)
            rejected = True
            logging.error("HiGHS rejected the warm-start basis (%s); the "
                          "solve runs cold and is recorded as failed", st)
    t0 = time.time()
    h.run()
    dt = time.time() - t0
    info = h.getInfo()
    status = h.modelStatusToString(h.getModelStatus())
    basis = h.getBasis()
    col_status = _statuses_to_ints(basis.col_status)
    row_status = _statuses_to_ints(basis.row_status)
    col_value = col_dual = None
    if want_solution:
        sol = h.getSolution()
        col_value = np.asarray(sol.col_value, dtype=np.float64)
        col_dual = np.asarray(sol.col_dual, dtype=np.float64)
    log_status = "WarmBasisRejected (ran cold)" if rejected else status
    log = _format_log(log_status, info.simplex_iteration_count, dt,
                      info.objective_function_value)
    return SolveResult(status=status, niter=int(info.simplex_iteration_count),
                       run_time=dt, objective=float(info.objective_function_value),
                       col_status=col_status, row_status=row_status, log=log,
                       basis_rejected=rejected, col_value=col_value,
                       col_dual=col_dual)


def _format_log(status: str, niter: int, run_time: float, obj: float) -> str:
    """HiGHS-style log text compatible with the reference parsers
    (utils.py:621-660: 'HiGHS' banner, 'Model status' line with 'Optimal',
    'iterations' line with the count as first integer, 'run time' line with a
    float)."""
    return (
        f"Running HiGHS {HIGHS_VERSION} (vendored): framework solver bridge\n"
        f"Model   status      : {status}\n"
        f"Simplex   iterations: {niter}\n"
        f"Objective value     :  {obj:.10e}\n"
        f"HiGHS run time      :          {run_time:.2f}\n"
    )


def solve_mps(mps_path: str, method: int = 1, basis_in_path: str | None = None,
              basis_out_path: str | None = None, log_path: str | None = None,
              random_seed: int = 0) -> SolveResult:
    """File-level solve matching the fork CLI contract:
    ``highs --model_file MPS --presolve off --solver simplex --random_seed 0
    [-bi IN.bas] [-bo OUT.bas] -ss METHOD`` (run_solver.py:30,
    run_solver_from_basis.py:27)."""
    lp = read_mps(mps_path)
    basis_in, parse_failed = None, False
    if basis_in_path:
        try:
            row_in, col_in = read_bas_highs(basis_in_path)
            basis_in = (col_in, row_in)
        except (OSError, ValueError) as e:   # unreadable == rejected
            parse_failed = True
            logging.error("unreadable warm-start basis %s (%s); recorded as "
                          "failed", basis_in_path, e)
    res = solve_lp(lp, method=method, basis_in=basis_in, random_seed=random_seed)
    if parse_failed:
        res = dataclasses.replace(
            res, basis_rejected=True,
            log=_format_log("WarmBasisRejected (unreadable)", res.niter,
                            res.run_time, res.objective))
    if basis_out_path:
        os.makedirs(os.path.dirname(basis_out_path) or ".", exist_ok=True)
        write_bas_highs(basis_out_path, vbas=res.col_status, cbas=res.row_status)
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "w") as f:
            f.write(res.log)
    return res
