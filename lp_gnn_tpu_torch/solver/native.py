"""The native C++ simplex engine through ctypes (counterpart of
``lp_gnn_tpu/solver/native.py``: the same functions, the same log text).

The engine (``solver/native/tpulp.cc``, the port's own copy of the JAX
package's source) provides what the reference's customized HiGHS fork
provided beyond stock HiGHS (SURVEY.md §2.2): rank-deficiency repair
counts during warm-start refactorization ('Rank_deficiency N' log line,
utils.py:593) and factorization timing ('time elapsed for factorize:',
utils.py:614), plus basis-in/basis-out and dual/primal strategy selection.

``build()`` compiles it with g++ into ``lp_gnn_tpu_torch/_build/``
(``solver/_cxx_build.py``); ``available()`` says whether that library is
there, which is how ``--engine auto`` chooses (``prep.solve_backend``).
This module imports no torch: the prep stages' solver processes load it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import logging
import os
import os.path as osp
import time

import numpy as np

from . import _cxx_build

_cdll = None
_lib = None


def build() -> str:
    """Build the library from the port's sources unless it is there;
    returns its path. A failed build raises (there is no fallback)."""
    return str(_cxx_build.build("libtpulp"))


def open_cdll():
    """Load the port's library once, shared by every ctypes front end of
    the engine (this module and ops/host_spmm.py). Returns None when the
    library is unbuilt or unloadable."""
    global _cdll
    if _cdll is None:
        path = _cxx_build.output_path("libtpulp")
        if path.exists():
            try:
                _cdll = ctypes.CDLL(str(path))
            except OSError:
                return None
    return _cdll


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is None:
        lib = open_cdll()
        if lib is None or not hasattr(lib, "tpulp_solve"):
            return None
        lib.tpulp_solve.restype = ctypes.c_int
        lib.tpulp_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong,       # m, n, nnz
            ctypes.POINTER(ctypes.c_int),                        # A indptr (csc)
            ctypes.POINTER(ctypes.c_int),                        # A indices
            ctypes.POINTER(ctypes.c_double),                     # A values
            ctypes.POINTER(ctypes.c_double),                     # c
            ctypes.POINTER(ctypes.c_double),                     # lb
            ctypes.POINTER(ctypes.c_double),                     # ub
            ctypes.POINTER(ctypes.c_double),                     # b_l
            ctypes.POINTER(ctypes.c_double),                     # b_u
            ctypes.c_int,                                        # method 1|4
            ctypes.POINTER(ctypes.c_int),                        # basis in/out col (n)
            ctypes.POINTER(ctypes.c_int),                        # basis in/out row (m)
            ctypes.c_int,                                        # have_basis_in
            ctypes.POINTER(ctypes.c_double),                     # x out (n)
            ctypes.POINTER(ctypes.c_longlong),                   # info out [niter, nrepair]
            ctypes.POINTER(ctypes.c_double),                     # dinfo out [obj, fact_time]
            ctypes.c_longlong,                                   # max_iter (0=auto)
        ]
        _lib = lib
    return _lib


@dataclasses.dataclass
class NativeResult:
    status: str
    niter: int
    run_time: float
    objective: float
    col_status: np.ndarray
    row_status: np.ndarray
    n_repair: int
    fact_time: float
    log: str
    basis_rejected: bool = False  # warm basis unreadable -> solve ran cold


_STATUS = {0: "Optimal", 1: "Infeasible", 2: "Unbounded", 3: "IterationLimit",
           4: "NumericalError"}


def solve_lp_native(lp, method: int = 1, basis_in=None,
                    max_iter: int = 0) -> NativeResult:
    """Solve with the native engine. ``max_iter`` 0 = automatic
    (200000 + 40*m in the C runtime)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native engine is not built: call "
                           "lp_gnn_tpu_torch.solver.native.build() first")
    A = lp.A.tocsc()
    m, n = lp.shape
    col_b = np.full(n, -1, dtype=np.int32)
    row_b = np.full(m, -1, dtype=np.int32)
    have_in = 0
    if basis_in is not None:
        col_b[:] = np.asarray(basis_in[0], dtype=np.int32)
        row_b[:] = np.asarray(basis_in[1], dtype=np.int32)
        have_in = 1
    x = np.zeros(n)
    info = np.zeros(2, dtype=np.int64)
    dinfo = np.zeros(2, dtype=np.float64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    indptr = A.indptr.astype(np.int32)
    indices = A.indices.astype(np.int32)
    data = A.data.astype(np.float64)
    c = np.ascontiguousarray(lp.c, dtype=np.float64)
    lb = np.ascontiguousarray(lp.lb, dtype=np.float64)
    ub = np.ascontiguousarray(lp.ub, dtype=np.float64)
    bl = np.ascontiguousarray(lp.b_l, dtype=np.float64)
    bu = np.ascontiguousarray(lp.b_u, dtype=np.float64)
    t0 = time.time()
    code = lib.tpulp_solve(
        m, n, A.nnz,
        p(indptr, ctypes.c_int), p(indices, ctypes.c_int), p(data, ctypes.c_double),
        p(c, ctypes.c_double), p(lb, ctypes.c_double), p(ub, ctypes.c_double),
        p(bl, ctypes.c_double), p(bu, ctypes.c_double),
        int(method), p(col_b, ctypes.c_int), p(row_b, ctypes.c_int), have_in,
        p(x, ctypes.c_double), p(info, ctypes.c_longlong),
        p(dinfo, ctypes.c_double), int(max_iter))
    dt = time.time() - t0
    status = _STATUS.get(code, "Unknown")
    log = _format_log(status, int(info[0]), dt, float(dinfo[0]),
                      int(info[1]), float(dinfo[1]))
    return NativeResult(status=status, niter=int(info[0]), run_time=dt,
                        objective=float(dinfo[0]) + lp.obj_const,
                        col_status=col_b.astype(np.int64),
                        row_status=row_b.astype(np.int64),
                        n_repair=int(info[1]), fact_time=float(dinfo[1]),
                        log=log)


def _format_log(status, niter, run_time, obj, n_repair, fact_time) -> str:
    """Log contract shared with the HiGHS bridge + the custom-fork-only
    lines the reference parsers expect (utils.py:571-660)."""
    return (
        "Running tpulp native simplex (HiGHS-compatible log)\n"
        f"Rank_deficiency {n_repair}\n"
        f"time elapsed for factorize: {fact_time:.6f}\n"
        f"Model   status      : {status}\n"
        f"Simplex   iterations: {niter}\n"
        f"Objective value     :  {obj:.10e}\n"
        f"HiGHS run time      :          {run_time:.2f}\n"
    )


def dump_lp_bin(lp, path: str) -> None:
    """Write the flat LP dump ``prof_main.cc`` reads (header m,n,nnz int64;
    CSC indptr/indices int32; data/c/lb/ub/bl/bu float64) so the solver can
    be profiled with perf/gprof outside the ctypes boundary
    (``_cxx_build.build("prof_main")`` builds the driver)."""
    A = lp.A.tocsc()
    m, n = lp.shape
    with open(path, "wb") as f:
        np.asarray([m, n, A.nnz], dtype=np.int64).tofile(f)
        A.indptr.astype(np.int32).tofile(f)
        A.indices.astype(np.int32).tofile(f)
        A.data.astype(np.float64).tofile(f)
        for arr, size in ((lp.c, n), (lp.lb, n), (lp.ub, n),
                          (lp.b_l, m), (lp.b_u, m)):
            a = np.ascontiguousarray(arr, dtype=np.float64)
            if a.shape != (size,):
                raise ValueError(f"LP vector of shape {a.shape}, expected "
                                 f"({size},)")
            a.tofile(f)


def solve_mps(mps_path: str, method: int = 1, basis_in_path: str | None = None,
              basis_out_path: str | None = None, log_path: str | None = None,
              random_seed: int = 0) -> NativeResult:
    """File-level solve with the same contract as highs_bridge.solve_mps.
    An unreadable basis, or one of the wrong size, is a rejected warm
    start: the solve runs cold, its log carries the sentinel status that
    parses to the reference's -1 (utils.py:621-626) and ``basis_rejected``
    is set. ``random_seed`` is accepted for the contract; the engine is
    deterministic."""
    from ..io.mps import read_mps
    from ..io.bas import read_bas_highs, write_bas_highs
    lp = read_mps(mps_path)
    basis_in, parse_failed = None, False
    if basis_in_path:
        try:
            row_in, col_in = read_bas_highs(basis_in_path)
            m, n = lp.shape
            if len(row_in) != m or len(col_in) != n:
                raise ValueError(f"basis sizes ({len(row_in)},{len(col_in)}) "
                                 f"!= LP ({m},{n})")
            basis_in = (col_in, row_in)
        except (OSError, ValueError, IndexError) as e:
            parse_failed = True
            logging.error("unreadable warm-start basis %s (%s); recorded as "
                          "failed", basis_in_path, e)
    res = solve_lp_native(lp, method=method, basis_in=basis_in)
    if parse_failed:
        res = dataclasses.replace(
            res, basis_rejected=True,
            log=_format_log("WarmBasisRejected (unreadable)", res.niter,
                            res.run_time, res.objective, res.n_repair,
                            res.fact_time))
    if basis_out_path:
        os.makedirs(osp.dirname(basis_out_path) or ".", exist_ok=True)
        write_bas_highs(basis_out_path, vbas=res.col_status, cbas=res.row_status)
    if log_path:
        os.makedirs(osp.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "w") as f:
            f.write(res.log)
    return res
