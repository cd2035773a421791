"""Cold/warm iteration table for both solver engines on one experiment (the
twin of ``scripts/engine_table.py``).

For every val-split LP of the experiment's results table, solve cold and
warm-started from the experiment's predicted basis with the HiGHS bridge
AND the native C++ engine (where its library is built: any
``--engine native`` run builds it), and print a line an LP and engine and
one JSON line with the script's keys. The pipeline's own stages write one
engine's logs at a time; this measures both side by side on the same
instances and bases. The results table is the port's ``time.json`` (the
script reads ``time.h5``).

    python -m lp_gnn_tpu_torch.engine_table --dataset mirp_bench \\
        --exp_nm <exp> [--lp_method 4]

A failed solve (not Optimal, or the -1 sentinel) stays out of the means
and counts in ``failed``. ``main`` also returns each solve's status,
iterations and objective under ``lps``.
"""
from __future__ import annotations

import json
import os.path as osp
import time

import numpy as np

from .config import parse_args
from .pipeline import TABLE
from .solver import native as native_solver
from .solver.highs_bridge import solve_mps as highs_solve
from .utils.serialize import json_load


def main(argv=None) -> dict:
    cfg = parse_args(argv, make_log_dir=False)
    method = cfg.normalized_lp_method()
    rows_in = json_load(osp.join(cfg.log_prefix, cfg.exp_nm, TABLE))
    fns = [r["fn"] for r in rows_in if r.get("split") == "val"]
    engines = {"highs": highs_solve}
    if native_solver.available():
        engines["native"] = native_solver.solve_mps
    rows, lps = {}, {}
    for eng, solve in engines.items():
        cold, warm, tc, tw, failed = [], [], [], [], 0
        lps[eng] = []
        for nm in fns:
            mps = f"{cfg.dataset_prefix}/mps/{nm}.mps"
            if not osp.exists(mps):
                mps += ".gz"
            bas = osp.join(cfg.log_prefix, cfg.exp_nm, "pred-basis",
                           f"{nm}.bas")
            t0 = time.time()
            rc = solve(mps, method=method)
            t_c = time.time() - t0
            t0 = time.time()
            rw = solve(mps, method=method, basis_in_path=bas)
            t_w = time.time() - t0
            ok = (rc.status == rw.status == "Optimal"
                  and rc.niter >= 0 and rw.niter >= 0)
            print(f"{eng:7s} {nm}: cold {rc.niter:6d} warm {rw.niter:6d} "
                  f"{'' if ok else 'STATUS ' + rc.status + '/' + rw.status}",
                  flush=True)
            lps[eng].append({"fn": nm, "ok": ok,
                             "cold_status": rc.status, "warm_status": rw.status,
                             "cold_niter": rc.niter, "warm_niter": rw.niter,
                             "cold_obj": rc.objective,
                             "warm_obj": rw.objective,
                             "cold_s": t_c, "warm_s": t_w})
            if not ok:
                # a failed solve must not enter the means: it would
                # deflate the iterations and inflate impr
                failed += 1
                continue
            cold.append(rc.niter)
            warm.append(rw.niter)
            tc.append(t_c)
            tw.append(t_w)
        if not cold:
            rows[eng] = {"n": 0, "failed": failed}
            continue
        c, w = np.mean(cold), np.mean(warm)
        rows[eng] = {"cold_niter": round(float(c), 1),
                     "warm_niter": round(float(w), 1),
                     "impr": round(float((c - w) / c), 4),
                     "cold_s_per_lp": round(float(np.mean(tc)), 3),
                     "warm_s_per_lp": round(float(np.mean(tw)), 3),
                     "n": len(cold), "failed": failed}
    out = {"dataset": cfg.dataset, "exp": cfg.exp_nm, "method": method,
           "engines": rows}
    print(json.dumps(out))
    return {**out, "lps": lps}


if __name__ == "__main__":
    main()
