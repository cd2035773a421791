"""Measure the dual and primal degeneracy of a dataset's LPs directly (the
twin of ``scripts/degeneracy_probe.py``).

Many optimal bases make an imperfect basis prediction land near an optimal
face anyway; this probe makes degeneracy a measured quantity, LP by LP:

- ``zero_rc_frac``: fraction of NONBASIC structural columns (not fixed)
  whose reduced cost is ~0 at the optimum — each is an alternative
  entering column at equal objective, another optimal basis one pivot
  away (the textbook dual-degeneracy count).
- ``degen_basic_frac``: fraction of BASIC structurals sitting at a bound
  (primal degeneracy).
- ``seed_disagree_frac``: fraction of column statuses that differ between
  two HiGHS runs with different ``random_seed`` at equal objective (NaN
  where the objectives differ) — "many optimal bases" observed.

    python -m lp_gnn_tpu_torch.degeneracy_probe --dataset mirp_bench --n 8

One JSON line an LP, then one summary line; ``main`` returns both.
"""
from __future__ import annotations

import argparse
import glob
import json
import os.path as osp

import numpy as np

from .io.mps import read_mps
from .solver.highs_bridge import solve_lp

RC_TOL = 1e-7
X_TOL = 1e-8


def probe_lp(lp) -> dict:
    r0 = solve_lp(lp, method=1, random_seed=0, want_solution=True)
    if r0.status != "Optimal":
        return {"status": r0.status}
    nonbasic = r0.col_status != 1
    zero_rc = nonbasic & (np.abs(r0.col_dual) < RC_TOL)
    # fixed columns (lb == ub) are left out: their reduced cost means nothing
    free_nb = nonbasic & (lp.ub - lp.lb > X_TOL)
    basic = r0.col_status == 1
    at_bound = (np.abs(r0.col_value - lp.lb) < X_TOL) | \
               (np.abs(r0.col_value - lp.ub) < X_TOL)
    r1 = solve_lp(lp, method=1, random_seed=7, want_solution=False)
    same_obj = (r1.status == "Optimal" and
                abs(r1.objective - r0.objective) <=
                1e-7 * max(1.0, abs(r0.objective)))
    dis = np.mean(r0.col_status != r1.col_status) if same_obj else np.nan
    return {
        "status": "Optimal",
        "niter": int(r0.niter),
        "zero_rc_frac": float(zero_rc[free_nb].mean()) if free_nb.any() else 0.0,
        "degen_basic_frac": float(at_bound[basic].mean()) if basic.any() else 0.0,
        "seed_disagree_frac": float(dis),
        "seed_obj_equal": bool(same_obj),
    }


def main(argv=None) -> tuple[list[dict], dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", type=str, required=True)
    ap.add_argument("--data_prefix", type=str, default="lp-dataset")
    ap.add_argument("--n", type=int, default=8,
                    help="probe the first n instances")
    args = ap.parse_args(argv)
    fns = sorted(glob.glob(f"{args.data_prefix}/{args.dataset}/mps/*.mps*"),
                 key=lambda nm: (len(nm), nm))[: args.n]
    if not fns:
        raise SystemExit(f"no mps under {args.data_prefix}/{args.dataset}/mps")
    rows = []
    for fn in fns:
        cell = {"fn": osp.basename(fn), **probe_lp(read_mps(fn))}
        rows.append(cell)
        print(json.dumps(cell), flush=True)
    ok = [r for r in rows if r.get("status") == "Optimal"]
    summ = {"dataset": args.dataset, "n": len(ok)}
    for k in ("niter", "zero_rc_frac", "degen_basic_frac",
              "seed_disagree_frac"):
        vals = [r[k] for r in ok if np.isfinite(r.get(k, np.nan))]
        if vals:
            summ[k + "_mean"] = round(float(np.mean(vals)), 4)
            summ[k + "_std"] = round(float(np.std(vals)), 4)
    print(json.dumps(summ))
    return rows, summ


if __name__ == "__main__":
    main()
