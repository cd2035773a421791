"""Solver-log parsing and the results table (counterpart of
``lp_gnn_tpu/reporting/extract.py``; roles of reference utils.py:571-660 and
scripts/extract_time.py).

The JAX package keeps the table as a pandas DataFrame in ``time.h5``. Here
it is plain Python, one dict a LP with the same column names
(``{method}/niter|time|repair_p|repair_p2|fact_time|impr_niter|impr_time``,
``acc``, ``prec``, ``recl``, ``cvg/*``, ``split``, ...), kept in
``{log_dir}/time.json`` and, where pandas imports, also in ``time.h5``
(``utils/serialize.py table_dump``). No pandas is needed to run it.

Error codes (reference utils.py:621-626): -1 optimal not found, -2 parse
failure, -3 missing file.
"""
from __future__ import annotations

import csv
import math
import os
import os.path as osp
import re

import numpy as np

from ..io.bas import read_bas_highs
from ..utils.misc import extract_fn
from ..utils.serialize import json_load, table_dump

SENTINELS = (-1, -2, -3)


def _read_lines(out: str) -> list[str]:
    if out.endswith(".log"):
        with open(out) as f:
            return f.read().split("\n")
    return out.split("\n")


def extract_time(out: str):
    """Parse (iterations, run_time) from a solver log
    (reference utils.py:621-660). Handles both log dialects the reference
    does: HiGHS-shaped ('Model status' / 'iterations' / 'run time' lines)
    and CPLEX-shaped ('Solution time =  T sec.  Iterations = N' lines,
    utils.py:641-645); the dialect is tracked from the banner."""
    lines = _read_lines(out)
    whose_log = "cplex"   # reference default until a banner says otherwise
    iters, tm = 0, None
    for line in lines:
        if "CPLEX" in line:
            whose_log = "cplex"
        if "HiGHS" in line:
            whose_log = "highs"
        if whose_log == "cplex" and line[:13] == "Solution time":
            parts = [x for x in line.split(" ") if x != ""]
            return int(parts[7]), float(parts[3])
        if "unable open file" in line:
            return -3, -3
        if whose_log != "highs":
            continue
        if "status" in line and "Model" in line:
            if "Optimal" not in line:
                return -1, -1
        if "iterations" in line:
            m = re.findall(r"\d+", line)
            if m:
                iters = int(m[0])
        if "run time" in line:
            m = re.findall(r"\d*\.\d*", line)
            if m:
                tm = float(m[0])
                return iters, tm
    return -2, -2


def basis_folder_for_log(log_folder: str) -> str:
    """Invert ``InferenceManager.get_log_folder`` (plus the ``-m{method}``
    suffix ``stage_warm_start`` appends for non-dual methods): the
    ``gnn-bas-{run}`` log folders map to ``pred-basis[-{run}]``; the
    all-slacks / sparsity decodes use one name for logs and bases."""
    name = re.sub(r"-m\d+$", "", log_folder)
    m = re.fullmatch(r"gnn-bas-(\d+)", name)
    if m:
        run = int(m.group(1))
        return "pred-basis" if run == 0 else f"pred-basis-{run}"
    return name


def extract_nrepair(out: str):
    """(num_basis, n_slack_basis_begin, n_add_slack) for a warm-start log
    (reference utils.py:571-597): n_add_slack from a 'Rank_deficiency N'
    line (written by a solver that repairs bases); the starting composition
    is read from the predicted-basis file matching the log's folder
    (``basis_folder_for_log``)."""
    lines = _read_lines(out)
    num_basis, n_slack_begin, n_add_slack = -1, -1, 0
    if out.endswith(".log"):
        folder = basis_folder_for_log(osp.basename(osp.dirname(out)))
        pred_basis = f"{osp.dirname(out)}/../../{folder}/{extract_fn(out)}.bas"
        if osp.exists(pred_basis):
            cs, _vs = read_bas_highs(pred_basis)
            num_basis = len(cs)
            n_slack_begin = int((cs == 1).sum())
    for line in lines:
        m = re.findall(r"Rank_deficiency (\d+)", line)
        if m:
            n_add_slack = int(m[0])
    return num_basis, n_slack_begin, n_add_slack


def extract_fact_time(out: str) -> float:
    """Factorization time from 'time elapsed for factorize: X'
    (reference utils.py:599-619)."""
    for line in _read_lines(out):
        m = re.findall(r"time elapsed for factorize: ([e\-\d\.]+)", line)
        if m:
            return float(m[0])
    return -1.0


def map_back_to_baseline(log_fdl_nm: str, solver_pref: str = "highs-") -> str:
    """Map a warm-start log folder to its cold baseline folder
    (reference scripts/extract_time.py:8-22, with the intended alternation
    and the all-slacks and sparsity-decode folders)."""
    name = log_fdl_nm.split("/")[0]
    is_warm = (name.startswith(("gnn-", "all-slacks-"))
               or "ca-bas" in name)
    if not is_warm:
        return ""
    for method in ("m2", "m4"):
        if name.endswith(f"-{method}"):
            return f"{solver_pref}no-bas-{method}"
    return f"{solver_pref}no-bas"


#: log/ subdirectories that are NOT solve methods and must not become
#: summary columns: the warm-gate calibration logs are measured on
#: TRAIN-split LPs (pipeline.calibrate_warm_gate).
NON_METHOD_LOG_DIRS = ("warm-gate-calib",)


def _num(v) -> float:
    """A cell as a float, NaN where it is missing or not a number
    (``pd.to_numeric(errors="coerce")``)."""
    if isinstance(v, bool) or v is None:
        return math.nan
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def columns(rows: list[dict]) -> list[str]:
    """The table's columns in order of first appearance."""
    return list(dict.fromkeys(k for r in rows for k in r))


def collect_results(log_dir: str, table: str, solver_prefix: str = "highs-",
                    mps_names=None) -> list[dict]:
    """Walk ``{log_dir}/log/*/*.log`` into the columns ``{method}/niter|time``
    plus repair/fact columns for gnn logs, then ``{method}/impr_*`` against
    the matched cold baseline (reference scripts/extract_time.py:47-92), and
    write the table back. A sentinel (< 0) warm value or a baseline <= 0
    gives no improvement (None: NaN in ``time.h5``), as the JAX package
    masks them."""
    rows = json_load(table)
    by_fn = {r["fn"]: r for r in rows}
    log_root = osp.join(log_dir, "log")
    methods = sorted(d for d in os.listdir(log_root)
                     if d not in NON_METHOD_LOG_DIRS) \
        if osp.isdir(log_root) else []
    names = mps_names if mps_names is not None else list(by_fn)
    for fn in names:
        row = by_fn.get(fn)
        if row is None:
            continue
        for method in methods:
            tgt = osp.join(log_root, method, f"{fn}.log")
            if not osp.exists(tgt):
                continue
            iters, tm = extract_time(tgt)
            row[f"{method}/niter"] = iters
            row[f"{method}/time"] = tm
            if "gnn" in method:
                num_basis, n_slack_begin, n_add = extract_nrepair(tgt)
                if num_basis > 0:
                    row[f"{method}/repair_p"] = n_add / num_basis
                    n_var_begin = num_basis - n_slack_begin
                    row[f"{method}/repair_p2"] = (
                        n_add / n_var_begin if n_var_begin else math.inf)
                row[f"{method}/fact_time"] = extract_fact_time(tgt)
    for colnm in columns(rows):
        bs_method = map_back_to_baseline(colnm, solver_prefix)
        if not bs_method or "/" not in colnm:
            continue
        method, impr = colnm.split("/")
        if impr not in ("time", "niter"):
            continue
        base_col = f"{bs_method}/{impr}"
        if not any(base_col in r for r in rows):
            continue
        for r in rows:
            cur, base = _num(r.get(colnm)), _num(r.get(base_col))
            if cur < 0:
                cur = math.nan
            if base <= 0:
                base = math.nan
            gain = -(cur - base) / base
            r[f"{method}/impr_{impr}"] = None if math.isnan(gain) else gain
    table_dump(rows, table)
    return rows


# ------------------------------------------------------------------ summary
def _mean_std(xs: list[float]) -> tuple[float, float]:
    """Mean and std (ddof=1) over the non-NaN values, NaN where there are
    too few (pandas' ``agg(["mean", "std"])``)."""
    xs = [x for x in xs if not math.isnan(x)]
    if not xs:
        return math.nan, math.nan
    mean = float(np.mean(xs))
    std = float(np.std(xs, ddof=1)) if len(xs) > 1 else math.nan
    return mean, std


def summarize(rows: list[dict]) -> dict:
    """Per-split mean/std over the metric columns (reference
    scripts/extract_time.py:82-91): ``{split: {column: (mean, std)}}``,
    splits sorted, sentinel values (-1/-2/-3) left out."""
    cols = [c for c in columns(rows)
            if c in ("acc", "prec", "recl") or "/niter" in c or "/time" in c
            or "/impr" in c]
    out: dict = {}
    for split in sorted({r["split"] for r in rows if r.get("split")}):
        part = [r for r in rows if r.get("split") == split]
        stats = {}
        for c in cols:
            vals = [_num(r.get(c)) for r in part]
            stats[c] = _mean_std([math.nan if v in SENTINELS else v
                                  for v in vals])
        out[split] = stats
    return out


def format_summary(summary: dict) -> str:
    """The summary as a text table: a row a metric, mean and std a split."""
    splits = list(summary)
    cols = list(dict.fromkeys(c for s in splits for c in summary[s]))
    width = max([len(c) for c in cols] + [6])
    head = f"{'':<{width}}" + "".join(f" {s + ' mean':>14} {s + ' std':>14}"
                                      for s in splits)
    lines = [head]
    for c in cols:
        cells = "".join(f" {summary[s][c][0]:>14.6g} {summary[s][c][1]:>14.6g}"
                        for s in splits)
        lines.append(f"{c:<{width}}" + cells)
    return "\n".join(lines)


# ------------------------------------------------------- LaTeX table helpers
def fmt_large_int(x: float) -> str:
    """29_900 -> '29.9K', 1_740_000 -> '1.7M' (reference utils.py:948-956)."""
    for cut, suffix in ((1e6, "M"), (1e3, "K")):
        if x >= cut:
            return f"{x / cut:.1f}{suffix}"
    return f"{x:.1f}"


def fmt_float(x: float) -> str:
    """>=0.05 -> one decimal; smaller -> exponent notation with the LaTeX
    'e-' escape (reference utils.py:957-964)."""
    if float(x) >= 0.05:
        return f"{x:.1f}"
    s = f"{x:.0e}".replace("-0", "-")
    return s.replace("e-", r"\text{e-}")


def _mean_pm_std(mean: float, std: float, fmt) -> str:
    out = f"${fmt(mean)}"
    if np.isfinite(std) and abs(std) > 1e-5:
        out += r"{\scriptscriptstyle \pm " + fmt(std) + "}"
    return out + "$"


def _proc_percent(mean: float, std: float) -> str:
    out = f"${mean * 100:.1f} "
    if np.isfinite(std) and abs(std * 100) > 1e-5:
        out += r"{\scriptscriptstyle \pm " + fmt_float(std * 100) + "}"
    return out + "$"


def proc(name: str, mean: float, std: float) -> str:
    """One (mean, std) of :func:`summarize` as a LaTeX cell, by the metric's
    name: percentages for acc/prec/recl/repair/impr, floats for inf/fact
    times, K/M-reduced ints for iteration counts (reference
    utils.py:917-971)."""
    if any(k in name for k in ("acc", "prec", "recl", "repair", "impr")):
        return _proc_percent(mean, std)
    if any(k in name for k in ("inf_time", "fact_time")):
        return _mean_pm_std(mean, std, fmt_float)
    return _mean_pm_std(mean, std, fmt_large_int)


def write_latex_csv(summary: dict, path: str) -> None:
    """``summary.tex.csv``: a row a metric, a formatted
    '$mean{\\pm std}$' cell a split (the JAX package's to_latex_table)."""
    splits = list(summary)
    cols = list(dict.fromkeys(c for s in splits for c in summary[s]))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", *splits])
        for c in cols:
            w.writerow([c, *(proc(c, *summary[s][c]) for s in splits)])
