"""Basis (.bas) files, HiGHS and CPLEX formats (counterpart of
``lp_gnn_tpu/io/bas.py``).

Status encoding is the 3-class label: 0 = LL (nonbasic at lower bound),
1 = BS (basic), 2 = UL (nonbasic at upper bound). HiGHS format
(reference pred_basis.py:14-23)::

    HiGHS v1
    Valid
    # Columns N
    s_1 ... s_N
    # Rows M
    s_1 ... s_M

CPLEX format (pred_basis.py:25-55): ``XL var con`` pairs a basic structural
variable with a nonbasic-at-lower row, ``XU var con`` with a
nonbasic-at-upper row, ``UL var`` marks a variable at its upper bound;
unlisted variables default to LL(0) and unlisted constraints to BS(1)
(cvt_to_pkl.py:184).
"""
from __future__ import annotations

import logging
import os

import numpy as np

LL, BS, UL = 0, 1, 2
# nonbasic free at zero (HiGHS kZero): the only valid nonbasic status for a
# variable/row with no finite bound to rest on
FZ = 3


def write_bas_highs(fn: str, vnms=None, cnms=None, vbas=None, cbas=None) -> None:
    """Write a HiGHS-style basis file (reference pred_basis.py:14-23)."""
    if vbas is None or cbas is None:
        raise ValueError("write_bas_highs needs vbas and cbas")
    d = os.path.dirname(fn)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(fn, "w") as f:
        f.write("HiGHS v1\nValid\n")
        f.write(f"# Columns {len(vbas)}\n")
        f.write(" ".join(str(int(v)) for v in vbas) + "\n")
        f.write(f"# Rows {len(cbas)}\n")
        f.write(" ".join(str(int(v)) for v in cbas) + "\n")


def read_bas_highs(fn: str):
    """Read a HiGHS-style basis file -> (con_stas, var_stas)
    (reference cvt_to_pkl.py:166-178)."""
    with open(fn) as f:
        lines = f.readlines()
    con_stas = var_stas = None
    for idx, line in enumerate(lines):
        if "Columns" in line:
            var_stas = np.array(lines[idx + 1].split(), dtype=int)
        if "Rows" in line:
            con_stas = np.array(lines[idx + 1].split(), dtype=int)
    if con_stas is None or var_stas is None:
        raise ValueError(f"{fn}: no '# Columns' / '# Rows' sections")
    return con_stas, var_stas


def write_bas_cplex(fn: str, var_nms, con_nms, pred_var, pred_con) -> None:
    """Write a CPLEX-style basis file (reference pred_basis.py:25-55).

    Requires a *valid* basis: #basic structural vars == #nonbasic rows —
    each basic var is paired with one nonbasic row via XL/XU lines.
    """
    var_nms = np.asarray(var_nms)
    con_nms = np.asarray(con_nms)
    pred_var = np.asarray(pred_var)
    pred_con = np.asarray(pred_con)
    var_bs = var_nms[pred_var == BS]
    con_ll = con_nms[pred_con == LL]
    con_ul = con_nms[pred_con == UL]
    if len(var_bs) != len(con_ll) + len(con_ul):
        raise ValueError(f"not a valid basis: {len(var_bs)} basic structurals, "
                         f"{len(con_ll) + len(con_ul)} nonbasic rows")
    with open(fn, "w") as f:
        f.write(f"NAME          0.mps  Iterations 0  Rows {len(con_nms)}  "
                f"Cols {len(var_nms)} \n")
        for v, cn in zip(var_bs[: len(con_ll)], con_ll):
            f.write(f" XL {v} {cn} \n")
        for v, cn in zip(var_bs[len(con_ll):], con_ul):
            f.write(f" XU {v} {cn} \n")
        for v in var_nms[pred_var == UL]:
            f.write(f" UL {v} \n")
        f.write("ENDATA")


def read_bas(fn: str, con_nms=None, var_nms=None):
    """Read a basis file in either format -> (con_lbls, var_lbls)
    (reference cvt_to_pkl.py:180-206); a CPLEX file needs the names."""
    with open(fn) as f:
        lines = f.readlines()
    if lines and "HiGHS" in lines[0]:
        return read_bas_highs(fn)
    if con_nms is None or var_nms is None:
        raise ValueError(f"{fn}: a CPLEX basis file needs con_nms and var_nms")
    status = {"LL": LL, "BS": BS, "UL": UL}
    con_map: dict[str, int] = {}
    var_map: dict[str, int] = {}
    for line in lines:
        tok = line.split()
        if not tok:
            continue
        key = tok[0]
        if key in ("XL", "XU"):
            vname, cname = tok[1], tok[2]
            var_map[vname] = BS
            con_map[cname] = UL if key == "XU" else LL
        elif key in status:
            var_map[tok[1]] = status[key]
    con_lbls = np.array([con_map.get(nm, BS) for nm in con_nms], dtype=np.int64)
    var_lbls = np.array([var_map.get(nm, LL) for nm in var_nms], dtype=np.int64)
    return con_lbls, var_lbls


def read_sol(fn: str):
    """Read a CPLEX XML .sol file -> (con_lbls, var_lbls, con_nms, var_nms)
    (reference cvt_to_pkl.py:136-164), for label sources from CPLEX."""
    import xml.etree.ElementTree as ET
    status = {"LL": LL, "BS": BS, "UL": UL}

    def read_leaves(nodes):
        k = len(nodes)
        lbls = np.empty(k, dtype=np.int64)
        nms = np.empty(k, dtype=object)
        for node in nodes:
            idx = int(node.attrib["index"])
            lbls[idx] = status[node.attrib["status"]]
            nms[idx] = node.attrib["name"]
        return lbls, nms

    tree = ET.parse(fn)
    con_lbls, con_nms = read_leaves(list(tree.getroot()[2]))
    var_lbls, var_nms = read_leaves(list(tree.getroot()[3]))
    return con_lbls, var_lbls, con_nms, var_nms


def check_lb(lbls: np.ndarray, l: np.ndarray, nms=None) -> None:
    """Fix labels nonbasic-at-lower with lower bound -inf -> UL
    (reference cvt_to_pkl.py:208-212). Mutates ``lbls`` in place."""
    idx = np.where((l == -np.inf) & (lbls == LL))[0]
    if len(idx):
        nm = nms[idx[0]] if nms is not None else "?"
        logging.error("check_lb: %d label/bound conflicts (first: %s)", len(idx), nm)
        lbls[idx] = UL


def check_ub(lbls: np.ndarray, u: np.ndarray, nms=None) -> None:
    """Fix labels nonbasic-at-upper with upper bound +inf -> LL
    (reference cvt_to_pkl.py:214-218). Mutates ``lbls`` in place."""
    idx = np.where((u == np.inf) & (lbls == UL))[0]
    if len(idx):
        nm = nms[idx[0]] if nms is not None else "?"
        logging.error("check_ub: %d label/bound conflicts (first: %s)", len(idx), nm)
        lbls[idx] = LL
