"""HiGHS basis (.bas) files (counterpart of ``lp_gnn_tpu/io/bas.py:38,52``).

Status encoding is the 3-class label: 0 = LL (nonbasic at lower bound),
1 = BS (basic), 2 = UL (nonbasic at upper bound). Format
(reference pred_basis.py:14-23)::

    HiGHS v1
    Valid
    # Columns N
    s_1 ... s_N
    # Rows M
    s_1 ... s_M
"""
from __future__ import annotations

import os

import numpy as np

LL, BS, UL = 0, 1, 2


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
