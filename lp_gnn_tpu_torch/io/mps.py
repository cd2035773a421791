"""Pure-Python MPS reader/writer (counterpart of ``lp_gnn_tpu/io/mps.py``,
an own copy: the same files in, the same bytes out).

Role of the reference's ``read_mps`` (scripts/cvt_to_pkl.py:61-133), which
shells out to CBC via python-mip. Here it is a native parser — no external
solver needed for ingestion. Semantics match the reference contract:

    min c.x  s.t.  b_l <= A x <= b_u,  lb <= x <= ub

- row senses: '=' -> b_l=b_u=rhs, '<' -> b_u=rhs, '>' -> b_l=rhs
  (cvt_to_pkl.py:110-120)
- MAX objectives are negated to MIN (cvt_to_pkl.py:105)
- default variable bounds lb=0, ub=+inf (cvt_to_pkl.py:88-94)
- integrality is dropped (LP relaxation, cvt_to_pkl.py:17-55)

Supports fixed and free MPS: NAME/OBJSENSE/ROWS/COLUMNS (INTORG/INTEND
markers)/RHS/RANGES/BOUNDS/ENDATA, and transparent ``.gz`` decompression.
"""
from __future__ import annotations

import dataclasses
import gzip

import numpy as np
from scipy.sparse import csr_matrix


@dataclasses.dataclass
class LPData:
    """An LP instance in the reference's canonical form."""
    c: np.ndarray          # (n,)
    b_l: np.ndarray        # (m,)
    A: csr_matrix          # (m, n)
    b_u: np.ndarray        # (m,)
    lb: np.ndarray         # (n,)
    ub: np.ndarray         # (n,)
    con_nms: np.ndarray    # (m,) str
    var_nms: np.ndarray    # (n,) str
    name: str = "LP"
    obj_const: float = 0.0

    @property
    def shape(self):
        return self.A.shape


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_mps(path: str) -> LPData:
    """Parse an MPS file into ``LPData``."""
    name = "LP"
    sense_max = False
    section = None
    obj_row = None
    row_sense: dict[str, str] = {}
    row_order: list[str] = []
    # per-column entries
    col_order: list[str] = []
    col_set: dict[str, int] = {}
    entries_r: list[int] = []   # row index (constraint rows only)
    entries_c: list[int] = []
    entries_v: list[float] = []
    row_idx: dict[str, int] = {}
    obj_coeff: dict[int, float] = {}
    rhs: dict[str, float] = {}
    ranges: dict[str, float] = {}
    obj_const = 0.0
    # bounds applied after columns known
    bound_lines: list[tuple[str, str, float | None]] = []

    with _open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("*"):
                continue
            is_header = line[0] not in " \t"
            tok = line.split()
            if is_header:
                head = tok[0].upper()
                if head == "NAME":
                    name = tok[1] if len(tok) > 1 else "LP"
                    section = "NAME"
                elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                              "OBJSENSE", "ENDATA", "OBJSENCE"):
                    section = head
                    if head == "OBJSENSE" and len(tok) > 1:
                        sense_max = tok[1].upper().startswith("MAX")
                    if head == "ENDATA":
                        break
                else:
                    section = head
                continue
            if section == "OBJSENSE":
                sense_max = tok[0].upper().startswith("MAX")
            elif section == "ROWS":
                sense, rname = tok[0].upper(), tok[1]
                if sense == "N":
                    if obj_row is None:
                        obj_row = rname
                        continue
                    sense = "F"   # additional N rows are free constraints
                row_sense[rname] = sense
                row_idx[rname] = len(row_order)
                row_order.append(rname)
            elif section == "COLUMNS":
                if len(tok) >= 3 and "'MARKER'" in line.upper():
                    continue   # INTORG/INTEND: integrality is dropped
                cname = tok[0]
                if cname not in col_set:
                    col_set[cname] = len(col_order)
                    col_order.append(cname)
                j = col_set[cname]
                for k in range(1, len(tok) - 1, 2):
                    rname, val = tok[k], float(tok[k + 1])
                    if rname == obj_row:
                        obj_coeff[j] = obj_coeff.get(j, 0.0) + val
                    elif rname in row_idx:
                        entries_r.append(row_idx[rname])
                        entries_c.append(j)
                        entries_v.append(val)
            elif section == "RHS":
                # first token is the RHS set name (may be omitted in free form
                # when the line has an even token count)
                start = 1 if len(tok) % 2 == 1 else 0
                if start == 0 and tok[0] in row_idx or (start == 0 and tok[0] == obj_row):
                    pass  # rhs-set name omitted
                else:
                    start = 1
                for k in range(start, len(tok) - 1, 2):
                    rname, val = tok[k], float(tok[k + 1])
                    if rname == obj_row:
                        obj_const = -val
                    else:
                        rhs[rname] = val
            elif section == "RANGES":
                start = 1 if len(tok) % 2 == 1 else 0
                if start == 0 and tok[0] not in row_idx:
                    start = 1
                for k in range(start, len(tok) - 1, 2):
                    ranges[tok[k]] = float(tok[k + 1])
            elif section == "BOUNDS":
                btype = tok[0].upper()
                if btype in ("FR", "MI", "PL", "BV"):
                    # BTYPE BNDNAME COLNAME
                    cname = tok[-1]
                    bound_lines.append((btype, cname, None))
                else:
                    cname, val = tok[-2], float(tok[-1])
                    bound_lines.append((btype, cname, val))

    m, n = len(row_order), len(col_order)
    con_nms = np.array(row_order, dtype=object)
    var_nms = np.array(col_order, dtype=object)

    c = np.zeros(n)
    for j, v in obj_coeff.items():
        c[j] = v
    if sense_max:
        c = -c

    b_l = np.full(m, -np.inf)
    b_u = np.full(m, np.inf)
    for rname in row_order:
        i = row_idx[rname]
        s = row_sense[rname]
        r = rhs.get(rname, 0.0)
        if s == "E":
            b_l[i] = b_u[i] = r
        elif s == "L":
            b_u[i] = r
        elif s == "G":
            b_l[i] = r
        # "F" (free row): both bounds stay infinite
    # RANGES: L row -> b_l = rhs - |R|; G row -> b_u = rhs + |R|;
    # E row -> R>=0: [rhs, rhs+R], R<0: [rhs+R, rhs]
    for rname, R in ranges.items():
        if rname not in row_idx:
            continue
        i = row_idx[rname]
        s = row_sense[rname]
        r = rhs.get(rname, 0.0)
        if s == "L":
            b_l[i] = r - abs(R)
        elif s == "G":
            b_u[i] = r + abs(R)
        else:
            if R >= 0:
                b_l[i], b_u[i] = r, r + R
            else:
                b_l[i], b_u[i] = r + R, r

    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    # the UP-negative convention applies only when the lower bound was never
    # set explicitly — an explicit 'LO 0' must survive a later negative UP
    lb_explicit = np.zeros(n, bool)
    for btype, cname, val in bound_lines:
        if cname not in col_set:
            continue
        j = col_set[cname]
        if btype == "UP":
            ub[j] = val
            # MPS convention: UP with negative value and no LO set -> lb=-inf
            if val is not None and val < 0 and not lb_explicit[j] \
                    and lb[j] == 0:
                lb[j] = -np.inf
        elif btype == "LO":
            lb[j] = val
            lb_explicit[j] = True
        elif btype == "FX":
            lb[j] = ub[j] = val
            lb_explicit[j] = True
        elif btype == "FR":
            lb[j], ub[j] = -np.inf, np.inf
            lb_explicit[j] = True
        elif btype == "MI":
            lb[j] = -np.inf
            lb_explicit[j] = True
        elif btype == "PL":
            ub[j] = np.inf
        elif btype == "BV":
            lb[j], ub[j] = 0.0, 1.0
            lb_explicit[j] = True

    A = csr_matrix((entries_v, (entries_r, entries_c)), shape=(m, n))
    A.sum_duplicates()
    return LPData(c=c, b_l=b_l, A=A, b_u=b_u, lb=lb, ub=ub,
                  con_nms=con_nms, var_nms=var_nms, name=name,
                  obj_const=obj_const)


def write_mps(lp: LPData, path: str) -> None:
    """Write free-format MPS readable by this package's reader and the C++
    solver runtime. Inverse of :func:`read_mps` on its canonical form."""
    c, b_l, A, b_u, lb, ub = lp.c, lp.b_l, lp.A, lp.b_u, lp.lb, lp.ub
    con_nms, var_nms = lp.con_nms, lp.var_nms
    m, n = A.shape
    Ac = A.tocsc()
    lines = [f"NAME {lp.name}", "ROWS", " N OBJ"]
    senses = []
    for i in range(m):
        lo, hi = b_l[i], b_u[i]
        if not np.isfinite(lo) and not np.isfinite(hi):
            s = "N"   # free row (non-objective N row)
        elif lo == hi:
            s = "E"
        elif np.isfinite(hi) and not np.isfinite(lo):
            s = "L"
        elif np.isfinite(lo) and not np.isfinite(hi):
            s = "G"
        else:  # two-sided range row: write as L + RANGES
            s = "L"
        senses.append(s)
        lines.append(f" {s} {con_nms[i]}")
    lines.append("COLUMNS")
    indptr, indices, data = Ac.indptr, Ac.indices, Ac.data
    for j in range(n):
        nm = var_nms[j]
        if c[j] != 0.0 or indptr[j] == indptr[j + 1]:
            # always emit at least one entry so empty zero-cost columns
            # survive the round trip
            lines.append(f"    {nm} OBJ {c[j]:.17g}")
        for k in range(indptr[j], indptr[j + 1]):
            lines.append(f"    {nm} {con_nms[indices[k]]} {data[k]:.17g}")
    lines.append("RHS")
    for i in range(m):
        s = senses[i]
        if s == "N":
            continue
        r = b_u[i] if s in ("L", "E") else b_l[i]
        if r != 0.0:
            lines.append(f"    RHS {con_nms[i]} {r:.17g}")
    if lp.obj_const != 0.0:
        lines.append(f"    RHS OBJ {-lp.obj_const:.17g}")
    range_rows = [i for i in range(m)
                  if senses[i] == "L" and np.isfinite(b_l[i]) and b_l[i] != b_u[i]]
    if range_rows:
        lines.append("RANGES")
        for ii in range_rows:
            lines.append(f"    RNG {con_nms[ii]} {b_u[ii] - b_l[ii]:.17g}")
    lines.append("BOUNDS")
    for j in range(n):
        nm = var_nms[j]
        lo, hi = lb[j], ub[j]
        if lo == hi:
            lines.append(f" FX BND {nm} {lo:.17g}")
            continue
        if not np.isfinite(lo) and not np.isfinite(hi):
            lines.append(f" FR BND {nm}")
            continue
        if not np.isfinite(lo):
            lines.append(f" MI BND {nm}")
        elif lo != 0.0:
            lines.append(f" LO BND {nm} {lo:.17g}")
        elif np.isfinite(hi) and hi < 0.0:
            # explicit LO 0: a bare negative UP makes MPS readers (including
            # read_mps) set the lower bound to -inf by convention
            lines.append(f" LO BND {nm} 0")
        if np.isfinite(hi):
            lines.append(f" UP BND {nm} {hi:.17g}")
    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
