"""The mirp family's LPs as the pipeline trains on them: frozen copies of
``lp_gnn_tpu_torch/data/generator.py gen_mirp_like`` (the matrix and
bounds it writes to MPS) and of ``prep``'s processing of an LP into a
training graph (``data/scaling.py scaling``, ``data/features.py
cvt_to_features``, as ``data/dataset.py process_one_raw`` applies them).

``generate`` consumes its two random states exactly as the program's
generator does, so a structure seed and a data seed give the program's
LP; ``perfbench/tests/test_lpgen.py`` holds the copies to the originals.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix


def generate(rs, rd, n_ports: int, n_periods: int, arc_density: float,
             tightness: float):
    """Multi-period inventory and shipping LP (``gen_mirp_like``):
    ``(c, b_l, A (csr), b_u, lb, ub)``. ``rs`` draws the structure (arcs,
    travel times, capacities), ``rd`` the data (rates, costs)."""
    P, T = n_ports, n_periods
    arcs = [(p, q) for p in range(P) for q in range(P)
            if p != q and rs.rand() < arc_density]
    if not arcs:
        arcs = [(0, 1 % P)]
    A_ = len(arcs)
    travel = 1 + rs.randint(0, 2, A_)
    prod_ports = rs.rand(P) < 0.5
    if not prod_ports.any():
        prod_ports[0] = True
    if prod_ports.all():
        prod_ports[-1] = False
    cap_store = (rs.rand(P) * 30 + 20) * tightness
    cap_arc = (rs.rand(A_) * 6 + 2) * tightness
    fleet_cap = A_ * (rs.rand() * 3 + 2) * tightness

    nI, nX, nZ = P * T, A_ * T, P * T
    nW = P * T
    n = nI + nX + nZ + nW
    m = P * T + T
    # variable blocks: inventory I, shipments X, spot purchases Z, disposal W
    vI = np.arange(nI).reshape(P, T)
    vX = nI + np.arange(nX).reshape(A_, T)
    vZ = nI + nX + np.arange(nZ).reshape(P, T)
    vW = nI + nX + nZ + np.arange(nW).reshape(P, T)
    rB = np.arange(P * T).reshape(P, T)   # balance rows
    rC = P * T + np.arange(T)             # fleet rows

    rate = np.where(prod_ports, rd.rand(P) * 4 + 2, -(rd.rand(P) * 4 + 2))
    r = rate[:, None] * (0.8 + 0.4 * rd.rand(P, T))

    rows, cols, vals = [], [], []
    for p in range(P):
        for t in range(T):
            i = rB[p, t]
            rows += [i, i, i]
            cols += [vI[p, t], vZ[p, t], vW[p, t]]
            vals += [1.0, -1.0, 1.0]
            if t > 0:
                rows.append(i)
                cols.append(vI[p, t - 1])
                vals.append(-1.0)
    for a, (p, q) in enumerate(arcs):
        for t in range(T):
            rows.append(rB[p, t])
            cols.append(vX[a, t])
            vals.append(1.0)
            if t + travel[a] < T:
                rows.append(rB[q, t + int(travel[a])])
                cols.append(vX[a, t])
                vals.append(-1.0)
            rows.append(rC[t])
            cols.append(vX[a, t])
            vals.append(1.0)

    A = coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    rhs = np.concatenate([r.reshape(-1), np.zeros(T)])
    b_l = rhs.copy()
    b_u = rhs.copy()
    b_l[P * T:] = -np.inf
    b_u[P * T:] = fleet_cap

    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    ub[:nI] = np.repeat(cap_store, T)
    ub[nI:nI + nX] = np.repeat(cap_arc, T)

    c = np.zeros(n)
    c[:nI] = 0.1 + 0.2 * rd.rand(nI)
    c[nI:nI + nX] = np.repeat(rd.rand(A_) * 3 + 1, T)
    c[nI + nX:nI + nX + nZ] = 50.0 + 10 * rd.rand(nZ)
    c[nI + nX + nZ:] = 40.0 + 10 * rd.rand(nW)
    return c, b_l, A, b_u, lb, ub


def prepare(c, b_l, A, b_u, lb, ub):
    """The training graph's parts of an LP, as ``process_one_raw`` makes
    them: ``(A scaled, as coo in row-major order; variable features (n,
    8); constraint features (m, 8))``, features in float32."""
    c, b_l, A, b_u, lb, ub = scale(c, b_l, A, b_u, lb, ub)
    v_feas, c_feas = features(c, b_l, A, b_u, lb, ub)
    return A.tocoo(), v_feas.astype(np.float32), c_feas.astype(np.float32)


def _div(A, vec, axis: str):
    B = (A.tocsr if axis == "row" else A.tocsc)(copy=True)
    B.data = B.data / np.repeat(np.asarray(vec).ravel(), np.diff(B.indptr))
    return B


def _guard(x):
    x = np.abs(x)
    x[(x == np.inf) | (x == 0)] = 1
    return x


def scale(c, b_l, A, b_u, l, u):
    """Rows by max(|b_l|, |b_u|), columns by max(colmax |A|, 1/|l|, 1/|u|),
    the objective by max |c| (``scaling``)."""
    b_u, b_l, l, u, c = (np.array(x, dtype=np.float64)
                         for x in (b_u, b_l, l, u, c))
    b_u[b_u > 1e308] = np.inf
    b_l[b_l < -1e308] = -np.inf
    u[u > 1e308] = np.inf
    l[l < -1e308] = -np.inf
    scale_row = np.maximum(_guard(b_l), _guard(b_u))
    A = _div(A, scale_row, "row")
    b_l, b_u = b_l / scale_row, b_u / scale_row
    scale_col2 = np.maximum(1.0 / _guard(l), 1.0 / _guard(u))
    scale_col = np.maximum(_guard(np.abs(A).max(0).toarray().ravel()),
                           scale_col2)
    A = _div(A, scale_col, "col").tocsr()
    l, u, c = l * scale_col, u * scale_col, c / scale_col
    top = np.abs(c).max() if c.size else 0.0
    return c / (top if top != 0.0 else 1.0), b_l, A, b_u, l, u


def _nnz(A, by: str) -> np.ndarray:
    row, col = A.nonzero()
    idx = col if by == "col" else row
    return np.bincount(idx, minlength=A.shape[1 if by == "col" else 0]) \
        .astype(np.float64)


def _cos(v, A, bound: float = 1e8) -> np.ndarray:
    """cos(v, A[:, j]) for every column j, v clipped, zero norms 1e-6."""
    v = np.clip(np.asarray(v, dtype=np.float64), -bound, bound)
    nrm_v = np.sqrt((v ** 2).sum()) or 1e-6
    nrm = np.sqrt(np.asarray(A.multiply(A).sum(0)).ravel())
    nrm = np.where(nrm == 0, 1e-6, nrm)
    return np.asarray(v @ A).ravel() / (nrm_v * nrm)


def _expand(x) -> np.ndarray:
    """A bound as (finite value or 0, tag -1 / 0 / +1 for -inf / finite /
    +inf)."""
    val = np.asarray(x, dtype=np.float64).copy()
    tag = np.zeros_like(val)
    tag[val == np.inf] = 1
    tag[val == -np.inf] = -1
    val[np.abs(val) == np.inf] = 0
    return np.stack((val, tag), axis=1)


def features(c, b_l, A, b_u, l, u):
    """(variable features (n, 8), constraint features (m, 8))
    (``cvt_to_features``)."""
    m, n = A.shape
    v = np.column_stack([c, _nnz(A, "col") / m, _cos(b_l, A), _cos(b_u, A),
                         _expand(l), _expand(u)])
    con = np.column_stack([_cos(c, A.T), _nnz(A, "row") / n, _cos(l, A.T),
                           _cos(u, A.T), _expand(b_l), _expand(b_u)])
    return v, con
