"""LP scaling / normalization (counterpart of ``lp_gnn_tpu/data/scaling.py``).
Numeric parity with reference dataset.py:23-76.

Row-scale A, b by max(|b_l|,|b_u|) (inf/0 guarded to 1); col-scale by
max(colmax|A|, 1/|l|, 1/|u|); scale c by max|c|; 1e308 -> inf.
"""
from __future__ import annotations

import logging

import numpy as np
from scipy.sparse import csr_matrix


def sparse_mat_div_by_vec(A, vec, axis: str = "row"):
    """Divide CSR/CSC rows (or cols) elementwise by a vector
    (reference utils.py:323-332)."""
    vec = np.asarray(vec).flatten()
    if axis == "row":
        B = A.tocsr(copy=True)
        B.data = B.data / np.repeat(vec, np.diff(B.indptr))
        return B
    B = A.tocsc(copy=True)
    B.data = B.data / np.repeat(vec, np.diff(B.indptr))
    return B


def scaling(c, b_l, A, b_u, l, u):
    """Scale an LP instance in place-semantics matching dataset.py:23-76.

    Returns scaled (c, b_l, A(csr), b_u, l, u). Arrays are modified like the
    reference (which mutates its inputs); pass copies if you need originals.
    """
    b_u = np.asarray(b_u, dtype=np.float64)
    b_l = np.asarray(b_l, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)

    b_u[b_u > 1e308] = np.inf
    b_l[b_l < -1e308] = -np.inf
    u[u > 1e308] = np.inf
    l[l < -1e308] = -np.inf

    # ---- row scaling by max(|b_l|, |b_u|)  (dataset.py:29-37)
    scale_l = np.abs(b_l)
    scale_l[(scale_l == np.inf) | (scale_l == 0)] = 1
    scale_u = np.abs(b_u)
    scale_u[(scale_u == np.inf) | (scale_u == 0)] = 1
    scale_row = np.maximum(scale_l, scale_u)
    A = sparse_mat_div_by_vec(A, scale_row, "row")
    b_l = b_l / scale_row
    b_u = b_u / scale_row

    # ---- col scaling by max(colmax|A|, 1/|l|, 1/|u|)  (dataset.py:39-67)
    scale_l = np.abs(l)
    scale_l[(scale_l == np.inf) | (scale_l == 0)] = 1
    scale_u = np.abs(u)
    scale_u[(scale_u == np.inf) | (scale_u == 0)] = 1
    scale_col2 = np.maximum(1.0 / scale_l, 1.0 / scale_u)

    scale_col = np.abs(A).max(0).toarray().flatten()
    scale_col[(scale_col == np.inf) | (scale_col == 0)] = 1
    scale_col = np.maximum(scale_col, scale_col2)

    A = sparse_mat_div_by_vec(A, scale_col, "col").tocsr()
    l = l * scale_col
    u = u * scale_col
    c = c / scale_col

    # ---- objective scaling by max|c|  (dataset.py:70-74)
    scale_c = np.abs(c).max() if c.size else 0.0
    if scale_c == 0.0:
        logging.warning("all c is zero — feasibility problem?")
        scale_c = 1.0
    c = c / scale_c

    return c, b_l, A, b_u, l, u
