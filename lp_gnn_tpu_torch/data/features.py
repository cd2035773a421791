"""8-dim node features for both sides of the bipartite LP graph
(counterpart of ``lp_gnn_tpu/data/features.py``).

Numeric parity with reference dataset.py:79-96 and utils.py:335-383:

variable features  [c_j, nnz_col/m, cos(b_l, A_:j), cos(b_u, A_:j),
                    l_val, l_tag, u_val, u_tag]
constraint features [cos(A_i:, c), nnz_row/n, cos(A_i:, l), cos(A_i:, u),
                    b_l_val, b_l_tag, b_u_val, b_u_tag]

where (val, tag) is the +-inf expansion of a bound: tag in {-1, 0, +1}
marks -inf / finite / +inf and val is the finite value (0 where infinite).
Cosine similarities clip the dense vector to +-1e8 and guard zero norms with
1e-6 (utils.py:350-361).
"""
from __future__ import annotations

import numpy as np


def count_nonzero_sparse_mat(A, by: str = "col") -> np.ndarray:
    """nnz per column (or row) of a scipy sparse matrix (utils.py:335-347)."""
    nrows, ncols = A.shape
    row, col = A.nonzero()
    if by == "col":
        nnz = np.zeros(ncols)
        idx, cnt = np.unique(col, return_counts=True)
        nnz[idx] = cnt
    else:
        nnz = np.zeros(nrows)
        idx, cnt = np.unique(row, return_counts=True)
        nnz[idx] = cnt
    return nnz


def cos_sim_vec_and_sparse_mat(v: np.ndarray, A, bound: float = 1e8) -> np.ndarray:
    """cos(v, A[:, j]) for every column j (utils.py:350-361).

    v is clipped to [-bound, bound]; zero norms replaced by 1e-6 so columns
    with no overlap give exactly 0.
    """
    v = np.clip(np.asarray(v, dtype=np.float64), -bound, bound)
    nrm_v = np.sqrt((v ** 2).sum())
    nrm_cols = np.sqrt(np.asarray(A.multiply(A).sum(0)).flatten())
    dot = v @ A
    dot = np.asarray(dot).flatten()
    nrm_cols = np.where(nrm_cols == 0, 1e-6, nrm_cols)
    if nrm_v == 0:
        nrm_v = 1e-6
    return dot / (nrm_v * nrm_cols)


def cos_sim_sparse_mat_and_vec(A, x: np.ndarray, bound: float = 1e8) -> np.ndarray:
    """cos(A[i, :], x) for every row i (utils.py:364-365)."""
    return cos_sim_vec_and_sparse_mat(x, A.T, bound)


def expand_inf(x: np.ndarray) -> np.ndarray:
    """(n,) bound vector -> (n, 2) [finite value, tag in {-1,0,1}]
    (utils.py:368-374)."""
    val = np.asarray(x, dtype=np.float64).copy()
    tag = np.zeros_like(val)
    tag[val == np.inf] = 1
    tag[val == -np.inf] = -1
    val[np.abs(val) == np.inf] = 0
    return np.stack((val, tag), axis=1)


def _cat(*args) -> np.ndarray:
    cols = [a.reshape(-1, 1) if a.ndim == 1 else a for a in args]
    return np.concatenate(cols, axis=1)


def cvt_to_features(c, b_l, A, b_u, l, u):
    """Build (v_features (n,8), c_features (m,8)) — reference dataset.py:79-96."""
    nrows, ncols = A.shape
    v_features = _cat(
        c,
        count_nonzero_sparse_mat(A, "col") / nrows,
        cos_sim_vec_and_sparse_mat(b_l, A),
        cos_sim_vec_and_sparse_mat(b_u, A),
        expand_inf(l),
        expand_inf(u),
    )
    c_features = _cat(
        cos_sim_sparse_mat_and_vec(A, c),
        count_nonzero_sparse_mat(A, "row") / ncols,
        cos_sim_sparse_mat_and_vec(A, l),
        cos_sim_sparse_mat_and_vec(A, u),
        expand_inf(b_l),
        expand_inf(b_u),
    )
    return v_features, c_features
