"""A GCN_FC training step (``perfbench/reference/gcn_fc.py``) with the
input conv's aggregations cached once a graph, as the trainer runs it."""
from __future__ import annotations

from . import Traversal, gemm_flops, itemsize


def traversals(cfg: dict, s) -> list[Traversal]:
    """Each hidden conv: A x_vars and A^T x_cons forward, and each one's
    input gradient (the transpose) backward, at the hidden width."""
    h, b = cfg["hids"], itemsize(cfg["dtype"])
    v2c = Traversal("spmm", s.ncons, s.vars_used, s.nnz, h, b)
    c2v = Traversal("spmm", s.nvars, s.cons_used, s.nnz, h, b)
    return [v2c, c2v, c2v, v2c] * max(cfg["depth"] - 2, 0)


def step_flops(cfg: dict, s) -> int:
    p, q, h = cfg["p"], cfg["q"], cfg["hids"]
    m, n = s.ncons, s.nvars
    f = (gemm_flops(m, q, h, False) + gemm_flops(m, p, h, False)
         + gemm_flops(n, p, h, False) + gemm_flops(n, q, h, False))
    f += max(cfg["depth"] - 2, 0) * 2 * (gemm_flops(m, h, h, True)
                                         + gemm_flops(n, h, h, True))
    f += gemm_flops(m, h, 3, True) + gemm_flops(n, h, 3, True)
    return f + sum(t.flops for t in traversals(cfg, s))
