"""The CSR SpMM (``ops/csrc/spmm.cu``): ``out[d] = sum val[e] x[idx[e]]``
over d's edges."""
from __future__ import annotations


def bytes_moved(t) -> int:
    """Read once: the pointers (n_dst + 1 int32), the indices and values
    (int32 + fp32 an edge), each source row with an edge; written once:
    the output rows."""
    return ((t.n_dst + 1) * 4 + t.nnz * 8 + t.n_src_used * t.width * t.itemsize
            + t.n_dst * t.width * t.itemsize)
