"""Sparse bipartite ops: hand-written CUDA kernels and their plain versions,
and the host SpMM over the native engine's library (``host_spmm``)."""
