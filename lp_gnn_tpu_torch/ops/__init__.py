"""Sparse bipartite ops: hand-written CUDA kernels and their plain versions."""
