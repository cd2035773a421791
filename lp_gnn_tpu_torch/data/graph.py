"""A bipartite LP graph as tensors on a device.

Counterpart of the host half of ``lp_gnn_tpu/data/batching.py:214
pad_graph``: the same two edge orderings (``:231-234``), row-sorted for
aggregating variables into constraints and col-sorted for the transpose,
here as CSR and CSC with int32 pointers. What the JAX package adds for the
TPU (bucket padding to static shapes, the MXU block layout, ``strip_coo``)
has no use under PyTorch's eager execution and is left out, so there are no
padded rows: every tensor covers the real nodes and edges only.

Three optional parts: the labels (``from_graph(..., labels=True)``, for
training), the permutations between the two edge orderings
(``from_graph(..., perms=True)``, for the GEN aggregation's backward,
``:236-244``) and the input conv's cached aggregations
(``ops/spmm.py attach_input_agg``). A sampled subgraph's seeds are its
first ``s_bs`` constraints and ``t_bs`` variables (``:285-286``; the whole
graph by default). :func:`union` joins several graphs into one disjoint
graph for the graph-batched step (the port's form of the JAX package's
stacked ``PaddedGraph``s, ``parallel/dp.py:27 stack_graphs``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .dataset import BipartiteGraph


class Member(NamedTuple):
    """One graph of a disjoint union: its first constraint and variable
    in the union, its node counts and its seed prefix."""
    c0: int
    v0: int
    ncons: int
    nvars: int
    s_bs: int
    t_bs: int


def seed_masks(ncons: int, nvars: int, s_bs: int, t_bs: int,
               device: torch.device):
    """The loss masks of a graph (JAX trainer.py:63): its first ``s_bs``
    constraints and ``t_bs`` variables, every node of a full graph."""
    def mask(n, k):
        if k == n:
            return torch.ones((), dtype=torch.bool, device=device).expand(n)
        return torch.arange(n, device=device) < k
    return mask(ncons, s_bs), mask(nvars, t_bs)


def lex_order(major: np.ndarray, minor: np.ndarray | None = None,
              n_minor: int = 1) -> np.ndarray:
    """``np.lexsort((minor, major))`` of non-negative int64 ids, ``minor``
    below ``n_minor`` (without ``minor``, a stable argsort of ``major``):
    one stable sort of the key ``major * n_minor + minor``, which orders
    as the pair does and keeps ties in their input order, so the
    permutation is lexsort's. torch sorts int64 keys on the host with a
    parallel radix sort, where lexsort runs one indirect merge sort a key
    on one thread: far faster at 10^8 edges, a little slower at an LP's
    10^4-10^5, where the sort costs a millisecond either way
    (``chip_smoke.py --host_sort`` times both)."""
    key = major if minor is None else major * max(n_minor, 1) + minor
    return torch.sort(torch.from_numpy(key), stable=True).indices.numpy()


@dataclasses.dataclass
class GraphTensors:
    # vars -> cons (dst = constraint rows): CSR of the row-sorted ordering
    rowptr: torch.Tensor   # (m+1,) int32
    col: torch.Tensor      # (E,) int32 source variable per edge
    val_r: torch.Tensor    # (E,) float32
    # cons -> vars (dst = variable columns): CSC of the col-sorted ordering
    colptr: torch.Tensor   # (n+1,) int32
    row: torch.Tensor      # (E,) int32 source constraint per edge
    val_c: torch.Tensor    # (E,) float32
    c_feas: torch.Tensor   # (m, 8) float32
    v_feas: torch.Tensor   # (n, 8) float32
    y_s: torch.Tensor | None = None      # (m,) int64 labels
    y_t: torch.Tensor | None = None      # (n,) int64 labels
    in_agg_c: torch.Tensor | None = None   # (m, q) A v_feas, compute dtype
    in_agg_v: torch.Tensor | None = None   # (n, p) A^T c_feas, compute dtype
    # the position of each CSR edge in the CSC ordering, and the reverse
    eperm_r: torch.Tensor | None = None    # (E,) int32
    eperm_c: torch.Tensor | None = None    # (E,) int32
    # the seeds: constraints [0, s_bs), variables [0, t_bs); all if None
    s_bs: int | None = None
    t_bs: int | None = None
    # the graphs of a disjoint union (``union``), in order; None for one
    members: tuple[Member, ...] | None = None

    #: a conv over this graph may be recomputed in the backward (remat)
    remat = True

    def __post_init__(self):
        if self.s_bs is None:
            self.s_bs = self.ncons
        if self.t_bs is None:
            self.t_bs = self.nvars

    @property
    def ncons(self) -> int:
        return self.c_feas.shape[0]

    @property
    def nvars(self) -> int:
        return self.v_feas.shape[0]

    @property
    def nnz(self) -> int:
        return self.col.shape[0]

    @property
    def device(self) -> torch.device:
        return self.c_feas.device

    def apply_conv(self, conv, left: torch.Tensor, right: torch.Tensor,
                   input_conv: bool = False):
        """A model's two-direction ``conv`` over this graph: the module's
        own forward, or, as the input conv, its ``apply_input``, which
        reads the cached aggregations. The models call their convs through
        the graph, so that a partition's tensors (``parallel/edge_partition
        .py DistGraphTensors``) run the same forwards over their shards."""
        if input_conv:
            return conv.apply_input(self, left, right)
        return conv(self, left, right)

    def to(self, device: torch.device | str) -> "GraphTensors":
        """The same graph with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    @classmethod
    def from_graph(cls, g: BipartiteGraph, device: torch.device | str,
                   labels: bool = False, perms: bool = False,
                   s_bs: int | None = None,
                   t_bs: int | None = None) -> "GraphTensors":
        m, n, e = g.ncons, g.nvars, g.nnz
        if e >= 2 ** 31:
            raise ValueError(f"{g.fn}: {e} edges overflow int32 pointers")
        row = np.asarray(g.row, np.int64)
        col = np.asarray(g.col, np.int64)
        if e and (row.min() < 0 or row.max() >= m or
                  col.min() < 0 or col.max() >= n):
            raise ValueError(f"{g.fn}: edge index outside the node range")
        # LPDataset.get hands out row-major graphs: check that in O(E) and
        # keep the order as it is; then a stable sort by col alone gives the
        # col-major order that lexsort((row, col)) would (ties in both keep
        # their input order)
        dr = np.diff(row)
        if np.all((dr > 0) | ((dr == 0) & (np.diff(col) >= 0))):
            order_r = slice(None)
            order_c = np.argsort(col, kind="stable")
        else:
            order_r = lex_order(row, col, n)
            order_c = lex_order(col, row, m)
        eperm_r = eperm_c = None
        if perms:
            inv_c = np.empty(e, np.int64)
            inv_c[order_c] = np.arange(e)
            if isinstance(order_r, slice):   # the CSR order is the input's
                eperm_r, eperm_c = inv_c, order_c
            else:
                inv_r = np.empty(e, np.int64)
                inv_r[order_r] = np.arange(e)
                eperm_r, eperm_c = inv_c[order_r], inv_r[order_c]

        def ptr(dst, num):
            p = np.zeros(num + 1, np.int32)
            np.cumsum(np.bincount(dst, minlength=num), out=p[1:])
            return p

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        val = np.asarray(g.val, np.float32)
        return cls(
            rowptr=dev(ptr(row, m)), col=dev(col[order_r].astype(np.int32)),
            val_r=dev(val[order_r]),
            colptr=dev(ptr(col, n)), row=dev(row[order_c].astype(np.int32)),
            val_c=dev(val[order_c]),
            c_feas=dev(np.asarray(g.c_feas, np.float32)),
            v_feas=dev(np.asarray(g.v_feas, np.float32)),
            y_s=dev(np.asarray(g.y_s, np.int64)) if labels else None,
            y_t=dev(np.asarray(g.y_t, np.int64)) if labels else None,
            eperm_r=dev(eperm_r.astype(np.int32)) if perms else None,
            eperm_c=dev(eperm_c.astype(np.int32)) if perms else None,
            s_bs=s_bs, t_bs=t_bs,
        )


def union(graphs: Sequence[GraphTensors]) -> GraphTensors:
    """The disjoint union of ``graphs`` (one device): node ids offset by
    the graphs before, the CSR and CSC pointers by their edges, and so the
    edge permutations; features, labels and the input aggregation cache
    concatenated (each graph's rows of a kernel's output depend on its own
    edges only, so the union computes what each graph would, up to the
    order of fp32 sums where the kernel splits a row across CTAs).
    ``members`` keeps each graph's node range and seeds, for its own
    loss. Labels, cache and permutations are kept where every graph has
    them."""
    if not graphs:
        raise ValueError("a union needs at least one graph")
    ms = np.cumsum([0] + [g.ncons for g in graphs])
    ns = np.cumsum([0] + [g.nvars for g in graphs])
    es = np.cumsum([0] + [g.nnz for g in graphs])
    if es[-1] >= 2 ** 31:
        raise ValueError(f"a union of {es[-1]} edges overflows int32 pointers")

    def cat(name, off=None, ptr=False):
        parts = [getattr(g, name) for g in graphs]
        if any(p is None for p in parts):
            return None
        if ptr:   # each graph's pointers after the first drop their 0
            parts = [parts[0]] + [p[1:] for p in parts[1:]]
        if off is not None:
            parts = [p + int(o) for p, o in zip(parts, off)]
        return torch.cat(parts)

    return GraphTensors(
        rowptr=cat("rowptr", es, ptr=True), col=cat("col", ns),
        val_r=cat("val_r"),
        colptr=cat("colptr", es, ptr=True), row=cat("row", ms),
        val_c=cat("val_c"),
        c_feas=cat("c_feas"), v_feas=cat("v_feas"),
        y_s=cat("y_s"), y_t=cat("y_t"),
        in_agg_c=cat("in_agg_c"), in_agg_v=cat("in_agg_v"),
        eperm_r=cat("eperm_r", es), eperm_c=cat("eperm_c", es),
        members=tuple(Member(int(c0), int(v0), g.ncons, g.nvars, g.s_bs,
                             g.t_bs)
                      for g, c0, v0 in zip(graphs, ms, ns)))
