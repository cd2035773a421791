"""Host-side neighbor-sampled subgraphs (counterpart of
``lp_gnn_tpu/data/sampling.py``; it replaces PyG's NeighborLoader,
reference train.py:111-116 with fanout [6]*(depth-1) for training and
val.py:22-27 with fanout [-1] for exact inference).

- Seeds run over every node (both sides), in batches of up to
  ``batch_size``, shuffled by one ``permutation`` of the caller's
  ``RandomState`` when ``shuffle``.
- L hops of fanout-k sampling on the undirected bipartite graph: a node of
  degree above k draws k of its edges by one ``rng.choice`` (no
  replacement), in node order; the sampled edges form the subgraph.
- Seed nodes come first on each side: the loss and the logits read the
  seed prefix ``s_bs`` / ``t_bs`` (reference dataset.py:319-326).

The draws are the JAX package's, made in the same order from the same
``RandomState``, so a run's numpy stream stays aligned with the JAX
trainer's. A subgraph is returned unpadded, as a :class:`Subgraph`: the
port runs eagerly and needs no bucket shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .dataset import BipartiteGraph


class Subgraph(NamedTuple):
    """A sampled subgraph and its seed prefix: constraints ``[0, s_bs)``
    and variables ``[0, t_bs)`` are the batch's seeds."""
    g: BipartiteGraph
    s_bs: int
    t_bs: int


class _BipartiteCSR:
    """Adjacency of one bipartite graph in both directions
    (sampling.py:25)."""

    def __init__(self, g: BipartiteGraph):
        m, n = g.ncons, g.nvars
        order_r = np.argsort(g.row, kind="stable")
        self.c2v_ptr = np.zeros(m + 1, np.int64)
        np.add.at(self.c2v_ptr[1:], g.row, 1)
        self.c2v_ptr = np.cumsum(self.c2v_ptr)
        self.c2v_idx = g.col[order_r]
        self.c2v_eid = order_r
        order_c = np.argsort(g.col, kind="stable")
        self.v2c_ptr = np.zeros(n + 1, np.int64)
        np.add.at(self.v2c_ptr[1:], g.col, 1)
        self.v2c_ptr = np.cumsum(self.v2c_ptr)
        self.v2c_idx = g.row[order_c]
        self.v2c_eid = order_c


def _take_all(ptr, nodes):
    """All slot indices of ``nodes`` in a CSR (sampling.py:45)."""
    starts = ptr[nodes]
    counts = ptr[nodes + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    csum = np.zeros(len(nodes), np.int64)
    np.cumsum(counts[:-1], out=csum[1:])
    return np.repeat(starts - csum, counts) + np.arange(total)


def _sample_neighbors(ptr, idx, eid, nodes, k, rng):
    """For each node, up to k sampled (neighbor, edge id) pairs; k < 0
    takes all (sampling.py:57). Only a node of degree above k draws, one
    ``rng.choice`` each, in the order of ``nodes``."""
    nodes = np.asarray(nodes, dtype=np.int64)
    if len(nodes) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if k < 0:
        sel = _take_all(ptr, nodes)
        return idx[sel], eid[sel]
    degs = ptr[nodes + 1] - ptr[nodes]
    small = nodes[degs <= k]
    big = nodes[degs > k]
    sels = [_take_all(ptr, small)]
    for u in big:
        s = ptr[u]
        sels.append(s + rng.choice(int(ptr[u + 1] - s), size=k, replace=False))
    sel = np.concatenate(sels)
    return idx[sel], eid[sel]


def sample_one_batch(g: BipartiteGraph, adj: _BipartiteCSR,
                     seed_cons: np.ndarray, seed_vars: np.ndarray,
                     fanout, rng) -> Subgraph:
    """One sampled subgraph from the given seed sets (sampling.py:79)."""
    in_cons = np.zeros(g.ncons, bool)
    in_vars = np.zeros(g.nvars, bool)
    in_cons[seed_cons] = True
    in_vars[seed_vars] = True
    edge_ids = []
    frontier_c, frontier_v = seed_cons, seed_vars
    for k in fanout:
        nv, ev = _sample_neighbors(adj.c2v_ptr, adj.c2v_idx, adj.c2v_eid,
                                   frontier_c, k, rng)
        nc, ec = _sample_neighbors(adj.v2c_ptr, adj.v2c_idx, adj.v2c_eid,
                                   frontier_v, k, rng)
        edge_ids.append(ev)
        edge_ids.append(ec)
        new_v = np.unique(nv[~in_vars[nv]]) if nv.size else np.empty(0, np.int64)
        new_c = np.unique(nc[~in_cons[nc]]) if nc.size else np.empty(0, np.int64)
        in_vars[new_v] = True
        in_cons[new_c] = True
        frontier_c, frontier_v = new_c, new_v
    edge_ids = np.unique(np.concatenate(edge_ids)) if edge_ids else \
        np.empty(0, np.int64)

    # relabel: seeds first on each side (the NeighborLoader contract)
    other_cons = np.setdiff1d(np.nonzero(in_cons)[0], seed_cons)
    other_vars = np.setdiff1d(np.nonzero(in_vars)[0], seed_vars)
    cons_ids = np.concatenate([seed_cons, other_cons])
    vars_ids = np.concatenate([seed_vars, other_vars])
    cmap = np.full(g.ncons, -1, np.int64)
    vmap = np.full(g.nvars, -1, np.int64)
    cmap[cons_ids] = np.arange(len(cons_ids))
    vmap[vars_ids] = np.arange(len(vars_ids))

    row = cmap[g.row[edge_ids]]
    col = vmap[g.col[edge_ids]]
    val = g.val[edge_ids]
    keep = (row >= 0) & (col >= 0)
    row, col, val = row[keep], col[keep], val[keep]

    sub = BipartiteGraph(
        row=row.astype(np.int32), col=col.astype(np.int32),
        val=val.astype(np.float32),
        c_feas=g.c_feas[cons_ids], v_feas=g.v_feas[vars_ids],
        y_s=g.y_s[cons_ids], y_t=g.y_t[vars_ids], fn=g.fn)
    return Subgraph(sub, len(seed_cons), len(seed_vars))


def sample_subgraphs(g: BipartiteGraph, rng, fanout, batch_size: int,
                     shuffle: bool = True, drop_last: bool = True,
                     exact: bool = False) -> list[Subgraph]:
    """Cover the nodes as seeds in batches of ``batch_size``
    (sampling.py:125): training shuffles and samples fanout-k
    (train.py:111-116); ``exact=True`` takes fanout -1 (val.py:22-27).
    With ``drop_last`` a short last batch is left out (unless it is the
    only one)."""
    adj = _BipartiteCSR(g)
    nodes = np.arange(g.ncons + g.nvars)
    if shuffle:
        nodes = rng.permutation(nodes)
    if exact:
        fanout = [-1] * len(fanout)
    out = []
    bs = min(batch_size, len(nodes))
    for s in range(0, len(nodes), bs):
        chunk = nodes[s: s + bs]
        if len(chunk) < bs and drop_last and s > 0:
            break
        seed_cons = chunk[chunk < g.ncons]
        seed_vars = chunk[chunk >= g.ncons] - g.ncons
        out.append(sample_one_batch(g, adj, seed_cons, seed_vars, fanout, rng))
    return out
