"""Time the edge-partitioned path's host prep at scale (the twin of
``scripts/bench_partition.py``).

The edge-partitioned path's host prep — ``compute_halo_width`` +
``partition_graph(halo=True)`` — is numpy and a per-graph constant, but
at 10^7-10^8 edges it is real wall time. This times it on a banded
mirp-like bipartite graph (the structure the halo path is designed for)
at the given edge and shard counts, and prints one JSON line per (edges,
shards) cell with the script's keys:

    python -m lp_gnn_tpu_torch.bench_partition \\
        --edges 10_000_000 100_000_000 --shards 2 8

The port partitions the unpadded ``BipartiteGraph`` (the JAX package pads
it first), so ``pad_graph_s`` times the port's graph construction,
``banded_graph``. ``--naive`` also times the per-pair halo-width loop
(O(D^2) ``np.unique`` calls, the JAX script's before/after reference) and
requires the same width; ``--cache_dir`` times the partition cache's
store and load alone (``.tpart.npz``). Host only: no device is used.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import time

import numpy as np

from .data.dataset import BipartiteGraph
from .parallel.edge_partition import (_load_partition, _real_edges,
                                      _round_up, _shard_sizes,
                                      _store_partition, compute_halo_width,
                                      partition_graph)


def banded_graph(E, M=None, N=None, band=4096, seed=0) -> BipartiteGraph:
    """Banded mirp-like bipartite graph: constraint i's nonzeros cluster
    around variable i*(N/M) within ±band/2 (multi-period LPs couple only
    nearby periods — the locality the halo exchange exploits). The JAX
    script's draws from ``RandomState(seed)``."""
    M = M or max(E // 16, 1024)
    N = N or 2 * M
    rng = np.random.RandomState(seed)
    row = rng.randint(0, M, E).astype(np.int32)
    center = (row.astype(np.int64) * N) // M
    off = rng.randint(-band // 2, band // 2 + 1, E)
    col = np.clip(center + off, 0, N - 1).astype(np.int32)
    val = (rng.rand(E).astype(np.float32) - 0.5)
    val[val == 0] = 0.5
    c_feas = (rng.rand(M, 8).astype(np.float32) - 0.5)
    v_feas = (rng.rand(N, 8).astype(np.float32) - 0.5)
    return BipartiteGraph(row=row, col=col, val=val, c_feas=c_feas,
                          v_feas=v_feas,
                          y_s=rng.randint(0, 3, M).astype(np.int32),
                          y_t=rng.randint(0, 3, N).astype(np.int32))


def naive_halo_width(g: BipartiteGraph, n_shards: int) -> int:
    """The per-pair halo width: O(D) full-edge masks and O(D^2)
    ``np.unique`` calls over per-pair subsets (the JAX script's reference
    for ``compute_halo_width``)."""
    ms, ns = _shard_sizes(g, n_shards)
    row, col, _ = _real_edges(g)
    w = 1
    for d in range(n_shards):
        c = col[(row >= d * ms) & (row < (d + 1) * ms)]
        for e in range(n_shards):
            if e == d:
                continue
            ce = c[(c >= e * ns) & (c < (e + 1) * ns)]
            w = max(w, len(np.unique(ce)))
    return _round_up(w, 8)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", type=int, nargs="+",
                    default=[1_000_000, 10_000_000])
    ap.add_argument("--shards", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--band", type=int, default=4096)
    ap.add_argument("--naive", action="store_true",
                    help="also time the per-pair halo-width loop")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cache_dir", type=str, default="",
                    help="also time the partition cache's store and load")
    args = ap.parse_args(argv)

    cells = []
    for E in args.edges:
        t0 = time.time()
        g = banded_graph(E, band=args.band)
        pad_t = time.time() - t0
        for D in args.shards:
            cell = {"edges": E, "shards": D,
                    "pad_graph_s": round(pad_t, 2)}
            best_w = np.inf
            for _ in range(args.reps):
                t0 = time.time()
                bh = compute_halo_width(g, D)
                best_w = min(best_w, time.time() - t0)
            cell["halo_width_s"] = round(best_w, 3)
            cell["bh"] = int(bh)
            best_p = np.inf
            for _ in range(args.reps):
                t0 = time.time()
                dg = partition_graph(g, D, halo=True, halo_width=bh)
                best_p = min(best_p, time.time() - t0)
            cell["partition_s"] = round(best_p, 3)
            if args.cache_dir:
                # the store and the load alone, without the partition
                shutil.rmtree(args.cache_dir, ignore_errors=True)
                os.makedirs(args.cache_dir)
                path = osp.join(args.cache_dir, "bench.tpart.npz")
                t0 = time.time()
                _store_partition(path, dg)
                cell["cache_store_s"] = round(time.time() - t0, 3)
                cell["cache_bytes"] = os.path.getsize(path)
                t0 = time.time()
                _load_partition(path)
                cell["cache_load_s"] = round(time.time() - t0, 3)
                shutil.rmtree(args.cache_dir, ignore_errors=True)
            del dg
            if args.naive:
                t0 = time.time()
                bh2 = naive_halo_width(g, D)
                cell["halo_width_naive_s"] = round(time.time() - t0, 3)
                if bh2 != bh:
                    raise RuntimeError(f"naive halo width {bh2} != {bh}")
            print(json.dumps(cell), flush=True)
            cells.append(cell)
        del g
    return cells


if __name__ == "__main__":
    main()
