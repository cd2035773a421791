"""Multi-process dry run: one dp x edge training step over the ranks of the
``LP_GNN_DIST_*`` contract (the twin of ``scripts/dryrun_multihost.py``).

Launch one process a rank (here 8 ranks of the (dp=2, edge=4) grid on one
host; ``--device cpu`` runs the plain versions over gloo):

    for i in 0 1 2 3 4 5 6 7; do
      LP_GNN_DIST_COORD=localhost:9911 LP_GNN_DIST_NPROCS=8 \\
      LP_GNN_DIST_PROC_ID=$i python -m lp_gnn_tpu_torch.dryrun_multihost \\
          --mesh dp=2,edge=4 &
    done; wait

The step is the JAX script's: one graph a dp row (``_tiny_graph(seed=d,
e=--edges)``), partitioned at the batch's shared sizes without the halo
lists (``partition_batch``'s default, the all-gather layout), GCN_FC(8,8,
hids=16,depth=3) with dropout 0 (weights from seed 0), Adam at lr 1e-3,
balanced CE, one ``dp_edge_train_step``. ``--layout`` says how the ranks
hold the (dp, edge) mesh:

- ``grid`` (the default): D*E ranks, rank (d, e) holding shard e of graph d
  (``parallel/mesh.py RankGrid``), as the JAX script's global mesh puts one
  shard on each device of every process;
- ``rows``: D ranks, rank d holding all E shards of graph d on its device
  (``parallel/combined.py``'s other layout).

Without the contract one process holds every shard of every graph. Rank 0
prints the script's one JSON line: ``ok``, ``distributed`` (the contract
is set), ``num_processes``, ``global_devices`` (the distinct devices the
ranks compute on, by host: ranks that share one card count it once, where
the JAX script counts every device of the global mesh), ``mesh`` and
``loss`` (before the update, rounded to 6 places). The ranks may run on
several hosts; ``global_devices`` counts the distinct (host, card) pairs
of the placement the group was made with (``parallel/mesh.py
Placement``).

The script's ``--local_devices`` (virtual CPU devices a process) has no
counterpart: a rank computes on one device, its card or the CPU.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.distributed as dist

from .data.dataset import BipartiteGraph
from .device import resolve_device
from .models.gcn import build_model
from .parallel.combined import dp_edge_train_step, partition_batch
from .parallel.dp import rank_block
from .parallel.edge_partition import dist_tensors
from .parallel.mesh import (dist_env, init_distributed, leave_distributed,
                            make_grid, make_mesh, parse_mesh_shape,
                            placement, world_and_rank)
from .train.losses import LOSS_REGISTRY
from .train.trainer import make_optimizer

ARCH = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
LR = 1e-3


def _tiny_graph(m=48, n=80, e=320, seed=0) -> BipartiteGraph:
    """``__graft_entry__.py:13 _tiny_graph``'s graph, the same draws in the
    same order, unpadded (the port pads nothing)."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, m, e).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    val = (rng.rand(e).astype(np.float32) - 0.5)
    c_feas = (rng.rand(m, 8).astype(np.float32) - 0.5)
    v_feas = (rng.rand(n, 8).astype(np.float32) - 0.5)
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    return BipartiteGraph(row=row, col=col, val=val, c_feas=c_feas,
                          v_feas=v_feas,
                          y_s=rng.randint(0, 3, m).astype(np.int32),
                          y_t=rng.randint(0, 3, n).astype(np.int32))


def step(shape: dict[str, int], layout: str, edges: int,
         device: torch.device) -> float:
    """This rank's part of the step; returns the loss (every rank's)."""
    dp, n_edge = shape.get("dp", 1), shape.get("edge", 1)
    world, rank = world_and_rank()
    grid = None
    if world == 1:
        mesh, own = make_mesh(n_edge, device), list(range(dp))
    elif layout == "grid":
        grid = make_grid(dp, n_edge)
        mesh = make_mesh(n_edge, device, grid.row, row=grid.d)
        own = rank_block(list(range(dp)), dp, grid.d)
    else:
        if world != dp:
            raise ValueError(f"--layout rows takes dp={dp} ranks, not "
                             f"{world}")
        mesh, own = make_mesh(n_edge, device), [rank]
    graphs = [_tiny_graph(seed=s, e=edges) for s in range(dp)]
    model = build_model(ARCH, generator=torch.Generator().manual_seed(0))
    model.to(device)
    optimizer = make_optimizer(model.parameters(), "adam", LR)
    dgs = [dist_tensors(model, dg, mesh)
           for dg in partition_batch(graphs, n_edge, own=own)]
    return float(dp_edge_train_step(model, optimizer, dgs,
                                    LOSS_REGISTRY["balanced"], grid=grid))


def global_devices() -> int:
    """The distinct (host, card) pairs the ranks compute on, from the
    placement the process group was made with (ranks off the card count
    one a host); 1 without a group."""
    pl = placement()
    if pl is None or not dist.is_initialized():
        return 1
    return len(set(zip(pl.hosts, pl.cards)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=str, default="dp=2,edge=4")
    ap.add_argument("--edges", type=int, default=320)
    ap.add_argument("--layout", choices=("grid", "rows"), default="grid",
                    help="grid: D*E ranks, one shard a rank; rows: D ranks, "
                         "each all E shards of its graph")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    shape = parse_mesh_shape(args.mesh)
    device, created = init_distributed(resolve_device(args.device))
    try:
        loss = step(shape, args.layout, args.edges, device)
        n_dev = global_devices()
        world, rank = world_and_rank()
    finally:
        if dist.is_initialized():
            leave_distributed(created)
    if not math.isfinite(loss):
        raise FloatingPointError(f"dry-run loss {loss}")
    if rank == 0:
        print(json.dumps({
            "ok": True, "distributed": dist_env() is not None,
            "num_processes": world, "global_devices": n_dev,
            "mesh": {k: int(v) for k, v in shape.items()},
            "loss": round(loss, 6),
        }), flush=True)
    return 0


if __name__ == "__main__":
    main()
