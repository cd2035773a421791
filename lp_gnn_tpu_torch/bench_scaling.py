"""Edge-partition scaling harness, twin of the repo's root
``bench_scaling.py``: the step time of the distributed training step at
1, 2, 4, ... shards.

    python -m lp_gnn_tpu_torch.bench_scaling [--devices 4] [--edges 200000]
        [--cons 16384] [--vars 32768] [--hids 128] [--steps 3] [--halo]
        [--device cpu]

The graph is ``bench.make_graph`` at ``--edges`` / ``--cons`` / ``--vars``;
the model GCN_FC(8,8,hids,depth=3) in fp32 with Adam and dropout 0
(``bench_scaling.py:62-82``), the same weights at every shard count. At
each d it partitions the graph into d shards (``--halo``: the boundary
halo exchange; else the all-gather / reduce-scatter branch), attaches the
input conv's cached aggregations, takes one warm-up step and times
``--steps`` steps, ended by a host read of the last loss.

Where the shards run: by default all d shards in this process, stacked on
one device (the card, or the CPU with ``--device cpu``), up to
``--devices`` shards (0: 1). Under the ``LP_GNN_DIST_*`` contract with W
ranks (``parallel/mesh.py``), shard k runs on rank k of a group of the
first d ranks, d up to ``--devices`` (0: W) and at most W; the other ranks
wait. Only rank 0 prints.

Prints one JSON line with ``bench_scaling.py``'s keys: ``mode``,
``multihost``, ``collectives`` (``halo`` or ``all-gather``), ``edges``,
``step_time_s`` and ``scaling_efficiency`` (t_1 / (d t_d)) by shard
count. ``mode`` is ``one-card`` (every shard in this process on one
device), ``ranks-on-one-card`` (ranks sharing one device) or
``ranks-on-own-cards``: with every shard on one card the efficiency is a
check of the function and of the collectives' overhead, not a scaling
claim, as ``bench_scaling.py:1-8`` says of its virtual mesh. The port's
own fields: ``device`` (``bench.device_label``) and ``losses`` (every
timed step's loss by shard count).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from .bench import device_label, make_graph
from .device import resolve_device
from .models.gcn import build_model
from .parallel.edge_partition import (dist_tensors, dist_train_step,
                                      partition_graph)
from .parallel.mesh import (dist_env, init_distributed, leave_distributed,
                            make_mesh, world_and_rank)
from .train.losses import LOSS_REGISTRY
from .train.trainer import make_optimizer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(model, optimizer, dgt, steps: int) -> tuple[float, list]:
    """One warm-up dist step, then ``steps`` steps timed together up to a
    host read of the last loss: seconds a step, and the steps' losses."""
    loss_fn = LOSS_REGISTRY["balanced"]
    float(dist_train_step(model, optimizer, dgt, loss_fn))
    _sync(dgt.device)
    t0 = time.perf_counter()
    losses = [dist_train_step(model, optimizer, dgt, loss_fn)
              for _ in range(steps)]
    float(losses[-1])
    seconds = (time.perf_counter() - t0) / steps
    return seconds, [float(v) for v in losses]


def mode_of(world: int, device: torch.device) -> str:
    if world == 1:
        return "one-card"
    if device.type != "cuda" or world > torch.cuda.device_count():
        return "ranks-on-one-card"
    return "ranks-on-own-cards"


def run(args, device: torch.device) -> dict | None:
    """Every shard count's step time; the JSON object on rank 0, None on
    the other ranks."""
    world, rank = world_and_rank()
    want = args.devices or world
    if world > 1 and want > world:
        if rank == 0:
            print(f"# requested {want} shards over {world} ranks, capping "
                  f"to {world}", flush=True)
        want = world
    g = make_graph(0, args.edges, args.cons, args.vars)
    arch = f"GCN_FC(8,8,hids={args.hids},depth=3,dp=0.0)"
    w0 = build_model(arch, generator=torch.Generator().manual_seed(0)
                     ).state_dict()
    times, losses = {}, {}
    d = 1
    while d <= want:
        group = dist.new_group(list(range(d))) if world > 1 else None
        if world == 1 or rank < d:
            model = build_model(arch)
            model.load_state_dict(w0)
            model.to(device)
            optimizer = make_optimizer(model.parameters(), "adam", 1e-3)
            mesh = make_mesh(d, device, group)
            dgt = dist_tensors(model, partition_graph(g, d, halo=args.halo),
                               mesh, input_agg=True)
            times[d], losses[d] = time_steps(model, optimizer, dgt,
                                             args.steps)
            del dgt, model, optimizer
        if world > 1:
            dist.barrier()
        d *= 2
    if rank != 0:
        return None
    base = times[1]
    return {
        "mode": mode_of(world, device),
        "multihost": dist_env() is not None,
        "collectives": "halo" if args.halo else "all-gather",
        "edges": args.edges,
        "step_time_s": {str(k): v for k, v in times.items()},
        "scaling_efficiency": {str(k): base / (v * k)
                               for k, v in times.items()},
        "device": device_label(device),
        "losses": {str(k): v for k, v in losses.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="the most shards: 0 = 1 in one process, or the "
                         "ranks of the LP_GNN_DIST_* contract")
    ap.add_argument("--edges", type=int, default=200_000)
    ap.add_argument("--cons", type=int, default=16_384)
    ap.add_argument("--vars", type=int, default=32_768)
    ap.add_argument("--hids", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--halo", action="store_true",
                    help="boundary halo exchange instead of the "
                         "all-gather/reduce-scatter decomposition")
    ap.add_argument("--device", default=os.environ.get("BENCH_DEVICE",
                                                       "cuda"),
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device, created = init_distributed(resolve_device(args.device))
    try:
        out = run(args, device)
    finally:
        if dist.is_initialized():
            leave_distributed(created)
    if out is not None:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    main()
