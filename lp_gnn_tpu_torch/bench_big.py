"""Single-card full-graph training at 10^7-10^8 edges (the twin of
``scripts/bench_big.py``).

    python -m lp_gnn_tpu_torch.bench_big [--edges 100000000] \\
        [--cons 262144] [--vars 524288] [--hids 256] [--steps 2] \\
        [--remat 0] [--device cuda]

Trains ``GCN_FC(8,8,hids=H,depth=3,dtype='bfloat16'[,remat=True])``
(weights from seed 0, Adam at lr 1e-3, balanced CE) full-graph on the
root ``bench.py``'s synthetic graph at the given size (``bench.py
make_graph``, seed 0, its draws in its order): 3 warm-up steps, then
``--steps`` timed steps, one step a call as the JAX script's
``make_train_step`` with its decode accuracy (``with_acc=True``), the
dropout generator seeded 0. Each timed step ends in a host read of its
loss.

Prints one JSON line with the script's keys: ``edges``, ``step_time_s``
(the timed steps' mean), ``traversals_per_s`` (edges x 6 / step time,
``bench.py``'s count: the hidden conv's 2 directions forward and
backward, the input conv's 2 forward, cached once and counted as
delivered), ``remat`` and ``budget``, which is null: the JAX script's
``--budget`` caps the memory of its streaming blocked SpMM
(``LP_GNN_SPMM_BUDGET``), and the port's SpMM kernel never materialises
the edge messages that budget bounds, so the flag has no counterpart and
is not taken. The port's own fields: ``device`` (the card's name and power
limit as ``nvidia-smi`` gives them; ``cpu`` on the CPU), ``graph_build_s``
(the host: the draws and the graph's two orderings), ``upload_input_agg_s``
(the copy to the device and the input conv's cached aggregations; with
the host part, ``train/trainer.py train_graph``), ``peak_device_bytes``
(``torch.cuda.max_memory_allocated`` over the run less what the process
held at its start, ``device_bytes_at_start``; both null on the CPU),
``host_peak_rss_bytes`` (the process's peak resident set so far, earlier
work in the process included),
``step_s`` (each timed step) and ``losses`` (each timed step's).

The JAX script strips the COO edge arrays (``strip_coo``): the port's
graph holds its CSR and CSC only, so there is nothing to strip.
"""
from __future__ import annotations

import argparse
import json
import resource
import time

import torch

from .bench import SPMM_PER_EDGE, device_label, make_graph
from .data.graph import GraphTensors
from .device import resolve_device
from .models.gcn import build_model
from .ops.spmm import attach_input_agg
from .train.losses import LOSS_REGISTRY
from .train.trainer import make_optimizer, train_step
from .utils.timer import Timer

LR = 1e-3
WARMUP_STEPS = 3


def arch_string(hids: int, remat: bool) -> str:
    """The script's model (``bench_big.py:58-59``)."""
    return (f"GCN_FC(8,8,hids={hids},depth=3,dtype='bfloat16'"
            f"{',remat=True' if remat else ''})")


def setup(arch: str, device: torch.device):
    """The model (weights from seed 0) on ``device`` and its Adam."""
    model = build_model(arch, generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    return model, make_optimizer(model.parameters(), "adam", LR)


def step(model, optimizer, gt: GraphTensors, generator: torch.Generator):
    """One step as ``make_train_step(model, "balanced", optimizer)``
    builds it (``with_acc`` True): the loss before the update and the
    decode accuracy of the same forward, 0-d tensors on the device."""
    return train_step(model, optimizer, gt, LOSS_REGISTRY["balanced"],
                      generator, with_acc=True)


def graph_on(model, edges: int, ncons: int, nvars: int,
             device: torch.device) -> tuple[GraphTensors, float, float]:
    """``bench.py``'s graph at this size as ``train_graph`` gives it for
    GCN_FC (labels, the input cache), built in two timed parts: the
    host's (the draws and the two orderings, on the CPU) and the device's
    (the copy and the cache). Returns it with the two parts' seconds."""
    timer = Timer()
    gt = GraphTensors.from_graph(make_graph(0, edges, ncons, nvars), "cpu",
                                 labels=True)
    build_s = timer.since_last_check()
    gt = attach_input_agg(gt.to(device), model.cdtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return gt, build_s, timer.since_last_check()


def run(args: argparse.Namespace,
        device: torch.device) -> tuple[dict, GraphTensors]:
    """The benchmark's JSON object (module docstring) and the graph it
    trained on, on ``device``."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if on_card else None
    model, optimizer = setup(arch_string(args.hids, bool(args.remat)),
                             device)
    gt, build_s, upload_s = graph_on(model, args.edges, args.cons,
                                     args.vars, device)
    generator = torch.Generator(device=device).manual_seed(0)
    for _ in range(WARMUP_STEPS):
        loss, _ = step(model, optimizer, gt, generator)
    float(loss)
    step_s, losses = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        loss, _ = step(model, optimizer, gt, generator)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    dt = sum(step_s) / len(step_s)
    line = {
        "edges": args.edges, "step_time_s": dt,
        "traversals_per_s": args.edges * SPMM_PER_EDGE / dt,
        "remat": bool(args.remat), "budget": None,
        "device": device_label(device),
        "graph_build_s": build_s, "upload_input_agg_s": upload_s,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device) - base
                              if on_card else None),
        "device_bytes_at_start": base,
        "host_peak_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "step_s": step_s, "losses": losses,
    }
    return line, gt


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=100_000_000)
    ap.add_argument("--cons", type=int, default=262_144)
    ap.add_argument("--vars", type=int, default=524_288)
    ap.add_argument("--hids", type=int, default=256)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--remat", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    line, _ = run(args, resolve_device(args.device))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    main()
