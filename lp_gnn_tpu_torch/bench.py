"""Benchmark twin of the repo's root ``bench.py``: GCN_FC train-step SpMM
throughput on one card.

    python -m lp_gnn_tpu_torch.bench [--device cpu]

Prints one JSON line with ``bench.py``'s keys: ``metric``
(``spmm_edge_traversals_per_s_per_chip``), ``value``, ``unit``,
``vs_baseline``, ``baseline_edges_s``, ``baseline_source``, ``spread``
(min / median / max over the 3 timed calls) and ``step_acc``; a
non-flagship configuration adds ``arch`` and ``traversals_per_edge``, GEN
``gen_max_mode``. The port's own fields: ``device`` (the card's name and
power limit as ``nvidia-smi`` gives them; ``cpu`` on the CPU),
``steps_per_call``, ``step_s`` (the timed calls' seconds a step) and
``losses`` (the last call's step losses).

The metric is ``bench.py``'s: edge traversals a second through the
bipartite aggregation during a full train step (forward, backward, Adam)
on a synthetic LP-shaped graph, ``value = E * traversals_per_edge / min
(step time)``. GCN_FC at depth 3 counts 6 a step and edge (2 convs x 2
directions forward, the hidden conv's 2 backward; the input conv's 2 are
cached once a graph and counted as delivered, ``bench.py:1-23``). Other
configurations count their traversals on a tiny graph
(:func:`count_traversals`). The steps are timed as ``bench.py`` times
them: ``train/scan.py make_scan_train_step(..., stacked=False)``, 5 steps
a call (on the card one CUDA graph after the first, eager call), 2
warm-up calls, then 3 calls each ending in a host read of its last loss.

The environment knobs are ``bench.py``'s, with its defaults:
``BENCH_EDGES`` (1,000,000), ``BENCH_CONS`` (65,536), ``BENCH_VARS``
(131,072), ``BENCH_HIDS`` (256), ``BENCH_ARCH`` (GCN_FC), ``BENCH_DEPTH``
(3 for GCN_FC, else 5), ``BENCH_REMAT`` (on for GENDeeper),
``BENCH_DTYPE`` (bfloat16), ``BENCH_CACHE_IN_AGG`` (1),
``BENCH_STEP_ACC`` (0) and ``BENCH_MEASURE_BASELINE``; ``BENCH_DEVICE``
(``cuda``) is the port's. The port computes GEN's per-segment max only
(``gen_max_mode: "seg"``): ``bench.py``'s ``LP_GNN_GEN_MAX`` has no
counterpart.

``bench.py``'s baseline constant is a TPU measurement and has no place
here: without ``BENCH_MEASURE_BASELINE=1`` the line says
``"baseline_source": "none"`` and ``vs_baseline`` is null. With it, the
naive direct port is measured live in the same run (:func:`measure_baseline`:
GCN_FC in fp32, no input cache, each SpMM the plain ``index_add_``
version, its backward autograd's) and counted with the same 6 traversals.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from .data.dataset import BipartiteGraph
from .data.graph import GraphTensors
from .device import resolve_device
from .models.gcn import build_model
from .ops import gen_agg as gen_agg_mod
from .ops import spmm as spmm_mod
from .train.losses import LOSS_REGISTRY
from .train.scan import make_scan_train_step
from .train.trainer import make_optimizer, train_graph, train_step

METRIC = "spmm_edge_traversals_per_s_per_chip"
SPMM_PER_EDGE = 6   # 2 convs x 2 directions forward + the hidden conv x 2 back
STEPS_PER_CALL = 5
LR = 1e-3


@dataclasses.dataclass(frozen=True)
class Knobs:
    """``bench.py``'s environment knobs (module docstring)."""
    edges: int
    cons: int
    vars: int
    hids: int
    arch: str
    depth: int
    remat: bool
    dtype: str
    cache_in_agg: bool
    step_acc: bool
    measure_baseline: bool

    @classmethod
    def from_env(cls, env=os.environ) -> "Knobs":
        arch = env.get("BENCH_ARCH", "GCN_FC")
        return cls(
            edges=int(env.get("BENCH_EDGES", 1_000_000)),
            cons=int(env.get("BENCH_CONS", 65_536)),
            vars=int(env.get("BENCH_VARS", 131_072)),
            hids=int(env.get("BENCH_HIDS", 256)),
            arch=arch,
            depth=int(env.get("BENCH_DEPTH", 3 if arch == "GCN_FC" else 5)),
            remat=env.get("BENCH_REMAT",
                          "1" if arch == "GENDeeper" else "0") == "1",
            dtype=env.get("BENCH_DTYPE", "bfloat16"),
            cache_in_agg=env.get("BENCH_CACHE_IN_AGG", "1") == "1",
            step_acc=env.get("BENCH_STEP_ACC", "0") == "1",
            measure_baseline=env.get("BENCH_MEASURE_BASELINE", "") == "1")

    @property
    def flagship(self) -> bool:
        return self.arch == "GCN_FC" and self.depth == 3

    def arch_string(self, hids: int | None = None,
                    dtype: str | None = None) -> str:
        """The measured model's arch string (``bench.py:187-189``); with
        ``hids``, the count's (no dtype, no remat)."""
        if hids is not None:
            return f"{self.arch}(8,8,hids={hids},depth={self.depth})"
        remat = ",remat=True" if self.remat else ""
        return (f"{self.arch}(8,8,hids={self.hids},depth={self.depth},"
                f"dtype='{dtype or self.dtype}'{remat})")


def make_graph(seed: int = 0, e: int = 1_000_000, m: int = 65_536,
               n: int = 131_072) -> BipartiteGraph:
    """``bench.py:91-111``'s synthetic LP graph, the same ``RandomState``
    draws in the same order: near-uniform rows with 10% of the edges on
    the first M/16 rows, uniform columns, values in [-0.5, 0.5), features
    with the sign columns of the LP features, random labels. Edges in the
    order drawn, as there."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, m, e).astype(np.int32)
    hot = rng.rand(e) < 0.1
    row[hot] = rng.randint(0, m // 16, hot.sum()).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    val = rng.rand(e).astype(np.float32) - 0.5
    c_feas = rng.rand(m, 8).astype(np.float32) - 0.5
    v_feas = rng.rand(n, 8).astype(np.float32) - 0.5
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    return BipartiteGraph(row=row, col=col, val=val, c_feas=c_feas,
                          v_feas=v_feas,
                          y_s=rng.randint(0, 3, m).astype(np.int32),
                          y_t=rng.randint(0, 3, n).astype(np.int32))


def make_tiny_graph(seed: int = 0, m: int = 12, n: int = 20,
                    e: int = 60) -> BipartiteGraph:
    """``bench.py:114-130``'s tiny graph for counting traversals, the same
    draws in the same order."""
    rng = np.random.RandomState(seed)
    c_feas = rng.rand(m, 8).astype(np.float32) - 0.5
    v_feas = rng.rand(n, 8).astype(np.float32) - 0.5
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    return BipartiteGraph(row=rng.randint(0, m, e).astype(np.int32),
                          col=rng.randint(0, n, e).astype(np.int32),
                          val=rng.rand(e).astype(np.float32) - 0.5,
                          c_feas=c_feas, v_feas=v_feas,
                          y_s=rng.randint(0, 3, m).astype(np.int32),
                          y_t=rng.randint(0, 3, n).astype(np.int32))


def count_traversals(model, g: BipartiteGraph, input_agg: bool) -> int:
    """The semantic edge traversals a step and edge of ``model`` on ``g``
    (``bench.py:133-185`` with ``:301-319``): one train step on the CPU
    with the calls of the SpMM's and of ``gen_agg_fwd``'s wrappers counted
    (each call is one launch on the card). A traversal is one pass over
    the edges: an SpMM direction, forward or backward, for the GraphConv
    archs; for GEN, the forward aggregation (``gen_agg_fwd``, JAX's
    ``gather_src`` forward) and its sources' gradient (the SpMM over the
    transpose ordering, ``gather_src``'s backward; ``gen_agg_bwd`` belongs
    to the same traversal). With ``input_agg`` and a model whose input conv
    reads the cache, the cached input conv's 2 traversals count as
    delivered, as ``bench.py`` counts them."""
    gt = train_graph(model, g, "cpu", input_agg=input_agg)
    optimizer = make_optimizer(model.parameters(), "adam")
    n = {"calls": 0}
    real_spmm, real_fwd = spmm_mod.spmm_csr, gen_agg_mod.gen_agg_fwd

    def spmm(*a, **kw):
        n["calls"] += 1
        return real_spmm(*a, **kw)

    def fwd(*a, **kw):
        n["calls"] += 1
        return real_fwd(*a, **kw)

    spmm_mod.spmm_csr, gen_agg_mod.gen_agg_fwd = spmm, fwd
    try:
        train_step(model, optimizer, gt, LOSS_REGISTRY["balanced"],
                   torch.Generator().manual_seed(0))
    finally:
        spmm_mod.spmm_csr, gen_agg_mod.gen_agg_fwd = real_spmm, real_fwd
    return n["calls"] + (2 if gt.in_agg_c is not None else 0)


def _timed_calls(step, gt, n_warmup: int, n_steps: int, acc_on) -> tuple:
    """``n_warmup`` calls of ``n_steps`` steps, then 3 timed calls, each
    ended by a host read of its last loss; returns the timed calls'
    seconds a step and the last call's losses."""
    for _ in range(n_warmup):
        losses, _ = step(gt, lr=LR, acc_on=acc_on, k=n_steps)
    float(losses[-1])
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses, _ = step(gt, lr=LR, acc_on=acc_on, k=n_steps)
        float(losses[-1])
        times.append((time.perf_counter() - t0) / n_steps)
    return times, losses.tolist()


def measure(knobs: Knobs, device: torch.device, g: BipartiteGraph,
            n_warmup: int = 2, n_steps: int = STEPS_PER_CALL) -> tuple:
    """``bench.py:187-233``: the configured model (weights from seed 0)
    with Adam as the trainer builds it, the input cache where the model
    reads it, ``n_steps`` steps a call through
    ``make_scan_train_step(stacked=False)`` (dropout from a generator
    seeded 0); returns the 3 timed calls' seconds a step and the last
    call's losses."""
    model = build_model(knobs.arch_string(),
                        generator=torch.Generator().manual_seed(0)).to(device)
    gt = train_graph(model, g, device, input_agg=knobs.cache_in_agg)
    optimizer = make_optimizer(model.parameters(), "adam", LR,
                               capturable=device.type == "cuda")
    step = make_scan_train_step(
        model, "balanced", optimizer, stacked=False,
        generator=torch.Generator(device=device).manual_seed(0))
    return _timed_calls(step, gt, n_warmup, n_steps,
                        [knobs.step_acc] * n_steps)


@dataclasses.dataclass
class PlainSpmmGraph(GraphTensors):
    """A graph whose convs aggregate with the SpMM's plain version
    (``ops/spmm.py spmm_csr_plain``: ``index_select``, a product and
    ``index_add_``), called explicitly on whatever device the graph is,
    its backward autograd's: the naive direct port, the baseline
    ``bench.py:236-283`` measures. It carries no input cache."""

    def apply_conv(self, conv, left, right, input_conv: bool = False):
        agg_c = spmm_mod.spmm_csr_plain(self.rowptr, self.col, self.val_r,
                                        right)
        agg_v = spmm_mod.spmm_csr_plain(self.colptr, self.row, self.val_c,
                                        left)
        return conv.right2left(agg_c, left), conv.left2right(agg_v, right)


def measure_baseline(knobs: Knobs, device: torch.device, g: BipartiteGraph,
                     n_warmup: int = 1, n_steps: int = 2) -> float:
    """The naive direct port, measured live (``bench.py:236-283``):
    GCN_FC(8,8,hids,depth=3) in fp32, no input cache, each aggregation the
    plain ``index_add_`` SpMM (:class:`PlainSpmmGraph`), the same step and
    timing as :func:`measure`; returns the best of the 3 timed calls'
    seconds a step."""
    model = build_model(f"GCN_FC(8,8,hids={knobs.hids},depth=3,"
                        "dtype='float32')",
                        generator=torch.Generator().manual_seed(0)).to(device)
    gt = train_graph(model, g, device, input_agg=False)
    plain = PlainSpmmGraph(**{f.name: getattr(gt, f.name)
                              for f in dataclasses.fields(gt)})
    optimizer = make_optimizer(model.parameters(), "adam", LR,
                               capturable=device.type == "cuda")
    step = make_scan_train_step(
        model, "balanced", optimizer, stacked=False,
        generator=torch.Generator(device=device).manual_seed(0))
    times, _ = _timed_calls(step, plain, n_warmup, n_steps,
                            [knobs.step_acc] * n_steps)
    return min(times)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its name alone where
    nvidia-smi cannot be run), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(index)


def run(knobs: Knobs, device: torch.device) -> dict:
    """The benchmark's JSON object (module docstring), on ``bench.py``'s
    graph (seed 0)."""
    g = make_graph(0, knobs.edges, knobs.cons, knobs.vars)
    per_edge = SPMM_PER_EDGE
    if not knobs.flagship:
        # counted on the model without remat: its recompute is overhead,
        # not work delivered (bench.py:295-298)
        model = build_model(knobs.arch_string(hids=16),
                            generator=torch.Generator().manual_seed(0))
        per_edge = count_traversals(model, make_tiny_graph(),
                                    knobs.cache_in_agg)
    times, losses = measure(knobs, device, g)
    e = knobs.edges
    value = e * per_edge / min(times)
    out = {
        "metric": METRIC,
        "value": value,
        "unit": "edges/s",
        "vs_baseline": None,
        "baseline_edges_s": None,
        "baseline_source": "none",
        "spread": {k: e * per_edge / t for k, t in
                   zip(("min", "median", "max"),
                       (max(times), sorted(times)[1], min(times)))},
        "step_acc": int(knobs.step_acc),
    }
    if knobs.measure_baseline:
        baseline = e * SPMM_PER_EDGE / measure_baseline(knobs, device, g)
        out.update(vs_baseline=value / baseline, baseline_edges_s=baseline,
                   baseline_source="measured")
    if not knobs.flagship:
        out["arch"] = f"{knobs.arch}(hids={knobs.hids},depth={knobs.depth})"
        out["traversals_per_edge"] = per_edge
        if "GEN" in knobs.arch:
            out["gen_max_mode"] = "seg"
    out.update(device=device_label(device), steps_per_call=STEPS_PER_CALL,
               step_s=times, losses=losses)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=os.environ.get("BENCH_DEVICE",
                                                       "cuda"),
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(Knobs.from_env(), device)), flush=True)
    return 0


if __name__ == "__main__":
    main()
