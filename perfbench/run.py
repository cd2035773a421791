"""One run of one cell.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

1. Set-up (``setup_s``, from the process's start): the imports, the
   device's context, the cell's LPs drawn from ``--seed``, the weights
   drawn on the card, the program's model, optimizer and graph tensors
   (``system.py``), and its first training steps, which build every
   kernel the window launches and are the steps the check compares; the
   result line's ``setup_split_s`` gives the seconds of each of these.
2. The window: training steps for ``--seconds``, each ending in the host
   read of its loss, the same object stepping on; with ``--trace 1`` the
   first steps of the window profiled (a warm-up round, then the
   recorded steps).
3. The check: once the window has closed and the peak of device memory
   is read, the program freed and the plain reference run over the same
   first steps (``check.py``).
4. The result: each number compared beside its limit as the last lines
   of standard error, and one JSON line as the last of standard output.

Exits with 2 and no result without the CUDA devices the cell asks for,
and with 3 and no result if the process holds a module of JAX or of the
JAX package when the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

from . import (check, counts, lpgen, manifest, metrics, seeds, system, trace,
               weights)
from .guard import jax_modules
from .reference import common, family as reference_family

_T0 = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``), or since
    this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device: torch.device, warmup: int, active: int):
    """The device's activity only (``trace.py``); the host's on the CPU,
    where there is no device."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU],
        schedule=torch.profiler.schedule(wait=0, warmup=warmup,
                                         active=active, repeat=1))


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Window:
    """The measured window: training steps for ``seconds``, the first
    ``warm + active`` of them under the profiler when ``profile`` is
    ``(warm, active)``: an unrecorded warm-up round, then the recorded
    steps, whose span is taken on the host's clock."""

    def __init__(self, sut, order, lps, seconds: float, device,
                 profile: tuple[int, int] | None):
        self.steps = self.failed = self.edges = 0
        self.recorded: list[int] = []
        t0 = time.perf_counter()
        if profile is not None:
            warm, active = profile
            with _profiler(device, warm, active) as prof:
                for k in range(warm + active):
                    if k == warm:
                        t_rec = time.perf_counter()
                    i = self._step(sut, order, lps)
                    if k >= warm:
                        self.recorded.append(i)
                        self.span_s = time.perf_counter() - t_rec
                    prof.step()
            self.device_ops, self.host_ops = trace.from_profiler(prof)
        while self.steps == 0 or time.perf_counter() - t0 < seconds:
            self._step(sut, order, lps)
        self.seconds = time.perf_counter() - t0

    def _step(self, sut, order, lps) -> int:
        i = order.next()
        loss = sut.step(i)
        self.steps += 1
        self.edges += lps[i].nnz
        self.failed += not math.isfinite(loss)
        return i


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device) -> dict:
    """One run of ``cell`` on ``device`` (the CLI's ``cuda``; the tests'
    ``cpu``): the result line's object."""
    cfg, traffic = cell.config, cell.traffic
    marks = [("imports", process_age())]
    torch.empty(0, device=device)
    _sync(device)
    marks.append(("device_context", process_age()))
    lps = lpgen.draw_lps(traffic, seed)
    if max(lp.nnz for lp in lps) > int(traffic["edge_num_thresh"]):
        raise ValueError("the cells train full graphs: an LP's nonzeros "
                         "must not pass edge_num_thresh")
    marks.append(("draws", process_age()))
    family = reference_family(cfg["family"])
    w0 = weights.draw(family.param_spec(cfg), seed, device)
    _sync(device)
    marks.append(("weights", process_age()))
    dropout_seed = seeds.derive(seed, "dropout")
    sut = system.Trainer(cfg, lps, w0, dropout_seed, device)
    _sync(device)
    t = process_age()
    marks += [("model", t - sut.graphs_s), ("graphs", t)]
    order = lpgen.StepOrder(len(lps), seed)
    first = [order.next() for _ in range(int(traffic["warmup_steps"]))]
    prog = sut.first_steps(first, w0)
    w0 = {k: v.cpu() for k, v in w0.items()}
    _sync(device)
    setup_s = process_age()
    marks.append(("first_steps", setup_s))
    setup_split = {name: t - (marks[k - 1][1] if k else 0.0)
                   for k, (name, t) in enumerate(marks)}

    win = Window(sut, order, lps, seconds, device,
                 (int(traffic["profile_warmup_steps"]),
                  int(traffic["profile_steps"])) if traced else None)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    common.exact_fp32()
    try:
        ref = common.train_steps(
            family, cfg, {k: v.to(device) for k, v in w0.items()}, lps,
            first, common.FedMasks(prog.masks))
    except common.MaskMismatch as e:
        print(f"perfbench: the reference cannot follow the program: {e}",
              file=sys.stderr)
        ref = None
    ok, compared = check.judge(check.readings(prog, ref),
                               check.limits(cell.name))

    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak}
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    if traced:
        tr = trace.Trace(win.device_ops, win.host_ops, win.span_s,
                         len(win.recorded),
                         [counts.Shape.of(lps[i]) for i in win.recorded],
                         cfg, trace.peaks_for(kind))
        values = {m["name"]: metrics.reader(m["name"]).read(tr)
                  for m in cell.per_layer}
        shown = cell.per_layer
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.span_s
    else:
        values = {"setup_s": setup_s,
                  "train_edges_per_s": win.edges / win.seconds,
                  "peak_device_gib": None if peak is None else peak / 2 ** 30}
        shown = cell.end_to_end
    line = {"correct": bool(ok and win.failed == 0),
            "attempted": win.steps, "failed": win.failed,
            "metrics": {m["name"]: {"value": values[m["name"]],
                                    "unit": m["unit"]}
                        for m in shown if values.get(m["name"]) is not None},
            "device": dev}
    if traced:
        line["breakdown"] = trace.breakdown(tr)
    line["setup_split_s"] = setup_split
    line["compared"] = compared
    return line


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))
    found = jax_modules()
    if found:
        print(f"perfbench: the process holds JAX modules: {found}",
              file=sys.stderr)
        return 3
    print("setup_split_s " + " ".join(
        f"{k} {v!r}" for k, v in line["setup_split_s"].items()),
        file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
