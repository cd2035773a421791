"""Produce ``SCALING_torch_r{NN}.json``: the edge-partitioned step time at
1, 2, 4, ... shards for both collective modes, and the banded graph's halo
wire volume (the twin of ``scripts/make_scaling_artifact.py``).

    python -m lp_gnn_tpu_torch.make_scaling_artifact --round 17 \\
        [--devices 8] [--out_dir .] [--device cuda] [--edges N]

Each mode is one subprocess of ``python -m lp_gnn_tpu_torch.bench_scaling
--devices D`` (``--halo`` for the halo mode), outside any process group,
with ``--device`` and, where given, ``--edges`` passed through (a smaller
graph than bench_scaling's 200,000 edges); its last line is read. Every shard
count runs all its shards in that one process, stacked on one device, so
the step times check the distributed program's function and show the
collectives' overhead on one card: they are not a scaling claim, as the
JAX script says of its virtual mesh. The wire volume is
``partition_graph(..., halo=True)`` of the script's banded graph at 2, 4
and 8 shards, by the port's own partition, with the script's keys.

The artifact goes to ``--out_dir`` (the current directory by default)
under a name of the port's own, so it never overwrites the JAX package's
``SCALING_r{NN}.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np

from .data.dataset import BipartiteGraph
from .parallel.edge_partition import partition_graph

# the package's parent: ``python -m`` finds the package from there
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def run_mode(devices: int, halo: bool, device: str,
             edges: int | None = None) -> dict:
    """One ``bench_scaling`` subprocess over widths 1..devices (doubling)
    for one collective mode; its JSON line (``step_time_s`` by width)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LP_GNN_DIST_")}
    cmd = [sys.executable, "-m", "lp_gnn_tpu_torch.bench_scaling",
           "--devices", str(devices), "--device", device]
    if edges is not None:
        cmd += ["--edges", str(edges)]
    out = subprocess.run(cmd + (["--halo"] if halo else []), cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=3600)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}: exit {out.returncode}\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def wire_volume() -> dict:
    """Halo vs all-gather rows moved per shard per layer on the banded
    mirp-like graph (the script's draws and keys)."""
    rng = np.random.RandomState(0)
    m, n, e, band = 2048, 4096, 16384, 64
    row = rng.randint(0, m, e).astype(np.int32)
    center = (row.astype(np.int64) * n) // m
    col = np.clip(center + rng.randint(-band // 2, band // 2 + 1, e),
                  0, n - 1).astype(np.int32)
    g = BipartiteGraph(row=row, col=col,
                       val=(rng.rand(e).astype(np.float32) - 0.5),
                       c_feas=rng.rand(m, 8).astype(np.float32),
                       v_feas=rng.rand(n, 8).astype(np.float32),
                       y_s=rng.randint(0, 3, m).astype(np.int32),
                       y_t=rng.randint(0, 3, n).astype(np.int32))
    out = {}
    for d in (2, 4, 8):
        dg = partition_graph(g, d, halo=True)
        out[str(d)] = {
            "halo_rows_per_shard_layer": 2 * d * dg.bh,
            "allgather_rows_per_shard_layer": 2 * dg.n_pad,
            "ratio": round(d * dg.bh / float(dg.n_pad), 4),
        }
    return {"graph": f"banded m={m} n={n} e={e} band={band} "
                     "(tests/_banded_pg construction)",
            "unit": "feature rows moved per shard per layer (x F floats)",
            "by_shards": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--round", type=int, required=True)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--out_dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--edges", type=int, default=None,
                    help="passed to bench_scaling (its default if unset)")
    args = ap.parse_args(argv)
    steps, cfg, label = {}, None, None
    for halo in (False, True):
        cell = run_mode(args.devices, halo, args.device, args.edges)
        cfg = cfg or {k: cell[k] for k in ("edges",) if k in cell}
        label = cell["device"]
        key = "halo" if halo else "all-gather"
        steps[key] = cell["step_time_s"]
        print(f"{key}: {steps[key]}", flush=True)
    art = {
        "round": args.round,
        "mode": f"one card ({label}), every shard count's shards in one "
                "process (bench_scaling mode one-card)",
        "caveat": "step times are functional validation of the distributed "
                  "program and show the collectives' overhead with all "
                  "shards on one card, NOT a hardware scaling claim. The "
                  "halo win is wire volume (below, held to the JAX "
                  "package's in tests).",
        "step_time_s": steps,
        "config": cfg,
        "wire_volume_banded_mirp_like": wire_volume(),
    }
    os.makedirs(args.out_dir, exist_ok=True)
    out = osp.join(args.out_dir, f"SCALING_torch_r{args.round:02d}.json")
    with open(out, "w") as f:
        json.dump(art, f, indent=1)
    print("wrote", out, flush=True)
    return 0


if __name__ == "__main__":
    main()
