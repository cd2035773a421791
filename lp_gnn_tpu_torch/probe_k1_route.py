"""Where the time of one exchange of K1's rank form goes, on the host.

    python -m lp_gnn_tpu_torch.probe_k1_route [--device cuda]

Starts RANKS processes of this module under the LP_GNN_DIST_* contract
(``parallel/mesh.py init_distributed``; ranks that share one card join
over gloo), each holding one shard's (K*Bh, D) bf16 halo buffer, K =
RANKS, Bh = BENCH_BH, the bench graph's halo width at K=4
(``chip_smoke.py``'s ``edge_ranks`` phase). For each D of DIMS, every
rank makes ITERS exchanges through ``parallel/halo.py
halo_all_to_all_ranks`` after 2 untimed ones, each followed by a
synchronise of the card so that an exchange's host time is whole, and
records:

- ``exchange_ms``: the host's wall from the exchange's call to the end of
  its card work, a mean over the exchanges;
- ``parts_ms`` and ``parts_calls``: the host's time and calls an exchange
  inside each host collective and synchronise (``torch.distributed``'s
  ``barrier``, ``all_gather``, ``all_gather_object``, ``all_to_all_single``;
  ``torch.cuda.Stream.synchronize``, ``torch.cuda.synchronize``) and in
  ``torch.cuda.Event.query``, wrapped for the timed exchanges only (the
  synchronise after each exchange is the probe's and is not counted);
- ``events_ms``: CUDA events around ITERS back-to-back exchanges with no
  synchronise between them (``chip_smoke.py``'s ``with_sync_ms``).

Rank 0 prints one JSON line: ``device`` (the card's name and power limit,
or ``cpu``), ``ranks``, ``Bh`` and, for each D, every rank's figures. The
module reads only what every revision of the rank form offers, so the same
file measures an older checkout of the package when copied into it, as
the split of the host route's exchange in PERF.md was measured.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import socket
import subprocess
import sys
import tempfile
import time

import torch

from .bench import device_label
from .device import resolve_device

RANKS = 4           # K, the ranks; they share the card
BENCH_BH = 30_056   # the bench graph's halo width at K=4
DIMS = (1024, 8)
ITERS = 20
WARM = 2
WRAPPED = [(torch.distributed, n) for n in (
    "barrier", "all_gather", "all_gather_object", "all_to_all_single")] + [
    (torch.cuda.Stream, "synchronize"), (torch.cuda, "synchronize"),
    (torch.cuda.Event, "query")]


class HostParts:
    """While entered, each of WRAPPED accumulates its host time (s) and
    calls by name."""

    def __init__(self):
        self.time, self.calls, self.saved = {}, {}, []

    def __enter__(self):
        for mod, name in WRAPPED:
            real = getattr(mod, name)
            key = f"{mod.__name__}.{name}"
            self.saved.append((mod, name, real))

            def timed(*a, _real=real, _key=key, **kw):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **kw)
                finally:
                    self.time[_key] = self.time.get(_key, 0.0) + \
                        time.perf_counter() - t0
                    self.calls[_key] = self.calls.get(_key, 0) + 1
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def rank_case(bh: int, d: int, iters: int, dev: torch.device) -> dict:
    """This rank's figures of ``iters`` exchanges at (K*Bh, d) bf16."""
    from .parallel.halo import halo_all_to_all_ranks
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    gen = torch.Generator().manual_seed(d)
    buf = torch.randn(k * bh, d, generator=gen).to(torch.bfloat16).to(dev)
    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    for _ in range(WARM):
        halo_all_to_all_ranks(buf)
    sync()
    torch.distributed.barrier()
    walls, parts = [], HostParts()
    for _ in range(iters):
        with parts:
            t0 = time.perf_counter()
            halo_all_to_all_ranks(buf)
        sync()
        walls.append(time.perf_counter() - t0)
    events_ms = None
    if card:
        torch.distributed.barrier()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(iters):
            halo_all_to_all_ranks(buf)
        ev[1].record()
        ev[1].synchronize()
        events_ms = ev[0].elapsed_time(ev[1]) / iters
    return {"exchange_ms": sum(walls) / iters * 1e3,
            "exchange_ms_each": [w * 1e3 for w in walls],
            "parts_ms": {n: t / iters * 1e3 for n, t in parts.time.items()},
            "parts_calls": {n: c / iters for n, c in parts.calls.items()},
            "events_ms": events_ms}


def rank_main(out_dir: str) -> None:
    """One rank: the sizes its parent wrote to ``out_dir/sizes.json`` in,
    its figures to ``out_dir/rank{r}.json`` out."""
    from .parallel.mesh import init_distributed, leave_distributed
    with open(osp.join(out_dir, "sizes.json")) as f:
        sizes = json.load(f)
    dev, created = init_distributed(resolve_device(sizes["device"]))
    try:
        out = {str(d): rank_case(sizes["bh"], d, sizes["iters"], dev)
               for d in sizes["dims"]}
    finally:
        leave_distributed(created)
    rank = os.environ["LP_GNN_DIST_PROC_ID"]
    with open(osp.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out_dir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.out_dir is not None:   # one rank
        return rank_main(args.out_dir)
    dev = resolve_device(args.device)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="probe_k1_") as tmp:
        with open(osp.join(tmp, "sizes.json"), "w") as f:
            json.dump({"bh": BENCH_BH, "dims": list(DIMS), "iters": ITERS,
                       "device": args.device}, f)
        cmd = [sys.executable, "-m", "lp_gnn_tpu_torch.probe_k1_route",
               "--out_dir", tmp]
        procs = [subprocess.Popen(cmd, cwd=root, env=dict(
            os.environ, LP_GNN_DIST_COORD=f"localhost:{port}",
            LP_GNN_DIST_NPROCS=str(RANKS),
            LP_GNN_DIST_PROC_ID=str(r))) for r in range(RANKS)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if any(rcs):
            raise SystemExit(f"probe_k1_route: rank exit codes {rcs}")
        ranks = []
        for r in range(RANKS):
            with open(osp.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    print(json.dumps({
        "device": device_label(dev), "ranks": RANKS, "Bh": BENCH_BH,
        "dtype": "bfloat16", "iters": ITERS,
        "cases": {str(d): [rk[str(d)] for rk in ranks] for d in DIMS}}))


if __name__ == "__main__":
    main()
