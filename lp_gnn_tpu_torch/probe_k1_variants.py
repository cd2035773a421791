"""K1's signalled rank form against variants of its own kernel, a card a
rank.

    python -m lp_gnn_tpu_torch.probe_k1_variants [--variants NAME ...]

Needs RANKS cards (one process a card, NCCL) and ``nvcc``. Each variant is
a copy of ``ops/csrc/halo_a2a.cu`` with one change of VARIANTS (each a text
substitution that must apply exactly once), built with the package's nvcc
flags into a library of its own; ``kernel`` is the source as it is. Then
RANKS processes of this module under the LP_GNN_DIST_* contract
(``parallel/mesh.py init_distributed``: rank r on cuda:r) run, for each
variant in turn (its library loaded in place of the package's, the
windows made anew), the rank route's exchanges through
``parallel/halo.py halo_all_to_all_ranks`` at the bench graph's halo
(K = RANKS, Bh = BENCH_BH) for each D of DIMS, bf16, and record:

- ``exact``: the result against the stacked plain version, bit for bit;
- ``ms``: CUDA events around ITERS back-to-back exchanges, every rank at
  once (``chip_smoke.py``'s ``with_sync_ms``);
- ``launch_ms_median``, ``launch_ms_range``: CUDA events around each of
  LAUNCHES exchanges on the rank's stream (the one kernel and any wait in
  it for a peer), and ``host_enqueue_ms`` the host's ms an exchange to
  enqueue them.

Rank 0 prints one JSON line: ``device`` (the card's name and power limit),
``ranks``, ``Bh`` and, for each variant and D, every rank's figures.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import os.path as osp
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .bench import device_label
from .ops import _build

RANKS = 4
BENCH_BH = 30_056   # the bench graph's halo width at K=4
DIMS = (1024, 8)
ITERS = 30
LAUNCHES = 15
WARM = 3

# the remote pairs round robin over the CTAs (halo_pairs_kernel's order),
# then the own block and the copy-outs, instead of the steps
_ROUND_ROBIN = r'''
__global__ void __launch_bounds__(kThreads)
halo_rank_signalled_kernel(const __grid_constant__ RankArgs a) {
  __shared__ unsigned long long seen;
  if (threadIdx.x == 0) seen = 0;
  __syncthreads();
  const long long G = gridDim.x, b = blockIdx.x, n16 = a.n16;
  const long long chunks = (n16 + kChunk - 1) / kChunk;
  const int K = a.K, me = a.me, w = a.w;
  char* own = a.base[me];
  const long long n = K - 1;
  if (n > 0) {
    const long long j = b % n, c0 = b / n, stride = (G - j + n - 1) / n;
    if (c0 < chunks) {
      const int q = static_cast<int>((me + 1 + j) % K);
      if (!wait_for(counter(own, a.window_bytes, w, 1, q), a.done_target, a, &seen)) return;
      copy_chunks(a.src + q * n16, window_of(a.base[q], a.window_bytes, w) + me * n16, n16,
                  c0, stride);
      publish(counter(a.base[q], a.window_bytes, w, 0, me), (chunks - c0 + stride - 1) / stride);
    }
  }
  const long long j = b % K, c0 = b / K, stride = (G - j + K - 1) / K;
  if (c0 >= chunks) return;
  if (j == 0) {
    copy_chunks(a.src + me * n16, a.out + me * n16, n16, c0, stride);
    return;
  }
  const int p = static_cast<int>((me - j + K) % K);
  if (!wait_for(counter(own, a.window_bytes, w, 0, p), a.arrival_target, a, &seen)) return;
  copy_chunks<false>(window_of(own, a.window_bytes, w) + p * n16, a.out + p * n16, n16, c0,
                     stride);
  publish(counter(a.base[p], a.window_bytes, w, 1, me), (chunks - c0 + stride - 1) / stride);
}

'''
_LOOKOUT = ("if (v == 0 && slot != last && slot % gridDim.x == blockIdx.x) {")
# name -> [(text of the kernel source, its replacement), ...]
VARIANTS = {
    "kernel": [],
    # every spinning CTA reads the host's abort words every 64 polls
    "reads_every_64": [(_LOOKOUT, "if (v == 0 && (++last & 63) == 0) {")],
    # no CTA reads them (the look-out's cost)
    "no_lookout": [(_LOOKOUT, "if (false) {")],
    # a system-scope fence in every thread before each publish
    "fence_every_thread": [(
        "void publish(unsigned long long* word, unsigned long long n) {\n"
        "  __syncthreads();",
        "void publish(unsigned long long* word, unsigned long long n) {\n"
        "  __threadfence_system();\n  __syncthreads();")],
    # at most 4 us between polls instead of 1
    "backoff_4096": [("kMaxBackoff = 1024;", "kMaxBackoff = 4096;")],
    "pairs_round_robin": [
        ("  if (grid > chunks) grid = chunks;",
         "  if (grid > K * chunks) grid = K * chunks;")],
}


def variant_source(name: str, src: str) -> str:
    """The kernel source with variant ``name``'s changes; each must apply
    exactly once."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{src.count(old)} times in halo_a2a.cu")
        src = src.replace(old, new)
    if name == "pairs_round_robin":
        start = src.index("// Rank me's exchange.")
        end = src.index("long long grid_x(")
        src = src[:start] + _ROUND_ROBIN + src[end:]
    return src


def build(names: list[str], out_dir: str) -> dict[str, str]:
    """Each variant's library in ``out_dir``, one nvcc each, all started
    together; returns name -> path."""
    src = (_build.SRC_DIR / "halo_a2a.cu").read_text()
    procs = {}
    for n in names:
        cu = osp.join(out_dir, f"{n}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(n, src))
        lib = osp.join(out_dir, f"lib{n}.so")
        procs[n] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR),
             "-o", lib, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"probe_k1_variants: nvcc failed for {n}:\n{log}")
        libs[n] = lib
    return libs


def rank_case(d: int, dev: torch.device) -> dict:
    """This rank's figures at (K*Bh, d) bf16 with the library loaded."""
    from .parallel import halo
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    gen = torch.Generator().manual_seed(d)
    bufs = torch.randn(k, k * BENCH_BH, d, generator=gen).to(torch.bfloat16)
    want = halo.halo_all_to_all_plain(bufs)[me]
    buf = bufs[me].to(dev)
    for _ in range(WARM):
        got = halo.halo_all_to_all_ranks(buf)
    exact = torch.equal(got.cpu(), want)
    torch.cuda.synchronize(dev)
    torch.distributed.barrier()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(ITERS):
        halo.halo_all_to_all_ranks(buf)
    t1.record()
    t1.synchronize()
    torch.distributed.barrier()
    ev = []
    h0 = time.perf_counter()
    for _ in range(LAUNCHES):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        halo.halo_all_to_all_ranks(buf)
        pair[1].record()
        ev.append(pair)
    host = (time.perf_counter() - h0) * 1e3 / LAUNCHES
    torch.cuda.synchronize(dev)
    spans = [a.elapsed_time(b) for a, b in ev]
    (win,) = halo._WINDOWS.values()
    return {"exact": exact, "form": win.form,
            "ms": t0.elapsed_time(t1) / ITERS,
            "launch_ms_median": float(np.median(spans)),
            "launch_ms_range": [float(min(spans)), float(max(spans))],
            "host_enqueue_ms": host}


def rank_main(out_dir: str) -> None:
    """One rank: the variants' libraries its parent wrote to
    ``out_dir/libs.json`` in, its figures to ``out_dir/rank{r}.json``
    out."""
    from .parallel import halo
    from .parallel.mesh import init_distributed, leave_distributed
    with open(osp.join(out_dir, "libs.json")) as f:
        libs = json.load(f)
    dev, created = init_distributed(torch.device("cuda"))
    real, out = _build.load, {}
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            _build.load = lambda _name, _lib=lib: _lib
            halo.release_windows()
            out[name] = {str(d): rank_case(d, dev) for d in DIMS}
        halo.release_windows()
    finally:
        _build.load = real
        leave_distributed(created)
    rank = os.environ["LP_GNN_DIST_PROC_ID"]
    with open(osp.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--out_dir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.out_dir is not None:   # one rank
        return rank_main(args.out_dir)
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        raise SystemExit(f"probe_k1_variants needs {RANKS} cards, a card a "
                         "rank")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="probe_k1_variants_") as tmp:
        _build.build_all(["halo_a2a"])
        with open(osp.join(tmp, "libs.json"), "w") as f:
            json.dump(build(args.variants, tmp), f)
        cmd = [sys.executable, "-m", "lp_gnn_tpu_torch.probe_k1_variants",
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
            raise SystemExit(f"probe_k1_variants: rank exit codes {rcs}")
        ranks = []
        for r in range(RANKS):
            with open(osp.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    print(json.dumps({
        "device": device_label(torch.device("cuda")), "ranks": RANKS,
        "Bh": BENCH_BH, "dtype": "bfloat16", "iters": ITERS,
        "variants": {n: {str(d): [rk[n][str(d)] for rk in ranks]
                         for d in DIMS} for n in args.variants}}))


if __name__ == "__main__":
    main()
