"""Is the GEN softmax aggregation at the card's memory and gather floor?
(The twin of ``scripts/probe_gen_floor.py``.)

    python -m lp_gnn_tpu_torch.probe_gen_floor [--device cuda]

At the script's shapes and knobs (``PROBE_EDGES`` 1,000,000,
``PROBE_CONS`` 65,536, ``PROBE_VARS`` 131,072, ``PROBE_HIDS`` 256; bf16)
and from its draws (``RandomState(0)``, in its order) it times the floors
one GEN direction's edge passes are made of:

  1. the HBM stream read of the (E, D) edge tensor (its fp32 sum);
  2. the row gather (E, D) <- (N, D): ``torch.index_select`` and the
     port's gather kernel (``ops/gather.py gather_rows``);
  3. the sorted segment max (E, D) -> (M, D) (``torch.segment_reduce``);
  4. the sorted segment sum with fp32 sums, 4a at (E, D), 4b over the
     concatenation of the edges and their squares, (E, 2D);
  5. the gather forward and backward: ``gather_rows`` on the table, then
     the port's ``ops/gen_agg.py gather_backward`` (the SpMM over the
     transpose ordering) on a cotangent of the gathered shape, the port's
     form of ``lp_gnn_tpu/ops/spmm.py:252 gather_src`` and its VJP;

and against them one GEN direction (``models/gen.py GENConv``: v2c, the
constraints from the variables, over ``gen_agg_fwd`` and, for x's
gradient, ``gen_agg_bwd`` and the gather's SpMM), forward and forward +
backward (the gradient for x of the output's fp32 sum, as the script's
``jax.grad``), and the two aggregation kernels alone beside their bounds
(the bytes of ``chip_smoke.py``'s kernel rows). The direction's weights
come from seed 0 in ``gen_dir_init``'s layout (no ``lin_src`` /
``lin_dst`` at equal widths). The script passes the gather's backward the
inverse of the transpose permutation; the port passes the permutation
itself, which gives the gradient, at the same cost.

Each op is timed alone with CUDA events (``probe_spmm.time_ms``: 10 calls
after 2), not as the slope of a ``lax.scan``: ``PROBE_RLO`` /
``PROBE_RHI`` have no counterpart, and no full-output reduce is added to
an op. The port has one GEN mode (``LP_GNN_GEN_FUSE`` has no
counterpart: ``"gen_modes": ["port"]``). ``PROBE_ONLY=gen`` skips no
floor: the port measures them anyway (``"floors_measured": true``); the
script's floors from its own chip have no place here.

Prints the script's human lines and its floor accounting (the fused
mode's formula, the gather floor the faster of probe 2's two), then one
JSON line: each probe's ``name``, ``ms``, ``bytes``, ``flops``,
``bound_ms``, ``bound_by`` and ``share_of_bound`` (bound / time; null on
the CPU), the port kernels' wrapper calls (``launches``), the accounting
and ``device``. A GEN row's bound counts its aggregation's fp32
operations, not its MLP's.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .bench import device_label
from .device import resolve_device
from .models.gen import GENConv
from .ops.gather import gather_rows
from .ops.gen_agg import (gather_backward, gen_agg_bwd, gen_agg_fwd,
                          padded_width)
from .probe_spmm import (FP32_FLOP_S, Probes, csr_ptr, gathered_bytes,
                         upload)

# fp32 operations an (edge, channel) of the aggregation (chip_smoke.py's
# GEN_FWD_OPS, GEN_BWD_OPS)
GEN_FWD_OPS, GEN_BWD_OPS = 10, 20


def knobs(env=os.environ) -> dict:
    """The script's environment knobs, with its defaults."""
    return {"E": int(env.get("PROBE_EDGES", 1_000_000)),
            "M": int(env.get("PROBE_CONS", 65_536)),
            "N": int(env.get("PROBE_VARS", 131_072)),
            "D": int(env.get("PROBE_HIDS", 256)),
            "only": env.get("PROBE_ONLY", "")}


# ------------------------------------------------------------------ ops
def stream_read(a: torch.Tensor) -> torch.Tensor:
    """Floor 1: one read of ``a`` (its fp32 sum)."""
    return torch.sum(a, dtype=torch.float32)


def segment_max(a: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Floor 3: ``jax.ops.segment_max`` over sorted segments of
    ``lengths`` rows; an empty segment is -inf, as there."""
    return torch.segment_reduce(a, "max", lengths=lengths, unsafe=True)


def segment_sum_f32(a: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Floor 4a: ``jax.ops.segment_sum(a.astype(f32))`` over sorted
    segments; an empty segment is 0."""
    return torch.segment_reduce(a.float(), "sum", lengths=lengths,
                                unsafe=True)


def fused_segment_sum_f32(a: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Floor 4b: the segment sum of ``concatenate([a, a * a], 1)`` in
    fp32, (M, 2D)."""
    return segment_sum_f32(torch.cat([a, a * a], dim=1), lengths)


def gather_fwd_bwd(x, ids, t_ptr, eperm, dpre):
    """Floor 5: ``gather_src``'s forward (``gather_rows``) and its VJP
    from the cotangent ``dpre`` (``gather_backward``)."""
    return gather_rows(x, ids), gather_backward(t_ptr, eperm, dpre,
                                                x.shape[1])


def gen_forward(conv: GENConv, graph: tuple, x, x_dst) -> torch.Tensor:
    """One GEN direction's forward (``gen_dir_apply``) over ``graph`` =
    (ptr, src, a, t_ptr, eperm), no gradient taken."""
    with torch.no_grad():
        return conv(*graph, x, x_dst)


def gen_input_grad(conv: GENConv, graph: tuple, x, x_dst) -> torch.Tensor:
    """The gradient for x of the direction's fp32 output sum (the
    script's ``jax.grad(loss)(x)``)."""
    xx = x.detach().requires_grad_(True)
    out = conv(*graph, xx, x_dst)
    (dx,) = torch.autograd.grad(out.float().sum(), xx)
    return dx


# ------------------------------------------------------------------ run
def run(k: dict, device: torch.device) -> dict:
    """The floors and the GEN direction (module docstring); returns the
    JSON object."""
    e, m, n, d = k["E"], k["M"], k["N"], k["D"]
    rng = np.random.RandomState(0)
    probe = Probes(device)
    label = device_label(device)
    print(f"device: {label}, E={e} M={m} N={n} D={d} dtype=bf16, each op "
          "timed alone" + (" (CUDA events)" if device.type == "cuda" else "")
          + (", PROBE_ONLY=gen: the floors are measured all the same"
             if k["only"] == "gen" else ""), flush=True)
    row = np.sort(rng.randint(0, m, e).astype(np.int32))
    col = rng.randint(0, n, e).astype(np.int32)
    x_src = upload(rng.rand(n, d).astype(np.float32) - 0.5, device,
                   torch.bfloat16)
    stream = upload(rng.rand(e, d).astype(np.float32) * 0.5, device,
                    torch.bfloat16)
    ids = torch.from_numpy(col).to(device)
    lengths = torch.from_numpy(np.bincount(row, minlength=m)).to(device)
    pass_gb = e * d * 2 / 1e9

    def floor(name, fn, n_bytes, **kw):
        s = probe(name, fn, n_bytes, **kw)
        print(f"{'':<48s} ({pass_gb / s:7.1f} GB/s per (E,D)-bf16-pass "
              "equivalent)")
        return s

    t_read = floor("1. HBM stream read (E,D) bf16",
                   lambda: stream_read(stream), e * d * 2 + 4,
                   library="sum")
    g_bytes = gathered_bytes(ids, d * 2)
    t_gather = min(
        floor("2. row gather (E,D) <- (N,D) table",
              lambda: torch.index_select(x_src, 0, ids), g_bytes,
              library="index_select"),
        floor("2. gather_rows kernel (E,D) <- (N,D)",
              lambda: gather_rows(x_src, ids), g_bytes,
              kernels={"gather_rows": 1}, kernel="gather_rows"))
    t_smax = floor("3. sorted segment_max (E,D)->(M,D)",
                   lambda: segment_max(stream, lengths),
                   e * d * 2 + m * 8 + m * d * 2, library="segment_reduce")
    t_ssum = floor("4a. sorted segment_sum (E,D)->(M,D) f32 acc",
                   lambda: segment_sum_f32(stream, lengths),
                   e * d * 2 + m * 8 + m * d * 4, library="segment_reduce")
    t_ssum2 = floor("4b. fused sorted segment_sum (E,2D) f32 acc",
                    lambda: fused_segment_sum_f32(stream, lengths),
                    e * d * 2 + m * 8 + m * 2 * d * 4,
                    library="cat, segment_reduce")
    del stream

    perm = np.argsort(col, kind="stable").astype(np.int32)
    t_ptr = torch.from_numpy(csr_ptr(col, n)).to(device)
    eperm = torch.from_numpy(perm).to(device)
    ld = padded_width(d, torch.bfloat16)
    dpre = torch.ones(e, ld, dtype=torch.bfloat16, device=device)
    bwd_bytes = (n + 1) * 4 + e * 8 + e * ld * 2 + n * ld * 2
    t_gfb = floor("5. gather_src fwd+bwd (E,D)",
                  lambda: gather_fwd_bwd(x_src, ids, t_ptr, eperm, dpre),
                  g_bytes + bwd_bytes,
                  kernels={"gather_rows": 1, "spmm_csr": 1},
                  kernel="gather_rows, spmm_csr")
    del dpre

    conv = GENConv(d, d, d, generator=torch.Generator().manual_seed(0))
    conv = conv.to(device).requires_grad_(False)   # x's gradient alone
    x_dst = upload(rng.rand(m, d).astype(np.float32) - 0.5, device,
                   torch.bfloat16)
    val = torch.from_numpy(rng.rand(e).astype(np.float32) - 0.5).to(device)
    ptr = torch.from_numpy(csr_ptr(row, m)).to(device)
    graph = (ptr, ids, val, t_ptr, eperm)
    s_used = int(np.unique(col).size)
    graph_bytes = (m + 1) * 4 + e * 8
    enc = (2 * d + 1) * 2
    fwd_bytes = graph_bytes + s_used * d * 2 + m * d * 2 + m * d * 2
    t_f = probe("6. GEN dir fwd (port)",
                lambda: gen_forward(conv, graph, x_src, x_dst), fwd_bytes,
                GEN_FWD_OPS * e * d, FP32_FLOP_S,
                kernels={"gen_agg_fwd": 1}, kernel="gen_agg_fwd")
    t_fb = probe("6. GEN dir fwd+bwd (port)",
                 lambda: gen_input_grad(conv, graph, x_src, x_dst),
                 fwd_bytes - m * d * 2 + (n + 1) * 4 + e * 4 + n * d * 2,
                 (GEN_FWD_OPS + GEN_BWD_OPS) * e * d, FP32_FLOP_S,
                 kernels={"gen_agg_fwd": 1, "gen_agg_bwd": 1, "spmm_csr": 1},
                 kernel="gen_agg_fwd, gen_agg_bwd, spmm_csr")
    print(f"   -> port: fwd = {t_f / t_read:.2f} read / "
          f"{t_f / t_gather:.2f} gather / {t_f / t_ssum:.2f} segsum "
          f"equivalents; fwd+bwd = {t_fb / t_read:.2f} read / "
          f"{t_fb / t_gather:.2f} gather / {t_fb / t_ssum:.2f} segsum")

    w, b, t = conv.encoder(torch.bfloat16)
    args = (ptr, ids, val, x_src, w, b, t)
    agg_bytes = graph_bytes + s_used * d * 2 + enc
    probe("7. gen_agg_fwd kernel (v2c)", lambda: gen_agg_fwd(*args),
          agg_bytes + 2 * m * d * 4, GEN_FWD_OPS * e * d, FP32_FLOP_S,
          kernels={"gen_agg_fwd": 1}, kernel="gen_agg_fwd")
    with torch.no_grad():
        aggr, lse = gen_agg_fwd(*args)
    probe.launches["gen_agg_fwd"] += 1
    g = torch.ones_like(aggr)
    probe("7. gen_agg_bwd kernel (v2c)",
          lambda: gen_agg_bwd(*args, g, aggr, lse),
          agg_bytes + 3 * m * d * 4 + e * ld * 2 + (2 * d + 1) * 4,
          GEN_BWD_OPS * e * d, FP32_FLOP_S,
          kernels={"gen_agg_bwd": 1}, kernel="gen_agg_bwd")

    print("\nfloor accounting: algorithm needs >= gather(xs) + segmax + "
          "segsum(E,2D) fwd; + cotangent gather (E,2D) + transpose segsum "
          "(E,D) + exp-bwd read bwd")
    need_f = t_gather + t_smax + t_ssum2
    need_fb = need_f + t_gather + t_ssum2 + t_gfb
    print(f"   sum-of-floors fwd ~= {need_f * 1e3:.1f} ms, "
          f"fwd+bwd ~= {need_fb * 1e3:.1f} ms")
    return {"probe": "probe_gen_floor", "device": label,
            "shapes": {"E": e, "M": m, "N": n, "D": d, "dtype": "bfloat16"},
            "gen_modes": ["port"], "probe_only": k["only"],
            "floors_measured": True,
            "timing": "CUDA events, each op alone" if device.type == "cuda"
                      else "host clock (CPU)",
            "accounting": {
                "need_fwd_ms": need_f * 1e3, "need_fwd_bwd_ms": need_fb * 1e3,
                "gen_fwd_ms": t_f * 1e3, "gen_fwd_bwd_ms": t_fb * 1e3,
                "fwd_read_equivalents": t_f / t_read,
                "fwd_gather_equivalents": t_f / t_gather,
                "fwd_segsum_equivalents": t_f / t_ssum,
                "fwd_bwd_read_equivalents": t_fb / t_read,
                "fwd_bwd_gather_equivalents": t_fb / t_gather,
                "fwd_bwd_segsum_equivalents": t_fb / t_ssum},
            "launches": dict(probe.launches), "probes": probe.rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    out = run(knobs(), resolve_device(args.device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    main()
