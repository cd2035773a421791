"""On-card microbenchmarks of the SpMM's candidate primitives (the twin of
``scripts/probe_spmm.py``).

    python -m lp_gnn_tpu_torch.probe_spmm [--device cuda]

The script's probes at its shapes (E=1M, M=65,536, N=131,072, D=256) and
from its draws (``RandomState(0)``, in its order), each op beside the
least time the card could take for it:

  1. row gather ``x[idx]``, bf16 and fp32: ``torch.index_select`` and
     the port's gather kernel (``ops/gather.py gather_rows``);
  2. window gather: 128- and 256-row windows gathered as single rows;
  3. HBM transpose of a (2048, 32, 32, D) bf16 array, axes 0 and 1;
  4. one-hot window contraction: C = E/512 chunks of K=512 edges, each
     chunk's sources in a W=256-row window, as a batched matmul with fp32
     sums;
  5. the blocked traversal of ``lp_gnn_tpu/ops/spmm.py:77 blocked_spmm``
     (gather + value product, one-hot destination contraction, the
     chunks' sum into their blocks) over ``data/stacking.py
     block_layout`` of the v2c edges, and the port's SpMM kernel
     (``ops/spmm.py spmm_csr``) on the same edges as CSR; 5b the message
     build alone, 5c the one-hot destination contraction (R=128) alone;
  6. a dense bmm of probe 4's shape.

The probes call library ops (``index_select``, ``bmm``,
``transpose().contiguous()``, ``segment_reduce``) on purpose: they
measure the card's rate for those primitives, as the JAX script measures
XLA's; none of them is on a path of the system. Each op is timed with
CUDA events over 10 back-to-back calls after 2 untimed ones (the
script's counts), where the script times jitted calls to a host read.

A probe's bound is the larger of its bytes (each input read once, each
output written once; a gather reads the rows it uses) over the card's
memory rate and, for probes 4 and 6, its operations over the dense bf16
tensor-core rate. ``share_of_bound`` is bound / time. Prints the script's
human lines, then one JSON line: each probe's ``name``, ``ms``,
``bytes``, ``flops``, ``bound_ms``, ``bound_by`` and ``share_of_bound``,
the port kernels' wrapper calls (``launches``, one launch each on the
card), the shapes and ``device`` (the card's name and power limit as
``nvidia-smi`` gives them; ``cpu`` on the CPU, where the times are the
host's and ``share_of_bound`` is null).
"""
from __future__ import annotations

import argparse
import json
import time
from collections import Counter

import numpy as np
import torch

from .bench import device_label
from .data.stacking import block_layout, chunk_ptr, pick_block_k
from .device import resolve_device
from .ops.gather import gather_rows
from .ops.spmm import spmm_csr

# NVIDIA H100 SXM data sheet (dense rates, no sparsity, at 700 W)
HBM_BYTES_S = 3.35e12     # HBM3
BF16_FLOP_S = 989e12      # bf16 on the tensor cores
FP32_FLOP_S = 67e12       # fp32 outside the tensor cores

E = 1_000_000             # the script's shapes
M = 65_536
N = 131_072
D = 256
TRANSPOSE_ROWS = 2048     # probe 3's leading axis

WIN_K, WIN_W = 512, 256   # probe 4: edges a chunk, rows a window
BLOCK_R = 128             # probe 5: destination rows a block
N_WARM, N_ITER = 2, 10    # the script's timeit


# ------------------------------------------------------------------ ops
def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, the products summed in fp32 and returned in fp32
    (JAX's ``preferred_element_type=jnp.float32``): on the card the
    tensor cores' bf16 product with an fp32 output, on the CPU the fp32
    product of the same values (bf16 x bf16 is exact in fp32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def one_hot(ids: torch.Tensor, width: int, dtype: torch.dtype) -> torch.Tensor:
    """``(ids[..., None] == arange(width))`` in ``dtype``."""
    return (ids[..., None] == torch.arange(width, device=ids.device,
                                           dtype=ids.dtype)).to(dtype)


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Probes 1 and 2: ``x[idx]`` (``torch.index_select``)."""
    return torch.index_select(x, 0, idx)


def hbm_transpose(a: torch.Tensor) -> torch.Tensor:
    """Probe 3: ``swapaxes(a, 0, 1)`` written out."""
    return a.transpose(0, 1).contiguous()


def onehot_contract(loc: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Probe 4: ``einsum("ckw,cwd->ckd", one_hot(loc, W), win)``, fp32."""
    return bmm_f32(one_hot(loc, win.shape[1], win.dtype), win)


def msg_build(blk_src: torch.Tensor, blk_val: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Probe 5b: ``x[blk_src] * blk_val[..., None]`` in x's dtype."""
    msg = torch.index_select(x, 0, blk_src.reshape(-1))
    return msg.view(*blk_src.shape, x.shape[1]) * \
        blk_val[..., None].to(x.dtype)


def dst_contract(blk_dst: torch.Tensor, msg: torch.Tensor,
                 r: int = BLOCK_R) -> torch.Tensor:
    """Probe 5c: ``einsum("bkr,bkd->brd", one_hot(blk_dst, r), msg)``,
    fp32."""
    return bmm_f32(one_hot(blk_dst, r, msg.dtype).transpose(1, 2), msg)


def blocked_spmm(blk_src, blk_dst, blk_val, chunks: torch.Tensor,
                 x: torch.Tensor, r: int = BLOCK_R) -> torch.Tensor:
    """Probe 5: ``blocked_spmm`` (``ops/spmm.py:77``, its in-memory
    branch): each chunk's messages contracted into its block's r rows,
    then the chunks' sorted sum into their blocks (``chunks``: each
    block's chunk count, from ``chunk_ptr``); (blocks * r, D) in x's
    dtype."""
    part = dst_contract(blk_dst, msg_build(blk_src, blk_val, x), r)
    out = torch.segment_reduce(part, "sum", lengths=chunks, unsafe=True)
    return out.reshape(-1, x.shape[1]).to(x.dtype)


def dense_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Probe 6: ``einsum("ckw,cwd->ckd", a, b)``, fp32."""
    return bmm_f32(a, b)


# ------------------------------------------------------------- measuring
def time_ms(fn, device: torch.device, iters: int = N_ITER,
            warm: int = N_WARM) -> float:
    """ms a call: CUDA events around ``iters`` back-to-back calls after
    ``warm`` untimed ones on the card; the host's clock on the CPU."""
    for _ in range(warm):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def csr_ptr(dst: np.ndarray, num: int) -> np.ndarray:
    """int32 CSR pointers of edges sorted by ``dst`` over ``num`` rows."""
    ptr = np.zeros(num + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=num), out=ptr[1:])
    return ptr


def gathered_bytes(idx: torch.Tensor, row_bytes: int) -> int:
    """Bytes of a gather of ``row_bytes`` rows: the rows it uses, read
    once, the index, and the output."""
    used = int(torch.unique(idx).numel())
    return used * row_bytes + idx.numel() * idx.element_size() + \
        idx.numel() * row_bytes


class Probes:
    """Times each probe, bounds it and counts the port kernels' calls."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rows: list[dict] = []
        self.launches: Counter = Counter()

    def __call__(self, name: str, fn, n_bytes: float, n_flops: float = 0.0,
                 flop_s: float = BF16_FLOP_S, kernels: dict | None = None,
                 **extra) -> float:
        """Time ``fn`` (``kernels``: the port kernels one call launches),
        print its line and keep its row; returns its seconds a call."""
        ms = time_ms(fn, self.device)
        for k, n in (kernels or {}).items():
            self.launches[k] += n * (N_WARM + N_ITER)
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        t_ops = n_flops / flop_s * 1e3
        bound_ms = max(t_bytes, t_ops)
        # a share of the card's bound is a device figure: none on the CPU
        share = bound_ms / ms if self.device.type == "cuda" else None
        self.rows.append({
            "name": name, "ms": ms, "bytes": n_bytes, "flops": n_flops,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": share, **extra})
        print(f"{name:<48s} {ms:9.3f} ms   bound {bound_ms:8.4f} ms"
              + (f" ({share:6.1%})" if share is not None else ""),
              flush=True)
        return ms / 1e3


def upload(a: np.ndarray, device: torch.device, dtype: torch.dtype):
    """A host array on the device in ``dtype`` (fp32 -> bf16 rounds to
    nearest even there, as the script's host cast does)."""
    return torch.from_numpy(a).to(device).to(dtype)


def run(device: torch.device) -> dict:
    """The probes (module docstring); returns the JSON object."""
    e, m, n, d, t_rows = E, M, N, D, TRANSPOSE_ROWS
    rng = np.random.RandomState(0)
    probe = Probes(device)
    label = device_label(device)
    print(f"device: {label}", flush=True)

    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x = upload(rng.randn(n, d).astype(np.float32), device, dt)
        idx = torch.from_numpy(rng.randint(0, n, e).astype(np.int32)).to(device)
        n_bytes = gathered_bytes(idx, d * x.element_size())
        s = probe(f"1. row gather (E={e}, D={d}, {dt_name})",
                  lambda: row_gather(x, idx), n_bytes, library="index_select")
        print(f"     -> {e / s / 1e6:8.1f} Mrow/s, "
              f"{e * d * x.element_size() / s / 2 ** 30:7.1f} GiB/s")
        probe(f"1. gather_rows kernel (E={e}, D={d}, {dt_name})",
              lambda: gather_rows(x, idx), n_bytes,
              kernels={"gather_rows": 1}, kernel="gather_rows")
        del x, idx

    x = upload(rng.randn(n, d).astype(np.float32), device, torch.bfloat16)
    for nwin, rows in ((2048, 128), (1024, 256)):
        xw = x.reshape(n // rows, rows * d)
        widx = torch.from_numpy(
            rng.randint(0, n // rows, nwin).astype(np.int32)).to(device)
        s = probe(f"2. window gather ({nwin} x {rows} rows, bf16)",
                  lambda: row_gather(xw, widx),
                  gathered_bytes(widx, rows * d * 2), library="index_select")
        print(f"     -> {nwin * rows * d * 2 / s / 2 ** 30:7.1f} GiB/s "
              "effective")
    del x, xw

    a = upload(rng.randn(t_rows, 32, 32, d).astype(np.float32),
               device, torch.bfloat16)
    n_bytes = 2 * a.numel() * 2
    s = probe(f"3. HBM transpose ({t_rows},32,32,{d})"
              "->(1,0,2,3)", lambda: hbm_transpose(a), n_bytes,
              library="transpose().contiguous()")
    print(f"     -> {n_bytes / s / 2 ** 30:7.1f} GiB/s (r+w)")
    del a

    c = e // WIN_K
    loc = torch.from_numpy(
        rng.randint(0, WIN_W, (c, WIN_K)).astype(np.int32)).to(device)
    win = upload(rng.randn(c, WIN_W, d).astype(np.float32), device,
                 torch.bfloat16)
    flops = 2.0 * c * WIN_K * WIN_W * d
    s = probe(f"4. one-hot window contract C={c} K={WIN_K} W={WIN_W}",
              lambda: onehot_contract(loc, win),
              loc.numel() * 4 + win.numel() * 2 + c * WIN_K * d * 4, flops,
              library="bmm")
    print(f"     -> {flops / s / 1e12:7.1f} TFLOP/s effective (E rows "
          f"produced: {e / s / 1e6:.0f} Mrow/s)")
    del loc

    row = np.sort(rng.randint(0, m, e).astype(np.int32))
    col = rng.randint(0, n, e).astype(np.int32)
    val = rng.rand(e).astype(np.float32)
    kb = pick_block_k(e, m)
    bs, bd, bv, bo, nblk = block_layout(row, col, val, m, k=kb)
    print(f"   [blocked layout: {bs.shape[0]} chunks x K={kb}, {nblk} "
          "blocks]")
    xv = upload(rng.randn(n, d).astype(np.float32), device, torch.bfloat16)
    bs, bd, bv = (torch.from_numpy(v).to(device) for v in (bs, bd, bv))
    chunks = torch.from_numpy(np.diff(chunk_ptr(bo, nblk))).to(device)
    s_used = int(np.unique(col).size)
    x_bytes = s_used * d * 2
    s = probe("5. blocked_spmm einsum traversal (v2c)",
              lambda: blocked_spmm(bs, bd, bv, chunks, xv),
              3 * bs.numel() * 4 + chunks.numel() * 8 + x_bytes
              + nblk * BLOCK_R * d * 2, library="index_select, bmm, "
              "segment_reduce")
    print(f"     -> {e / s / 1e6:8.1f} Medge/s")
    ptr, col_d, val_d = (torch.from_numpy(v).to(device)
                         for v in (csr_ptr(row, m), col, val))
    s = probe("5. spmm_csr kernel, the same edges (v2c)",
              lambda: spmm_csr(ptr, col_d, val_d, xv),
              (m + 1) * 4 + e * 8 + x_bytes + m * d * 2,
              kernels={"spmm_csr": 1}, kernel="spmm_csr")
    print(f"     -> {e / s / 1e6:8.1f} Medge/s")
    del ptr, col_d, val_d
    probe("5b. gather+mul msg build alone",
          lambda: msg_build(bs, bv, xv),
          2 * bs.numel() * 4 + x_bytes + bs.numel() * d * 2,
          library="index_select")
    msg = msg_build(bs, bv, xv)
    probe(f"5c. one-hot dst contract alone (R={BLOCK_R})",
          lambda: dst_contract(bd, msg),
          bd.numel() * 4 + msg.numel() * 2 + bs.shape[0] * BLOCK_R * d * 4,
          library="bmm")
    del msg, bs, bd, bv, chunks, xv

    a6 = upload(rng.randn(c, WIN_K, WIN_W).astype(np.float32), device,
                torch.bfloat16)
    s = probe("6. dense bmm (C,K,W)@(C,W,D)", lambda: dense_bmm(a6, win),
              a6.numel() * 2 + win.numel() * 2 + c * WIN_K * d * 4, flops,
              library="bmm")
    print(f"     -> {flops / s / 1e12:7.1f} TFLOP/s")
    return {"probe": "probe_spmm", "device": label,
            "shapes": {"E": e, "M": m, "N": n, "D": d,
                       "transpose_rows": t_rows,
                       "window": [WIN_K, WIN_W], "block_k": kb,
                       "chunks": c},
            "timing": f"CUDA events, {N_ITER} calls after {N_WARM}"
                      if device.type == "cuda" else "host clock (CPU)",
            "hbm_bytes_s": HBM_BYTES_S, "bf16_flop_s": BF16_FLOP_S,
            "launches": dict(probe.launches), "probes": probe.rows}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(resolve_device(args.device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    main()
