"""The traced steps: ``torch.profiler`` over a fixed number of steps
inside the window, after an unrecorded warm-up round, kept in memory and
reduced to what the per-layer metrics read.

The profiler records the device's activity only (CUPTI: kernels, copies,
sets, and the CUDA runtime calls that launched them): recording every
host operation as well doubled a GCN_FC step on the H100, so the traced
steps would no longer stand for the window's. The span of the recorded
steps is taken on the host's clock, from the start of the first recorded
step to the host read of the last one's loss.

The reduction: the device's operations, their union (the busy time), the
gaps between them named by the CUDA call the host was in at each gap,
and the device time by kind of kernel (a frozen copy of ``chip_smoke.py
categorize``).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
TOP = 10   # entries of each list of the breakdown


@dataclasses.dataclass
class Op:
    name: str
    start: float   # s, the profiler's clock
    end: float


@dataclasses.dataclass
class Trace:
    """The profiled steps of one run."""
    device_ops: list[Op]
    host_ops: list[Op]        # the CUDA runtime calls
    span_s: float             # the recorded steps' wall time, host clock
    steps: int
    shapes: list              # counts.Shape of each profiled step's LP
    cfg: dict                 # the configuration
    peaks: dict | None        # peaks.json's entry for this device

    def busy_intervals(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for op in sorted(self.device_ops, key=lambda o: o.start):
            if out and op.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], op.end)
            else:
                out.append([op.start, op.end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_s(self, kind: str) -> float:
        """Device seconds of the kernels of ``kind`` (:func:`categorize`)."""
        return sum(op.end - op.start for op in self.device_ops
                   if categorize(op.name) == kind)


def categorize(name: str) -> str:
    """The kind of a device operation, as ``chip_smoke.py categorize``
    sorts them: the SpMM, the GEN aggregation's kernels, cuBLAS GEMMs, the
    optimizer (Adam's foreach kernels), the rest (losses, casts,
    activations, norms, reductions, copies)."""
    low = name.lower()
    if "spmm_csr_kernel" in low:
        return "spmm_csr"
    if "gen_agg_" in low:
        return "gen_agg"
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    if "multi_tensor_apply" in low:
        return "optimizer"
    return "other"


def peaks_for(kind: str) -> dict | None:
    """peaks.json's entry for a device named ``kind``, None if absent."""
    return json.loads(PEAKS.read_text()).get(kind)


def from_profiler(prof) -> tuple[list[Op], list[Op]]:
    """(device ops, host ops) of a finished ``torch.profiler`` session;
    annotations (``ProfilerStep#``, ``record_function``) are no
    operation."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        if e.name.startswith("ProfilerStep") or \
                getattr(e, "is_user_annotation", False):
            continue
        op = Op(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            device.append(op)
        elif e.device_type == DeviceType.CPU:
            host.append(op)
    return device, host


def _short(name: str) -> str:
    return name if len(name) <= 100 else name[:97] + "..."


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time (seconds by name over the
    profiled steps) and the device's idle time by what the host was doing:
    between two device operations, the innermost CUDA call the host was in
    at the gap's middle, or none (the host in Python or the framework);
    the idle time before the first and after the last operation apart.
    ``TOP`` of each."""
    by_op: dict[str, float] = {}
    for op in tr.device_ops:
        key = _short(op.name)
        by_op[key] = by_op.get(key, 0.0) + (op.end - op.start)
    busy = tr.busy_intervals()
    gaps = [(b, a2) for (_, b), (a2, _) in zip(busy, busy[1:])]
    host = sorted(tr.host_ops, key=lambda h: h.start)
    starts = [h.start for h in host]
    by_host: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        # the latest-starting host op that covers mid: the innermost
        inner = next((host[i] for i in range(
            bisect.bisect_right(starts, mid) - 1, -1, -1)
            if host[i].end >= mid), None)
        key = _short(inner.name) if inner is not None else "(no CUDA call)"
        by_host[key] = by_host.get(key, 0.0) + (b - a)
    outer = tr.span_s - tr.busy_s() - sum(b - a for a, b in gaps)
    if outer > 0:
        by_host["(before the first or after the last device op)"] = outer

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
