"""Tracing and resource snapshots (counterpart of
``lp_gnn_tpu/utils/profiling.py``; the reference has wall-clock timers
only, utils.py:27-78, 500-510).

- :func:`trace`: context manager over ``torch.profiler.profile`` writing a
  trace that TensorBoard's profiler plugin and Perfetto read (a Chrome
  trace, ``*.pt.trace.json``) under the directory it is given: host
  activity, and the card's kernels and copies where there is a card.
- :func:`annotate`: a named region inside a trace
  (``torch.profiler.record_function``).
- :func:`show_resource`: host memory and load, and the card's allocated
  memory where there is one, logged and returned (role of reference
  utils.py:724-728, which shelled nvidia-smi/free).
"""
from __future__ import annotations

import contextlib
import logging
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the enclosed work into ``log_dir`` (made if missing): one
    ``{host}_{pid}.{time}.pt.trace.json`` when the block ends. A profiler
    that cannot start raises: a trace asked for is never skipped."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region for traces: ``with annotate("scan_replay"): ...``"""
    return torch.profiler.record_function(name)


def show_resource() -> dict:
    """Host memory and load (``/proc``), and on a card
    ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` in bytes;
    logged and returned."""
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(("MemTotal", "MemAvailable")):
                    k, v = line.split(":")
                    out[k] = v.strip()
        with open("/proc/loadavg") as f:
            out["loadavg"] = f.read().split()[0]
    except OSError:
        pass
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["cuda_memory_allocated"] = torch.cuda.memory_allocated()
        out["cuda_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    logging.info("resources: %s", out)
    return out
