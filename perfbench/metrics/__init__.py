"""The per-layer metrics, one reader a file, found by the metric's name
(``<name>.py``). A reader's module holds ``read(trace)``: the number
from a :class:`~perfbench.trace.Trace`, or None where the trace holds
nothing it reads (the harness then leaves the metric out of the line).
What the metric is (its unit, layer, what it moves) is its entry in
``BENCHMARK.json``; the kinds of kernel it reads are
``trace.categorize``'s."""
from __future__ import annotations

import importlib.util
from pathlib import Path

from .. import counts

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The reader module of the per-layer metric ``name``."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"{__name__}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_pct(tr, kinds: tuple[str, ...], kernel: str) -> float | None:
    """The read-once bound of the traversals of ``kinds`` that the profiled
    steps needed (the configuration family's count), over the device time
    of the kernels of ``kernel``'s kind in them, in %. None without the
    device's peaks, without such kernels or without such traversals."""
    spent = tr.device_s(kernel)
    if tr.peaks is None or spent <= 0:
        return None
    fam = counts.family(tr.cfg["family"])
    bound = sum(counts.bound_s(t, tr.peaks) for shape in tr.shapes
                for t in fam.traversals(tr.cfg, shape) if t.kind in kinds)
    return 100.0 * bound / spent if bound > 0 else None
