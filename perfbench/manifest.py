"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix and metrics, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- a cell's limits: ``limits/<workload>.json`` (``check.py``);
- a per-layer metric: ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it reads."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]   # the end-to-end metrics it reports
    per_layer: list[dict]    # the per-layer metrics it reports


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, workload: str, e2e_names: set[str]) -> bool:
    """Whether ``workload`` reports ``metric``: a metric with ``workloads``
    in those cells; an end-to-end one without in every cell; a per-layer
    one without in every cell that reports what it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    bm = benchmark(root)
    by_name = {w["name"]: w for w in bm["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    entry = next(c for c in bm["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bm["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bm["per_layer"] if reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)
