"""``BENCHMARK.json`` against the contract it is checked by, and the files
it names against it: names and units of the allowed characters, every
per-layer metric moving an end-to-end metric that its cells report and
having a reader, every configuration used, every
bound a share, every cell's files present."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import manifest, metrics
from perfbench.reference import family as reference_family

BM = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BM["paths"]) <= 16
    for p in BM["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.startswith("/")
    assert 1 <= len(BM["command"]) <= 32
    assert all(LINE.match(w) for w in BM["command"])
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) <= 64 * 1024


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BM[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    metric_names = [m["name"] for g in ("end_to_end", "per_layer")
                    for m in BM[g]]
    assert len(metric_names) == len(set(metric_names))
    for w in BM["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)


def test_entry_keys():
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])


def test_bounds_are_shares():
    names = {m["name"] for m in BM["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m


def test_every_config_has_a_cell_and_its_file():
    used = {w["config"] for w in BM["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BM["workloads"]}
    assert len(pairs) == len(BM["workloads"])
    for c in BM["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BM["paths"]))
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert f"hids={cfg['hids']}" in cfg["arch"]
        assert f"depth={cfg['depth']}" in cfg["arch"]
        assert f"dtype='{cfg['dtype']}'" in cfg["arch"]
        reference_family(cfg["family"])
    assert len({c["file"] for c in BM["configs"]}) == len(BM["configs"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_reads_its_files(name):
    cell = manifest.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert (manifest.HERE / "limits" / f"{name}.json").is_file()


def test_per_layer_metrics_and_their_readers():
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    for m in BM["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            em = e2e[m["moves"]]
            assert "workloads" not in em or w in em["workloads"]
        assert callable(metrics.reader(m["name"]).read)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct") and m["unit"] == "%"
    layers = {}
    for m in BM["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert any("mfu" in m["name"] for m in BM["per_layer"])


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in BM["workloads"])
    assert four <= max(1, len(BM["workloads"]) // 4)


def test_check_fits_the_budget():
    cells = 24
    runs = 2 + 14 * cells
    assert (runs * (BM["run_seconds"] + 60) + cells * 2 * 90 + 1200
            <= 43200)
