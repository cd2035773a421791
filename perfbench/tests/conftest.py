"""The cells at a size a CPU test can hold: every width and the traffic's
structure as in the cell, the hidden width and the LPs cut."""
from __future__ import annotations

import pytest

from perfbench import manifest

# per traffic structure, the sizes a CPU test holds
TINY = {"uniform": {"cons": 200, "vars": 400, "nnz": 3000, "hot_rows": 12},
        "mirp": {"n_ports": 4, "n_periods": 6}}   # --size small


def tiny_cell(name: str, hids: int = 32, graphs: int | None = None,
              dtype: str | None = None) -> manifest.Cell:
    cell = manifest.cell(name)
    cfg = cell.config
    arch = cfg["arch"].replace(f"hids={cfg['hids']}", f"hids={hids}")
    if dtype is not None:
        arch = arch.replace(f"dtype='{cfg['dtype']}'", f"dtype='{dtype}'")
        cfg["dtype"] = dtype
    cfg.update(hids=hids, arch=arch)
    cell.traffic.update(TINY[cell.traffic["structure"]])
    cell.traffic["graphs"] = graphs or min(int(cell.traffic["graphs"]), 3)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
