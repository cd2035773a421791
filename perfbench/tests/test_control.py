"""The control, the reference computed in float8 in the program's place,
comes out not correct against each cell's limits, at a size a CPU test
holds; on the chip ``python -m perfbench.control --what control`` reads
it at the cell's own size."""
from __future__ import annotations

import pytest
import torch

from perfbench import check, control, manifest

CPU = torch.device("cpu")
CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tiny, name):
    cell = tiny(name, hids=64)
    for seed in (1, 2, 3):
        read = control.readings(cell, seed, ["control"], CPU)["control"]
        ok, compared = check.judge(read, check.limits(name))
        assert not ok, compared
