"""On the card (marked ``cuda``; skipped without one): each cell's run at
its own size comes out correct, with its per-layer metrics in the traced
run. ``python -m pytest perfbench/tests -m cuda`` runs them."""
from __future__ import annotations

import pytest
import torch

from perfbench import manifest, run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.benchmark()["workloads"]])
def test_cell_correct_on_the_card(card, name):
    cell = manifest.cell(name)
    line = run.run_cell(cell, 2 ** 31 + 99, 2.0, True, card)
    assert line["correct"], line["compared"]
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
