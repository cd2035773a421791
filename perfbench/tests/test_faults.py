"""A run with the timed path broken underneath comes out not correct:
once for each fault a training cell on one chip can have (a step that
leaves its state unchanged; half of the batch left out, the mean taken
over the rest; the step's answer, its loss, altered where it is made).
The look for a chip is skipped: the run drives the program's plain
kernels on the CPU at a small size in float32 (where a sound run is the
reference's to rounding), against the cell's own limits."""
from __future__ import annotations

import pytest
import torch

from perfbench import control, manifest, run

FAULTS = ["frozen", "half_batch", "loss_off"]
CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", FAULTS)
def test_fault_is_not_correct(tiny, name, kind):
    cell = tiny(name, hids=64, dtype="float32")
    with control.fault(kind):
        line = run.run_cell(cell, 77, 0.2, False, torch.device("cpu"))
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    cell = tiny(name, hids=64, dtype="float32")
    line = run.run_cell(cell, 77, 0.2, False, torch.device("cpu"))
    assert line["correct"] is True, line["compared"]
    assert list(line)[-1] == "compared"
    assert set(line["setup_split_s"]) == {
        "imports", "device_context", "draws", "weights", "model", "graphs",
        "first_steps"}
    assert sum(line["setup_split_s"].values()) == pytest.approx(
        line["metrics"]["setup_s"]["value"])


def test_dropout_left_out_is_not_correct(tiny, monkeypatch):
    """A program that applies no dropout, where the configuration states
    0.1, departs from it: the reference, fed no masks, cannot follow."""
    from lp_gnn_tpu_torch.models import gcn

    monkeypatch.setattr(gcn, "dropout", lambda x, rate, gen, train: x)
    cell = tiny("gcn_fc_h1024.lp1m", hids=64, dtype="float32")
    line = run.run_cell(cell, 77, 0.2, False, torch.device("cpu"))
    assert line["correct"] is False, line["compared"]
