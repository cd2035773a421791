"""The plain references against the program on the CPU: in float32 the
program's first steps (its plain kernels) are the reference's to
rounding, fed the dropout masks the program applied, however it drew
them; the reference's parameters are the program's, name for name and
shape for shape. (In the configurations' bf16 the cells' limits hold on
the chip: ``test_card.py``.)"""
from __future__ import annotations

import pytest
import torch

from perfbench import check, control, lpgen, manifest, run, system, weights
from perfbench.reference import common, family

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_param_spec_is_the_programs(tiny, name):
    cell = tiny(name)
    spec = family(cell.config["family"]).param_spec(cell.config)
    w0 = weights.draw(spec, 5, CPU)
    lps = lpgen.draw_lps(dict(cell.traffic, graphs=1), 5)
    sut = system.Trainer(cell.config, lps, w0, 1, CPU)   # loads strictly
    sd = sut.model.state_dict()
    assert sorted(k for k, _, _ in spec) == sorted(sd)
    for k, shape, _ in spec:
        assert tuple(sd[k].shape) == tuple(shape), k
        assert torch.equal(sd[k], w0[k]), k


@pytest.mark.parametrize("name", CELLS)
def test_program_fp32_is_the_reference(tiny, name):
    """The same steps, weights, graphs, order and dropout masks: in fp32
    the only differences are the order of sums. The masks tapped from the
    program are those its dropout drew from the stream the run hands it."""
    cell = tiny(name, dtype="float32")
    for seed in (3, 2 ** 31 + 11):
        lps = lpgen.draw_lps(cell.traffic, seed)
        prog = control.program_record(cell, seed, lps, CPU)
        ref = control.reference_record(cell, seed, lps, CPU,
                                       common.FedMasks(prog.masks))
        read = check.readings(prog, ref)
        assert read["loss_gap"] < 1e-6, read
        assert read["grad_gap"] < 1e-5, read
        assert read["change_gap"] < 1e-5, read
        drawn = control.drawn_masks(cell, seed, CPU)
        control.reference_record(cell, seed, lps, CPU, drawn)
        assert len(prog.masks) == len(drawn.kept) == 2 * (
            cell.config["depth"] - 2) * len(prog.losses)
        assert all(torch.equal(a, b) for a, b in zip(prog.masks, drawn.kept))


def test_masks_drawn_otherwise_are_still_correct(tiny, monkeypatch):
    """A program that draws its dropout masks another way (here the
    complement of the stream's draws) is held to the reference all the
    same: the reference applies the masks the program applied."""
    from lp_gnn_tpu_torch.models import gcn

    def other(x, rate, generator, train):
        if not train or rate <= 0:
            return x
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u >= rate, x / (1 - rate), 0.0).to(x.dtype)

    cell = tiny("gcn_fc_h1024.lp1m", hids=64, dtype="float32")
    lps = lpgen.draw_lps(cell.traffic, 5)
    drawn = control.drawn_masks(cell, 5, CPU)
    control.reference_record(cell, 5, lps, CPU, drawn)
    monkeypatch.setattr(gcn, "dropout", other)
    prog = control.program_record(cell, 5, lps, CPU)
    assert not torch.equal(prog.masks[0], drawn.kept[0])
    line = run.run_cell(cell, 5, 0.2, False, CPU)
    assert line["correct"] is True, line["compared"]


def test_blocked_aggregation_is_one_block(monkeypatch):
    """The reference's aggregation in many blocks of edges (as at 10^8
    edges) sums what one block does, forward and backward."""
    from perfbench.reference import common

    g = torch.Generator().manual_seed(0)
    e, n_src, n_dst, d = 1000, 50, 40, 6
    src = torch.randint(0, n_src, (e,), generator=g)
    dst = torch.randint(0, n_dst, (e,), generator=g)
    val = torch.rand(e, generator=g)
    x = torch.rand(n_src, d, generator=g, dtype=torch.float64,
                   requires_grad=True)

    def run():
        out = common.aggregate(x, dst, src, val.double(), n_dst)
        gx, = torch.autograd.grad((out * out).sum(), x)
        return out.detach(), gx

    one = run()
    monkeypatch.setattr(common, "AGG_BLOCK_BYTES", 7 * d * 8)
    many = run()
    for a, b in zip(one, many):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def test_grad_diff_is_the_norm_of_the_difference():
    """Two first gradients of equal norms and opposite signs read a gap of
    norms of 0 and a difference of twice the norm."""
    g = torch.tensor([3.0, 4.0])
    ref = check.Record(losses=[1.0], grad1={"w": 5.0, "b": 5.0},
                       change={"w": 1.0, "b": 1.0},
                       grad1_vec={"w": g, "b": g})
    prog = check.Record(losses=[1.0], grad1={"w": 5.0, "b": 5.0},
                        change={"w": 1.0, "b": 1.0},
                        grad1_vec={"w": -g, "b": g})
    read = check.readings(prog, ref)
    assert read["grad_gap"] == 0.0
    assert read["grad_diff_gap"] == pytest.approx(2.0)
    assert read["grad_diff_median_gap"] == pytest.approx(1.0)
    prog.grad1_vec.pop("b")
    assert check.readings(prog, ref)["grad_diff_gap"] == float("inf")
