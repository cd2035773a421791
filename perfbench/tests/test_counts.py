"""The counts and the trace readers against counts made by hand on tiny
shapes and traces."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import counts, lpgen, metrics, trace
from perfbench.counts import Shape, Traversal, gcn_fc, spmm

PEAKS = {"hbm_bytes_per_s": 1e3, "bf16_flops_per_s": 1e6}


def lp(row, col, m, n):
    row, col = np.asarray(row, np.int32), np.asarray(col, np.int32)
    z = np.zeros(len(row), np.float32)
    return lpgen.LP(row, col, z, np.zeros((m, 8), np.float32),
                    np.zeros((n, 8), np.float32), np.zeros(m, np.int32),
                    np.zeros(n, np.int32))


def test_shape_counts_nodes_with_an_edge():
    s = Shape.of(lp([0, 0, 2], [1, 3, 3], m=4, n=5))
    assert s == Shape(ncons=4, nvars=5, nnz=3, cons_used=2, vars_used=2)


def test_spmm_bytes_by_hand():
    # 3 destinations, 2 of 4 sources used, 5 edges, width 8 bf16:
    # ptr 4*4, idx+val 5*8, rows read 2*8*2, rows written 3*8*2
    t = Traversal("spmm", n_dst=3, n_src_used=2, nnz=5, width=8, itemsize=2)
    assert spmm.bytes_moved(t) == 16 + 40 + 32 + 48
    assert t.flops == 2 * 5 * 8


def test_bound_is_the_read_once_bytes():
    # however many operations a byte, the bound is the bytes at the rate
    t = Traversal("spmm", n_dst=3, n_src_used=2, nnz=5, width=1024,
                  itemsize=2)
    assert counts.bound_s(t, PEAKS) == spmm.bytes_moved(t) / 1e3


def test_gcn_fc_step_by_hand():
    cfg = {"p": 8, "q": 8, "hids": 4, "depth": 3, "dtype": "bfloat16"}
    s = Shape(ncons=2, nvars=3, nnz=5, cons_used=2, vars_used=3)
    ts = gcn_fc.traversals(cfg, s)
    assert [(t.n_dst, t.n_src_used) for t in ts] == [(2, 3), (3, 2), (3, 2),
                                                     (2, 3)]
    assert all(t.width == 4 and t.itemsize == 2 for t in ts)
    one = 2 * 8 * 4   # a conv1 GEMM's forward a row (8 -> 4)
    conv1 = (2 * 2 + 2 * 3) * one * 2          # forward + weight gradient
    hidden = (2 * 2 + 2 * 3) * (2 * 4 * 4) * 3
    heads = (2 + 3) * (2 * 4 * 3) * 3
    aggs = 4 * 2 * 5 * 4
    assert gcn_fc.step_flops(cfg, s) == conv1 + hidden + heads + aggs


def fake_trace(ops, span_s, steps=2, shapes=(), cfg=None, peaks=PEAKS,
               host=()):
    return trace.Trace([trace.Op(n, a, b) for n, a, b in ops],
                       [trace.Op(n, a, b) for n, a, b in host], span_s, steps,
                       list(shapes), cfg or {}, peaks)


def test_readers_by_hand():
    ops = [("void spmm_csr_kernel<...>", 0.0, 1.0),
           ("ampere_bf16_gemm", 1.0, 1.5),
           ("elementwise_kernel", 1.2, 2.0),    # overlaps the GEMM
           ("multi_tensor_apply_kernel", 3.0, 3.5),
           ("Memcpy DtoH", 4.0, 4.25)]
    s = Shape(ncons=2, nvars=3, nnz=5, cons_used=2, vars_used=3)
    cfg = {"family": "gcn_fc", "p": 8, "q": 8, "hids": 4, "depth": 3,
           "dtype": "bfloat16"}
    tr = fake_trace(ops, 5.0, steps=2, shapes=[s, s], cfg=cfg,
                    host=[("aten::item", 2.0, 3.0), ("step", 0.0, 5.0)])
    read = {n: metrics.reader(n).read(tr) for n in (
        "launches_per_step", "elementwise_ms_per_step", "gemm_ms_per_step",
        "device_idle_pct", "spmm_roofline_pct", "train_mfu")}
    assert read["launches_per_step"] == 2.5
    assert read["elementwise_ms_per_step"] == pytest.approx(1e3 * 1.05 / 2)
    assert read["gemm_ms_per_step"] == pytest.approx(250.0)
    # busy: [0, 2] + [3, 3.5] + [4, 4.25] = 2.75 of 5
    assert read["device_idle_pct"] == pytest.approx(45.0)
    bound = sum(counts.bound_s(t, PEAKS) for t in gcn_fc.traversals(cfg, s))
    assert read["spmm_roofline_pct"] == pytest.approx(100 * 2 * bound / 1.0)
    assert read["train_mfu"] == pytest.approx(
        100 * 2 * gcn_fc.step_flops(cfg, s) / 5.0 / 1e6)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["void spmm_csr_kernel<...>", 1.0]
    # between ops: [2, 3] under aten::item, [3.5, 4] under step; the
    # rest of the 2.25 s idle lies before the first or after the last op
    assert bd["idle_gaps"] == [
        ["aten::item", pytest.approx(1.0)],
        ["(before the first or after the last device op)",
         pytest.approx(0.75)],
        ["step", pytest.approx(0.5)]]


def test_readers_find_nothing_return_none():
    empty = fake_trace([], 1.0, peaks=None,
                       cfg={"family": "gcn_fc"})
    for name in ("launches_per_step", "elementwise_ms_per_step",
                 "gemm_ms_per_step", "device_idle_pct", "spmm_roofline_pct",
                 "train_mfu"):
        assert metrics.reader(name).read(empty) is None, name
    # a roofline without its kernel in the trace is silent, never 0
    tr = fake_trace([("ampere_bf16_gemm", 0.0, 1.0)], 1.0,
                    cfg={"family": "gcn_fc"})
    assert metrics.reader("spmm_roofline_pct").read(tr) is None


def test_categorize_is_chip_smokes():
    assert trace.categorize("void gen_agg_bwd_kernel<bf16>") == "gen_agg"
    assert trace.categorize("nvjet_tst_128x64") == "gemm"
    assert trace.categorize("sm90_xmma_gemm_bf16") == "gemm"
    assert trace.categorize("Memset (Device)") == "other"
