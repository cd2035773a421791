"""The port's benchmark twins (lp_gnn_tpu_torch/bench.py,
lp_gnn_tpu_torch/bench_scaling.py) against the repo's root ``bench.py``
and ``bench_scaling.py``, on the CPU, where every kernel wrapper runs its
plain version: the same graphs from the same draws, the same traversal
counts as JAX's trace count, and one JSON line of the root scripts' keys
from each twin at a tiny size.

Tolerances: the graphs' arrays and the counts exact; the JSON line's
``value`` to rtol 1e-12 of E * traversals / min(step time) (the same
floats, divided in another order).
"""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch import bench as tbench
from lp_gnn_tpu_torch import bench_scaling as tscaling
from lp_gnn_tpu_torch.models.gcn import build_model

torch.set_num_threads(2)

TINY = dict(BENCH_EDGES="3000", BENCH_CONS="500", BENCH_VARS="1000",
            BENCH_HIDS="16")
SCALING = ["--edges", "3000", "--cons", "500", "--vars", "1000", "--hids",
           "16", "--steps", "2", "--device", "cpu"]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_edges_s",
              "baseline_source", "spread", "step_acc"}
SCALING_KEYS = {"mode", "multihost", "collectives", "edges", "step_time_s",
                "scaling_efficiency"}


@pytest.fixture(scope="module")
def root_bench():
    """The repo's root bench.py (it reads its knobs at import and imports
    JAX only inside its functions)."""
    import bench
    return bench


FIELDS = ("row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")


def test_graphs_are_bench_py_draws(root_bench, monkeypatch):
    """make_graph at a small E / M / N (bench_scaling.py's way of sizing
    it: the module's E, M, N) and make_tiny_graph draw what bench.py's
    draw, array for array (its graphs taken before their padding)."""
    import lp_gnn_tpu.data.batching as batching
    monkeypatch.setattr(batching, "pad_graph", lambda g: g)
    monkeypatch.setattr(root_bench, "E", 5000)
    monkeypatch.setattr(root_bench, "M", 640)
    monkeypatch.setattr(root_bench, "N", 1000)
    pairs = [(root_bench.make_graph(3), tbench.make_graph(3, 5000, 640, 1000)),
             (root_bench.make_tiny_graph(), tbench.make_tiny_graph()),
             (root_bench.make_tiny_graph(2, 30, 40, 90),
              tbench.make_tiny_graph(2, 30, 40, 90))]
    for want, got in pairs:
        for f in FIELDS:
            a, b = np.asarray(getattr(want, f)), getattr(got, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
@pytest.mark.parametrize("arch", ["GCN_FC(8,8,hids=16,depth=3)",
                                  "GCN(8,8,hids=16)",
                                  "GCNDeeper(8,8,hids=16,depth=5)",
                                  "GENDeeper(8,8,hids=16,depth=5)"])
def test_count_traversals_matches_jax(root_bench, arch, cache):
    """count_traversals (the SpMM's and gen_agg_fwd's wrapper calls over
    one step, + 2 for an input cache the model reads) equals bench.py's
    trace count plus its +2 (bench.py:301-319), with and without the
    cache: 6 for GCN_FC at depth 3."""
    import jax.numpy as jnp
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    from lp_gnn_tpu.ops.spmm import attach_input_agg
    jmodel = jax_build_model(arch)
    tiny = root_bench.make_tiny_graph()
    if cache and "GEN" not in arch:
        tiny = attach_input_agg(tiny, jnp.dtype(jmodel.dtype))
    want = root_bench.count_traversals(jmodel, tiny) + \
        (2 if tiny.in_agg_c is not None else 0)
    got = tbench.count_traversals(build_model(arch),
                                  tbench.make_tiny_graph(), cache)
    assert got == want
    if arch.startswith("GCN_FC"):
        assert got == tbench.SPMM_PER_EDGE


def run_main(main, argv) -> list[dict]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


@pytest.mark.parametrize("baseline", [False, True])
def test_bench_prints_bench_py_line(monkeypatch, baseline):
    """python -m lp_gnn_tpu_torch.bench --device cpu at a tiny size: one
    JSON line with bench.py's keys and the port's own; without
    BENCH_MEASURE_BASELINE no baseline (bench.py's constant is a TPU
    number), with it the naive port measured live; value = E * 6 /
    min(step time), every step loss finite."""
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_MEASURE_BASELINE", "1" if baseline else "")
    (out,) = run_main(tbench.main, ["--device", "cpu"])
    assert BENCH_KEYS <= set(out)
    assert out["metric"] == "spmm_edge_traversals_per_s_per_chip"
    assert out["unit"] == "edges/s" and out["step_acc"] == 0
    assert out["device"] == "cpu" and out["steps_per_call"] == 5
    assert "arch" not in out and "traversals_per_edge" not in out
    np.testing.assert_allclose(out["value"], 3000 * 6 / min(out["step_s"]),
                               rtol=1e-12)
    assert out["spread"]["max"] == out["value"]
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    if baseline:
        assert out["baseline_source"] == "measured"
        assert out["baseline_edges_s"] > 0
        np.testing.assert_allclose(
            out["vs_baseline"], out["value"] / out["baseline_edges_s"],
            rtol=1e-12)
    else:
        assert out["baseline_source"] == "none"
        assert out["vs_baseline"] is None and out["baseline_edges_s"] is None


def test_bench_counts_a_non_flagship_arch(monkeypatch):
    """BENCH_ARCH=GENDeeper BENCH_DEPTH=3: the line adds arch,
    traversals_per_edge (the count on the tiny graph) and gen_max_mode
    "seg", and value uses that count."""
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_ARCH", "GENDeeper")
    monkeypatch.setenv("BENCH_DEPTH", "3")
    (out,) = run_main(tbench.main, ["--device", "cpu"])
    per_edge = tbench.count_traversals(
        build_model("GENDeeper(8,8,hids=16,depth=3)"),
        tbench.make_tiny_graph(), True)
    assert out["arch"] == "GENDeeper(hids=16,depth=3)"
    assert out["traversals_per_edge"] == per_edge == 12
    assert out["gen_max_mode"] == "seg"
    np.testing.assert_allclose(out["value"],
                               3000 * per_edge / min(out["step_s"]),
                               rtol=1e-12)


def test_no_tpu_constant_in_the_twin():
    """bench.py's TPU-measured baseline constant has no counterpart."""
    src = open(tbench.__file__).read()
    assert "SCATTER_BASELINE" not in src and "0.715" not in src
    assert not hasattr(tbench, "SCATTER_BASELINE_EDGES_S")


@pytest.mark.parametrize("halo", [False, True], ids=["all_gather", "halo"])
def test_bench_scaling_prints_bench_scaling_py_line(halo):
    """python -m lp_gnn_tpu_torch.bench_scaling --devices 2 --device cpu,
    with and without --halo: one JSON line with bench_scaling.py's keys, at
    1 and 2 shards in one process (mode one-card, never hardware), finite
    losses, equal at both shard counts' first step (the same weights and
    graph)."""
    (out,) = run_main(tscaling.main,
                      SCALING + ["--devices", "2"] + (["--halo"] if halo
                                                      else []))
    assert SCALING_KEYS <= set(out)
    assert out["mode"] == "one-card" and out["multihost"] is False
    assert out["collectives"] == ("halo" if halo else "all-gather")
    assert out["edges"] == 3000
    assert set(out["step_time_s"]) == set(out["scaling_efficiency"]) == \
        {"1", "2"}
    assert out["scaling_efficiency"]["1"] == 1.0
    losses = out["losses"]
    assert all(len(v) == 2 and np.isfinite(v).all() for v in losses.values())
    np.testing.assert_allclose(losses["2"][0], losses["1"][0], rtol=1e-5)
