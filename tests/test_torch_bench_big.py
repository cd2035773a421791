"""The port's twin of ``scripts/bench_big.py`` (lp_gnn_tpu_torch/bench_big.py)
and its copy of ``lp_gnn_tpu/utils/timer.py``, against the JAX package on
the CPU, where every kernel wrapper runs its plain version.

Tolerances:
- the timer's seconds and logged messages, the graph orderings
  (``lex_order``), the split graph build against ``train_graph``: exact;
- one ``bench_big`` step (GCN_FC(8,8,hids=16,depth=3), fp32, dropout 0,
  with and without remat) against ``make_train_step(model, "balanced",
  make_optimizer("adam"))`` from the same weights: the loss rtol 1e-5, the
  decode accuracy exact, the updated parameters rtol 1e-5 / atol 1e-6
  (Adam's first step moves each entry by about lr = 1e-3, so the fp32
  round-off of the gradients reaches it at that scale);
- the JSON line's ``traversals_per_s`` to rtol 1e-12 of edges x 6 /
  ``step_time_s`` (the same floats, divided in another order).
"""
import io
import json
import logging
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.ops.spmm import attach_input_agg as jax_attach_input_agg
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu.utils import timer as jtimer
from lp_gnn_tpu_torch import bench_big
from lp_gnn_tpu_torch import utils as tutils
from lp_gnn_tpu_torch.bench import make_graph
from lp_gnn_tpu_torch.data.graph import lex_order
from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
from lp_gnn_tpu_torch.train.trainer import train_graph
from lp_gnn_tpu_torch.utils import timer as ttimer

torch.set_num_threads(2)

TINY = ["--edges", "3000", "--cons", "500", "--vars", "1000", "--hids", "16"]
SCRIPT_KEYS = {"edges", "step_time_s", "traversals_per_s", "remat", "budget"}


# ------------------------------------------------------------------ timer
def clocked(monkeypatch, mod, ticks):
    """``mod``'s clock (its ``time.time``) stepping through ``ticks``."""
    it = iter(ticks)
    monkeypatch.setattr(mod, "time", SimpleNamespace(time=lambda: next(it)))


def test_timer_is_exported_as_jax_exports_it():
    assert tutils.Timer is ttimer.Timer and tutils.timed is ttimer.timed
    assert ttimer.timer_func is ttimer.timed


def test_timer_checkpoints_match_jax(monkeypatch, caplog):
    """The same clock readings give the same checkpoints and the same
    logged lines (verbose) as JAX's Timer."""
    ticks = [10.0, 10.5, 12.25, 13.0, 20.125]
    got, want, logs = [], [], []
    for mod, out in ((ttimer, got), (jtimer, want)):
        clocked(monkeypatch, mod, ticks)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            t = mod.Timer()
            out += [t.since_last_check("a", verbose=True),
                    t.since_start("b", verbose=True),
                    t.since_last_check(),
                    t.since_start("c")]
        logs.append([r.getMessage() for r in caplog.records])
    assert got == want == [0.5, 2.25, 2.5, 10.125]
    assert logs[0] == logs[1] == ["a 0.500s", "b 2.250s"]


def test_timed_logs_as_jax(monkeypatch, caplog):
    def work(x):
        return x + 1

    msgs = []
    for mod in (ttimer, jtimer):
        clocked(monkeypatch, mod, [1.0, 3.5])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert mod.timed(work)(1) == 2
        msgs.append([r.getMessage() for r in caplog.records])
    assert msgs[0] == msgs[1] == ["'work' executed in 2.50s"]
    assert ttimer.timed(work).__name__ == "work"


# ---------------------------------------------------------- graph build
def test_lex_order_is_lexsort_with_ties():
    """One stable key sort gives np.lexsort's permutation, duplicate
    edges (ties in both keys) kept in their input order."""
    rng = np.random.RandomState(3)
    row = rng.randint(0, 7, 400).astype(np.int64)
    col = rng.randint(0, 5, 400).astype(np.int64)
    np.testing.assert_array_equal(lex_order(row, col, 5),
                                  np.lexsort((col, row)))
    np.testing.assert_array_equal(lex_order(col, row, 7),
                                  np.lexsort((row, col)))
    np.testing.assert_array_equal(lex_order(col),
                                  np.argsort(col, kind="stable"))
    assert lex_order(row[:0], col[:0], 5).shape == (0,)


def test_graph_on_is_train_graph_in_two_parts():
    """bench_big's timed build (host, then the device with the cache)
    gives train_graph's tensors on bench.py's graph."""
    model, _ = bench_big.setup(bench_big.arch_string(16, False), "cpu")
    gt, build_s, upload_s = bench_big.graph_on(
        model, 3000, 500, 1000, torch.device("cpu"))
    want = train_graph(model, make_graph(0, 3000, 500, 1000), "cpu")
    assert build_s >= 0 and upload_s >= 0
    for name in ("rowptr", "col", "val_r", "colptr", "row", "val_c",
                 "c_feas", "v_feas", "y_s", "y_t", "in_agg_c", "in_agg_v"):
        assert torch.equal(getattr(gt, name), getattr(want, name)), name
    assert gt.in_agg_c.dtype == torch.bfloat16
    assert gt.eperm_r is None and gt.to("cpu").nnz == 3000


# ------------------------------------------------------------------ step
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_step_matches_jax_train_step(remat):
    """bench_big.step (train_step with the decode accuracy) against JAX's
    make_train_step with its default with_acc, one Adam step from the same
    weights on bench.py's graph at E=3000, with the input cache both
    sides."""
    arch = ("GCN_FC(8,8,hids=16,depth=3,dp=0.0"
            + (",remat=True)" if remat else ")"))
    jmodel = jax_build_model(arch)
    params = jmodel.init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    opt = jtrainer.make_optimizer("adam")
    g = make_graph(0, 3000, 500, 1000)
    jg = JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")})
    pg = jax_attach_input_agg(pad_graph(jg), jnp.float32)
    step = jtrainer.make_train_step(jmodel, "balanced", opt)
    jp, _, jloss, jacc = step(params, opt.init(params), pg,
                              jax.random.PRNGKey(0), jnp.float32(1e-3))

    model, optimizer = bench_big.setup(arch, torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax_params(host))
    gt, _, _ = bench_big.graph_on(model, 3000, 500, 1000,
                                  torch.device("cpu"))
    loss, acc = bench_big.step(model, optimizer, gt,
                               torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jp))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ CLI
def run_main(argv) -> list[dict]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench_big.main(argv) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def test_main_prints_the_scripts_line():
    """One JSON line with the script's five keys (budget null: no
    counterpart) and the port's own; traversals_per_s = edges x 6 /
    step_time_s; the timed steps' losses finite."""
    (out,) = run_main(TINY + ["--device", "cpu"])
    assert SCRIPT_KEYS <= set(out)
    assert out["edges"] == 3000 and out["remat"] is False
    assert out["budget"] is None
    np.testing.assert_allclose(out["traversals_per_s"],
                               3000 * 6 / out["step_time_s"], rtol=1e-12)
    np.testing.assert_allclose(out["step_time_s"],
                               sum(out["step_s"]) / 2, rtol=1e-12)
    assert len(out["losses"]) == len(out["step_s"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert out["device"] == "cpu" and out["peak_device_bytes"] is None
    assert out["device_bytes_at_start"] is None
    assert out["graph_build_s"] > 0 and out["upload_input_agg_s"] > 0
    assert out["host_peak_rss_bytes"] > 0


def test_main_has_no_budget_and_needs_a_card_by_default():
    with pytest.raises(SystemExit):
        bench_big.parse_args(TINY + ["--budget", str(1 << 30)])
    assert bench_big.parse_args([]).device == "cuda"
    assert bench_big.parse_args([]).edges == 100_000_000
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_big.main(TINY)


def test_remat_flag_builds_the_remat_model():
    assert bench_big.arch_string(256, True) == \
        "GCN_FC(8,8,hids=256,depth=3,dtype='bfloat16',remat=True)"
    model, _ = bench_big.setup(bench_big.arch_string(16, True), "cpu")
    assert model.remat


def test_no_tpu_constant_in_the_twins():
    """The JAX scripts' TPU-measured figures and settings have no place in
    the three twins: probe_gen_floor's r5 floors, probe_spmm's gather
    rate, bench_big's budget default."""
    from lp_gnn_tpu_torch import probe_gen_floor, probe_spmm
    for mod in (bench_big, probe_spmm, probe_gen_floor):
        src = open(mod.__file__).read()
        for const in ("5.4e-4", "4.35e-3", "1.285e-2", "1.264e-2",
                      "1.896e-2", "1.991e-2", "135", "1 << 30",
                      "LP_GNN_SPMM_BUDGET="):
            assert const not in src, (mod.__name__, const)
