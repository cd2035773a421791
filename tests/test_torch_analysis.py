"""The port's analysis twins against the JAX package's scripts, on the CPU:
``degeneracy_probe``, ``bench_partition``, ``decode_sweep`` and
``engine_table`` (``lp_gnn_tpu_torch/<name>.py`` against
``scripts/<name>.py``, each loaded from its path). The same inputs give the
same JSON lines (keys, and every value that is not a time), the same
arrays and the same basis folders.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax

from lp_gnn_tpu import pipeline as jpipeline
from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.data.generator import generate_instance as jax_generate
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.parallel.edge_partition import \
    compute_halo_width as jax_halo_width
from lp_gnn_tpu.reporting.extract import extract_time as jax_extract_time
from lp_gnn_tpu.train.trainer import save_ckpt
from lp_gnn_tpu_torch import (bench_partition, decode_sweep,
                              degeneracy_probe, engine_table)
from lp_gnn_tpu_torch.data.generator import generate_instance
from lp_gnn_tpu_torch.infer.decode import parse_inference_manager
from lp_gnn_tpu_torch.parallel.edge_partition import compute_halo_width
from lp_gnn_tpu_torch.reporting.extract import extract_time
from lp_gnn_tpu_torch.solver import native
from lp_gnn_tpu_torch.solver.highs_bridge import HAVE_HIGHS
from tests.test_torch_native import jax_native_in
from tests.test_torch_pipeline import ARCH, TINY, _cfgs, prep_both

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not HAVE_HIGHS, reason="no vendored highspy")

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
MANAGERS = ["InferenceManager(0,)", "InferenceManager(2,mode='add',gnn_wei=0.5)"]


def script(name: str):
    """``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", osp.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_lines(fn, *args) -> list[dict]:
    """The JSON lines ``fn(*args)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def run_script_main(mod, argv: list[str]):
    old = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        return mod.main()
    finally:
        sys.argv = old


def same(a, b) -> bool:
    """Equal, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b


# ---------------------------------------------------------------- degeneracy
@pytest.mark.parametrize("family,kw", [
    ("mirp_like", dict(n_ports=4, n_periods=6)),
    ("transport", {}),
    ("packing", dict(m=40, n=80)),
])
def test_degeneracy_probe_lp(family, kw):
    """``probe_lp``: every key and value of the script's, exactly."""
    got = degeneracy_probe.probe_lp(generate_instance(family, seed=0,
                                                      instance=0, **kw))
    want = script("degeneracy_probe").probe_lp(
        jax_generate(family, seed=0, instance=0, **kw))
    assert list(got) == list(want)
    assert all(same(got[k], want[k]) for k in want), (got, want)
    assert got["status"] == "Optimal"
    for k in ("zero_rc_frac", "degen_basic_frac"):
        assert 0.0 <= got[k] <= 1.0


def test_degeneracy_probe_main(tmp_path):
    """The CLI's lines (one an LP, the summary) are the script's."""
    from lp_gnn_tpu_torch.io.mps import write_mps
    mps = tmp_path / "lp-dataset" / "tr" / "mps"
    mps.mkdir(parents=True)
    for i in range(3):
        write_mps(generate_instance("transport", seed=1, instance=i),
                  str(mps / f"tr_{i}.mps"))
    argv = ["--dataset", "tr", "--data_prefix", str(tmp_path / "lp-dataset"),
            "--n", "2"]
    got = json_lines(degeneracy_probe.main, argv)
    want = json_lines(run_script_main, script("degeneracy_probe"), argv)
    assert len(got) == 3 and got[-1]["n"] == 2
    assert [list(r) for r in got] == [list(r) for r in want]
    assert all(same(g[k], w[k]) for g, w in zip(got, want) for k in w)


# ---------------------------------------------------------------- partition
def test_banded_graph_and_halo_widths():
    """``banded_graph``: the script's arrays; the per-pair halo width equals
    ``compute_halo_width`` and the JAX package's (over its padded graph)."""
    bp = script("bench_partition")
    g = bench_partition.banded_graph(20_000, band=512, seed=3)
    jg = bp.banded_graph(20_000, band=512, seed=3)
    for f in ("row", "col", "val", "c_feas", "v_feas", "y_s", "y_t"):
        a, b = getattr(g, f), np.asarray(getattr(jg, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    pg = pad_graph(jg)
    for d in (2, 3, 8):
        bh = compute_halo_width(g, d)
        assert bench_partition.naive_halo_width(g, d) == bh
        assert bh == jax_halo_width(pg, d) == bp.naive_halo_width(pg, d)


def test_bench_partition_lines(tmp_path):
    """One line a (edges, shards) cell with the script's keys in its order
    and its sizes and halo widths; the cache's store and load timed."""
    argv = ["--edges", "20000", "--shards", "2", "4", "--naive", "--reps",
            "1", "--band", "512"]
    got = json_lines(bench_partition.main,
                     argv + ["--cache_dir", str(tmp_path / "p")])
    want = json_lines(run_script_main, script("bench_partition"),
                      argv + ["--cache_dir", str(tmp_path / "j")])
    assert [list(c) for c in got] == [list(c) for c in want]
    assert len(got) == 2
    for g, w in zip(got, want):
        for k in ("edges", "shards", "bh"):
            assert g[k] == w[k], k
        assert g["cache_bytes"] > 0
    assert not (tmp_path / "p").exists()


# ---------------------------------------------------------------- the sweep
@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """A tiny family prepped by both packages; one seeded JAX checkpoint;
    the port's ``decode_sweep`` over two managers, and the script's loop
    (``dataclasses.replace(cfg, inference_manager=...)``, predict and warm
    start each, one extract) on the JAX side."""
    root = str(tmp_path_factory.mktemp("torch_analysis"))
    prep_both(root, "mirp_like", **TINY)
    params = jax_build_model(ARCH).init(jax.random.PRNGKey(2))
    ckpt = osp.join(root, "seeded.ckpt")
    save_ckpt(ckpt, params, None, epoch=0)
    jcfg, tcfg = _cfgs(root, "sweep", ckpt)
    decode_sweep.main([
        "--managers", *MANAGERS, "--dataset", "mirp_like",
        "--data_prefix", tcfg.data_prefix, "--log_prefix", tcfg.log_prefix,
        "--exp_nm", "sweep", "--arch", ARCH, "--load_from", ckpt,
        "--device", "cpu"])
    for mng in MANAGERS:
        c = dataclasses.replace(jcfg, inference_manager=mng)
        jpipeline.stage_pred_basis(c)
        jpipeline.stage_warm_start(c)
    jpipeline.stage_extract(jcfg)
    return jcfg, tcfg


def test_decode_sweep_folders(swept):
    """Each manager's predicted and converged bases are the script's, and
    its warm logs give the same iterations."""
    jcfg, tcfg = swept
    folders = [parse_inference_manager(m, "mirp_like") for m in MANAGERS]
    assert [f.get_basis_folder() for f in folders] == \
        ["pred-basis", "gnn-sparsity-add-0.5-0"]
    for mng in folders:
        for folder in (mng.get_basis_folder(),
                       "opt-from-" + mng.get_basis_folder()):
            names = sorted(f for f in os.listdir(osp.join(tcfg.log_dir, folder))
                           if f.endswith(".bas"))
            assert len(names) == 3
            assert names == sorted(
                f for f in os.listdir(osp.join(jcfg.log_dir, folder))
                if f.endswith(".bas"))
            for f in names:
                with open(osp.join(tcfg.log_dir, folder, f)) as a, \
                        open(osp.join(jcfg.log_dir, folder, f)) as b:
                    assert a.read() == b.read(), (folder, f)
        logs = osp.join("log", mng.get_log_folder())
        for f in sorted(os.listdir(osp.join(tcfg.log_dir, logs))):
            assert extract_time(osp.join(tcfg.log_dir, logs, f))[0] == \
                jax_extract_time(osp.join(jcfg.log_dir, logs, f))[0]


def test_engine_table(swept, tmp_path_factory):
    """Both engines over the sweep's run: the JSON line's keys are the
    script's, and its iteration means, impr, n and failed are what the
    script gives on the same files and bases (the JAX package's
    ``native.solve_mps`` and ``highs_bridge.solve_mps``)."""
    _, tcfg = swept
    native.build()
    argv = ["--dataset", "mirp_like", "--data_prefix", tcfg.data_prefix,
            "--log_prefix", tcfg.log_prefix, "--exp_nm", "sweep"]
    got = json_lines(engine_table.main, argv + ["--device", "cpu"])
    with jax_native_in(tmp_path_factory.mktemp("jax_native_et")):
        want = json_lines(run_script_main, script("engine_table"), argv)
    assert len(got) == len(want) == 1
    got, want = got[0], want[0]
    assert list(got) == list(want) == ["dataset", "exp", "method", "engines"]
    assert list(got["engines"]) == list(want["engines"]) == ["highs", "native"]
    for eng, row in want["engines"].items():
        assert list(got["engines"][eng]) == list(row)
        for k in ("cold_niter", "warm_niter", "impr", "n", "failed"):
            assert got["engines"][eng][k] == row[k], (eng, k)
        assert row["n"] == 3 and row["failed"] == 0
