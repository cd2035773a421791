"""The port stands alone: no module of lp_gnn_tpu_torch, and not
chip_smoke.py, imports jax, optax or lp_gnn_tpu, and none imports pandas
when it is imported; a JAX-trained ``mdl.ckpt`` serves without JAX; the
whole pipeline (prep, train, predict, warm start, val, report) runs where
neither JAX nor pandas imports; the entry point refuses to run without a
GPU unless the CPU is asked for."""
import os
import os.path as osp
import pickle
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import optax

from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.train.trainer import save_ckpt
from lp_gnn_tpu_torch import pred_basis, run_family_table
from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PKG = osp.join(ROOT, "lp_gnn_tpu_torch")
BLOCKED = ("jax", "jaxlib", "optax", "lp_gnn_tpu")

# imports jax, optax and lp_gnn_tpu are refused in, before anything else
PRELUDE = f"""
import sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
sys.path.insert(0, {ROOT!r})
"""


def run_isolated(body: str, tmp_path, blocked=BLOCKED) -> str:
    script = tmp_path / "isolated.py"
    script.write_text(PRELUDE.replace(repr(BLOCKED), repr(blocked))
                      + textwrap.dedent(body))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_every_module_imports_without_jax(tmp_path):
    out = run_isolated("""
        import importlib, pkgutil
        import lp_gnn_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            lp_gnn_tpu_torch.__path__, "lp_gnn_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        loaded = [m for m, v in sys.modules.items() if v is not None and
                  m.split(".")[0] in ("jax", "jaxlib", "optax", "lp_gnn_tpu")]
        assert not loaded, loaded
        # the sampled, graph-batched and dp paths' modules among them, the
        # K-step call's and the profiler's, the benchmark twins, the native
        # engine, the analysis twins, the big-graph bench and the probes,
        # the family table's twin
        assert {"lp_gnn_tpu_torch.data.sampling",
                "lp_gnn_tpu_torch.data.stacking",
                "lp_gnn_tpu_torch.parallel.dp",
                "lp_gnn_tpu_torch.parallel.dist_gen",
                "lp_gnn_tpu_torch.train.scan",
                "lp_gnn_tpu_torch.utils.profiling",
                "lp_gnn_tpu_torch.bench",
                "lp_gnn_tpu_torch.bench_scaling",
                "lp_gnn_tpu_torch.solver.native",
                "lp_gnn_tpu_torch.solver._cxx_build",
                "lp_gnn_tpu_torch.ops.host_spmm",
                "lp_gnn_tpu_torch.engine_table",
                "lp_gnn_tpu_torch.decode_sweep",
                "lp_gnn_tpu_torch.degeneracy_probe",
                "lp_gnn_tpu_torch.bench_partition",
                "lp_gnn_tpu_torch.bench_big",
                "lp_gnn_tpu_torch.probe_spmm",
                "lp_gnn_tpu_torch.probe_gen_floor",
                "lp_gnn_tpu_torch.utils.timer",
                "lp_gnn_tpu_torch.dryrun_multihost",
                "lp_gnn_tpu_torch.make_scaling_artifact",
                "lp_gnn_tpu_torch.run_family_table"} <= set(names), names
        print(len(names))
    """, tmp_path)
    assert int(out.split()[-1]) >= 20


def test_no_module_imports_pandas_when_imported(tmp_path):
    """pandas is optional (the card's machine may lack it): importing any
    module of the port, or chip_smoke.py, must not need it."""
    out = run_isolated("""
        import importlib, pkgutil
        import lp_gnn_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            lp_gnn_tpu_torch.__path__, "lp_gnn_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        print(len(names))
    """, tmp_path, blocked=BLOCKED + ("pandas",))
    assert int(out.split()[-1]) >= 35


def test_pipeline_cli_without_jax_or_pandas(tmp_path):
    """``run_prep_data`` then ``run_train_test --device cpu`` on a tiny
    family, in a process where jax, optax, lp_gnn_tpu and pandas do not
    import: the summary is printed and the run dir holds the results table
    and the reference's logs."""
    out = run_isolated("""
        import runpy
        def run(module, *argv):
            sys.argv = [module, *argv]
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        run("lp_gnn_tpu_torch.run_prep_data", "--dataset", "mirp_like",
            "--n_instances", "10", "--size", "small")
        run("lp_gnn_tpu_torch.run_train_test", "--dataset", "mirp_like",
            "--exp_nm", "cli", "--arch", "GCN_FC(8,8,hids=16,depth=3)",
            "--epochs", "3", "--device", "cpu")
    """, tmp_path, blocked=BLOCKED + ("pandas",))
    assert "gnn-bas-0/impr_niter" in out and "val mean" in out
    run = tmp_path / "runs" / "cli"
    for f in ("mdl.pth", "warm_gate.json", "time.json", "summary.tex.csv",
              "log-ing", "log-prt", "log-prt-err"):
        assert (run / f).exists(), f
    assert not (run / "time.h5").exists()
    assert len(os.listdir(run / "log" / "gnn-bas-0")) == 3
    assert "gnn-bas-0/impr_niter" in (run / "log-prt").read_text()


def test_no_import_statement_names_jax():
    """A function-level import would escape the import walk above."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|lp_gnn_tpu)\b"
                     r"(?!_torch)", re.M)
    files = [osp.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG):
        files += [osp.join(d, f) for f in fs if f.endswith(".py")]
    for fn in files:
        with open(fn) as f:
            assert not pat.search(f.read()), fn


def test_jax_ckpt_serves_without_jax(tmp_path):
    """A JAX ``mdl.ckpt`` (trainer.py:216 save_ckpt, optax Adam state
    included) loads in a process that cannot import jax or optax, and its
    logits equal those of the directly converted params."""
    arch = "GCN_FC(8,8,hids=32,depth=3)"
    params = jax_build_model(arch).init(jax.random.PRNGKey(1))
    opt_state = optax.adam(1e-3).init(params)
    ckpt = str(tmp_path / "mdl.ckpt")
    save_ckpt(ckpt, params, opt_state, epoch=3, extra={"note": "x"})
    g, _ = random_graph(np.random.RandomState(8))
    np.savez(tmp_path / "g.npz", row=g.row, col=g.col, val=g.val,
             c_feas=g.c_feas, v_feas=g.v_feas, y_s=g.y_s, y_t=g.y_t)
    run_isolated(f"""
        import numpy as np, torch
        from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
        from lp_gnn_tpu_torch.data.graph import GraphTensors
        from lp_gnn_tpu_torch.models.convert import load_checkpoint
        from lp_gnn_tpu_torch.models.gcn import build_model
        g = BipartiteGraph(**dict(np.load("g.npz")))
        model = build_model({arch!r})
        model.load_state_dict(load_checkpoint({ckpt!r}))
        with torch.no_grad():
            lc, lv = model.eval()(GraphTensors.from_graph(g, "cpu"))
        np.savez("logits.npz", lc=lc.numpy(), lv=lv.numpy())
    """, tmp_path)
    got = np.load(tmp_path / "logits.npz")
    model = build_model(arch)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        lc, lv = model.eval()(GraphTensors.from_graph(g, "cpu"))
    np.testing.assert_array_equal(got["lc"], lc.numpy())
    np.testing.assert_array_equal(got["lv"], lv.numpy())


def test_jax_ckpt_loader_refuses_other_globals(tmp_path):
    path = str(tmp_path / "evil.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"params": os.getcwd, "opt_state": None}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        load_checkpoint(path)


@pytest.mark.parametrize("entry", ["pred_basis", "run_family_table"])
def test_entry_point_needs_a_gpu_unless_asked(tmp_path, monkeypatch, entry):
    """Without a card an entry point raises unless the CPU is asked for;
    the family table's twin before any prep (nothing is written)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "pred_basis":
            pred_basis.main(["--dataset", "none", "--log_prefix",
                             str(tmp_path), "--warm_gate", "off"])
        else:
            run_family_table.main(["--data_prefix", str(tmp_path / "data")])
    if entry == "run_family_table":
        assert os.listdir(tmp_path) == []
