"""The twins of scripts/dryrun_multihost.py (lp_gnn_tpu_torch/
dryrun_multihost.py) and scripts/make_scaling_artifact.py
(lp_gnn_tpu_torch/make_scaling_artifact.py) against the scripts, on the
CPU, where every kernel wrapper runs its plain version.

The dry run's ranks are processes of ``python -m
lp_gnn_tpu_torch.dryrun_multihost --device cpu`` joined over gloo by the
LP_GNN_DIST_* contract: 4 ranks of the (dp=2, edge=2) grid, and 2 ranks of
``--layout rows``.

Tolerances, stated where they are used:
- the port's ``_tiny_graph``: equal to ``__graft_entry__._tiny_graph``'s
  graph, array for array;
- the dry run's loss: rtol 1e-5 against JAX's make_dp_edge_train_step on
  the same batch and weights (the line rounds it to 6 places, 5e-7 at the
  loss's size);
- the wire volume: equal to the script's ``wire_volume()``, exactly.
"""
import hashlib
import importlib.util
import json
import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch import dryrun_multihost as twin
from lp_gnn_tpu_torch import make_scaling_artifact as scaling
from lp_gnn_tpu_torch.models.gcn import build_model

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
MESH = {"dp": 2, "edge": 2}
LINE_KEYS = {"ok", "distributed", "num_processes", "global_devices", "mesh",
             "loss"}   # scripts/dryrun_multihost.py:80-86


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_twin(k, layout):
    """``k`` ranks of the dry-run twin at MESH, started, not waited for."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "lp_gnn_tpu_torch.dryrun_multihost",
         "--mesh", "dp=2,edge=2", "--layout", layout, "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2",
                           LP_GNN_DIST_COORD=f"localhost:{port}",
                           LP_GNN_DIST_NPROCS=str(k),
                           LP_GNN_DIST_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(k)]


def rank0_line(procs, timeout=300):
    """Wait for every rank (exit 0 asserted); rank 0's JSON lines and the
    other ranks' stdout."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        finally:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0] * len(procs), \
        "\n".join(err[-3000:] for _, err in outs)
    lines = [json.loads(ln) for ln in outs[0][0].splitlines()
             if ln.startswith("{")]
    return lines, [o for o, _ in outs[1:]]


def jax_tiny_graph(monkeypatch, **kw):
    """``__graft_entry__._tiny_graph``'s graph before its padding."""
    import __graft_entry__
    from lp_gnn_tpu.data import batching
    monkeypatch.setattr(batching, "pad_graph", lambda g: g)
    return __graft_entry__._tiny_graph(**kw)


def jax_loss():
    """The script's step (scripts/dryrun_multihost.py:63-77) on MESH of the
    conftest's virtual devices, from the twin's weights carried across."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _tiny_graph
    from lp_gnn_tpu.models.torch_import import gcn_fc_params_from_state_dict
    from lp_gnn_tpu.parallel.combined import (make_dp_edge_train_step,
                                              partition_batch)
    from lp_gnn_tpu.parallel.mesh import make_mesh
    from lp_gnn_tpu.train.trainer import make_optimizer
    mesh = make_mesh(MESH)
    batch = partition_batch([_tiny_graph(seed=s, e=320)
                             for s in range(MESH["dp"])], MESH["edge"])
    sd = build_model(twin.ARCH, generator=torch.Generator().manual_seed(0)
                     ).state_dict()
    params = jax.tree.map(jnp.asarray, gcn_fc_params_from_state_dict(sd))
    optimizer = make_optimizer("adam")
    step = make_dp_edge_train_step("balanced", optimizer, mesh, dp_rate=0.0)
    _, _, loss = step(params, optimizer.init(params), batch,
                      jax.random.PRNGKey(0), jnp.float32(twin.LR))
    return float(loss)


@pytest.fixture(scope="module")
def dryrun_lines():
    """Rank 0's line of the grid (4 ranks) and of ``--layout rows`` (2
    ranks), both started together, and JAX's loss computed meanwhile."""
    grid, rows = start_twin(4, "grid"), start_twin(2, "rows")
    try:
        want = jax_loss()
    finally:
        out = {"grid": rank0_line(grid), "rows": rank0_line(rows)}
    return out, want


@pytest.mark.parametrize("layout,ranks", [("grid", 4), ("rows", 2)])
def test_dryrun_twin_matches_jax(dryrun_lines, layout, ranks):
    """The twin under the contract prints the script's one JSON line from
    rank 0 alone, with the script's keys; its loss is JAX's on the same
    batch and weights."""
    out, want = dryrun_lines
    lines, others = out[layout]
    assert len(lines) == 1 and not any(o.strip() for o in others)
    line = lines[0]
    assert set(line) == LINE_KEYS
    assert line["ok"] is True and line["distributed"] is True
    assert line["num_processes"] == ranks and line["global_devices"] == 1
    assert line["mesh"] == MESH
    np.testing.assert_allclose(line["loss"], want, rtol=1e-5)


def test_dryrun_twin_in_one_process_equals_the_ranks(dryrun_lines,
                                                     capsys):
    """Without the contract one process holds every shard of every graph:
    the same loss as the grid's ranks (rounded as the line rounds it)."""
    out, _ = dryrun_lines
    assert twin.main(["--mesh", "dp=2,edge=2", "--device", "cpu"]) == 0
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert line["distributed"] is False and line["num_processes"] == 1
    np.testing.assert_allclose(line["loss"], out["grid"][0][0]["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("seed,e", [(0, 320), (1, 320), (3, 1000)])
def test_tiny_graph_equals_graft_entry(monkeypatch, seed, e):
    """The port's copy of __graft_entry__.py:13 _tiny_graph draws the same
    graph, array for array."""
    want = jax_tiny_graph(monkeypatch, seed=seed, e=e)
    got = twin._tiny_graph(seed=seed, e=e)
    for f in ("row", "col", "val", "c_feas", "v_feas", "y_s", "y_t"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_wire_volume_equals_the_script():
    """The twin's wire_volume() is the script's, exactly (the same banded
    graph, the port's partition_graph against the JAX package's), and the
    figures chip_smoke.py's scaling_artifact phase holds the card's run
    to."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_scaling_artifact",
        osp.join(ROOT, "scripts", "make_scaling_artifact.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want = script.wire_volume()
    assert scaling.wire_volume() == want
    import chip_smoke
    assert chip_smoke.SCALING_WIRE_VOLUME == want["by_shards"]


def root_files():
    return {n: hashlib.sha256(open(osp.join(ROOT, n), "rb").read()
                              ).hexdigest()
            for n in os.listdir(ROOT) if n.startswith("SCALING_")}


def test_scaling_artifact_tiny_run(tmp_path):
    """A tiny run (2 shards, 3,000 edges, the CPU) writes
    SCALING_torch_r{NN}.json into the current directory with the script's
    keys, labelled one card, a step time for every width of both modes,
    and touches no file at the repo's root."""
    before = root_files()
    out = subprocess.run(
        [sys.executable, "-m", "lp_gnn_tpu_torch.make_scaling_artifact",
         "--round", "7", "--devices", "2", "--device", "cpu", "--edges",
         "3000"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2",
                 PYTHONPATH=os.pathsep.join(
                     [ROOT, os.environ.get("PYTHONPATH", "")])))
    assert out.returncode == 0, out.stderr[-3000:]
    assert root_files() == before
    assert os.listdir(tmp_path) == ["SCALING_torch_r07.json"]
    with open(tmp_path / "SCALING_torch_r07.json") as f:
        art = json.load(f)
    assert set(art) == {"round", "mode", "caveat", "step_time_s", "config",
                        "wire_volume_banded_mirp_like"}
    assert art["round"] == 7 and art["mode"].startswith("one card (cpu)")
    assert "NOT a hardware scaling claim" in art["caveat"]
    assert art["config"] == {"edges": 3000}
    for mode in ("all-gather", "halo"):
        times = art["step_time_s"][mode]
        assert set(times) == {"1", "2"} and all(t > 0 for t in times.values())
    assert art["wire_volume_banded_mirp_like"] == scaling.wire_volume()
