"""One edge shard a rank with dp across: the port's (dp, edge) grid of ranks
(lp_gnn_tpu_torch/parallel/mesh.py RankGrid, combined.py grid_average, the
trainer's and pred_basis' --mesh_shape dp=D,edge=E over D*E ranks) against
the JAX package's (dp, edge) mesh on the conftest's virtual CPU devices and
against the port's layout of D ranks each holding all E shards, on the CPU,
where K1's rank form runs its plain version (all_to_all_single over gloo).
Also --graph_batch over edge ranks against the one-process run.

The ranks are processes of this module (``python -m tests.test_torch_grid
MODE PAYLOAD``), which imports JAX only inside the tests: a session of 4
ranks (dp=2, edge=2) computes every grid case at once, then runs the train
and pred_basis entry points; a session of 2 ranks does the same cases in
the D-rank layout and the --graph_batch run. Inputs are made with numpy
from a seed: graphs of 150 x 250 nodes and 1,200 edges, width 16, depth 3.

Tolerances, stated where they are used (tests/test_torch_combined.py's):
- one grid step (SGD at lr 1e-3, dropout 0, fp32) from the JAX weights:
  the loss rtol 1e-5, the params atol RUN_ATOL and each tensor's update
  within UPDATE_RTOL of its largest, against JAX's make_dp_edge_train_step
  and against the D-rank layout's step; every rank's weights equal;
- a whole run (Adam, 2 epochs, from one JAX mdl.ckpt): each step's loss
  rtol 1e-5 against JAX's run_exp and against the D-rank run, val/acc
  equal, the final params atol RUN_ATOL; the bases pred_basis writes equal
  the one-process run's, byte for byte;
- --graph_batch 2 over edge=2 ranks: each step's loss rtol 1e-5 against
  the one-process run.
"""
import filecmp
import json
import logging
import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lp_gnn_tpu_torch.models.convert import load_checkpoint
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import combined as tcombined
from lp_gnn_tpu_torch.parallel.dp import rank_block
from lp_gnn_tpu_torch.parallel.edge_partition import dist_tensors
from lp_gnn_tpu_torch.parallel.mesh import (grid_ranks, init_distributed,
                                            leave_distributed, make_grid,
                                            make_mesh, world_and_rank)
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced
from tests.test_torch_kernels import port_graph

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
DP, EDGE = 2, 2
GRAPH = dict(m=150, n=250, e=1200)
ARCH = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
GEN = "GENDeeper(8,8,hids=16,depth=3)"
# (arch, halo) of the one-step cases
STEP_CASES = [(ARCH, True), (ARCH, False), (GEN, True)]
STEP_LR = 1e-3
UPDATE_RTOL = 1e-4
RUN_ATOL = 1e-6
# the run's family by split position (8 LPs: train 1-3, 6-7; val 0, 4-5):
# three train graphs of one bucket above RUN_THRESH edges (a grid batch of
# 2, one left over) and two small ones of one stack key (a dp stack)
RUN_SIZES = [(30, 44, 320), (24, 40, 300), (30, 44, 320), (28, 36, 310),
             (20, 30, 120), (22, 34, 130), (20, 30, 120), (22, 34, 130)]
RUN_THRESH = 200


def step_graphs():
    """The batch of the one-step cases: two graphs of one bucket."""
    return [port_graph(np.random.RandomState(70 + i), **GRAPH)
            for i in range(2)]


def weights_path(tmp, arch):
    return osp.join(tmp, f"w0_{arch.split('(')[0]}.pt")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ the rank side
def step_cases(weights, mesh, parts_of, grid=None) -> dict:
    """One dp_edge_train_step a case of STEP_CASES from the JAX weights in
    the directory ``weights``, over ``mesh`` on this rank's block
    (``parts_of(halo)``)."""
    out = {}
    for i, (arch, halo) in enumerate(STEP_CASES):
        model = build_model(arch)
        model.load_state_dict(torch.load(weights_path(weights, arch),
                                         weights_only=True))
        model.dp = 0.0   # JAX's step takes dp_rate=0.0 whatever the arch's
        opt = ttrainer.make_optimizer(model.parameters(), "sgd", STEP_LR)
        dgs = [dist_tensors(model, dg, mesh, input_agg=True)
               for dg in parts_of(halo)]
        loss = tcombined.dp_edge_train_step(model, opt, dgs, balanced,
                                            grid=grid)
        out[i] = {"state": model.state_dict(), "loss": float(loss)}
    return out


def recorded_losses():
    """Each step of the trainer records its loss, in order."""
    losses = []
    for name in ("train_step", "dp_train_step", "dist_train_step",
                 "dp_edge_train_step"):
        real = getattr(ttrainer, name)

        def run(*a, _real=real, **kw):
            out = _real(*a, **kw)
            losses.append(float(out[0] if isinstance(out, tuple) else out))
            return out
        setattr(ttrainer, name, run)
    return losses


def run_entry(payload, rank, exp, argv):
    """The train entry point with ``argv`` and a log prefix of the rank's
    own; returns each step's loss."""
    from lp_gnn_tpu_torch.train.__main__ import main as train_main
    saved = {n: getattr(ttrainer, n) for n in (
        "train_step", "dp_train_step", "dist_train_step",
        "dp_edge_train_step")}
    losses = recorded_losses()
    try:
        train_main([*argv, "--exp_nm", exp, "--log_prefix",
                    osp.join(payload["dir"], f"{exp}{rank}")])
    finally:
        for n, f in saved.items():
            setattr(ttrainer, n, f)
    return losses


def grid_session(payload):
    """Every case of the 4 ranks: the grid's cells and groups, the grid
    steps, then the train and pred_basis entry points (the warm gate's
    solver ``fake_solve``); writes this rank's results."""
    from lp_gnn_tpu_torch import pipeline
    from lp_gnn_tpu_torch.pred_basis import main as pred_main
    from tests.test_torch_edge_ranks import fake_solve
    sys.modules["torch.utils.tensorboard"] = None   # metrics.jsonl alone
    _, rank = world_and_rank()
    tmp = payload["dir"]
    grid = make_grid(DP, EDGE)
    out = {"cell": (grid.d, grid.e),
           "row": dist.get_process_group_ranks(grid.row),
           "col": dist.get_process_group_ranks(grid.col),
           "again": make_grid(DP, EDGE) is grid}
    mesh = make_mesh(EDGE, "cpu", grid.row, row=grid.d)
    graphs = step_graphs()
    own = rank_block([0, 1], DP, grid.d)
    out["steps"] = step_cases(
        payload["weights"], mesh, lambda halo: tcombined.partition_batch(
            graphs, EDGE, halo=halo, own=own), grid)
    out["run"] = run_entry(payload, rank, "grid", payload["train"])
    pipeline.solve_backend = lambda cfg: fake_solve
    pred_main([*payload["pred"], "--log_prefix",
               osp.join(tmp, f"pred{rank}")])
    torch.save(out, osp.join(tmp, f"grid_rank{rank}.pt"))


def rows_session(payload):
    """The 2-rank cases: the one-step cases and the run in the D-rank
    layout (each rank all E shards of its block), then the --graph_batch 2
    run over edge=2 ranks; writes this rank's results."""
    sys.modules["torch.utils.tensorboard"] = None
    _, rank = world_and_rank()
    tmp = payload["dir"]
    graphs = step_graphs()
    own = rank_block([0, 1], DP, rank)
    out = {"steps": step_cases(payload["weights"], make_mesh(EDGE, "cpu"),
                               lambda halo: tcombined.partition_batch(
                                   graphs, EDGE, halo=halo, own=own)),
           "run": run_entry(payload, rank, "rows", payload["train"]),
           "batched": run_entry(payload, rank, "batched",
                                payload["batched"])}
    torch.save(out, osp.join(tmp, f"rows_rank{rank}.pt"))


def start_ranks(mode, payload, tmp, k):
    """``k`` processes of this module in ``mode``, joined over gloo by the
    LP_GNN_DIST_* contract, started and not waited for."""
    path = osp.join(tmp, f"{mode}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    port = free_port()
    procs = []
    for rank in range(k):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   LP_GNN_DIST_COORD=f"localhost:{port}",
                   LP_GNN_DIST_NPROCS=str(k), LP_GNN_DIST_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_grid", mode, path],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs, timeout=300):
    """Every process of ``start_ranks`` ended; each exit code 0 asserted."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0] * len(procs), \
        "\n".join(o[-3000:] for o in outs)


def main(argv):
    mode, path = argv
    with open(path) as f:
        payload = json.load(f)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    _, created = init_distributed(torch.device("cpu"))
    try:
        {"grid": grid_session, "rows": rows_session}[mode](payload)
    finally:
        leave_distributed(created)


# ------------------------------------------------------------- the JAX side
def jax_params(arch, key=0):
    import jax
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    return jax.tree.map(np.asarray, jax_build_model(arch).init(
        jax.random.PRNGKey(key)))


def jax_graph(g):
    from lp_gnn_tpu.data.batching import pad_graph
    from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
    return pad_graph(JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")}))


def update_rel(w0, a, b):
    """The largest, over tensors, of max |u_a - u_b| / max |u_b|, u = w0 -
    w, an SGD step's update."""
    worst = 0.0
    for name, v in w0.items():
        ua = v.double() - a[name].double()
        ub = v.double() - b[name].double()
        worst = max(worst, float((ua - ub).abs().max()
                                 / ub.abs().max().clamp(min=1e-30)))
    return worst


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """RUN_SIZES' LPs, each with a cold solve's log (the warm gate reads
    its iterations), one JAX mdl.ckpt, and the JAX weights of every step
    case as port state_dicts."""
    import jax
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    from tests.test_torch_sampling import write_family
    root = tmp_path_factory.mktemp("torch_grid")
    prefix = root / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"), RUN_SIZES, seed=17)
    logs = prefix / "fam" / "log" / "highs-no-bas"
    logs.mkdir(parents=True)
    for i in range(len(RUN_SIZES)):
        (logs / f"lp_{i}.log").write_text(
            f"Solution time =  0.5 sec.  Iterations = {40 + i}\n")
    ckpt = str(root / "init.ckpt")
    jtrainer.save_ckpt(ckpt, jax.tree.map(np.asarray, jax_build_model(
        ARCH).init(jax.random.PRNGKey(9))))
    for arch in {a for a, _ in STEP_CASES}:
        torch.save(state_dict_from_jax_params(jax_params(arch)),
                   weights_path(str(root), arch))
    return str(root), str(prefix), ckpt


def train_argv(data_prefix, ckpt, mesh_shape, **kw):
    """The runs' flags: no input cache (exact either way; the step cases
    hold the grid's cache, and JAX compiles each attach of it apart)."""
    kw = dict(dataset="fam", data_prefix=data_prefix, device="cpu",
              arch=ARCH, epochs=2, eval_every=2, load_from=ckpt,
              mesh_shape=mesh_shape, edge_num_thresh=RUN_THRESH,
              cache_in_agg=0, **kw)
    return [x for k, v in kw.items() for x in (f"--{k}", str(v))]


def pred_argv(data_prefix, ckpt):
    return ["--dataset", "fam", "--data_prefix", data_prefix, "--device",
            "cpu", "--arch", ARCH, "--mesh_shape", f"dp={DP},edge={EDGE}",
            "--edge_num_thresh", str(RUN_THRESH), "--exp_nm", "pred",
            "--load_from", ckpt, "--split", "val", "--warm_gate", "auto",
            "--warm_gate_k", "1", "--warm_gate_kmax", "1"]


def jax_step(root, case):
    """JAX's make_dp_edge_train_step on the (dp=2, edge=2) grid of virtual
    devices (tests/test_parallel.py:526) from the case's weights: (loss,
    the weights after it as a port state_dict)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    from lp_gnn_tpu.parallel import combined as jcombined
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    arch, halo = STEP_CASES[case]
    params = jax_params(arch)
    mesh = jax_make_mesh({"dp": DP, "edge": EDGE},
                         devices=jax.devices()[:DP * EDGE])
    reads = "GEN" not in arch
    batch = jcombined.partition_batch(
        [jax_graph(g) for g in step_graphs()], EDGE, halo=halo,
        input_agg_mesh=Mesh(mesh.devices[0], ("edge",)) if reads else None)
    opt = jtrainer.make_optimizer("sgd")
    step = jcombined.make_dp_edge_train_step(
        "balanced", opt, mesh, dp_rate=0.0, arch=jax_build_model(arch).name)
    p1, _, loss = step(params, opt.init(params), batch,
                       jax.random.PRNGKey(1), jnp.float32(STEP_LR))
    return float(loss), state_dict_from_jax_params(
        jax.tree.map(np.asarray, p1))


def jax_run(data_prefix, ckpt, log_prefix):
    """JAX's run_exp with the grid run's flags on its (dp, edge) mesh:
    (each step's loss, the run's config, the final weights as a port
    state_dict). The steps' dropout is 0 (tests/test_torch_combined.py
    record_jax_steps) and each dp step's loss is recorded too."""
    import pickle
    from lp_gnn_tpu.config import Config as JaxConfig
    from lp_gnn_tpu.parallel import dp as jdp
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    from tests.test_torch_combined import record_jax_steps
    with pytest.MonkeyPatch.context() as mp:
        seen = record_jax_steps(mp)
        real_dp = jdp.make_dp_train_step

        def make_dp(*a, **kw):
            step = real_dp(*a, **kw)

            def run(*sa, **skw):
                out = step(*sa, **skw)
                seen.append(float(out[2]))
                return out
            return run

        mp.setattr(jdp, "make_dp_train_step", make_dp)
        jcfg = JaxConfig(
            exp_nm="jax", log_prefix=log_prefix, dataset="fam",
            data_prefix=data_prefix, arch=ARCH, epochs=2, eval_every=2,
            load_from=ckpt, mesh_shape=f"dp={DP},edge={EDGE}",
            edge_num_thresh=RUN_THRESH, cache_in_agg=0).finalize()
        jpath = jtrainer.run_exp(jcfg)
    with open(jpath, "rb") as f:
        want = state_dict_from_jax_params(pickle.load(f)["params"])
    return seen, jcfg, want


@pytest.fixture(scope="module")
def results(family):
    """Both rank sessions (4 grid ranks; 2 ranks of the D-rank layout),
    started together, and the JAX side computed while they run."""
    root, data_prefix, ckpt = family
    shape = f"dp={DP},edge={EDGE}"
    tmp = osp.join(root, "ranks")
    os.makedirs(tmp)
    procs = start_ranks("grid", {"dir": tmp, "weights": root,
                                 "train": train_argv(data_prefix, ckpt,
                                                     shape),
                                 "pred": pred_argv(data_prefix, ckpt)},
                        tmp, DP * EDGE)
    procs += start_ranks("rows", {"dir": tmp, "weights": root,
                                  "train": train_argv(data_prefix, ckpt,
                                                      shape),
                                  "batched": train_argv(
                                      data_prefix, ckpt, f"edge={EDGE}",
                                      graph_batch=2)}, tmp, DP)
    try:
        steps = [jax_step(root, c) for c in range(len(STEP_CASES))]
        run = jax_run(data_prefix, ckpt, osp.join(root, "jax"))
    finally:
        wait_ranks(procs)
    grid = [torch.load(osp.join(tmp, f"grid_rank{r}.pt"), weights_only=True)
            for r in range(DP * EDGE)]
    rows = [torch.load(osp.join(tmp, f"rows_rank{r}.pt"), weights_only=True)
            for r in range(DP)]
    return {"dir": tmp, "grid": grid, "rows": rows, "jax_steps": steps,
            "jax_run": run}


# --------------------------------------------------------------- the grid
@pytest.mark.parametrize("dp,edge", [(2, 4), (2, 2)])
def test_grid_cells_follow_jax_device_order(dp, edge):
    """Rank r is cell (r // E, r % E): each row's and column's ranks are
    the device ids of that row and column of JAX's make_mesh({"dp": D,
    "edge": E}) over the conftest's virtual devices (numbered 0..7)."""
    import jax
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    devs = jax_make_mesh({"dp": dp, "edge": edge},
                         devices=jax.devices()[:dp * edge]).devices
    ids = np.vectorize(lambda d: d.id)(devs)
    rows, cols = grid_ranks(dp, edge)
    assert rows == ids.tolist() and cols == ids.T.tolist()


def test_grid_groups_over_ranks(results):
    """Over 4 ranks each rank's cell, row group and column group are
    grid_ranks' (the JAX device order), and make_grid returns its grid
    again without new groups."""
    rows, cols = grid_ranks(DP, EDGE)
    for r, res in enumerate(results["grid"]):
        d, e = divmod(r, EDGE)
        assert res["cell"] == (d, e)
        assert res["row"] == rows[d] and res["col"] == cols[e]
        assert res["again"]


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[f"{a.split('(')[0]}-{'halo' if h else 'ag'}"
                              for a, h in STEP_CASES])
def test_grid_step_matches_jax_and_rows(family, results, case):
    """One dp_edge_train_step on the (dp=2, edge=2) grid of 4 gloo ranks
    against JAX's make_dp_edge_train_step on the same grid of virtual
    devices and against the D-rank layout's step over 2 ranks, from the
    same weights: every rank's loss and weights equal; the loss, the
    weights and every tensor's update."""
    arch, _ = STEP_CASES[case]
    jloss, want = results["jax_steps"][case]
    w0 = torch.load(weights_path(family[0], arch), weights_only=True)
    got = results["grid"][0]["steps"][case]
    for res in results["grid"][1:]:
        assert res["steps"][case]["loss"] == got["loss"]
        assert all(torch.equal(v, res["steps"][case]["state"][k])
                   for k, v in got["state"].items())
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    for name, v in got["state"].items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    assert update_rel(w0, got["state"], want) < UPDATE_RTOL
    rows_step = results["rows"][0]["steps"][case]
    np.testing.assert_allclose(got["loss"], rows_step["loss"], rtol=1e-5)
    assert update_rel(w0, got["state"], rows_step["state"]) < UPDATE_RTOL


def test_grid_run_matches_jax_and_rows(results):
    """The train entry point with --mesh_shape dp=2,edge=2 over 4 gloo
    ranks against JAX's run_exp with the same flags on its (dp, edge) mesh
    and against the same flags over 2 ranks (each all shards of its
    block), 2 epochs of Adam from one JAX mdl.ckpt: an epoch takes one
    grid batch, one dp stack over the columns and one graph left over
    (dist over each row); the same losses on every rank, the same steps'
    losses, val/acc and final weights; only rank 0 writes."""
    from tests.test_torch_train import metrics
    tmp, grid = results["dir"], results["grid"]
    seen, jcfg, want = results["jax_run"]
    losses = grid[0]["run"]
    assert all(res["run"] == losses for res in grid[1:])
    assert len(losses) == len(seen) == 6
    np.testing.assert_allclose(losses, seen, rtol=1e-5)
    np.testing.assert_allclose(losses, results["rows"][0]["run"], rtol=1e-5)
    assert [osp.exists(osp.join(tmp, f"grid{r}")) for r in range(4)] == \
        [True, False, False, False]
    log_dir = osp.join(tmp, "grid0", "grid")
    assert metrics(log_dir)["val/acc"] == metrics(jcfg.log_dir)["val/acc"]
    for name, v in load_checkpoint(osp.join(log_dir, "mdl.pth")).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)


def test_grid_pred_basis_equals_one_process(family, results, tmp_path,
                                            monkeypatch):
    """pred_basis with --mesh_shape dp=2,edge=2 over 4 ranks (row 0
    serves, row 1 runs nothing) against the same flags in one process (all
    shards stacked): the same .bas files, byte for byte, and the same warm
    gate; only rank 0 writes."""
    from lp_gnn_tpu_torch import pipeline
    from lp_gnn_tpu_torch.config import parse_args
    from tests.test_torch_edge_ranks import fake_solve
    _, data_prefix, ckpt = family
    tmp = results["dir"]
    assert [osp.exists(osp.join(tmp, f"pred{r}")) for r in range(4)] == \
        [True, False, False, False]
    monkeypatch.setattr(pipeline, "solve_backend", lambda cfg: fake_solve)
    one = parse_args([*pred_argv(data_prefix, ckpt), "--log_prefix",
                      str(tmp_path)])
    out_dir = pipeline.stage_pred_basis(one)
    with open(osp.join(one.log_dir, "warm_gate.json")) as f:
        want_gate = json.load(f)
    with open(osp.join(tmp, "pred0", "pred", "warm_gate.json")) as f:
        assert json.load(f) == want_gate and want_gate["k"] == 1
    names = sorted(os.listdir(out_dir))
    got_dir = osp.join(tmp, "pred0", "pred", osp.basename(out_dir))
    assert len(names) == 6 and sorted(os.listdir(got_dir)) == names
    assert all(filecmp.cmp(osp.join(got_dir, n), osp.join(out_dir, n),
                           shallow=False) for n in names)


def test_graph_batch_over_edge_ranks_equals_one_process(family, results,
                                                        tmp_path,
                                                        monkeypatch):
    """--mesh_shape edge=2 --graph_batch 2 over 2 ranks (the small graphs'
    unions alike on both ranks, the oversize graphs' dist steps over the
    ranks) against the same flags in one process: each step's loss."""
    from lp_gnn_tpu_torch.config import parse_args
    _, data_prefix, ckpt = family
    rows = results["rows"]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    saved = {n: getattr(ttrainer, n) for n in (
        "train_step", "dp_train_step", "dist_train_step",
        "dp_edge_train_step")}
    for n, f in saved.items():
        monkeypatch.setattr(ttrainer, n, f)
    seen = recorded_losses()
    ttrainer.run_exp(parse_args([
        *train_argv(data_prefix, ckpt, f"edge={EDGE}", graph_batch=2),
        "--exp_nm", "one", "--log_prefix", str(tmp_path)]))
    assert rows[0]["batched"] == rows[1]["batched"]
    assert len(seen) == len(rows[0]["batched"]) == 2 * (1 + 3)
    np.testing.assert_allclose(rows[0]["batched"], seen, rtol=1e-5)


if __name__ == "__main__":
    main(sys.argv[1:])
