"""Edge shards on their own ranks (lp_gnn_tpu_torch/parallel: the rank form
of K1 in halo.py, EdgeMesh over a group in mesh.py, the rank route of the
halo pair, the losses' psums and the gradient sum in edge_partition.py; the
trainer's and pred_basis' --mesh_shape edge=K under the LP_GNN_DIST_*
contract) against the JAX package's edge axis on the conftest's virtual CPU
devices and against the port's one-process stacked path, on the CPU, where
K1's rank form runs its plain version (all_to_all_single over gloo).

The ranks are processes of this module (``python -m
tests.test_torch_edge_ranks MODE PAYLOAD``), which imports JAX only inside
the tests: a session of K ranks computes every rank-side case at once and
writes each rank's results to a file; the tests read them. Inputs are made
with numpy from a seed: a graph of 150 x 250 nodes and 1,200 edges, width
16, depth 3.

Tolerances, stated where they are used:
- K1's rank form: bit for bit (a copy), against JAX's pallas_all_to_all in
  interpret mode and the stacked plain version;
- fp32 logits: against JAX's dist_apply atol DIST_ATOL (JAX's own
  dist-vs-single tolerance, tests/test_parallel.py:43), GENDeeper's
  GEN_ATOL (tests/test_torch_dist_zoo.py's); against the stacked path atol
  STACKED_ATOL (the same sums; the linears run over one shard's rows
  instead of all K shards', which may round otherwise);
- one dist SGD step at lr 1, dropout 0: the loss rtol 1e-5 and each
  tensor's update within UPDATE_RTOL of its largest, against JAX's
  make_dist_train_step (GraphConv archs) and against the stacked
  dist_train_step (tests/test_torch_dist_train.py's rule); every rank's
  weights equal;
- a whole run (Adam, 2 epochs) against the one-process run: each step's
  loss rtol 1e-5, the final params atol RUN_ATOL, val/acc equal; the
  bases that pred_basis writes equal, byte for byte.
"""
import filecmp
import json
import logging
import os
import os.path as osp
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.infer.predict import mesh_from_cfg
from lp_gnn_tpu_torch.models.convert import load_checkpoint
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel import halo as thalo
from lp_gnn_tpu_torch.parallel.mesh import (EdgeMesh, init_distributed,
                                            leave_distributed, make_mesh,
                                            world_and_rank)
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import LOSS_REGISTRY
from tests.test_torch_kernels import port_graph

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
GRAPH = dict(m=150, n=250, e=1200)
DIST_ATOL = 5e-4
GEN_ATOL = 5e-5
STACKED_ATOL = 1e-5
UPDATE_RTOL = 1e-4
RUN_ATOL = 1e-6
ARCH = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
GEN = "GENDeeper(8,8,hids=16,depth=3)"
ZOO = ["GCN(8,8,hids=16)", "GCNDeeper(8,8,hids=16,depth=3)"]
FWD_ARCHS = [ARCH, *ZOO, GEN, "GCNRand()"]
# (arch, loss) of the one-step cases a session of K ranks takes
STEPS = {2: [(ARCH, loss) for loss in LOSS_REGISTRY]
         + [(a, "balanced") for a in (*ZOO, GEN, "GCNRand()")],
         4: [(ARCH, "balanced"), (GEN, "balanced")]}
A2A = dict(bh=6, f=5)


def graph(k):
    return port_graph(np.random.RandomState(60 + k), **GRAPH)


def a2a_inputs(k):
    rng = np.random.RandomState(40 + k)
    shape = (k, k * A2A["bh"], A2A["f"])
    return rng.randn(*shape).astype(np.float32), \
        rng.randn(*shape).astype(np.float32)


def weights_path(tmp, arch):
    return osp.join(tmp, f"w0_{arch.split('(')[0]}.pt")


def fake_solve(mps, method=1, basis_in_path=None, basis_out_path=None,
               log_path=None):
    """A stand-in for the solver in the warm gate: the iterations a CRC of
    the basis it is given, so that two gates agree only on equal bases."""
    with open(basis_in_path, "rb") as f:
        niter = zlib.crc32(f.read()) % 97
    return types.SimpleNamespace(niter=niter, basis_rejected=False,
                                 status="Optimal")


def no_dropout(model):
    """dropout 0 in the models whose rate is fixed (GCN, GCNDeeper)."""
    if hasattr(model, "dp"):
        model.dp = 0.0
    return model


# ------------------------------------------------------------ the rank side
def rank_session(payload):
    """Every rank-side case of a session of K ranks: the rank form of K1
    and its backward, each arch's dist forward (eval) and the logits
    gathered to rank 0, one dist step a case, and the refusals that need a
    group; writes this rank's results."""
    k, me = world_and_rank()
    tmp = payload["dir"]
    mesh = make_mesh(k, "cpu", dist.group.WORLD)
    bufs, cts = a2a_inputs(k)
    out = {"a2a": thalo.halo_all_to_all_ranks(torch.from_numpy(bufs[me]))}
    x = torch.from_numpy(bufs[me]).requires_grad_()
    thalo.HaloAllToAllRanks.apply(x, dist.group.WORLD).backward(
        torch.from_numpy(cts[me]))
    out["a2a_grad"] = x.grad
    g = graph(k)
    dg = tEP.partition_graph(g, k, halo=True)
    for arch in FWD_ARCHS:
        model = build_model(arch)
        model.load_state_dict(torch.load(weights_path(tmp, arch)))
        model.eval()
        with torch.no_grad():
            local = tEP.dist_apply(model, dg, mesh)
            out[f"fwd/{arch}"] = tEP.gather_logits(*local, mesh)
        out[f"fwd_local/{arch}"] = local
    for arch, loss in STEPS[k]:
        model = no_dropout(build_model(arch))
        model.load_state_dict(torch.load(weights_path(tmp, arch)))
        opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
        dgt = tEP.dist_tensors(model, dg, mesh, input_agg=True)
        step_loss = tEP.dist_train_step(model, opt, dgt, LOSS_REGISTRY[loss],
                                        torch.Generator().manual_seed(1))
        out[f"step/{arch}/{loss}"] = (float(step_loss), model.state_dict())
    refused = {}
    try:
        mesh_from_cfg(Config(mesh_shape=f"edge={2 * k}"), torch.device("cpu"))
    except ValueError as e:
        refused["edge_vs_world"] = str(e)
    out["refused"] = refused
    agreed = {}
    for name, rc in (("all_ok", 0), ("last_failed", int(me == k - 1) * 700)):
        try:
            thalo._agree(rc, None, torch.device("cpu"))
            agreed[name] = "ok"
        except RuntimeError as e:
            agreed[name] = str(e)
    out["agree"] = agreed
    out["launches"] = thalo.halo_all_to_all.launches
    torch.save(out, osp.join(tmp, f"rank{me}.pt"))


def rank_run(payload):
    """One rank of the whole-run case: the train entry point, then the
    pred_basis entry point (a new group, on a port of its own; the warm
    gate's solver ``fake_solve``), each with a log prefix of the rank's
    own; each dist step's loss recorded. The metrics go to metrics.jsonl
    alone: importing TensorBoard takes seconds here and is not what the
    test holds."""
    from lp_gnn_tpu_torch import pipeline
    from lp_gnn_tpu_torch.pred_basis import main as pred_main
    from lp_gnn_tpu_torch.train.__main__ import main as train_main
    sys.modules["torch.utils.tensorboard"] = None
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    losses = []
    real = ttrainer.dist_train_step

    def recorded(*a, **kw):
        loss = real(*a, **kw)
        losses.append(float(loss))
        return loss

    ttrainer.dist_train_step = recorded
    train_main([*payload["train"], "--log_prefix",
                osp.join(payload["dir"], f"rank{rank}")])
    os.environ["LP_GNN_DIST_COORD"] = payload["coord2"]
    pipeline.solve_backend = lambda cfg: fake_solve
    pred_main([*payload["pred"], "--log_prefix",
               osp.join(payload["dir"], f"pred{rank}")])
    with open(osp.join(payload["dir"], f"losses_rank{rank}.json"), "w") as f:
        json.dump(losses, f)


def run_ranks(mode, payload, tmp_path, k, timeout=300):
    """``k`` processes of this module in ``mode``, joined over gloo by the
    LP_GNN_DIST_* contract; each rank's exit code 0 asserted."""
    from tests.test_torch_dp import free_port
    path = str(tmp_path / f"{mode}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    port = free_port()
    procs = []
    for rank in range(k):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   LP_GNN_DIST_COORD=f"localhost:{port}",
                   LP_GNN_DIST_NPROCS=str(k), LP_GNN_DIST_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_edge_ranks", mode, path],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0] * k, \
        "\n".join(o[-3000:] for o in outs)
    return outs


def main(argv):
    mode, path = argv
    with open(path) as f:
        payload = json.load(f)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if mode == "run":   # the entry points join and leave the group
        return rank_run(payload)
    _, created = init_distributed(torch.device("cpu"))
    try:
        rank_session(payload)
    finally:
        leave_distributed(created)


# ------------------------------------------------------------- the JAX side
def jax_params(arch):
    import jax
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    return jax.tree.map(np.asarray, jax_build_model(arch).init(
        jax.random.PRNGKey(0)))


def jax_mesh(k):
    import jax
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    return jax_make_mesh({"edge": k}, devices=jax.devices()[:k])


def jax_partition(k):
    from lp_gnn_tpu.data.batching import pad_graph
    from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
    from lp_gnn_tpu.parallel import edge_partition as jEP
    g = graph(k)
    jg = JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")})
    return jEP.partition_graph(pad_graph(jg), k, halo=True)


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def session(request, tmp_path_factory):
    """The JAX weights of every arch (as port state_dicts), one session of
    K ranks over them; returns (K, the weights, each rank's results)."""
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    k = request.param
    tmp = tmp_path_factory.mktemp(f"edge_ranks_k{k}")
    weights = {}
    for arch in FWD_ARCHS:
        weights[arch] = build_model(arch).state_dict() \
            if arch == "GCNRand()" else \
            state_dict_from_jax_params(jax_params(arch))
        torch.save(weights[arch], weights_path(str(tmp), arch))
    run_ranks("session", {"dir": str(tmp)}, tmp, k)
    ranks = [torch.load(osp.join(tmp, f"rank{r}.pt")) for r in range(k)]
    return k, weights, ranks


# ------------------------------------------------------------------- tests
def test_rank_exchange_matches_jax_pallas_and_plain(session):
    """K1's rank form over K gloo ranks, each rank's buffer against JAX's
    pallas_all_to_all in interpret mode (the remote-copy kernel,
    parallel/pallas_halo.py:69) under shard_map and against the stacked
    plain version, bit for bit; its backward is the same exchange of the
    cotangent; no stacked launch."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from lp_gnn_tpu.parallel.pallas_halo import pallas_all_to_all
    k, _, ranks = session
    bufs, cts = a2a_inputs(k)
    fn = jax.jit(shard_map(
        lambda a: pallas_all_to_all(a[0], "edge", k, A2A["bh"])[None],
        mesh=jax_mesh(k), in_specs=P("edge"), out_specs=P("edge"),
        check_vma=False))
    want = np.asarray(fn(bufs))
    plain = thalo.halo_all_to_all_plain(torch.from_numpy(bufs))
    grad = thalo.halo_all_to_all_plain(torch.from_numpy(cts))
    for me, r in enumerate(ranks):
        np.testing.assert_array_equal(r["a2a"].numpy(), want[me])
        assert torch.equal(r["a2a"], plain[me])
        assert torch.equal(r["a2a_grad"], grad[me])
        assert r["launches"] == 0


def stacked_logits(model, k):
    g = graph(k)
    with torch.no_grad():
        lc, lv = tEP.dist_apply(model,
                                tEP.partition_graph(g, k, halo=True),
                                make_mesh(k, "cpu"))
    return lc, lv


@pytest.mark.parametrize("arch", FWD_ARCHS)
def test_rank_forward_matches_jax_and_stacked(session, arch):
    """Each arch's dist forward with shard k on rank k (fp32, eval): the
    logits rank 0 gathers against JAX's dist_apply at edge=K with the same
    weights (DIST_ATOL) and against the one-process stacked path
    (STACKED_ATOL), each rank's own rows those of its shard; the other
    ranks hold no gathered logits. GCNRand draws from the port's
    generator, not JAX's keys: against JAX its knowledge mask (the signs),
    against the stacked path exactly."""
    import jax
    from lp_gnn_tpu.parallel import edge_partition as jEP
    k, weights, ranks = session
    g = graph(k)
    model = build_model(arch)
    model.load_state_dict(weights[arch])
    model.eval()
    lc, lv = stacked_logits(model, k)
    got_c, got_v = ranks[0][f"fwd/{arch}"]
    assert all(r[f"fwd/{arch}"] == (None, None) for r in ranks[1:])
    params = jax_params(arch)
    dg = jax_partition(k)
    jc, jv = jax.jit(lambda p, d: jEP.dist_apply(
        p, d, jax_mesh(k), arch=arch.split("(")[0]))(params, dg)
    want = np.concatenate([np.asarray(jc)[:g.ncons], np.asarray(jv)[:g.nvars]])
    got = np.concatenate([got_c[:g.ncons].numpy(), got_v[:g.nvars].numpy()])
    stacked = np.concatenate([lc[:g.ncons].numpy(), lv[:g.nvars].numpy()])
    ms, ns = got_c.shape[0] // k, got_v.shape[0] // k
    for me, r in enumerate(ranks):
        loc_c, loc_v = r[f"fwd_local/{arch}"]
        assert torch.equal(loc_c, got_c[me * ms:(me + 1) * ms])
        assert torch.equal(loc_v, got_v[me * ns:(me + 1) * ns])
    if arch == "GCNRand()":
        np.testing.assert_array_equal(got < 0, want < 0)
        np.testing.assert_array_equal(got, stacked)
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GEN_ATOL if arch == GEN else DIST_ATOL)
    np.testing.assert_allclose(got, stacked, rtol=0, atol=STACKED_ATOL)


def update_rel(w0, a, b):
    from tests.test_torch_dist_train import update_rel as rel
    return rel(w0, a, b)


def stacked_step(arch, loss, w0, k):
    model = no_dropout(build_model(arch))
    model.load_state_dict(w0)
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
    dgt = tEP.dist_tensors(model,
                           tEP.partition_graph(graph(k), k, halo=True),
                           make_mesh(k, "cpu"), input_agg=True)
    got = tEP.dist_train_step(model, opt, dgt, LOSS_REGISTRY[loss],
                              torch.Generator().manual_seed(1))
    return float(got), model.state_dict()


def jax_step(arch, loss, k):
    import jax
    import jax.numpy as jnp
    from lp_gnn_tpu.parallel import edge_partition as jEP
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    params = jax_params(arch)
    optimizer = jtrainer.make_optimizer("sgd")
    step = jax.jit(jEP.make_dist_train_step(
        loss, optimizer, jax_mesh(k), dp_rate=0.0, arch=arch.split("(")[0]))
    p1, _, jloss = step(params, optimizer.init(params), jax_partition(k),
                        jax.random.PRNGKey(1), jnp.float32(1.0))
    return float(jloss), state_dict_from_jax_params(
        jax.tree.map(np.asarray, p1))


def test_rank_train_steps_match_jax_and_stacked(session):
    """One dist step a case with shard k on rank k (SGD at lr 1, dropout
    0, fp32), from the JAX weights: the loss (the whole graph's, on every
    rank) and every tensor's update against JAX's make_dist_train_step at
    edge=K and against the stacked dist_train_step; every rank ends with
    the same weights. GCNRand's weights depend on no gradient: its loss
    against the stacked step's only (its logits are the port's draws).
    GENDeeper against the stacked step (which tests/test_torch_dist_zoo.py
    holds to the single-card step): the owners' merge over ranks."""
    k, weights, ranks = session
    for arch, loss in STEPS[k]:
        key = f"step/{arch}/{loss}"
        got_loss, got = ranks[0][key]
        for r in ranks[1:]:
            assert r[key][0] == got_loss
            assert all(torch.equal(v, r[key][1][n]) for n, v in got.items())
        w0 = weights[arch]
        s_loss, stacked = stacked_step(arch, loss, w0, k)
        np.testing.assert_allclose(got_loss, s_loss, rtol=1e-5, err_msg=key)
        if arch == "GCNRand()":
            assert all(torch.equal(v, w0[n]) for n, v in got.items())
            continue
        assert update_rel(w0, got, stacked) < UPDATE_RTOL, key
        if arch == GEN:
            continue
        j_loss, want = jax_step(arch, loss, k)
        np.testing.assert_allclose(got_loss, j_loss, rtol=1e-5, err_msg=key)
        assert update_rel(w0, got, want) < UPDATE_RTOL, key


def test_refusals_over_ranks(session):
    """An edge mesh whose K is not the group's size raises."""
    _, _, ranks = session
    for r in ranks:
        assert "one shard a rank" in r["refused"]["edge_vs_world"]


def test_rank_launch_failure_raises_on_every_rank(session):
    """The rank form swaps the ranks' error codes after its launch: where
    one rank's launch failed, every rank raises and names it (none waits
    for the one that failed); where none did, none raises."""
    k, _, ranks = session
    codes = [0] * (k - 1) + [700]
    for r in ranks:
        assert r["agree"]["all_ok"] == "ok"
        assert f"CUDA errors by rank {codes}" in r["agree"]["last_failed"]


def test_refusals_in_one_process():
    """Two devices in one process (an edge mesh, K1's list form) raise and
    name their ROADMAP item (7c's rest); a world of dp*E ranks (the grid)
    and --graph_batch over edge ranks, once refused as queue item 7f, take
    their batch shapes (tests/test_torch_grid.py runs them)."""
    with pytest.raises(NotImplementedError, match="queue item 7c's rest"):
        EdgeMesh((torch.device("cpu"), torch.device("meta")))
    with pytest.raises(NotImplementedError, match="queue item 7c's rest"):
        thalo.halo_all_to_all([torch.zeros(4, 4),
                               torch.zeros(4, 4, device="meta")])
    assert ttrainer.batch_shape(Config(mesh_shape="dp=2,edge=2"), 4) == \
        (2, 1)
    assert ttrainer.batch_shape(Config(mesh_shape="edge=2", graph_batch=2),
                                2) == (1, 2)
    assert ttrainer.batch_shape(Config(mesh_shape="edge=2"), 2) == (1, 1)


def test_rank_windows_grow_and_stay_one(monkeypatch):
    """The rank form's receive windows: one a (group, device), grown to
    the largest exchange so far and never kept beside a smaller one, so a
    run over many graph sizes holds one window of the largest. The CUDA
    allocation and the peers' mapping are stubbed; their order is what is
    held (the old window dropped before the new one is made)."""
    calls = []

    def make(nbytes, group, dev):
        calls.append(("make", nbytes))
        return thalo._Window(0, nbytes, [1], None, group)

    def drop(key):
        calls.append(("drop", thalo._WINDOWS.pop(key).nbytes))

    monkeypatch.setattr(thalo, "_WINDOWS", {})
    monkeypatch.setattr(thalo, "_make_window", make)
    monkeypatch.setattr(thalo, "_drop_window", drop)
    dev, other = torch.device("cuda", 0), torch.device("cuda", 1)
    for nbytes in (4096, 1024, 8192, 4096, 8192, 2048):
        assert thalo._window(nbytes, None, dev).nbytes >= nbytes
        assert len(thalo._WINDOWS) == 1
    assert calls == [("make", 4096), ("drop", 4096), ("make", 8192)]
    assert thalo.window_bytes() == 8192
    thalo._window(64, None, other)   # another device: a window of its own
    assert thalo.window_bytes() == 8192 + 64
    thalo.release_windows()
    assert thalo._WINDOWS == {} and thalo.window_bytes() == 0


# ---------------------------------------------------------- whole entries
@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """3 tiny LPs (2 train, 1 val), each with a cold solve's log (the
    warm gate reads its iterations), and a seeded checkpoint."""
    from tests.test_torch_sampling import write_family
    root = tmp_path_factory.mktemp("edge_ranks_run")
    prefix = root / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"),
                 [(30, 50, 300), (24, 40, 260), (36, 44, 320)], seed=13)
    logs = prefix / "fam" / "log" / "highs-no-bas"
    logs.mkdir(parents=True)
    for i in range(3):
        (logs / f"lp_{i}.log").write_text(
            f"Solution time =  0.5 sec.  Iterations = {40 + i}\n")
    ckpt = str(root / "seeded.pth")
    torch.save(build_model(ARCH, generator=torch.Generator().manual_seed(5))
               .state_dict(), ckpt)
    return str(prefix), ckpt


def test_run_and_serve_over_ranks_equal_one_process(family, tmp_path,
                                                    monkeypatch):
    """The train and pred_basis entry points with --mesh_shape edge=2
    --edge_num_thresh 0 over 2 ranks against the same in one process (all
    shards stacked): the same steps' losses, val/acc and final params
    (Adam, 2 epochs); the same .bas files and the same warm gate (rank 0
    decides and tells rank 1, LP by LP: one LP run, then the stop, with
    --warm_gate_k 1 --warm_gate_kmax 1); rank 1 writes nothing."""
    from lp_gnn_tpu_torch.pipeline import stage_pred_basis
    from tests.test_torch_dp import free_port
    from tests.test_torch_train import metrics
    data_prefix, ckpt = family
    common = ["--dataset", "fam", "--data_prefix", data_prefix,
              "--device", "cpu", "--arch", ARCH, "--mesh_shape", "edge=2",
              "--edge_num_thresh", "0"]
    train = [*common, "--exp_nm", "run", "--epochs", "2", "--eval_every",
             "2", "--seed", "3"]
    pred = [*common, "--exp_nm", "pred", "--load_from", ckpt, "--split",
            "val", "--warm_gate", "auto", "--warm_gate_k", "1",
            "--warm_gate_kmax", "1"]
    run_ranks("run", {"dir": str(tmp_path), "train": train, "pred": pred,
                      "coord2": f"localhost:{free_port()}"}, tmp_path, 2)
    assert not osp.exists(tmp_path / "rank1") and \
        not osp.exists(tmp_path / "pred1")
    with open(tmp_path / "losses_rank0.json") as f:
        rank_losses = json.load(f)
    with open(tmp_path / "losses_rank1.json") as f:
        assert json.load(f) == rank_losses

    seen = []
    real = ttrainer.dist_train_step

    def recorded(*a, **kw):
        loss = real(*a, **kw)
        seen.append(float(loss))
        return loss

    monkeypatch.setattr(ttrainer, "dist_train_step", recorded)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from lp_gnn_tpu_torch.config import parse_args
    one = parse_args([*train, "--log_prefix", str(tmp_path / "one")])
    path = ttrainer.run_exp(one)
    assert len(seen) == len(rank_losses) == 4
    np.testing.assert_allclose(rank_losses, seen, rtol=1e-5)
    ranks_dir = tmp_path / "rank0" / "run"
    assert metrics(str(ranks_dir))["val/acc"] == \
        metrics(one.log_dir)["val/acc"]
    want = load_checkpoint(path)
    for name, v in load_checkpoint(str(ranks_dir / "mdl.pth")).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    from lp_gnn_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "solve_backend", lambda cfg: fake_solve)
    one_pred = parse_args([*pred, "--log_prefix", str(tmp_path / "one_pred")])
    out_dir = stage_pred_basis(one_pred)
    with open(osp.join(one_pred.log_dir, "warm_gate.json")) as f:
        want_gate = json.load(f)
    with open(tmp_path / "pred0" / "pred" / "warm_gate.json") as f:
        got_gate = json.load(f)
    assert got_gate == want_gate and want_gate["k"] == 1
    names = sorted(os.listdir(out_dir))
    got_dir = tmp_path / "pred0" / "pred" / osp.basename(out_dir)
    assert names and sorted(os.listdir(got_dir)) == names
    assert all(filecmp.cmp(got_dir / n, osp.join(out_dir, n), shallow=False)
               for n in names)


if __name__ == "__main__":
    main(sys.argv[1:])
