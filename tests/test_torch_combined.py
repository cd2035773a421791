"""The port's dp x edge training (lp_gnn_tpu_torch/parallel/combined.py, the
trainer's --mesh_shape dp=K,edge=E) against the JAX package's
(lp_gnn_tpu/parallel/combined.py, on the conftest's virtual CPU devices), on
the CPU, where every kernel wrapper runs its plain version. The port's two
ranks are two processes of this module (``python -m
tests.test_torch_combined``), joined over gloo by the LP_GNN_DIST_*
contract.

Tolerances, stated where they are used:
- partition_batch's shared sizes and halo lists: exact;
- one dp x edge step (SGD at lr 1e-3, dropout 0, fp32) from the JAX
  weights: the loss rtol 1e-5, the params atol RUN_ATOL, and each tensor's
  update within UPDATE_RTOL of its largest (tests/test_torch_dist_train.py's
  rule, which holds the gradient and not only the weights);
- a whole run from one JAX mdl.ckpt (Adam, 2 epochs): each step's loss
  rtol 1e-5, val/acc exact, the final params atol RUN_ATOL.
"""
import json
import logging
import os
import os.path as osp
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.parallel import combined as jcombined
from lp_gnn_tpu.parallel import edge_partition as jEP
from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import combined as tcombined
from lp_gnn_tpu_torch.parallel.dp import rank_block
from lp_gnn_tpu_torch.parallel.edge_partition import dist_tensors
from lp_gnn_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                            world_and_rank)
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced
from tests.test_torch_dist_train import UPDATE_RTOL, update_rel
from tests.test_torch_dp import free_port
from tests.test_torch_sampling import ARCH_TRAIN, RUN_ATOL, write_family
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RANKS = 2
K_EDGE = 2
STEP_LR = 1e-3
STEP_CASES = [("GCN_FC(8,8,hids=16,depth=3,dp=0.0)", True),
              ("GCN_FC(8,8,hids=16,depth=3,dp=0.0)", False),
              ("GENDeeper(8,8,hids=8,depth=3)", True),
              ("GENDeeper(8,8,hids=8,depth=3)", False)]
# the dp x edge run's family by split position (5 LPs: train 0-2, val 3-4):
# three train graphs of one bucket, a batch of 2 and one left over
RUN_SIZES = [(24, 40, 150), (30, 44, 160), (28, 36, 140), (20, 30, 120),
             (22, 34, 130)]


def step_graphs():
    """The pair of the one-step cases: one bucket, as
    tests/test_parallel.py:526 draws them."""
    return [random_graph(np.random.RandomState(i), m=24, n=40, e=150)
            for i in range(2)]


def jax_params(arch):
    return jax.tree.map(np.asarray, jax_build_model(arch).init(
        jax.random.PRNGKey(0)))


# ------------------------------------------------------------ the rank side
def rank_step(payload):
    """One rank of the one-step cases: this rank's block of the pair,
    partitioned at the pair's shared sizes, one dp_edge_train_step a case
    from the JAX weights; writes each case's weights and loss."""
    world, rank = world_and_rank()
    mesh = make_mesh(K_EDGE, "cpu")
    graphs = [g for g, _ in step_graphs()]
    parts = tcombined.partition_batch(
        graphs, K_EDGE, halo=True, own=rank_block([0, 1], world, rank))
    out = {}
    for i, (arch, cache) in enumerate(STEP_CASES):
        model = build_model(arch)
        model.load_state_dict(torch.load(
            osp.join(payload["dir"], f"w0_{arch}.pt"), weights_only=True))
        model.dp = 0.0
        opt = ttrainer.make_optimizer(model.parameters(), "sgd", STEP_LR)
        dgs = [dist_tensors(model, dg, mesh, input_agg=cache) for dg in parts]
        loss = tcombined.dp_edge_train_step(model, opt, dgs, balanced)
        out[i] = {"state": model.state_dict(), "loss": float(loss),
                  "cached": [dg.in_agg_c is not None for dg in dgs]}
    torch.save(out, osp.join(payload["dir"], f"step_rank{rank}.pt"))


def rank_run(payload):
    """One rank of the whole run: the train CLI with the payload's flags
    and a log prefix of the rank's own, each step's loss recorded and
    written to a file of the rank's own."""
    from lp_gnn_tpu_torch.train.__main__ import main as train_main
    _, rank = world_and_rank()
    losses = []

    def recorded(step):
        def run(*a, **kw):
            loss = step(*a, **kw)
            losses.append(float(loss))
            return loss
        return run

    ttrainer.dp_edge_train_step = recorded(ttrainer.dp_edge_train_step)
    ttrainer.dist_train_step = recorded(ttrainer.dist_train_step)
    train_main([*payload["argv"], "--log_prefix",
                osp.join(payload["dir"], f"rank{rank}")])
    with open(osp.join(payload["dir"], f"losses_rank{rank}.json"), "w") as f:
        json.dump(losses, f)


def run_ranks(mode, payload, tmp_path, timeout=300):
    """RANKS processes of this module in ``mode``, joined over gloo;
    returns their output, each rank's exit code 0 asserted."""
    path = str(tmp_path / f"{mode}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    port = free_port()
    procs = []
    for rank in range(RANKS):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   LP_GNN_DIST_COORD=f"localhost:{port}",
                   LP_GNN_DIST_NPROCS=str(RANKS),
                   LP_GNN_DIST_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_combined", mode, path],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0] * RANKS, \
        "\n".join(o[-3000:] for o in outs)
    return outs


def main(argv):
    mode, path = argv
    with open(path) as f:
        payload = json.load(f)
    logging.basicConfig(level=logging.INFO)
    _, created = init_distributed(torch.device("cpu"))
    try:
        {"step": rank_step, "run": rank_run}[mode](payload)
    finally:
        if created:
            torch.distributed.destroy_process_group()


# ---------------------------------------------------------- partition_batch
@pytest.mark.parametrize("sizes", [[(24, 40, 150), (30, 52, 150)],
                                   [(400, 420, 1500), (560, 500, 1500)]],
                         ids=["jax_pair", "sizes_differ"])
def test_partition_batch_shares_jax_sizes(sizes):
    """partition_batch gives every graph of a mixed-size same-bucket pair
    JAX's batch ms, ns and halo width (combined.py:53-58, the pair of
    tests/test_parallel.py:596, and one whose own shard sizes differ), and
    each graph the halo lists JAX's stacked batch holds for it; ``own``
    partitions a block at the same sizes."""
    pairs = [random_graph(np.random.RandomState(5 + i), m=m, n=n, e=e)
             for i, (m, n, e) in enumerate(sizes)]
    pgs = [pad_graph(jg) for _, jg in pairs]
    assert pgs[0].bucket_key() == pgs[1].bucket_key()
    graphs = [g for g, _ in pairs]
    parts = tcombined.partition_batch(graphs, K_EDGE, halo=True)
    jb = jcombined.partition_batch(pgs, K_EDGE, halo=True)
    _, _, ms, _ = jb["c_feas"].shape
    ns = jb["v_feas"].shape[2]
    bh = jb["halo_send"].shape[-1]
    own_sizes = [jEP._shard_sizes(pg, K_EDGE) for pg in pgs]
    if sizes[0][0] == 400:
        assert own_sizes[0] != own_sizes[1]
    for b, dg in enumerate(parts):
        assert (dg.ms, dg.ns, dg.bh) == (ms, ns, bh)
        for f in ("halo_send", "halo_perm", "halo_ids", "nnz_s"):
            np.testing.assert_array_equal(getattr(dg, f), jb[f][b], err_msg=f)
    (last,) = tcombined.partition_batch(graphs, K_EDGE, halo=True, own=[1])
    np.testing.assert_array_equal(last.halo_send, parts[1].halo_send)
    assert (last.ms, last.ns, last.bh) == (ms, ns, bh)


def test_partition_refuses_sizes_below_the_graphs():
    g, _ = random_graph(np.random.RandomState(3), m=400, n=420, e=1500)
    from lp_gnn_tpu_torch.parallel.edge_partition import partition_graph
    with pytest.raises(ValueError, match="below the graph"):
        partition_graph(g, K_EDGE, halo=True, ms=128)
    with pytest.raises(ValueError, match="halo width"):
        partition_graph(g, K_EDGE, halo=True, halo_width=8)


def test_dist_stack_groups_by_bucket():
    """Oversize graphs group by bucket alone (trainer.py:580-583), not by
    the stack key of the dp stacks: two graphs of one bucket whose blocked
    layouts take different chunk counts share a batch. Groups in index
    order, buckets in first-seen order, remainders left out."""
    from lp_gnn_tpu_torch.data.stacking import stack_key
    from tests.test_torch_dp import skewed_graph
    rng = np.random.RandomState(2)
    ds = [random_graph(rng, m=m, n=n, e=e)[0] for m, n, e in (
        (30, 40, 200), (300, 40, 200), (30, 40, 220), (30, 40, 500),
        (30, 40, 210), (300, 40, 190), (20, 40, 100))]
    srng = np.random.RandomState(1)
    ds += [skewed_graph(srng, 0.0), skewed_graph(srng, 0.33)]
    assert stack_key(ds[7]) != stack_key(ds[8])
    batches, covered = tcombined.dist_stack_groups(ds, 2,
                                                   edge_num_thresh=150)
    assert batches == [[0, 2], [1, 5], [7, 8]]
    assert covered == {0, 1, 2, 5, 7, 8}
    batches, covered = tcombined.dist_stack_groups(ds, 3,
                                                   edge_num_thresh=150)
    assert batches == [[0, 2, 4]] and covered == {0, 2, 4}


# ---------------------------------------------------------- one dp x edge step
@pytest.fixture(scope="module")
def rank_steps(tmp_path_factory):
    """Both ranks' one-step results for every case of STEP_CASES, from the
    JAX weights of each arch."""
    tmp = tmp_path_factory.mktemp("torch_combined_step")
    for arch in {a for a, _ in STEP_CASES}:
        torch.save(state_dict_from_jax_params(jax_params(arch)),
                   str(tmp / f"w0_{arch}.pt"))
    run_ranks("step", {"dir": str(tmp)}, tmp)
    return [torch.load(str(tmp / f"step_rank{r}.pt"), weights_only=True)
            for r in range(RANKS)], tmp


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[f"{a.split('(')[0]}-{'cache' if c else 'none'}"
                              for a, c in STEP_CASES])
def test_dp_edge_step_matches_jax(rank_steps, case):
    """One dp_edge_train_step, 2 gloo ranks x edge=2, against JAX's
    make_dp_edge_train_step on the (dp=2, edge=2) grid from the same
    weights (tests/test_parallel.py:526, :567): the loss, the weights and
    every tensor's update; the ranks' weights equal; the input cache where
    asked and the arch reads it."""
    ranks, tmp = rank_steps
    arch, cache = STEP_CASES[case]
    params = jax_params(arch)
    jm = jax_build_model(arch)
    mesh = jax_make_mesh({"dp": RANKS, "edge": K_EDGE})
    reads = cache and "GEN" not in arch
    batch = jcombined.partition_batch(
        [pad_graph(jg) for _, jg in step_graphs()], K_EDGE, halo=True,
        input_agg_mesh=Mesh(mesh.devices[0], ("edge",)) if reads else None)
    opt = jtrainer.make_optimizer("sgd")
    step = jcombined.make_dp_edge_train_step("balanced", opt, mesh,
                                             dp_rate=0.0, arch=jm.name)
    p1, _, jloss = step(params, opt.init(params), batch,
                        jax.random.PRNGKey(1), jnp.float32(STEP_LR))
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, p1))
    w0 = state_dict_from_jax_params(params)
    got = ranks[0][case]
    assert got["cached"] == [reads]
    assert got["loss"] == ranks[1][case]["loss"]
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    for name, v in got["state"].items():
        assert torch.equal(v, ranks[1][case]["state"][name]), name
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    assert update_rel(w0, got["state"], want) < UPDATE_RTOL


# ------------------------------------------------------------- whole runs
@pytest.fixture(scope="module")
def combined_family(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_combined_run")
    prefix = root / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"), RUN_SIZES, seed=17)
    ckpt = str(root / "init.ckpt")
    jtrainer.save_ckpt(ckpt, jax.tree.map(np.asarray, jax_build_model(
        ARCH_TRAIN).init(jax.random.PRNGKey(9))))
    return str(prefix), ckpt


def record_jax_steps(monkeypatch):
    """Each JAX dp x edge and dist step's loss, in order, both steps
    patched to dropout 0 (the dist step's 0.1 whatever the arch's,
    trainer.py:388, is a named deviation)."""
    seen = []
    real_combined = jcombined.make_dp_edge_train_step
    real_dist = jEP.make_dist_train_step

    def make_combined(*a, **kw):
        step = real_combined(*a, **{**kw, "dp_rate": 0.0})

        def run(*sa, **skw):   # called eagerly by the trainer
            out = step(*sa, **skw)
            seen.append(float(out[2]))
            return out
        return run

    def make_dist(*a, **kw):
        step = real_dist(*a, **{**kw, "dp_rate": 0.0})

        def run(*sa, **skw):   # traced: the trainer jits the step
            out = step(*sa, **skw)
            jax.debug.callback(lambda v: seen.append(float(v)), out[2])
            return out
        return run

    monkeypatch.setattr(jcombined, "make_dp_edge_train_step", make_combined)
    monkeypatch.setattr(jEP, "make_dist_train_step", make_dist)
    return seen


def test_dp_edge_run_exp_matches_jax(combined_family, tmp_path, monkeypatch):
    """run_exp --mesh_shape dp=2,edge=2 --edge_num_thresh 0 over 2 gloo
    ranks against JAX's run_exp with the same flags from one JAX mdl.ckpt,
    2 epochs of Adam and a val pass: a batch of the bucket's first two
    train graphs (one dp x edge step) and the third left over (one dist
    step) an epoch; the same steps' losses, val/acc and final weights;
    rank 1 writes no file."""
    data_prefix, ckpt = combined_family
    kw = dict(dataset="fam", data_prefix=data_prefix, arch=ARCH_TRAIN,
              epochs=2, eval_every=2, load_from=ckpt,
              mesh_shape=f"dp={RANKS},edge={K_EDGE}", edge_num_thresh=0)
    seen = record_jax_steps(monkeypatch)
    jcfg = JaxConfig(exp_nm="jax", log_prefix=str(tmp_path), **kw).finalize()
    jpath = jtrainer.run_exp(jcfg)
    argv = [x for k, v in dict(kw, exp_nm="port", device="cpu").items()
            for x in (f"--{k}", str(v))]
    outs = run_ranks("run", {"dir": str(tmp_path), "argv": argv}, tmp_path)
    assert "combined dp x edge training: 2 rank(s) x 2 shards" in outs[0]
    assert not (tmp_path / "rank1").exists()
    losses = []
    for r in range(RANKS):
        with open(tmp_path / f"losses_rank{r}.json") as f:
            losses.append(json.load(f))
    assert losses[0] == losses[1] and len(losses[0]) == len(seen) == 4
    np.testing.assert_allclose(losses[0], seen, rtol=1e-5)
    from tests.test_torch_train import metrics
    log_dir = str(tmp_path / "rank0" / "port")
    assert metrics(log_dir)["val/acc"] == metrics(jcfg.log_dir)["val/acc"]
    with open(jpath, "rb") as f:
        want = state_dict_from_jax_params(pickle.load(f)["params"])
    for name, v in load_checkpoint(osp.join(log_dir, "mdl.pth")).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)


def test_dp_axis_drop_equals_the_edge_run(combined_family, tmp_path, caplog):
    """--mesh_shape dp=2,edge=2 without 2 ranks warns that the dp axis is
    dropped (trainer.py:350-353) and trains edge-only: the same weights as
    --mesh_shape edge=2, bit for bit."""
    data_prefix, ckpt = combined_family
    kw = dict(dataset="fam", data_prefix=data_prefix,
              log_prefix=str(tmp_path), arch=ARCH_TRAIN, epochs=1,
              load_from=ckpt, edge_num_thresh=0, device="cpu")
    with caplog.at_level("WARNING"):
        dropped = ttrainer.run_exp(Config(
            exp_nm="dropped", mesh_shape=f"dp={RANKS},edge={K_EDGE}",
            **kw).finalize())
    assert f"mesh_shape dp={RANKS},edge={K_EDGE} exceeds 1 rank(s) — " \
        "dropping the dp axis" in caplog.text
    edge = ttrainer.run_exp(Config(exp_nm="edge", mesh_shape=f"edge={K_EDGE}",
                                   **kw).finalize())
    a, b = load_checkpoint(dropped), load_checkpoint(edge)
    assert all(torch.equal(a[k], b[k]) for k in a)


if __name__ == "__main__":
    main(sys.argv[1:])
