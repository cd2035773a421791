"""The port's graph-batched and data-parallel training (data/graph.py
union, data/stacking.py, parallel/dp.py, parallel/mesh.py's process group,
the trainer's batched loop) against the JAX package's, on the CPU.

Tolerances, stated where they are used:
- a union against its graphs one by one, fp32: logits atol 1e-5 (the same
  sums; the plain SpMM sums each row in its order either way);
- the stack key: exact (the same groups as the JAX leaf-shape signature);
- one batched Adam step from the same params, fp32, dropout off: loss rtol
  1e-5, params atol 1e-6 (JAX's own dp-vs-serial test holds 1e-5);
- whole runs (run_exp, the 2-rank gloo run) from one JAX mdl.ckpt, fp32,
  dropout 0: each step's loss rtol 1e-5, final params atol RUN_ATOL.
"""
import logging
import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.parallel.dp import make_dp_train_step, stack_graphs
from lp_gnn_tpu.parallel.mesh import make_mesh
from lp_gnn_tpu.train import losses as jlosses
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data.graph import GraphTensors, union
from lp_gnn_tpu_torch.data.stacking import stack_key
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.ops.spmm import attach_input_agg
from lp_gnn_tpu_torch.parallel import dp, mesh
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced
from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
from tests.test_torch_sampling import (ARCH_TRAIN, RUN_ATOL, assert_same_run,
                                       jax_graph, lp_graph, run_both,
                                       write_family)

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def graphs(n_graphs=4, seed=0, **kw):
    rng = np.random.RandomState(seed)
    return [lp_graph(rng, m=12 + 2 * i, n=20 + 3 * i, e=60 + 10 * i,
                     ids=False, **kw) for i in range(n_graphs)]


# -------------------------------------------------------------------- union
@pytest.mark.parametrize("arch", ["GCN_FC(8,8,hids=16,depth=3)",
                                  "GENDeeper(8,8,hids=16,depth=3)"])
def test_union_computes_each_graph(arch):
    """The union's logits are each graph's own (node ranges in
    ``members``); its permutations map each CSR edge to its CSC position
    and back; the input cache is each graph's."""
    gs = graphs()
    model = build_model(arch).eval()
    parts = [GraphTensors.from_graph(g, "cpu", labels=True, perms=True)
             for g in gs]
    parts = [attach_input_agg(p, torch.float32) for p in parts]
    u = union(parts)
    assert u.nnz == sum(g.nnz for g in gs) and u.s_bs == u.ncons
    assert u.in_agg_c is not None and u.eperm_r is not None
    torch.testing.assert_close(u.val_c[u.eperm_r.long()], u.val_r)
    torch.testing.assert_close(u.val_r[u.eperm_c.long()], u.val_c)
    with torch.no_grad():
        lc, lv = model(u)
        for p, mb in zip(parts, u.members):
            assert (mb.ncons, mb.nvars) == (p.ncons, p.nvars)
            pc, pv = model(p)
            torch.testing.assert_close(lc[mb.c0:mb.c0 + mb.ncons], pc,
                                       rtol=0, atol=1e-5)
            torch.testing.assert_close(lv[mb.v0:mb.v0 + mb.nvars], pv,
                                       rtol=0, atol=1e-5)


def test_union_keeps_what_every_graph_has():
    a, b = (GraphTensors.from_graph(g, "cpu") for g in graphs(2))
    u = union([a, GraphTensors.from_graph(graphs(2)[1], "cpu",
                                          labels=True)])
    assert u.y_s is None and u.eperm_r is None and u.in_agg_c is None
    assert union([a, b]).rowptr[-1] == a.nnz + b.nnz
    with pytest.raises(ValueError, match="at least one graph"):
        union([])


# ---------------------------------------------------------------- stack key
def skewed_graph(rng, hot_share, m=200, n=150, e=3000):
    """A graph whose ``hot_share`` of edges falls on the first 128 rows
    (one blocked-layout block), the rest on the others: the chunk counts
    move with it (chunks of 1024 edges: a share near 1/3 or 2/3 takes 3
    chunks, 0, 0.2 or 1/2 takes 4)."""
    hot = rng.rand(e) < hot_share
    row = np.where(hot, rng.randint(0, 128, e), rng.randint(128, m, e))
    g = lp_graph(rng, m=m, n=n, e=e, ids=False)
    order = np.lexsort((g.col, row))
    g.row, g.col = row[order].astype(np.int32), g.col[order]
    return g


@pytest.mark.parametrize("family", ["sizes", "skew"])
def test_stack_key_groups_as_jax_signatures(family):
    """Graphs group under the port's stack key exactly as under the JAX
    leaf-shape signature of pad_graph (trainer.py:557); the families give
    more than one group: several buckets, or one bucket whose blocked
    layouts take different chunk counts."""
    rng = np.random.RandomState(1)
    if family == "sizes":
        gs = [lp_graph(rng, m=m, n=n, e=e, ids=False) for m, n, e in (
            (30, 40, 200), (250, 40, 200), (30, 40, 250), (30, 40, 300),
            (300, 260, 900), (20, 20, 0), (30, 45, 180))]
    else:
        gs = [skewed_graph(rng, s) for s in (0.0, 0.33, 0.5, 0.66, 0.2, 0.33)]

    def groups(key):
        out: dict = {}
        for i, g in enumerate(gs):
            out.setdefault(key(g), []).append(i)
        return sorted(out.values())

    jax_sig = groups(lambda g: tuple(
        np.shape(x) for x in jax.tree.leaves(pad_graph(jax_graph(g)))))
    assert groups(stack_key) == jax_sig
    assert 1 < len(jax_sig) < len(gs)


def test_stack_groups_order():
    """stack_groups: sampled graphs apart, each key's graphs in index
    order cut into stacks, remainders single, keys in first-seen order."""
    rng = np.random.RandomState(2)
    sizes = [(30, 40, 200), (300, 40, 200), (30, 40, 220), (30, 40, 500),
             (30, 40, 210), (300, 40, 190), (30, 40, 230)]
    ds = [lp_graph(rng, m=m, n=n, e=e, ids=False) for m, n, e in sizes]
    stacks, singles, sampled = dp.stack_groups(ds, 2, edge_num_thresh=400)
    assert (stacks, singles, sampled) == ([[0, 2], [4, 6], [1, 5]], [], [3])
    stacks, singles, _ = dp.stack_groups(ds, 3, edge_num_thresh=400)
    assert (stacks, singles) == ([[0, 2, 4]], [6, 1, 5])
    assert dp.rank_block([4, 6, 1, 5], 2, 1) == [1, 5]


# -------------------------------------------------------------- batched step
def test_batched_step_matches_jax_dp_and_serial():
    """One dp_train_step over the union of 4 graphs against the JAX
    make_dp_train_step(train=False) on a dp=4 mesh and against a step on
    the serial mean of the 4 balanced losses (the pattern of
    tests/test_parallel.py:318), from the same params, Adam at lr 1e-3
    (dropout 0: the port's step runs in training mode)."""
    arch = ARCH_TRAIN
    gs = graphs()
    jm = jax_build_model(arch)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    opt = jtrainer.make_optimizer("adam")
    step = make_dp_train_step(jm, "balanced", opt, make_mesh({"dp": 4}),
                              train=False)
    jp, _, jloss = step(params, opt.init(params),
                        stack_graphs([pad_graph(jax_graph(g)) for g in gs]),
                        jax.random.PRNGKey(0), jnp.float32(1e-3))

    def fresh():
        model = build_model(arch)
        model.load_state_dict(state_dict_from_jax_params(params))
        return model, ttrainer.make_optimizer(model.parameters(), "adam",
                                              1e-3)

    model, optimizer = fresh()
    u = union([ttrainer.train_graph(model, g, "cpu") for g in gs])
    loss = dp.dp_train_step(model, optimizer, u, balanced)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jp))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)

    serial, optimizer = fresh()
    total = 0.0
    for g in gs:
        gt = ttrainer.train_graph(serial, g, "cpu")
        lc, lv = serial(gt)
        total = total + balanced(lc, lv, gt.y_s, gt.y_t,
                                 *ttrainer.seed_masks(gt))
    (total / len(gs)).backward()
    optimizer.step()
    np.testing.assert_allclose(float(loss), float(total.detach()) / len(gs),
                               rtol=1e-5)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), serial.state_dict()[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    # the JAX serial check itself, for the loss scale (losses.py:59)
    jl = np.mean([float(jlosses.balanced(
        *jm.apply(params, pg), pg.y_s, pg.y_t, *jtrainer.seed_masks(pg)))
        for pg in (pad_graph(jax_graph(g)) for g in gs)])
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)


def test_step_generator_is_one_draw_of_the_run_generator():
    """Every rank draws the same seed from the run's generator, so the
    run generators stay equal; the ranks' step generators differ."""
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    ga, gb = dp.step_generator(a, 0), dp.step_generator(b, 1)
    assert torch.equal(a.get_state(), b.get_state())
    assert not torch.equal(torch.rand(4, generator=ga),
                           torch.rand(4, generator=gb))
    assert dp.step_generator(None, 0) is None


# ---------------------------------------------------------------- whole runs
def family_sizes(n_lps=9):
    """Sizes by split position: 4 train graphs of one stack key, one of
    another key (300 constraints: bucket 384), one sampled (350 edges
    above a threshold of 300); the val graphs small."""
    train_idx, _ = split_idxs_train_val(n_lps)
    train_sizes = iter([(24, 36, 180), (300, 40, 200), (26, 30, 200),
                        (30, 44, 350), (20, 34, 150), (28, 40, 240)])
    return [next(train_sizes) if i in train_idx else (18, 26, 120)
            for i in range(n_lps)]


@pytest.fixture(scope="module")
def dp_family(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dp")
    prefix = root / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"), family_sizes(),
                 seed=21)
    ckpt = str(root / "init.ckpt")
    jtrainer.save_ckpt(ckpt, jax.tree.map(np.asarray, jax_build_model(
        ARCH_TRAIN).init(jax.random.PRNGKey(6))))
    return str(prefix), ckpt


def test_graph_batch_run_matches_jax(dp_family, tmp_path, monkeypatch):
    """run_exp --graph_batch 2 against JAX's: 2 stacks of 2, 1 single and
    1 sampled graph, in the JAX order (each epoch's stacks in a drawn
    order, then the single, then the sampled graph's subgraphs): the
    same steps' losses and the same final params, 2 epochs."""
    jl, tl, want, got = run_both(tmp_path, monkeypatch, *dp_family,
                                 epochs=2, graph_batch=2, edge_num_thresh=300,
                                 batch_size=40)
    # a batched step a stack, one step the single, >= 1 a subgraph
    assert len(tl) >= 2 * (2 + 1 + 1)
    assert_same_run(jl, tl, want, got)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dp_over_gloo_matches_graph_batch_and_jax(dp_family, tmp_path,
                                                  monkeypatch):
    """Two ranks (processes of ``python -m lp_gnn_tpu_torch.train``
    joined by the LP_GNN_DIST_* contract over gloo) take --mesh_shape dp=2
    for 2 epochs: rank 0's mdl.pth equals the single-process --graph_batch
    2 run's and JAX's dp=2 run's (RUN_ATOL); rank 1 writes no file."""
    data_prefix, ckpt = dp_family
    argv = ["--dataset", "fam", "--data_prefix", data_prefix, "--exp_nm",
            "dp", "--arch", ARCH_TRAIN, "--epochs", "2", "--device", "cpu",
            "--mesh_shape", "dp=2", "--edge_num_thresh", "300",
            "--batch_size", "40", "--load_from", ckpt]
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   LP_GNN_DIST_COORD=f"localhost:{port}",
                   LP_GNN_DIST_NPROCS="2", LP_GNN_DIST_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lp_gnn_tpu_torch.train", *argv,
             "--log_prefix", str(tmp_path / f"rank{rank}")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:] + \
        outs[1][-3000:]
    assert not (tmp_path / "rank1").exists()
    ranks = load_checkpoint(str(tmp_path / "rank0" / "dp" / "mdl.pth"))

    jl, tl, want, got = run_both(
        tmp_path, monkeypatch, *dp_family,
        jax_kw={"mesh_shape": "dp=2", "graph_batch": 1}, epochs=2,
        edge_num_thresh=300, batch_size=40, graph_batch=2)
    assert_same_run(jl, tl, want, got)
    for k, v in ranks.items():
        np.testing.assert_allclose(v.numpy(), got[k].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=k)


def test_process_group_from_the_contract(monkeypatch):
    """init_distributed reads LP_GNN_DIST_*: gloo on the CPU, the group
    destroyed by its creator; without the contract it does nothing."""
    monkeypatch.delenv("LP_GNN_DIST_COORD", raising=False)
    assert mesh.init_distributed(torch.device("cpu")) == (
        torch.device("cpu"), False)
    assert mesh.world_and_rank() == (1, 0) and mesh.is_primary()
    monkeypatch.setenv("LP_GNN_DIST_COORD", f"localhost:{free_port()}")
    monkeypatch.setenv("LP_GNN_DIST_NPROCS", "1")
    monkeypatch.setenv("LP_GNN_DIST_PROC_ID", "0")
    dev, created = mesh.init_distributed(torch.device("cpu"))
    try:
        assert created and dev == torch.device("cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert mesh.world_and_rank() == (1, 0)
        t = torch.ones(3)
        torch.distributed.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.setenv("LP_GNN_DIST_NPROCS", "2")
    monkeypatch.setenv("LP_GNN_DIST_PROC_ID", "1")
    assert not mesh.is_primary()
    with pytest.raises(ValueError, match="outside"):
        monkeypatch.setenv("LP_GNN_DIST_PROC_ID", "2")
        mesh.dist_env()


def test_batch_shape_takes_every_rank():
    """dp=K runs over a group of exactly K ranks: fewer ranks fall back
    (the warning is tests/test_torch_train.py's), a group larger than dp
    is refused."""
    cfg = Config(mesh_shape="dp=2", graph_batch=3)
    assert ttrainer.batch_shape(cfg, 2) == (2, 3)
    assert ttrainer.batch_shape(cfg, 1) == (1, 1)
    with pytest.raises(ValueError, match="must name them all"):
        ttrainer.batch_shape(Config(graph_batch=2), 2)


def test_batched_run_logs_its_shape(dp_family, tmp_path, caplog):
    """A graph-batched run logs its ranks and graphs a step and writes its
    checkpoint."""
    data_prefix, _ = dp_family
    cfg = Config(exp_nm="gb", dataset="fam", data_prefix=data_prefix,
                 log_prefix=str(tmp_path), arch=ARCH_TRAIN, epochs=1,
                 graph_batch=4, device="cpu").finalize()
    with caplog.at_level(logging.INFO):
        ttrainer.run_exp(cfg)
    assert "1 rank(s) x 4 graphs a step" in caplog.text
    assert osp.exists(osp.join(cfg.log_dir, "mdl.pth"))
