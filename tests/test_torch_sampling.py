"""The port's sampler and its two uses (lp_gnn_tpu_torch/data/sampling.py,
the exact sampled branch of infer/predict.py model_inference, the
trainer's sampled fallback) against the JAX package's, on the CPU.

Tolerances, stated where they are used:
- the sampler: exact (the same seeds, node ids, edges, seed counts and
  RandomState after the call);
- exact sampled logits, fp32: atol 5e-4 against JAX's and against the
  port's full-graph forward (tests/test_sampling.py:51);
- sampled training from one JAX mdl.ckpt, fp32, dropout 0: each step's
  loss rtol 1e-5, the final params atol RUN_ATOL.
"""
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import jax

from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.data import sampling as jsampling
from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
from lp_gnn_tpu.infer.predict import model_inference as jax_model_inference
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu.utils.serialize import msgpack_dump as jax_msgpack_dump
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data import sampling
from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.infer.predict import model_inference
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.ops import spmm as tspmm
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val

torch.set_num_threads(2)


def lp_graph(rng, m=30, n=50, e=400, kind="dense", ids=True):
    """A random LP graph, with ``ids`` its node ids in feature column 0
    (so a subgraph's rows name the nodes they came from). ``dense``: every node
    likely above fanout 6; ``isolated``: constraints 20.. and variables
    35.. have no edge; ``blocks``: disjoint complete bipartite blocks of 3
    constraints x 5 variables, so that two hops from any seed close its
    block and exact sampling equals the full graph at any depth."""
    if kind == "blocks":
        nb = m // 3
        n = nb * 5
        row = np.repeat(np.arange(nb * 3), 5)
        col = (np.repeat(np.arange(nb), 15) * 5
               + np.tile(np.arange(5), nb * 3))
        e = len(row)
    else:
        hi_m, hi_n = (20, 35) if kind == "isolated" else (m, n)
        row = rng.randint(0, hi_m, e)
        col = rng.randint(0, hi_n, e)
    val = (rng.rand(e) * 2 - 1).astype(np.float32)
    c_feas = (rng.rand(m, 8) - 0.5).astype(np.float32)
    v_feas = (rng.rand(n, 8) - 0.5).astype(np.float32)
    if ids:
        c_feas[:, 0], v_feas[:, 0] = np.arange(m), np.arange(n)
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    order = np.lexsort((col, row))
    return BipartiteGraph(row=row[order].astype(np.int32),
                          col=col[order].astype(np.int32), val=val[order],
                          c_feas=c_feas, v_feas=v_feas,
                          y_s=rng.randint(0, 3, m).astype(np.int32),
                          y_t=rng.randint(0, 3, n).astype(np.int32))


def jax_graph(g):
    return JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")})


def edges(row, col, val):
    order = np.lexsort((col, row))
    return row[order], col[order], val[order]


# ------------------------------------------------------------------ sampler
@pytest.mark.parametrize("kind", ["dense", "isolated"])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False),
                                               (True, False)])
@pytest.mark.parametrize("fanout", [[6, 6], [-1, -1]])
def test_sampler_matches_jax(kind, shuffle, drop_last, fanout):
    """From one RandomState state: the same subgraphs (seed counts, the
    node ids of each side in order, the edge set with its values) and the
    same RandomState state after the call. Unshuffled batches of 16 take
    constraints only, then variables only: empty seed sides."""
    g = lp_graph(np.random.RandomState(3), kind=kind)
    rng_t, rng_j = np.random.RandomState(7), np.random.RandomState(7)
    got = sampling.sample_subgraphs(g, rng_t, fanout, 16, shuffle=shuffle,
                                    drop_last=drop_last)
    want = jsampling.sample_subgraphs(jax_graph(g), rng_j, fanout, 16,
                                      shuffle=shuffle, drop_last=drop_last)
    assert len(got) == len(want) > 1
    assert any(s.s_bs == 0 or s.t_bs == 0 for s in got) == (not shuffle)
    for sub, pg in zip(got, want):
        m, n, e = int(pg.ncons), int(pg.nvars), int(pg.nnz)
        assert (sub.s_bs, sub.t_bs) == (int(pg.s_bs), int(pg.t_bs))
        assert (sub.g.ncons, sub.g.nvars, sub.g.nnz) == (m, n, e)
        np.testing.assert_array_equal(sub.g.c_feas, pg.c_feas[:m])
        np.testing.assert_array_equal(sub.g.v_feas, pg.v_feas[:n])
        np.testing.assert_array_equal(sub.g.y_s, pg.y_s[:m])
        for a, b in zip(edges(sub.g.row, sub.g.col, sub.g.val),
                        (pg.row_r[:e], pg.col_r[:e], pg.val_r[:e])):
            np.testing.assert_array_equal(a, b)
    st, sj = rng_t.get_state(), rng_j.get_state()
    np.testing.assert_array_equal(st[1], sj[1])
    assert st[2:] == sj[2:]


def test_sampler_draws_only_for_nodes_above_the_fanout():
    """A fanout at or above every degree draws nothing after the seeds'
    permutation; fanout -1 and no shuffle draw nothing at all."""
    g = lp_graph(np.random.RandomState(4), kind="dense")
    deg = max(np.bincount(g.row).max(), np.bincount(g.col).max())
    for fanout, shuffle, draws in (([int(deg)] * 2, True, 1),
                                   ([-1, -1], False, 0)):
        rng, ref = np.random.RandomState(2), np.random.RandomState(2)
        for _ in range(draws):
            ref.permutation(g.ncons + g.nvars)
        sampling.sample_subgraphs(g, rng, fanout, 16, shuffle=shuffle)
        assert rng.get_state()[2] == ref.get_state()[2]


# ---------------------------------------------------------- exact inference
ARCHS = ["GCN_FC(8,8,hids=16,depth=3)", "GCNDeeper(8,8,hids=16,depth=3)",
         "GENDeeper(8,8,hids=16,depth=3)"]


def port_and_jax_models(arch, seed=0):
    jm = jax_build_model(arch)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    model = build_model(arch)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.eval(), jm, params


@pytest.mark.parametrize("kind", ["dense", "isolated", "blocks"])
@pytest.mark.parametrize("arch", ARCHS)
def test_exact_sampled_inference_matches_jax_and_full(arch, kind):
    """model_inference(edge_num_thresh=0, batch_size=17, depth=3) against
    the JAX package's on the same weights, and, where two hops reach every
    input of a seed's logits, against the port's full-graph forward (atol
    5e-4). Two hops cover GCN_FC's 2 convs on any graph; GCNDeeper and
    GENDeeper at depth 3 run 3 convs, which two hops cover on the blocks
    graph only (the JAX package samples depth - 1 hops for every arch).
    The isolated graph's shards hold seeds without an edge."""
    g = lp_graph(np.random.RandomState(5), m=30, n=50, e=300, kind=kind)
    model, jm, params = port_and_jax_models(arch)
    before = tspmm.spmm_csr.launches
    lc, lv = model_inference(model, g, edge_num_thresh=0, batch_size=17,
                             depth=3, rng=np.random.RandomState(1))
    assert tspmm.spmm_csr.launches == before   # the CPU runs no kernel
    jc, jv = jax_model_inference(jm, params, jax_graph(g), edge_num_thresh=0,
                                 batch_size=17, depth=3,
                                 rng=np.random.RandomState(1))
    np.testing.assert_allclose(lc, jc, atol=5e-4)
    np.testing.assert_allclose(lv, jv, atol=5e-4)
    if kind == "blocks" or arch.startswith("GCN_FC"):
        fc, fv = model_inference(model, g)
        np.testing.assert_allclose(lc, fc, atol=5e-4)
        np.testing.assert_allclose(lv, fv, atol=5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_edgeless_subgraph_matches_jax(arch):
    """A subgraph with nodes and no edge (its seeds isolated): the forward,
    the balanced loss over a seed prefix with an empty side (losses.py
    :62-67 take max(m, 1)) and the top-m decode of zero seeds, against the
    JAX package on its padded graph (fp32 atol 1e-5; decode exact)."""
    from lp_gnn_tpu.data.batching import pad_graph
    from lp_gnn_tpu.infer.decode import decode_topm_device as jdecode
    from lp_gnn_tpu.train import losses as jlosses
    from lp_gnn_tpu_torch.infer.decode import decode_topm_device
    from lp_gnn_tpu_torch.train.losses import balanced
    g = lp_graph(np.random.RandomState(2), m=6, n=9, e=0, ids=False)
    model, jm, params = port_and_jax_models(arch)
    gt = GraphTensors.from_graph(g, "cpu", labels=True, s_bs=0, t_bs=4)
    with torch.no_grad():
        lc, lv = model(gt)
    pg = pad_graph(jax_graph(g), s_bs=0, t_bs=4)
    jc, jv = jm.apply(params, pg)
    np.testing.assert_allclose(lc.numpy(), np.asarray(jc)[:6], atol=1e-5)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jv)[:9], atol=1e-5)
    ms, mt = ttrainer.seed_masks(gt)
    jms, jmt = jtrainer.seed_masks(pg)
    np.testing.assert_array_equal(ms.numpy(), np.asarray(jms)[:6])
    np.testing.assert_array_equal(mt.numpy(), np.asarray(jmt)[:9])
    loss = balanced(lc, lv, gt.y_s, gt.y_t, ms, mt)
    jloss = jlosses.balanced(jc, jv, pg.y_s, pg.y_t, jms, jmt)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    pc, pv = decode_topm_device(lc, lv, ms, mt, ms.sum())
    jpc, jpv = jdecode(jc, jv, jms, jmt, jms.sum())
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jpc)[:6])
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv)[:9])


def test_sampled_inference_leaves_the_rng_alone():
    """An exact unshuffled pass draws nothing from the sampler's rng."""
    g = lp_graph(np.random.RandomState(6))
    model, _, _ = port_and_jax_models(ARCHS[0])
    rng = np.random.RandomState(9)
    state = rng.get_state()[2]
    model_inference(model, g, edge_num_thresh=0, batch_size=20, rng=rng)
    assert rng.get_state()[2] == state


# ------------------------------------------------------------------ training
ARCH_TRAIN = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
RUN_ATOL = 1e-6   # as tests/test_torch_train.py: fp32 Adam steps at lr 1e-3


def write_family(root, sizes, seed=0):
    """Processed LPs of the given (m, n, e), in the reference blob format
    (written by the JAX package's writer)."""
    rng = np.random.RandomState(seed)
    for i, (m, n, e) in enumerate(sizes):
        g = lp_graph(rng, m=m, n=n, e=e, ids=False)
        path = osp.join(root, "processed", f"lp_{i}.pk")
        jax_msgpack_dump([g.row, g.col, g.val.astype(np.float64), g.c_feas,
                          g.v_feas, g.y_s.astype(np.int64),
                          g.y_t.astype(np.int64), m + n], path)
        jax_msgpack_dump(dict(num_cons=m, num_vars=n, raw_path="",
                              processed_path=path,
                              con_nms=[f"c{k}" for k in range(m)],
                              var_nms=[f"x{k}" for k in range(n)]),
                         path + ".meta")


def record_steps(monkeypatch):
    """Each step's loss of both trainers, in order: the JAX single-graph
    and dp steps, the port's train_step and dp_train_step."""
    seen = {"jax": [], "port": []}

    def wrap_jax(module, name, loss_at):
        real = getattr(module, name)

        def make(*a, **kw):
            step = real(*a, **kw)

            def run(*sa, **skw):
                out = step(*sa, **skw)
                seen["jax"].append(float(out[loss_at]))
                return out
            return run
        monkeypatch.setattr(module, name, make)

    from lp_gnn_tpu.parallel import dp as jdp
    wrap_jax(jtrainer, "make_train_step", 2)
    wrap_jax(jdp, "make_dp_train_step", 2)
    for name in ("train_step", "dp_train_step"):
        real = getattr(ttrainer, name)

        def run(*a, _real=real, **kw):
            out = _real(*a, **kw)
            loss = out[0] if isinstance(out, tuple) else out
            seen["port"].append(float(loss))
            return out
        monkeypatch.setattr(ttrainer, name, run)
    return seen


def run_both(tmp_path, monkeypatch, data_prefix, ckpt, jax_kw=None, **kw):
    """Both packages' run_exp on the family from one JAX mdl.ckpt (the
    JAX run's config updated by ``jax_kw``); returns (JAX step losses,
    port step losses, JAX params as a state_dict, port mdl.pth)."""
    seen = record_steps(monkeypatch)
    common = dict(dataset="fam", data_prefix=data_prefix,
                  log_prefix=str(tmp_path), arch=ARCH_TRAIN,
                  load_from=ckpt, **kw)
    jpath = jtrainer.run_exp(JaxConfig(
        exp_nm="jax", **{**common, **(jax_kw or {})}).finalize())
    tpath = ttrainer.run_exp(Config(exp_nm="port", device="cpu",
                                    **common).finalize())
    with open(jpath, "rb") as f:
        want = state_dict_from_jax_params(pickle.load(f)["params"])
    return seen["jax"], seen["port"], want, load_checkpoint(tpath)


def assert_same_run(jl, tl, want, got):
    assert len(tl) == len(jl) > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def sampled_family(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sampled")
    prefix = root / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"),
                 [(30, 50, 300), (24, 40, 260), (36, 44, 320),
                  (20, 30, 200), (28, 36, 240)], seed=11)
    ckpt = str(root / "init.ckpt")
    jtrainer.save_ckpt(ckpt, jax.tree.map(np.asarray, jax_build_model(
        ARCH_TRAIN).init(jax.random.PRNGKey(4))))
    return str(prefix), ckpt


def test_sampled_training_matches_jax(sampled_family, tmp_path,
                                      monkeypatch):
    """run_exp with edge_num_thresh=0: every train graph is sampled afresh
    each epoch (fanout [6, 6], batch 24, shuffled, last short batch
    dropped) from the run's numpy stream, one step a subgraph. The steps'
    losses agree in number and value, and so do the final params; the
    SpMM runs inline on the CPU (no kernel launches)."""
    before = tspmm.spmm_csr.launches
    jl, tl, want, got = run_both(tmp_path, monkeypatch, *sampled_family,
                                 epochs=2, edge_num_thresh=0, batch_size=24)
    assert tspmm.spmm_csr.launches == before
    n_train = len(split_idxs_train_val(5)[0])
    assert len(tl) > 2 * n_train   # several subgraphs a graph
    assert_same_run(jl, tl, want, got)


def test_sampled_subgraph_tensors_carry_their_seeds(sampled_family):
    """train_graph of a sampled subgraph: the seed prefix as s_bs / t_bs
    and the loss masks over it; a full graph's masks cover every node."""
    g = lp_graph(np.random.RandomState(8))
    sub = sampling.sample_subgraphs(g, np.random.RandomState(0), [6, 6],
                                    16)[0]
    model = build_model(ARCH_TRAIN)
    gt = ttrainer.train_graph(model, sub.g, "cpu", sub.s_bs, sub.t_bs)
    ms, mt = ttrainer.seed_masks(gt)
    assert (int(ms.sum()), int(mt.sum())) == (sub.s_bs, sub.t_bs)
    assert ms[:sub.s_bs].all() and mt[:sub.t_bs].all()
    full = GraphTensors.from_graph(g, "cpu")
    ms, mt = ttrainer.seed_masks(full)
    assert ms.all() and mt.all() and len(ms) == g.ncons
