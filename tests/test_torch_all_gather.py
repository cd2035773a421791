"""The all-gather branch of the port's edge-partitioned path
(lp_gnn_tpu_torch/parallel: ``partition_graph(..., halo=False)``, the
all-gather / reduce-scatter pair and its SpMMs in edge_partition.py, GEN's
all-gather layout in dist_gen.py; the trainer's and predict's choice of
layout by DIST_HALO_ARCHS; the partition cache's ``halo`` key) against the
JAX package's halo=False partition, dist_apply and make_dist_train_step on
the conftest's virtual CPU devices, against the port's halo route and
single card, and over two gloo rank processes of this module against the
stacked route, on the CPU, where every kernel wrapper runs its plain
version. Inputs are made with numpy from a seed: 500 x 1,000 nodes and
3,000 edges, so that every shard owns rows and variables at K=2 and K=4.

Tolerances, stated where they are used:
- the partition's edges: exact;
- fp32 logits: against JAX's dist_apply atol DIST_ATOL (GraphConv archs,
  JAX's own dist-vs-single tolerance, tests/test_parallel.py:43) or
  GEN_ATOL (GENDeeper, tests/test_torch_dist_zoo.py's); against the port's
  halo route and single card the same;
- gradcheck in fp64: torch's defaults;
- one GCN_FC SGD step at lr 1, dropout 0, against JAX's halo=False step:
  the loss rtol 1e-5, each tensor's update within UPDATE_RTOL of its
  largest (tests/test_torch_dist_train.py's rule for the halo step);
- one GENDeeper SGD step at lr 1e-3 against JAX's halo=False step: the
  loss rtol 1e-5, the weights atol 1e-5 (tests/test_parallel.py:225-256);
- the rank form (two gloo ranks) against the stacked route: fp32 logits
  atol STACKED_ATOL (the same sums; the linears run over one shard's rows
  instead of both shards', which may round otherwise), one step's loss
  rtol 1e-5 and updates within UPDATE_RTOL, both ranks' weights equal.
"""
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data.dataset import LPDataset
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.infer import predict as tpredict
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import combined as tcombined
from lp_gnn_tpu_torch.parallel import dist_gen
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel.mesh import (init_distributed,
                                            leave_distributed, make_mesh,
                                            world_and_rank)
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced
from tests.test_torch_kernels import port_graph

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
GRAPH = dict(m=500, n=1000, e=3000)
DIST_ATOL = 5e-4
GEN_ATOL = 5e-5
STACKED_ATOL = 1e-5
UPDATE_RTOL = 1e-4
GCN_FC = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
GEN = "GENDeeper(8,8,hids=16,depth=3)"
ARCHS = ["GCN_FC(8,8,hids=16,depth=3)", "GCN(8,8,hids=16)",
         "GCNDeeper(8,8,hids=16,depth=4)", "GENDeeper(8,8,hids=16,depth=3)",
         "GCNRand()"]
RANKS = 2


def graph(seed):
    return port_graph(np.random.RandomState(seed), **GRAPH)


def jax_graph(g):
    from lp_gnn_tpu.data.batching import pad_graph
    from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
    return pad_graph(JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")}))


def jax_mesh(k):
    import jax
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    return jax_make_mesh({"edge": k}, devices=jax.devices()[:k])


def jax_params(arch, seed=0):
    import jax
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    return jax.tree.map(np.asarray, jax_build_model(arch).init(
        jax.random.PRNGKey(seed)))


def port_model(params, arch):
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    model = build_model(arch)
    if params is not None:
        model.load_state_dict(state_dict_from_jax_params(params))
    return model


def unpad(lc, lv, g):
    return np.concatenate([np.asarray(lc)[:g.ncons], np.asarray(lv)[:g.nvars]])


def port_logits(model, g, k, halo):
    with torch.no_grad():
        lc, lv = tEP.dist_apply(model.eval(),
                                tEP.partition_graph(g, k, halo=halo),
                                make_mesh(k, "cpu"))
    return unpad(lc.numpy(), lv.numpy(), g)


# ------------------------------------------------------------ the partition
@pytest.mark.parametrize("k", [2, 4])
def test_partition_without_halo_is_jax_default(k):
    """partition_graph(g, K) builds the all-gather layout, as JAX's default
    does: no halo list, no halo CSR, and each shard's full v2c / full c2v
    hold exactly the edges, in the orders, of JAX's row_r / col_c (rows
    local, columns global); the node fields and nnz_s equal JAX's."""
    from lp_gnn_tpu.parallel import edge_partition as jEP
    g = graph(k)
    dg = tEP.partition_graph(g, k)
    jd = jEP.partition_graph(jax_graph(g), k)
    assert not dg.halo and dg.bh == 0 and dg.nh == 0
    assert dg.halo_send is None and dg.halo_perm is None
    assert all(getattr(dg, kind) == [] for kind in tEP.CSR_KINDS)
    assert len(dg.full_v2c) == len(dg.full_c2v) == k
    assert dg.n_pad == jd.n_pad and dg.ms == jd.ms
    np.testing.assert_array_equal(dg.nnz_s, np.asarray(jd.nnz_s))
    for f in ("c_feas", "v_feas", "y_s", "y_t", "cons_mask", "vars_mask"):
        np.testing.assert_array_equal(getattr(dg, f), np.asarray(
            getattr(jd, f)), err_msg=f)
    for d in range(k):
        n = int(dg.nnz_s[d])
        v2c, c2v = dg.full_v2c[d], dg.full_c2v[d]
        assert v2c.ptr.shape == (dg.ms + 1,)
        assert c2v.ptr.shape == (dg.n_pad + 1,)
        row = np.repeat(np.arange(dg.ms), np.diff(v2c.ptr))
        np.testing.assert_array_equal(row, np.asarray(jd.row_r[d])[:n])
        np.testing.assert_array_equal(v2c.idx, np.asarray(jd.col_r[d])[:n])
        np.testing.assert_array_equal(v2c.val, np.asarray(jd.val_r[d])[:n])
        col = np.repeat(np.arange(dg.n_pad), np.diff(c2v.ptr))
        np.testing.assert_array_equal(col, np.asarray(jd.col_c[d])[:n])
        np.testing.assert_array_equal(c2v.idx, np.asarray(jd.row_c[d])[:n])
        np.testing.assert_array_equal(c2v.val, np.asarray(jd.val_c[d])[:n])


def test_partition_batch_without_halo_shares_sizes():
    """partition_batch(..., halo=False) (combined.py:29, JAX's default):
    the all-gather layout at the batch's shared ms / ns, no halo width."""
    graphs = [graph(1), port_graph(np.random.RandomState(2), m=700, n=900,
                                   e=2000)]
    parts = tcombined.partition_batch(graphs, 2)
    assert all(not p.halo for p in parts)
    assert len({(p.ms, p.ns) for p in parts}) == 1
    assert parts[0].ms == max(tEP._shard_sizes(g, 2)[0] for g in graphs)


# --------------------------------------------------------------- the logits
@pytest.fixture(scope="module")
def zoo_params():
    return {a: (None if a == "GCNRand()" else jax_params(a, seed=1))
            for a in ARCHS}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_all_gather_logits_match_jax(zoo_params, arch, k):
    """Each arch's all-gather logits (fp32, eval) against JAX's dist_apply
    over partition_graph(pg, K) with the same weights, and against the
    port's halo route and single card. GCNRand draws from the port's
    generator, not JAX's keys: against JAX its knowledge mask (the signs),
    against the halo route exactly."""
    import jax
    from lp_gnn_tpu.parallel import edge_partition as jEP
    g = graph(10 + k)
    params = zoo_params[arch]
    model = port_model(params, arch)
    got = port_logits(model, g, k, halo=False)
    halo = port_logits(model, g, k, halo=True)
    assert got.dtype == np.float32 and got.shape == (g.ncons + g.nvars, 3)
    name = arch.split("(")[0]
    if params is None:
        params = jax_params(arch)
    mesh = jax_mesh(k)
    jlc, jlv = jax.jit(lambda p, d: jEP.dist_apply(p, d, mesh, arch=name))(
        params, jEP.partition_graph(jax_graph(g), k))
    want = unpad(jlc, jlv, g)
    if name == "GCNRand":
        np.testing.assert_array_equal(got < 0, want < 0)
        np.testing.assert_array_equal(got, halo)
        return
    atol = GEN_ATOL if name == "GENDeeper" else DIST_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, halo, rtol=0, atol=atol)
    with torch.no_grad():
        single = np.concatenate(model(GraphTensors.from_graph(g, "cpu")))
    np.testing.assert_allclose(got, single, rtol=0, atol=atol)


# ------------------------------------------------------------------ a step
def update_rel(w0, a, b):
    from tests.test_torch_dist_train import update_rel as rel
    return rel(w0, a, b)


def jax_step(arch, params, g, k, lr):
    """JAX's make_dist_train_step (SGD, dropout 0) over partition_graph(pg,
    K) (halo=False): the loss and the new weights as a port state_dict."""
    import jax
    import jax.numpy as jnp
    from lp_gnn_tpu.parallel import edge_partition as jEP
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    opt = jtrainer.make_optimizer("sgd")
    step = jax.jit(jEP.make_dist_train_step(
        "balanced", opt, jax_mesh(k), dp_rate=0.0, arch=arch.split("(")[0]))
    p1, _, loss = step(params, opt.init(params),
                       jEP.partition_graph(jax_graph(g), k),
                       jax.random.PRNGKey(1), jnp.float32(lr))
    return float(loss), state_dict_from_jax_params(
        jax.tree.map(np.asarray, p1))


def port_step(arch, params, g, k, lr, halo=False):
    model = port_model(params, arch)
    model.dp = 0.0
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", lr)
    dgt = tEP.dist_tensors(model, tEP.partition_graph(g, k, halo=halo),
                           make_mesh(k, "cpu"), input_agg=True)
    loss = tEP.dist_train_step(model, opt, dgt, balanced)
    return float(loss), model.state_dict()


def test_gcn_fc_step_matches_jax():
    """One GCN_FC step over the all-gather layout at K=4 (the input cache
    through the all-gather pair, then the hidden conv's forward and the
    pair as each other's backward) against JAX's halo=False step."""
    g = graph(6)
    params = jax_params(GCN_FC)
    w0 = port_model(params, GCN_FC).state_dict()
    jloss, want = jax_step(GCN_FC, params, g, 4, 1.0)
    loss, got = port_step(GCN_FC, params, g, 4, 1.0)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert update_rel(w0, got, want) < UPDATE_RTOL


def test_gen_deeper_step_matches_jax():
    """One GENDeeper step over the all-gather layout at K=4 (r2l against
    the all-gathered sources; l2r's K parts merged by log-sum-exp, its
    backward gen_agg_bwd a shard over all n_pad rows) against JAX's
    halo=False step (pmax and psum_scatter of the exp-sums)."""
    g = graph(7)
    params = jax_params(GEN)
    jloss, want = jax_step(GEN, params, g, 4, 1e-3)
    loss, got = port_step(GEN, params, g, 4, 1e-3)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------- gradcheck
def small_partition(k, gen=False):
    g = port_graph(np.random.RandomState(20 + k), m=300, n=500, e=900)
    dg = tEP.partition_graph(g, k)
    return dg, tEP.DistGraphTensors.from_partition(dg, make_mesh(k, "cpu"),
                                                   gen=gen)


@pytest.mark.parametrize("k", [2, 4])
def test_all_gather_pair_gradcheck(k):
    """gradcheck in fp64 of AllGatherVars and ReduceScatterVars, alone and
    as the dist conv composes them with the SpMMs: right -> all-gather ->
    full v2c (SpmmFromFull), left -> full c2v partials (ShardPartials) ->
    reduce-scatter."""
    dg, dgt = small_partition(k)
    rng = np.random.RandomState(k)
    right = torch.from_numpy(rng.randn(k * dg.ns, 3)).requires_grad_()
    left = torch.from_numpy(rng.randn(k * dg.ms, 3)).requires_grad_()
    parts = torch.from_numpy(rng.randn(k, dg.n_pad, 3)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: tEP.AllGatherVars.apply(x, dgt), (right,))
    assert torch.autograd.gradcheck(
        lambda p: tEP.ReduceScatterVars.apply(p, dgt), (parts,))
    assert torch.autograd.gradcheck(
        lambda r, l: tEP._dist_aggs(dgt, l, r), (right, left))


@pytest.mark.parametrize("k", [2, 4])
def test_gen_l2r_all_gather_gradcheck(k):
    """gradcheck in fp64 of DistGenL2R over the all-gather layout (x, w, b,
    t): K gen_agg_fwd and the merge of the K parts of each row; gen_agg_bwd
    a shard over all n_pad rows with the merged statistics and the
    gather's SpMM backward."""
    dg, dgt = small_partition(k, gen=True)
    rng = np.random.RandomState(k)
    d = 3
    x = torch.from_numpy(rng.randn(k * dg.ms, d)).requires_grad_()
    w = torch.from_numpy(rng.randn(d)).requires_grad_()
    b = torch.from_numpy(rng.randn(d)).requires_grad_()
    t = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *v: dist_gen.DistGenL2R.apply(*v, dgt), (x, w, b, t))


def test_reduce_scatter_sums_in_shard_order():
    """With every shard here the reduce-scatter is the sum of the K partials
    left to right in their dtype (bf16 here), each add rounded, as
    psum_scatter sums them; the all-gather is the rows themselves."""
    _, dgt = small_partition(4)
    rng = np.random.RandomState(0)
    parts = torch.from_numpy(rng.randn(4, dgt.n_pad, 8)).bfloat16()
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(tEP.ReduceScatterVars.apply(parts, dgt), want)
    x = torch.randn(dgt.n_pad, 8)
    assert tEP.AllGatherVars.apply(x, dgt).data_ptr() == x.data_ptr()


# ------------------------------------------------------------- the rank form
def rank_side(payload):
    """One rank of RANKS gloo ranks: the all-gather route's
    GCN_FC and GENDeeper logits (eval) gathered to rank 0, and one dist
    step of each (SGD at lr 1, dropout 0); writes this rank's results."""
    k, me = world_and_rank()
    mesh = make_mesh(k, "cpu", dist.group.WORLD)
    dg = tEP.partition_graph(graph(50), k)
    out = {}
    for arch in (GCN_FC, GEN):
        model = build_model(arch)
        model.load_state_dict(torch.load(osp.join(
            payload["dir"], f"w0_{arch.split('(')[0]}.pt")))
        model.eval()
        with torch.no_grad():
            out[f"fwd/{arch}"] = tEP.gather_logits(
                *tEP.dist_apply(model, dg, mesh), mesh)
        model.dp = 0.0
        opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
        dgt = tEP.dist_tensors(model, dg, mesh, input_agg=True)
        loss = tEP.dist_train_step(model, opt, dgt, balanced)
        out[f"step/{arch}"] = (float(loss), model.state_dict())
    torch.save(out, osp.join(payload["dir"], f"rank{me}.pt"))


def main(argv):
    _, path = argv
    with open(path) as f:
        payload = json.load(f)
    _, created = init_distributed(torch.device("cpu"))
    try:
        rank_side(payload)
    finally:
        leave_distributed(created)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Seeded weights of both archs and one run of RANKS rank processes."""
    from tests.test_torch_dp import free_port
    tmp = tmp_path_factory.mktemp("all_gather_ranks")
    weights = {}
    for i, arch in enumerate((GCN_FC, GEN)):
        weights[arch] = build_model(
            arch, generator=torch.Generator().manual_seed(i)).state_dict()
        torch.save(weights[arch], tmp / f"w0_{arch.split('(')[0]}.pt")
    path = str(tmp / "payload.json")
    with open(path, "w") as f:
        json.dump({"dir": str(tmp)}, f)
    port = free_port()
    procs = []
    for rank in range(RANKS):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   LP_GNN_DIST_COORD=f"localhost:{port}",
                   LP_GNN_DIST_NPROCS=str(RANKS),
                   LP_GNN_DIST_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_all_gather", "ranks",
             path], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0] * RANKS, \
        "\n".join(o[-3000:] for o in outs)
    return weights, [torch.load(tmp / f"rank{r}.pt") for r in range(RANKS)]


@pytest.mark.parametrize("arch", [GCN_FC, GEN])
def test_rank_form_matches_stacked(rank_results, arch):
    """The all-gather route with shard k on rank k (gloo: the all-gather
    and the reduce-scatter's exchange staged through host copies, the
    reduce-scatter's sum in rank order; GEN's parts exchanged and merged at
    their owners) against the one-process stacked route: rank 0's gathered
    logits, one step's loss and updates, both ranks' weights equal."""
    weights, ranks = rank_results
    g = graph(50)
    model = build_model(arch)
    model.load_state_dict(weights[arch])
    want = port_logits(model, g, RANKS, halo=False)
    lc, lv = ranks[0][f"fwd/{arch}"]
    assert ranks[1][f"fwd/{arch}"] == (None, None)
    np.testing.assert_allclose(unpad(lc.numpy(), lv.numpy(), g), want,
                               rtol=0, atol=STACKED_ATOL)
    model = build_model(arch)
    model.load_state_dict(weights[arch])
    model.dp = 0.0
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
    loss = tEP.dist_train_step(model, opt, tEP.dist_tensors(
        model, tEP.partition_graph(g, RANKS), make_mesh(RANKS, "cpu"),
        input_agg=True), balanced)
    got_loss, got = ranks[0][f"step/{arch}"]
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    assert update_rel(weights[arch], got, model.state_dict()) < UPDATE_RTOL
    for name, v in got.items():
        assert torch.equal(v, ranks[1][f"step/{arch}"][1][name]), name


# ---------------------------------------------------- the trainer's choice
@pytest.fixture(scope="module")
def family(tmp_path_factory):
    from tests.test_torch_sampling import write_family
    prefix = tmp_path_factory.mktemp("all_gather_family") / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"),
                 [(300, 500, 900), (260, 520, 800), (280, 400, 700)], seed=3)
    return str(prefix)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_and_predict_choose_by_dist_halo_archs(family, tmp_path,
                                                       monkeypatch, arch):
    """--mesh_shape edge=2 --edge_num_thresh 0: the trainer (its steps and
    its val pass) and predict partition with halo = the arch is in
    DIST_HALO_ARCHS (trainer.py:368, predict.py:106): GCNRand takes the
    all-gather partition, every other arch the halo partition; the
    partition cache keeps one file a graph and layout."""
    seen = []
    real = tEP.cached_partition_graph

    def recorded(*a, **kw):
        dg = real(*a, **kw)
        seen.append((kw["halo"], dg.halo))
        return dg

    monkeypatch.setattr(ttrainer, "cached_partition_graph", recorded)
    monkeypatch.setattr(tEP, "cached_partition_graph", recorded)
    cfg = Config(exp_nm="choose", dataset="fam", data_prefix=family,
                 log_prefix=str(tmp_path), device="cpu", arch=arch,
                 epochs=1, eval_every=1, mesh_shape="edge=2",
                 edge_num_thresh=0, seed=3).finalize()
    ttrainer.run_exp(cfg)
    halo = arch.split("(")[0] in tEP.DIST_HALO_ARCHS
    assert len(seen) == 3 and set(seen) == {(halo, halo)}
    model = build_model(arch).eval()
    g = LPDataset(cfg.dataset_processed_prefix)[0]
    tpredict.model_inference(model, g, 0, mesh=make_mesh(2, "cpu"),
                             part_dir=str(tmp_path / "parts"))
    assert seen[-1] == (halo, halo)
    (name,) = os.listdir(tmp_path / "parts")
    assert f"-D2-h{int(halo)}-" in name


# ---------------------------------------------------------------- the cache
def test_cache_keys_on_halo_and_rebuilds_old_versions(tmp_path, monkeypatch):
    """cached_partition_graph keys its file on halo (-h0 / -h1, as JAX's
    :558-560): both layouts of one graph are two files, each loads back
    equal and in its layout; a file of the previous cache version is a
    miss, rebuilt and rewritten."""
    g = graph(8)
    calls = {"n": 0}
    real = tEP.partition_graph

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tEP, "partition_graph", counted)
    kw = dict(cache_dir=str(tmp_path), fn="g")
    built = {h: tEP.cached_partition_graph(g, 2, halo=h, **kw)
             for h in (False, True)}
    assert calls["n"] == 2
    names = sorted(os.listdir(tmp_path))
    assert [n.split("-")[2] for n in names] == ["h0", "h1"]
    for h, dg in built.items():
        again = tEP.cached_partition_graph(g, 2, halo=h, **kw)
        assert again.halo == h and again.bh == dg.bh
        for kind in tEP.CSR_KINDS + tEP.FULL_KINDS:
            assert len(getattr(again, kind)) == len(getattr(dg, kind))
            for m1, m2 in zip(getattr(again, kind), getattr(dg, kind)):
                for x, y in zip(m1, m2):
                    np.testing.assert_array_equal(x, y)
    assert calls["n"] == 2
    path = str(tmp_path / names[0])
    with np.load(path) as z:
        old = {k: z[k] for k in z.files}
    old["version"] = np.int64(tEP._CACHE_VERSION - 1)
    with open(path, "wb") as f:
        np.savez(f, **old)
    tEP.cached_partition_graph(g, 2, halo=False, **kw)
    assert calls["n"] == 3
    with np.load(path) as z:
        assert int(z["version"]) == tEP._CACHE_VERSION


if __name__ == "__main__":
    main(sys.argv[1:])
