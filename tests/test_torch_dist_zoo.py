"""The zoo's edge-partitioned forwards in the port (parallel/edge_partition.py
DIST_MODELS, parallel/dist_gen.py, ops/gen_agg.py gen_lse_merge) against
the JAX package's dist_apply on the conftest's virtual CPU devices, and a
dist GENDeeper step against the port's single-card step, on the CPU,
where every kernel wrapper runs its plain version. Inputs are made with
numpy from a seed, sized as tests/test_parallel.py:205 (m=24, n=40,
e=150; K=2 and one K=4 case).

Tolerances, stated where they are used:
- GraphConv archs' fp32 logits: atol DIST_ATOL, JAX's own dist-vs-single
  tolerance (tests/test_parallel.py:43);
- GENDeeper's fp32 logits: atol GEN_ATOL, 10x the 3.8e-6 measured here
  (JAX combines the owners' maxes and sums exps; the port merges each
  part's log-sum-exp: the same softmax rounded otherwise, through 4 layers
  and their norms);
- the lse merge against the softmax over all edges, fp64: rtol 1e-12;
- gradcheck in fp64: torch's defaults;
- a dist step against the single-card step (SGD at lr 1, dropout 0, fp32):
  the loss rtol 1e-5, each tensor's update within UPDATE_RTOL of its
  largest.
"""
import numpy as np
import pytest
import torch

import jax

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.parallel import edge_partition as jEP
from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.infer.predict import model_inference
from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
from lp_gnn_tpu_torch.models.gcn import MODEL_REGISTRY, build_model
from lp_gnn_tpu_torch.ops import gen_agg
from lp_gnn_tpu_torch.parallel import dist_gen
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel.mesh import make_mesh
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced
from tests.test_torch_dist_train import UPDATE_RTOL, update_rel
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

GRAPH = dict(m=24, n=40, e=150)
DIST_ATOL = 5e-4
GEN_ATOL = 5e-5
ARCHS = ["GCN_FC(8,8,hids=16,depth=3)", "GCN(8,8,hids=16)",
         "GCNDeeper(8,8,hids=16,depth=5)", "GENDeeper(8,8,hids=16,depth=4)"]


def graphs(seed):
    return random_graph(np.random.RandomState(seed), **GRAPH)


def both_models(arch, seed=0):
    """The JAX params of ``arch`` from a seed and the port's model holding
    them, in eval mode."""
    params = jax.tree.map(np.asarray, jax_build_model(arch).init(
        jax.random.PRNGKey(seed)))
    model = build_model(arch)
    model.load_state_dict(state_dict_from_jax_params(params))
    return params, model.eval()


def jax_dist(arch, params, jg, k):
    """JAX dist_apply over the halo partition, unpadded."""
    mesh = jax_make_mesh({"edge": k}, devices=jax.devices()[:k])
    dg = jEP.partition_graph(pad_graph(jg), k, halo=True)
    name = arch.split("(")[0]
    lc, lv = jax.jit(lambda p, d: jEP.dist_apply(p, d, mesh, arch=name))(
        params, dg)
    return np.concatenate([np.asarray(lc)[: jg.ncons],
                           np.asarray(lv)[: jg.nvars]])


def port_dist(model, g, k):
    with torch.no_grad():
        lc, lv = tEP.dist_apply(model,
                                tEP.partition_graph(g, k, halo=True),
                                make_mesh(k, "cpu"))
    return np.concatenate([lc[: g.ncons].numpy(), lv[: g.nvars].numpy()])


@pytest.mark.parametrize("arch,k", [(a, 2) for a in ARCHS[:3]]
                         + [(ARCHS[2], 4)])
def test_dist_logits_match_jax(arch, k):
    """The GraphConv archs' dist forwards in fp32 against JAX's dist_apply
    with the same weights, and against the port's single-card forward."""
    g, jg = graphs(k)
    params, model = both_models(arch)
    got = port_dist(model, g, k)
    assert got.dtype == np.float32 and got.shape == (g.ncons + g.nvars, 3)
    np.testing.assert_allclose(got, jax_dist(arch, params, jg, k), rtol=0,
                               atol=DIST_ATOL)
    with torch.no_grad():
        single = np.concatenate(model(GraphTensors.from_graph(g, "cpu")))
    np.testing.assert_allclose(got, single, rtol=0, atol=DIST_ATOL)


@pytest.mark.parametrize("k", [2, 4])
def test_dist_gen_deeper_matches_jax(k, monkeypatch):
    """GENDeeper's dist forward in fp32 against JAX's halo GEN layer
    (:880), through the compact halo space: every conv's l2r goes through
    DistGenL2R (the owners' lse merge), none through the single-card
    conv."""
    arch = ARCHS[3]
    g, jg = graphs(10 + k)
    params, model = both_models(arch, seed=1)
    calls = {"n": 0}
    real = dist_gen.DistGenL2R.apply

    def counted(*a):
        calls["n"] += 1
        return real(*a)

    monkeypatch.setattr(dist_gen.DistGenL2R, "apply", counted)
    got = port_dist(model, g, k)
    assert calls["n"] == 4   # conv_in, 2 blocks, conv_out
    np.testing.assert_allclose(got, jax_dist(arch, params, jg, k), rtol=0,
                               atol=GEN_ATOL)


def test_dist_gcn_rand_keeps_the_knowledge_mask():
    """GCNRand's dist logits: uniforms through the knowledge mask of the
    stacked features (numbers from the run's generator, not JAX's keys):
    negative exactly where JAX's are, and the same given one generator
    seed."""
    g, jg = graphs(5)
    model = build_model("GCNRand()").eval()
    got = port_dist(model, g, 2)
    params = jax.tree.map(np.asarray, jax_build_model("GCNRand()").init(
        jax.random.PRNGKey(0)))
    want = jax_dist("GCNRand()", params, jg, 2)
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_array_equal(got, port_dist(model, g, 2))


@pytest.mark.parametrize("arch", ARCHS + ["GCNRand()"])
def test_predict_serves_every_arch_edge_partitioned(arch):
    """model_inference with an edge mesh (the path pred_basis, validation
    and the val pass take) serves every arch: the dist logits equal the
    single-card ones (GCNRand: finite, its mask only)."""
    g, _ = graphs(7)
    g.fn = "g7"
    model = build_model(arch, generator=torch.Generator().manual_seed(2))
    model.eval()
    got = np.concatenate(model_inference(model, g, 0, mesh=make_mesh(2, "cpu")))
    single = np.concatenate(model_inference(model, g))
    assert got.shape == single.shape and np.isfinite(got).all()
    if arch != "GCNRand()":
        np.testing.assert_allclose(got, single, rtol=0, atol=DIST_ATOL)


def test_dist_registries_match_jax():
    """DIST_MODELS names every arch of the zoo, as JAX's does, and
    DIST_HALO_ARCHS (the archs that launch the halo exchange) equals JAX's
    DIST_HALO_ARCHS (edge_partition.py:1043-1057); the archs whose convs
    aggregate by softmax (GEN's compact halo space) are among them."""
    assert set(tEP.DIST_MODELS) == set(jEP.DIST_MODELS)
    assert tEP.DIST_HALO_ARCHS == jEP.DIST_HALO_ARCHS
    softmax = {n for n, c in MODEL_REGISTRY.items() if c.softmax_aggregation}
    assert softmax == {"GENDeeper"} and softmax < tEP.DIST_HALO_ARCHS


# ------------------------------------------------------------ the lse merge
def test_lse_merge_is_the_softmax_of_all_edges():
    """Segments cut into parts (a local part, possibly empty, and up to two
    slot parts, listed in any order in the parts array): gen_lse_merge of
    the parts' (aggr, lse) from gen_agg_fwd equals gen_agg_fwd over all
    the edges, in fp64; a row without edges gets aggr 0 and lse 0."""
    rng = np.random.RandomState(3)
    rows, d, n_src = 40, 5, 30
    counts = rng.randint(0, 7, rows)
    counts[[2, 7]] = 0
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    src = rng.randint(0, n_src, ptr[-1]).astype(np.int32)
    a = rng.randn(ptr[-1]).astype(np.float32)
    x = torch.from_numpy(rng.randn(n_src, d))
    w, b = torch.from_numpy(rng.randn(d)), torch.from_numpy(rng.randn(d))
    t = torch.tensor(1.7, dtype=torch.float64)

    def agg_of(edge_lists):
        p = np.concatenate([[0], np.cumsum([len(e) for e in edge_lists])])
        e = np.concatenate(edge_lists).astype(np.int64)
        return gen_agg.gen_agg_fwd(torch.from_numpy(p.astype(np.int32)),
                                   torch.from_numpy(src[e]),
                                   torch.from_numpy(a[e]), x, w, b, t)

    whole = agg_of([np.arange(ptr[r], ptr[r + 1]) for r in range(rows)])
    local = np.array([rng.randint(0, c + 1) for c in counts], np.int32)
    slots = []
    for r in range(rows):
        rest = np.arange(ptr[r] + local[r], ptr[r + 1])
        cut = rng.randint(0, len(rest) + 1)
        slots += [(r, p) for p in (rest[:cut], rest[cut:]) if len(p)]
    slots = [slots[i] for i in rng.permutation(len(slots))]
    assert ((local == 0) & (counts > 0)).any() and (local > 0).any()
    loc_aggr, loc_lse = agg_of([np.arange(ptr[r], ptr[r] + local[r])
                                for r in range(rows)])
    s_aggr, s_lse = agg_of([e for _, e in slots])
    parts = torch.cat([s_aggr, s_lse, torch.zeros(len(slots), 2,
                                                  dtype=torch.float64)], 1)
    by_row = sorted(range(len(slots)), key=lambda i: slots[i][0])
    m_ptr = np.zeros(rows + 1, np.int32)
    np.cumsum(np.bincount([r for r, _ in slots], minlength=rows),
              out=m_ptr[1:])
    aggr, lse = gen_agg.gen_lse_merge(
        torch.from_numpy(local), loc_aggr, loc_lse, torch.from_numpy(m_ptr),
        torch.tensor(by_row, dtype=torch.int32), parts)
    np.testing.assert_allclose(aggr.numpy(), whole[0].numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lse.numpy(), whole[1].numpy(), rtol=1e-12,
                               atol=1e-12)
    assert (aggr[[2, 7]] == 0).all() and (lse[[2, 7]] == 0).all()


@pytest.mark.parametrize("k", [2, 4])
def test_dist_gen_l2r_gradcheck(k):
    """gradcheck in fp64 of DistGenL2R (x, w, b, t): K gen_agg_fwd, K1 and
    the lse merge forward; the halo gather of the merged statistics,
    gen_agg_bwd over every compact row and the gather's SpMM backward."""
    g, _ = graphs(20 + k)
    dg = tEP.partition_graph(g, k, halo=True)
    dgt = tEP.DistGraphTensors.from_partition(dg, make_mesh(k, "cpu"),
                                              gen=True)
    rng = np.random.RandomState(k)
    d = 3
    x = torch.from_numpy(rng.randn(k * dg.ms, d)).requires_grad_()
    w = torch.from_numpy(rng.randn(d)).requires_grad_()
    b = torch.from_numpy(rng.randn(d)).requires_grad_()
    t = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *v: dist_gen.DistGenL2R.apply(*v, dgt), (x, w, b, t))


# --------------------------------------------------------- a dist GEN step
@pytest.mark.parametrize("k", [2, 4])
def test_dist_gen_step_matches_single_card(k):
    """One dist GENDeeper step (SGD at lr 1, dropout 0, fp32) against the
    port's single-card step from the same weights on the same graph: the
    loss and every tensor's update."""
    g, _ = graphs(30 + k)
    arch = ARCHS[3]
    w0 = build_model(arch, generator=torch.Generator().manual_seed(4)
                     ).state_dict()
    out = {}
    for way in ("single", "dist"):
        model = build_model(arch)
        model.load_state_dict(w0)
        model.dp = 0.0
        opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
        if way == "single":
            gt = ttrainer.train_graph(model, g, "cpu")
            loss, _ = ttrainer.train_step(model, opt, gt, balanced)
        else:
            dgt = tEP.dist_tensors(model,
                                   tEP.partition_graph(g, k, halo=True),
                                   make_mesh(k, "cpu"), input_agg=True)
            assert dgt.gen is not None and dgt.in_agg_c is None
            loss = tEP.dist_train_step(model, opt, dgt, balanced)
        out[way] = (float(loss), model.state_dict())
    np.testing.assert_allclose(out["dist"][0], out["single"][0], rtol=1e-5)
    assert update_rel(w0, out["dist"][1], out["single"][1]) < UPDATE_RTOL
