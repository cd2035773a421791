"""The port's edge-partitioned training (lp_gnn_tpu_torch/parallel: the halo
pair's and K1's backwards, the dist losses and step, the input aggregation
cache; the trainer's --mesh_shape edge=K) against the JAX package's
(lp_gnn_tpu/parallel/edge_partition.py) on the conftest's virtual CPU
devices, on the CPU, where every kernel wrapper runs its plain version.
Inputs are made with numpy from a seed, sized as tests/test_parallel.py:205
(m=24, n=40, e=150; K=2 and one K=4 case).

Tolerances, stated where they are used:
- the halo pair's and K1's VJPs: the gather direction and K1 exact (row
  copies), the reduce direction's sums atol 1e-6;
- gradcheck in fp64: torch's defaults;
- the dist losses: rtol 1e-5 (the same sums in another order);
- one dist SGD step at lr 1, dropout 0: the loss rtol 1e-5, each tensor's
  update within UPDATE_RTOL of its largest (an update is the gradient plus
  the coupled decay, so this holds the gradient to 1e-4 of its scale);
- whole runs from one JAX mdl.ckpt (Adam, 2 epochs): each step's loss rtol
  1e-5, the final params atol RUN_ATOL, val/acc exact.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.parallel import edge_partition as jEP
from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.ops.spmm import spmm_csr_plain
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel.halo import HaloAllToAll
from lp_gnn_tpu_torch.parallel.mesh import make_mesh
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import LOSS_REGISTRY
from tests.test_torch_sampling import RUN_ATOL, write_family
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

ARCH = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
GRAPH = dict(m=24, n=40, e=150)
UPDATE_RTOL = 1e-4
LOSSES = ("balanced", "unbalanced", "focal", "critical")


def graphs(seed):
    return random_graph(np.random.RandomState(seed), **GRAPH)


def jax_mesh(k):
    return jax_make_mesh({"edge": k}, devices=jax.devices()[:k])


def shard_map_edge(body, k, n_in, out=P("edge")):
    return jax.jit(shard_map(body, mesh=jax_mesh(k),
                             in_specs=(P("edge"),) * n_in, out_specs=out,
                             check_vma=False))


def partitions(seed, k):
    """The port's partition on the CPU, its device tensors, and JAX's."""
    g, jg = graphs(seed)
    dg = tEP.partition_graph(g, k, halo=True)
    dgt = tEP.DistGraphTensors.from_partition(dg, make_mesh(k, "cpu"))
    return g, dg, dgt, jEP.partition_graph(pad_graph(jg), k, halo=True)


def real_slots(dg):
    """(K, nh) bool: the halo slots some edge of the shard reads."""
    return np.stack([np.diff(m.ptr) > 0 for m in dg.halo_c2v])


# ------------------------------------------------------------ the halo pair
@pytest.mark.parametrize("k", [2, 4])
def test_halo_pair_vjps_match_jax(k):
    """The port's HaloGather / HaloReduce backwards against jax.vjp of the
    JAX pair's custom VJPs (edge_partition.py:612, :645) under shard_map.
    The gather's cotangent is zero at the padding slots, as on the dist
    path, where no edge reads them."""
    _, dg, dgt, _ = partitions(10 + k, k)
    rng = np.random.RandomState(k)
    f = 6
    x = rng.randn(k, dg.ns, f).astype(np.float32)
    ct_h = rng.randn(k, dg.nh, f).astype(np.float32) * real_slots(dg)[..., None]
    ct_r = rng.randn(k, dg.ns, f).astype(np.float32)
    part = rng.randn(k, dg.nh, f).astype(np.float32)
    idx = (dg.halo_send, dg.halo_perm, dg.halo_ids)

    def jgather_vjp(x, s, p, i, ct):
        _, vjp = jax.vjp(lambda a: jEP.halo_gather(a, s[0], p[0], i[0],
                                                   "edge"), x[0])
        return vjp(ct[0])[0][None]

    def jreduce_vjp(part, s, p, i, ct):
        _, vjp = jax.vjp(lambda a: jEP.halo_reduce(a, s[0], p[0], i[0],
                                                   dg.ns, "edge"), part[0])
        return vjp(ct[0])[0][None]

    want_g = np.asarray(shard_map_edge(jgather_vjp, k, 5)(x, *idx, ct_h))
    want_r = np.asarray(shard_map_edge(jreduce_vjp, k, 5)(part, *idx, ct_r))
    right = torch.from_numpy(x.reshape(k * dg.ns, f)).requires_grad_()
    tEP.HaloGather.apply(right, dgt).backward(torch.from_numpy(ct_h))
    np.testing.assert_allclose(right.grad.numpy().reshape(k, dg.ns, f),
                               want_g, rtol=0, atol=1e-6)
    parts = torch.from_numpy(part).requires_grad_()
    tEP.HaloReduce.apply(parts, dgt).backward(
        torch.from_numpy(ct_r.reshape(k * dg.ns, f)))
    np.testing.assert_array_equal(parts.grad.numpy(), want_r)


@pytest.mark.parametrize("k", [2, 4])
def test_halo_pair_gradcheck_with_padding_slots(k):
    """gradcheck in fp64 of each direction as the dist conv composes it:
    the gather feeding the halo v2c SpMM, the halo c2v SpMM feeding the
    reduce. The partition has padding slots (K*Bh above its real slots), so
    the gradient of ``right`` is exact with them in the buffers."""
    g, dg, dgt, _ = partitions(20 + k, k)
    assert real_slots(dg).sum() < k * dg.nh
    rng = np.random.RandomState(k)
    right = torch.from_numpy(rng.randn(k * dg.ns, 3)).requires_grad_()
    left = torch.from_numpy(rng.randn(k * dg.ms, 3)).requires_grad_()

    def gather_then_v2c(right):
        h = tEP.HaloGather.apply(right, dgt)
        return torch.cat([spmm_csr_plain(*dgt.halo_v2c[d], h[d])
                          for d in range(k)])

    def c2v_then_reduce(left):
        ls = left.split(dg.ms)
        parts = torch.stack([spmm_csr_plain(*dgt.halo_c2v[d], ls[d])
                             for d in range(k)])
        return tEP.HaloReduce.apply(parts, dgt)

    assert torch.autograd.gradcheck(gather_then_v2c, (right,))
    assert torch.autograd.gradcheck(c2v_then_reduce, (left,))


@pytest.mark.parametrize("op", ["gather", "a2a", "spmm", "gen_gather_bwd"])
def test_fp64_off_the_cpu_reaches_the_wrappers(op):
    """The dist path takes the plain versions for fp64 on the CPU only: an
    fp64 tensor on another device goes to the kernel's wrapper, which
    refuses the dtype (here on the meta device, which stands in for the
    card)."""
    from lp_gnn_tpu_torch.ops.gen_agg import gather_backward
    meta = dict(device="meta")
    x = torch.empty(8, 8, dtype=torch.float64, **meta)
    i32 = torch.zeros(4, dtype=torch.int32, **meta)
    csr = tEP.CSR(torch.zeros(3, dtype=torch.int32, **meta), i32,
                  torch.ones(4, **meta))
    call = {"gather": lambda: tEP._gather(x, i32, None),
            "a2a": lambda: tEP._a2a(x.view(2, 4, 8)),
            "spmm": lambda: tEP._spmm(csr, x),
            "gen_gather_bwd": lambda: gather_backward(csr.ptr, i32, x[:4], 8)}
    assert tEP.plain_fp64(torch.zeros(1, dtype=torch.float64))
    assert not tEP.plain_fp64(x)
    with pytest.raises(TypeError, match="fp32"):
        call[op]()


@pytest.mark.parametrize("k", [2, 4])
def test_all_to_all_backward_is_the_exchange(k):
    """K1's backward (HaloAllToAll) equals jax.vjp of the tiled
    lax.all_to_all under shard_map, and the same exchange of the
    gradient, exactly."""
    rng = np.random.RandomState(30 + k)
    x = rng.randn(k, k * 3, 5).astype(np.float32)
    ct = rng.randn(k, k * 3, 5).astype(np.float32)

    def jvjp(a, c):
        _, vjp = jax.vjp(lambda v: jax.lax.all_to_all(v, "edge", 0, 0,
                                                      tiled=True), a[0])
        return vjp(c[0])[0][None]

    want = np.asarray(shard_map_edge(jvjp, k, 2)(x, ct))
    xt = torch.from_numpy(x).requires_grad_()
    HaloAllToAll.apply(xt).backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert torch.equal(xt.grad, tEP.halo_all_to_all_plain(torch.from_numpy(ct)))


# ------------------------------------------------------- cache and losses
def test_attach_dist_input_agg_is_exact():
    """The cached input aggregations equal the dist conv's own, bit for
    bit, and a forward reading them gives the same logits."""
    g, dg, dgt, _ = partitions(3, 2)
    cached = tEP.attach_dist_input_agg(dgt, torch.float32)
    agg_c, agg_v = tEP._dist_aggs(dgt, dgt.c_feas, dgt.v_feas)
    assert torch.equal(cached.in_agg_c, agg_c)
    assert torch.equal(cached.in_agg_v, agg_v)
    model = build_model(ARCH, generator=torch.Generator().manual_seed(1))
    model.eval()
    with torch.no_grad():
        for a, b in zip(tEP.dist_forward(model, cached),
                        tEP.dist_forward(model, dgt)):
            assert torch.equal(a, b)


def jax_dist_loss(name, k, jd, lc, lv):
    """DIST_LOSSES[name] under shard_map on the JAX partition's labels and
    masks, with the (K, ms, 3) / (K, ns, 3) logits."""
    def body(lc, lv, ys, yt, ms, mt):
        return jEP.DIST_LOSSES[name](lc[0], lv[0], ys[0], yt[0], ms[0],
                                     mt[0], "edge")
    return float(shard_map_edge(body, k, 6, out=P())(
        lc, lv, jd.y_s, jd.y_t, jd.cons_mask, jd.vars_mask))


@pytest.mark.parametrize("name", LOSSES)
def test_dist_losses_match_jax(name):
    """The port's losses on the stacked logits with the partition's masks
    are JAX's DIST_LOSSES (critical with its 24-step bisection of psummed
    counts) on the same logits."""
    k = 2
    g, dg, dgt, jd = partitions(4, k)
    rng = np.random.RandomState(5)
    lc = (rng.randn(k, dg.ms, 3) * 3).astype(np.float32)
    lv = (rng.randn(k, dg.ns, 3) * 3).astype(np.float32)
    np.testing.assert_array_equal(dg.y_s, np.asarray(jd.y_s))
    np.testing.assert_array_equal(dg.y_t, np.asarray(jd.y_t))
    got = LOSS_REGISTRY[name](
        torch.from_numpy(lc.reshape(-1, 3)), torch.from_numpy(lv.reshape(-1, 3)),
        dgt.y_s, dgt.y_t, dgt.cons_mask, dgt.vars_mask)
    np.testing.assert_allclose(float(got), jax_dist_loss(name, k, jd, lc, lv),
                               rtol=1e-5)


# ---------------------------------------------------------- the dist step
def update_rel(w0, a, b):
    """The largest, over tensors, of max |u_a - u_b| / max |u_b|, u = w0 -
    w, an SGD step's update at lr 1."""
    worst = 0.0
    for name, v in w0.items():
        ua = (v.double() - a[name].double())
        ub = (v.double() - b[name].double())
        worst = max(worst, float((ua - ub).abs().max()
                                 / ub.abs().max().clamp(min=1e-30)))
    return worst


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_build_model(ARCH).init(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name,k", [(n, 2) for n in LOSSES] + [("balanced", 4)])
def test_dist_train_step_matches_jax(jax_params, name, k):
    """One dist_train_step (SGD at lr 1, dropout 0) against JAX's
    make_dist_train_step from the same params on the same partition: the
    loss and every tensor's update."""
    g, dg, _, jd = partitions(6, k)
    w0 = state_dict_from_jax_params(jax_params)
    optimizer = jtrainer.make_optimizer("sgd")
    step = jax.jit(jEP.make_dist_train_step(name, optimizer, jax_mesh(k),
                                            dp_rate=0.0))
    p1, _, jloss = step(jax_params, optimizer.init(jax_params), jd,
                        jax.random.PRNGKey(1), jnp.float32(1.0))
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, p1))
    model = build_model(ARCH)
    model.load_state_dict(w0)
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
    dgt = tEP.dist_tensors(model, dg, make_mesh(k, "cpu"), input_agg=True)
    loss = tEP.dist_train_step(model, opt, dgt, LOSS_REGISTRY[name])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert update_rel(w0, model.state_dict(), want) < UPDATE_RTOL


# ------------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def dist_family(tmp_path_factory):
    """3 tiny LPs (2 train, 1 val) and a JAX mdl.ckpt holding params only."""
    root = tmp_path_factory.mktemp("torch_dist_train")
    prefix = root / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"),
                 [(30, 50, 300), (24, 40, 260), (36, 44, 320)], seed=13)
    ckpt = str(root / "init.ckpt")
    jtrainer.save_ckpt(ckpt, jax.tree.map(np.asarray, jax_build_model(
        ARCH).init(jax.random.PRNGKey(7))))
    return str(prefix), ckpt


def record_dist_steps(monkeypatch):
    """Each dist step's loss of both trainers, in order. The JAX trainer's
    dist step draws dropout 0.1 whatever the arch's rate
    (trainer.py:388): taken here at the arch's 0, as the port's does."""
    seen = {"jax": [], "port": []}
    real_make = jEP.make_dist_train_step

    def make(*a, **kw):
        step = real_make(*a, **{**kw, "dp_rate": 0.0})

        def run(*sa, **skw):   # traced: the trainer jits the step
            out = step(*sa, **skw)
            jax.debug.callback(lambda v: seen["jax"].append(float(v)), out[2])
            return out
        return run

    real_step = ttrainer.dist_train_step

    def port_step(*a, **kw):
        loss = real_step(*a, **kw)
        seen["port"].append(float(loss))
        return loss

    monkeypatch.setattr(jEP, "make_dist_train_step", make)
    monkeypatch.setattr(ttrainer, "dist_train_step", port_step)
    return seen


def test_edge_run_exp_matches_jax(dist_family, tmp_path, monkeypatch):
    """run_exp --mesh_shape edge=2 --edge_num_thresh 0 on the CPU against
    JAX's run_exp with the same flags from one JAX mdl.ckpt: every graph
    takes dist steps, 2 epochs of Adam, a val pass at the end; the same
    steps' losses, val/acc and final params."""
    data_prefix, ckpt = dist_family
    seen = record_dist_steps(monkeypatch)
    kw = dict(dataset="fam", data_prefix=data_prefix, log_prefix=str(tmp_path),
              arch=ARCH, epochs=2, eval_every=2, load_from=ckpt,
              mesh_shape="edge=2", edge_num_thresh=0)
    jcfg = JaxConfig(exp_nm="jax", **kw).finalize()
    jpath = jtrainer.run_exp(jcfg)
    tcfg = Config(exp_nm="port", device="cpu", **kw).finalize()
    tpath = ttrainer.run_exp(tcfg)
    assert len(seen["port"]) == len(seen["jax"]) == 4
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-5)
    from tests.test_torch_train import metrics
    assert metrics(tcfg.log_dir)["val/acc"] == metrics(jcfg.log_dir)["val/acc"]
    with open(jpath, "rb") as f:
        want = state_dict_from_jax_params(pickle.load(f)["params"])
    for name, v in load_checkpoint(tpath).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    parts = os.listdir(os.path.join(tcfg.dataset_processed_prefix,
                                    "partitions"))
    assert sum(f.endswith(".tpart.npz") for f in parts) == 3


@pytest.mark.parametrize("arch", ["GCN_FC(8,8,hids=8,depth=3)",
                                  "GCN(8,8,hids=8)",
                                  "GCNDeeper(8,8,hids=8,depth=4)",
                                  "GENDeeper(8,8,hids=8,depth=3)",
                                  "GCNRand()"])
def test_edge_training_runs_every_arch(dist_family, tmp_path, monkeypatch,
                                       arch):
    """--mesh_shape edge=2 --edge_num_thresh 0 trains every arch of the
    zoo (the edge case of test_unported_training_paths_name_their_roadmap_item
    before it trained): one dist step a train graph, finite losses, a val
    pass through the dist forward, the checkpoints; weights that move,
    except GCNRand's, which depend on no gradient."""
    data_prefix, _ = dist_family
    seen = record_dist_steps(monkeypatch)
    cfg = Config(exp_nm="every", dataset="fam", data_prefix=data_prefix,
                 log_prefix=str(tmp_path), device="cpu", arch=arch, epochs=1,
                 eval_every=1, mesh_shape="edge=2", edge_num_thresh=0,
                 seed=3).finalize()
    w0 = build_model(cfg.arch_with_dtype(),
                     generator=torch.Generator().manual_seed(3)).state_dict()
    got = load_checkpoint(ttrainer.run_exp(cfg))
    assert len(seen["port"]) == 2 and np.isfinite(seen["port"]).all()
    from tests.test_torch_train import metrics
    assert len(metrics(cfg.log_dir)["val/acc"]) == 1
    moved = any(not torch.equal(w0[n], got[n]) for n in w0)
    assert moved == (arch != "GCNRand()")


def test_dp_and_edge_on_one_rank_trains_and_keeps_graph_batch(
        dist_family, tmp_path, monkeypatch, caplog):
    """dp x edge (parallel/combined.py; refused until it was ported) on one
    rank trains: the dp axis is dropped with a warning and graph_batch is
    kept (trainer.py:350-353 drops dp alone, unlike the dp-only fallback),
    and every train graph, above the threshold, takes one dist step."""
    data_prefix, _ = dist_family
    seen = record_dist_steps(monkeypatch)
    cfg = Config(exp_nm="dpe", dataset="fam", data_prefix=data_prefix,
                 log_prefix=str(tmp_path), device="cpu", arch=ARCH,
                 epochs=1, graph_batch=2, mesh_shape="dp=2,edge=2",
                 edge_num_thresh=0).finalize()
    with caplog.at_level("INFO"):
        path = ttrainer.run_exp(cfg)
    assert "mesh_shape dp=2,edge=2 exceeds 1 rank(s) — dropping the dp " \
        "axis" in caplog.text
    assert "1 rank(s) x 2 graphs a step" in caplog.text
    assert len(seen["port"]) == 2 and np.isfinite(seen["port"]).all()
    assert os.path.exists(path)


def test_old_partition_cache_is_rebuilt(tmp_path, monkeypatch):
    """A .tpart.npz of another cache version (v1 held no labels) is a
    miss: the partition is built again and the file rewritten, not a
    ValueError."""
    g, _ = graphs(8)
    dg = tEP.cached_partition_graph(g, 2, cache_dir=str(tmp_path), fn="g",
                                    halo=True)
    (name,) = os.listdir(tmp_path)
    path = str(tmp_path / name)
    with np.load(path) as z:
        v1 = {k: z[k] for k in z.files if k not in ("y_s", "y_t")}
    v1["version"] = np.int64(1)
    with open(path, "wb") as f:
        np.savez(f, **v1)
    calls = {"n": 0}
    real = tEP.partition_graph

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tEP, "partition_graph", counted)
    again = tEP.cached_partition_graph(g, 2, cache_dir=str(tmp_path),
                                       fn="g", halo=True)
    assert calls["n"] == 1
    np.testing.assert_array_equal(again.y_s, dg.y_s)
    with np.load(path) as z:
        assert int(z["version"]) == tEP._CACHE_VERSION == 3
    tEP.cached_partition_graph(g, 2, cache_dir=str(tmp_path), fn="g",
                               halo=True)
    assert calls["n"] == 1
