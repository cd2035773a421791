"""The port's edge-partitioned prediction (lp_gnn_tpu_torch/parallel) against
the JAX package's (lp_gnn_tpu/parallel/edge_partition.py), on the CPU.

The JAX side runs on the conftest's virtual 8-device mesh with its default
XLA transport, which tests/test_parallel.py:709 holds bit-equal to the
Pallas kernel K1; the port runs all shards on the CPU through the plain
versions of its kernels. Inputs are made with numpy from a seed.
"""
import os

import numpy as np
import pytest
import torch

import jax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.parallel import edge_partition as jEP
from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.infer import predict as tpredict
from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel.halo import (halo_all_to_all,
                                            halo_all_to_all_plain)
from lp_gnn_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_gcn_fc import BF16_VS_JAX_BF16, jax_logits
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

ARCH = "GCN_FC(8,8,hids=16,depth=3)"
# 500 rows and 1000 variables: blocks of 128 rows and 256 variables at K=4,
# so every shard owns rows and the halo crosses every pair
GRAPH = dict(m=500, n=1000, e=3000)
# the tolerance of tests/test_parallel.py:43 (dist vs single chip, fp32)
DIST_ATOL = 5e-4


def graphs(seed):
    return random_graph(np.random.RandomState(seed), **GRAPH)


def coo(m):
    """(dst, src, val) of a port CSR."""
    ptr = np.asarray(m.ptr)
    dst = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    return dst, np.asarray(m.idx), np.asarray(m.val)


def shard_map_edge(body, k, n_in):
    mesh = jax_make_mesh({"edge": k}, devices=jax.devices()[:k])
    return shard_map(body, mesh=mesh, in_specs=(P("edge"),) * n_in,
                     out_specs=P("edge"), check_vma=False)


@pytest.mark.parametrize("k", [2, 4])
def test_partition_matches_jax(k):
    """The cut points and halo lists equal partition_graph(pad_graph(g), K,
    halo=True)'s, and each shard's four CSRs hold exactly its edges."""
    g, jg = graphs(k)
    dg = tEP.partition_graph(g, k, halo=True)
    jd = jEP.partition_graph(pad_graph(jg), k, halo=True)
    bh = jd.halo_send.shape[-1]
    assert (dg.ms, dg.ns, dg.bh) == (jd.ms, jd.ns, bh)
    assert tEP.compute_halo_width(g, k) == bh == \
        jEP.compute_halo_width(pad_graph(jg), k)
    for f in ("halo_send", "halo_perm", "halo_ids", "nnz_s", "c_feas",
              "v_feas", "cons_mask", "vars_mask"):
        np.testing.assert_array_equal(getattr(dg, f), np.asarray(getattr(jd, f)),
                                      err_msg=f)
    for d in range(k):
        n = int(jd.nnz_s[d])
        want = sorted(zip(jd.row_r[d][:n].tolist(), jd.col_r[d][:n].tolist(),
                          jd.val_r[d][:n].tolist()))
        dst, src, v = coo(dg.local_v2c[d])
        got = list(zip(dst.tolist(), (src + d * dg.ns).tolist(), v.tolist()))
        dst, slot, v = coo(dg.halo_v2c[d])
        owner, rank = np.divmod(slot, dg.bh)
        assert (owner != d).all()
        col = owner * dg.ns + dg.halo_send[owner, d, rank]
        got += list(zip(dst.tolist(), col.tolist(), v.tolist()))
        assert sorted(got) == want
        # the c2v CSRs are the transposes of the v2c ones
        for v2c, c2v in ((dg.local_v2c[d], dg.local_c2v[d]),
                         (dg.halo_v2c[d], dg.halo_c2v[d])):
            a, b, w = coo(v2c)
            c, e, x = coo(c2v)
            assert sorted(zip(a.tolist(), b.tolist(), w.tolist())) == \
                sorted(zip(e.tolist(), c.tolist(), x.tolist()))


@pytest.mark.parametrize("k", [2, 4])
def test_all_to_all_plain_matches_jax(k):
    """halo_all_to_all_plain == lax.all_to_all(x, ax, 0, 0, tiled=True)
    under shard_map, exactly."""
    x = np.random.RandomState(k).randn(k, k * 5, 3).astype(np.float32)
    want = shard_map_edge(
        lambda a: jax.lax.all_to_all(a[0], "edge", 0, 0, tiled=True)[None],
        k, 1)(x)
    got = halo_all_to_all_plain(list(torch.from_numpy(x)))
    np.testing.assert_array_equal(torch.stack(got).numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [2, 4])
def test_halo_gather_reduce_match_jax(k):
    g, jg = graphs(10 + k)
    dg = tEP.partition_graph(g, k, halo=True)
    dt = tEP.DistGraphTensors.from_partition(dg, make_mesh(k, "cpu"))
    rng = np.random.RandomState(k)
    x = rng.randn(k, dg.ns, 8).astype(np.float32)
    part = rng.randn(k, dg.nh, 8).astype(np.float32)
    # the halo c2v SpMM leaves zeros in the padding slots (no edge targets
    # them), which the port's reduce skips and JAX's adds to local row 0
    for d in range(k):
        part[d][np.diff(dg.halo_c2v[d].ptr) == 0] = 0
    idx = (dg.halo_send, dg.halo_perm, dg.halo_ids)

    def jgather(x, s, p, i):
        return jEP.halo_gather(x[0], s[0], p[0], i[0], "edge")[None]

    def jreduce(x, s, p, i):
        return jEP.halo_reduce(x[0], s[0], p[0], i[0], dg.ns, "edge")[None]

    want_h = np.asarray(shard_map_edge(jgather, k, 4)(x, *idx))
    want_r = np.asarray(shard_map_edge(jreduce, k, 4)(part, *idx))
    got_h = tEP.halo_gather(torch.from_numpy(x).reshape(k * dg.ns, 8),
                            dt.halo_src, dt.halo_sched)
    got_r = tEP.halo_reduce(torch.from_numpy(part), dt.halo_red)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_allclose(torch.stack(got_r).numpy(), want_r, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("bh", [1, 5, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_halo_src_folds_the_all_to_all(k, bh):
    """One gather over compose_halo_src, in the order of its schedule,
    equals the JAX route's send-row gathers followed by the all-to-all,
    exactly, for any K and Bh."""
    rng = np.random.RandomState(k * 10 + bh)
    ns = 3 * bh + 2
    halo_send = rng.randint(0, ns, (k, k, bh)).astype(np.int32)
    x = torch.from_numpy(rng.randn(k, ns, 6).astype(np.float32))
    want = halo_all_to_all_plain(
        [x[p][torch.from_numpy(halo_send[p].reshape(-1)).long()]
         for p in range(k)])
    src = tEP.compose_halo_src(halo_send, ns)
    assert src.shape == (k, k * bh) and src.dtype == np.int32
    sched = torch.from_numpy(tEP.halo_schedule(src, window=4))
    got = tEP.halo_gather(x.reshape(k * ns, 6), torch.from_numpy(src), sched)
    assert torch.equal(got, torch.stack(want))


@pytest.mark.parametrize("k", [2, 4])
def test_halo_schedule_covers_each_slot_once(k):
    """The halo schedule of a real partition: ranges that cover every slot
    of the composed index once, each within one (receiver, sender) block
    and one window of sender rows, at most a window long, listed window by
    window."""
    g, _ = graphs(30 + k)
    dg = tEP.partition_graph(g, k, halo=True)
    src = tEP.compose_halo_src(dg.halo_send, dg.ns)
    window = 16
    sched = tEP.halo_schedule(src, window)
    assert sched.dtype == np.int32 and sched.shape[1] == 2
    first, rows = sched[:, 0], sched[:, 1]
    assert (rows >= 1).all() and (rows <= window).all()
    cover = np.zeros(src.size, int)
    np.add.at(cover, np.repeat(first, rows) + np.concatenate(
        [np.arange(r) for r in rows]), 1)
    assert (cover == 1).all()
    flat = src.reshape(-1)
    last = first + rows - 1
    assert (first // dg.bh == last // dg.bh).all()
    assert (flat[first] // window == flat[last] // window).all()
    assert (np.diff(flat[first] // window) >= 0).all()


@pytest.mark.parametrize("k", [2, 4])
def test_stacked_all_to_all_matches_list_and_jax(k):
    """halo_all_to_all on one stacked (K, K*Bh, F) tensor equals its list
    form and lax.all_to_all(x, ax, 0, 0, tiled=True), exactly."""
    x = np.random.RandomState(k + 20).randn(k, k * 3, 5).astype(np.float32)
    want = shard_map_edge(
        lambda a: jax.lax.all_to_all(a[0], "edge", 0, 0, tiled=True)[None],
        k, 1)(x)
    got = halo_all_to_all(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    listed = halo_all_to_all(list(torch.from_numpy(x)))
    assert torch.equal(got, torch.stack(listed))


_JAX_DIST: dict = {}


def jax_dist_logits(k, params, jg):
    """JAX dist_apply logits on the virtual mesh, unpadded, cached by K.
    It takes no dtype: the JAX package's edge-partitioned forward runs in
    fp32 whatever the arch's dtype (edge_partition.py:757-783)."""
    if k not in _JAX_DIST:
        mesh = jax_make_mesh({"edge": k}, devices=jax.devices()[:k])
        dg = jEP.partition_graph(pad_graph(jg), k, halo=True)
        lc, lv = jEP.dist_apply(params, dg, mesh)
        _JAX_DIST[k] = np.concatenate([np.asarray(lc)[: jg.ncons],
                                       np.asarray(lv)[: jg.nvars]])
    return _JAX_DIST[k]


def port_logits(arch, sd, g, k=None):
    """The port's logits on the CPU: single-device, or over K shards."""
    model = build_model(arch)
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        if k is None:
            lc, lv = model(GraphTensors.from_graph(g, "cpu"))
        else:
            lc, lv = tEP.dist_apply(model,
                                    tEP.partition_graph(g, k, halo=True),
                                    make_mesh(k, "cpu"))
            lc, lv = lc[: g.ncons], lv[: g.nvars]
    return np.concatenate([lc.numpy(), lv.numpy()])


@pytest.fixture(scope="module")
def params():
    model = jax_build_model(ARCH)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("k", [2, 4])
def test_dist_gcn_fc_matches_jax_fp32(params, k):
    """fp32: JAX dist_apply and the port's single-device forward, to the
    tolerance of tests/test_parallel.py:43 (sums in another order)."""
    g, jg = graphs(0)
    sd = state_dict_from_jax_params(params)
    got = port_logits(ARCH, sd, g, k)
    assert got.dtype == np.float32 and got.shape == (g.ncons + g.nvars, 3)
    np.testing.assert_allclose(got, jax_dist_logits(k, params, jg), rtol=0,
                               atol=DIST_ATOL)
    np.testing.assert_allclose(got, port_logits(ARCH, sd, g), rtol=0,
                               atol=DIST_ATOL)


def test_dist_gcn_fc_bf16_within_jax_spread(params):
    """bf16, which the port's edge-partitioned forward honours and JAX's
    does not, is held to JAX's own single-chip bf16 (test_torch_gcn_fc.py's
    rule): mean |diff| to it at most 0.25, and a mean distance from JAX's
    fp32 dist logits at most 3x that of JAX's bf16."""
    g, jg = graphs(0)
    arch16 = ARCH[:-1] + ",dtype='bfloat16')"
    got = port_logits(arch16, state_dict_from_jax_params(params), g, 2)
    jax16 = np.concatenate(jax_logits(arch16, params, jg))
    exact = jax_dist_logits(2, params, jg)
    assert np.isfinite(got).all()
    assert np.abs(got - jax16).mean() <= 0.25
    assert np.abs(got - exact).mean() <= \
        BF16_VS_JAX_BF16 * np.abs(jax16 - exact).mean()


def test_partition_runs_once_per_pass(monkeypatch):
    """One dataset pass partitions each graph once (test_parallel.py:366)."""
    g, _ = graphs(3)
    g.fn = "g3"
    calls = {"n": 0}
    orig = tEP.partition_graph

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tEP, "partition_graph", counted)
    model = build_model("GCN_FC(8,8,hids=8,depth=2)").eval()
    mesh, cache = make_mesh(2, "cpu"), {}
    out1 = tpredict.model_inference(model, g, 0, mesh=mesh, dist_cache=cache)
    out2 = tpredict.model_inference(model, g, 0, mesh=mesh, dist_cache=cache)
    assert calls["n"] == 1
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)


def test_partition_disk_cache_roundtrip(tmp_path, monkeypatch):
    """cached_partition_graph stores the partition as the port's own
    .tpart.npz beside the JAX package's .pk caches, never touching those;
    a second call loads it equal; another K or a changed graph misses
    (test_parallel.py:397)."""
    g, jg = graphs(4)
    jEP.cached_partition_graph(pad_graph(jg), 2, halo=True,
                               cache_dir=str(tmp_path), fn="g0")
    (jax_pk,) = os.listdir(tmp_path)
    assert jax_pk.endswith(".pk")
    jax_stat = os.stat(tmp_path / jax_pk)
    calls = {"n": 0}
    orig = tEP.partition_graph

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tEP, "partition_graph", counted)
    d1 = tEP.cached_partition_graph(g, 2, cache_dir=str(tmp_path),
                                    fn="g0", halo=True)
    d2 = tEP.cached_partition_graph(g, 2, cache_dir=str(tmp_path),
                                    fn="g0", halo=True)
    assert calls["n"] == 1
    for f in d1.__dataclass_fields__:
        a, b = getattr(d1, f), getattr(d2, f)
        if isinstance(a, list):
            for m1, m2 in zip(a, b, strict=True):
                for x, y in zip(m1, m2):
                    np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)
    tEP.cached_partition_graph(g, 4, cache_dir=str(tmp_path), fn="g0",
                               halo=True)
    assert calls["n"] == 2
    g2, _ = graphs(5)
    tEP.cached_partition_graph(g2, 2, cache_dir=str(tmp_path), fn="g0",
                               halo=True)
    assert calls["n"] == 3
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 4 and jax_pk in files
    assert all(f.endswith(".tpart.npz") for f in files if f != jax_pk)
    assert os.stat(tmp_path / jax_pk).st_mtime_ns == jax_stat.st_mtime_ns
