"""The port's GEN layer and the rest of the model zoo (lp_gnn_tpu_torch/
models/{gen,gcn}.py, ops/gen_agg.py) against the JAX package's on the same
inputs and weights, on the CPU, where the GEN aggregation's wrappers run
their plain versions (the forward in JAX's order of roundings, the backward
as the kernel's formula).

Tolerances, stated where they are used:
- fp32 GEN direction and bidirectional conv: atol 1e-5 (the same sums in
  another order; outputs O(1));
- bf16: the port's distance to JAX's fp32 output within 2x JAX's own
  bf16's (mean and max over the real rows);
- fp32 gradients against jax.grad: rtol 1e-4, atol 1e-5 of each
  parameter's largest entry;
- whole-model logits: fp32 atol 1e-4 on the +-10-scaled logits, bf16 as
  tests/test_torch_gcn_fc.py holds GCN_FC (BF16_VS_JAX_BF16);
- Adam steps: losses rtol 1e-5, params atol ADAM_ATOL.
"""
import os
import os.path as osp
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
from lp_gnn_tpu.models import gcn as jgcn
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.models.gen import (_segment_softmax_agg, gen_bidir_apply,
                                   gen_bidir_init, gen_dir_apply)
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu_torch import pred_basis
from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.infer.decode import inference_gnn
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.models.gen import BidirGENConv
from lp_gnn_tpu_torch.models.layers import LayerNorm
from lp_gnn_tpu_torch.ops import gen_agg
from lp_gnn_tpu_torch.ops import spmm as tspmm
from lp_gnn_tpu_torch.train import __main__ as train_main
from lp_gnn_tpu_torch.train import losses as tlosses
from lp_gnn_tpu_torch.train import trainer as ttrainer
from tests.test_torch_gcn_fc import BF16_VS_JAX_BF16
from tests.test_torch_predict import write_processed
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

# Adam's step turns each gradient entry into about +-lr whatever its size,
# so the frameworks' fp32 round-off reaches the params at lr times its
# relative size: after 3 steps at lr 1e-3, within 1e-6. An entry whose
# gradient sits within round-off of 0 moves further (GEN's relu leaves
# some: up to 6e-5 on other seeds, with the losses still within 2e-6);
# this graph and init have none
ADAM_ATOL = 1e-6
ZOO = ["GENDeeper(8,8,hids=16,depth=3)", "GCNDeeper(8,8,hids=16,depth=4)",
       "GCN(8,8,hids=16)"]


def gen_graph(seed, m=30, n=45, e=260, long_seg=120):
    """A random LP graph with constraint 0 and variable 0 isolated, one
    constraint row of ``long_seg`` edges and one variable column of
    ``long_seg // 2`` (longer than a team's share in the kernel), rows in
    CSR order. Returns the port's and the JAX package's graph."""
    rng = np.random.RandomState(seed)
    row = np.concatenate([rng.randint(1, m, e), np.full(long_seg, 3),
                          rng.randint(1, m, long_seg // 2)])
    col = np.concatenate([rng.randint(1, n, e), rng.randint(1, n, long_seg),
                          np.full(long_seg // 2, 7)])
    val = (rng.rand(len(row)) * 2 - 1).astype(np.float32)
    c_feas = (rng.rand(m, 8) - 0.5).astype(np.float32)
    v_feas = (rng.rand(n, 8) - 0.5).astype(np.float32)
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    order = np.lexsort((col, row))
    kw = dict(row=row[order].astype(np.int32), col=col[order].astype(np.int32),
              val=val[order], c_feas=c_feas, v_feas=v_feas,
              y_s=rng.randint(0, 3, m).astype(np.int32),
              y_t=rng.randint(0, 3, n).astype(np.int32))
    return BipartiteGraph(**kw), JaxGraph(**kw)


def np_params(tree):
    return jax.tree.map(np.asarray, tree)


def port_bidir(params) -> BidirGENConv:
    """A BidirGENConv holding the JAX bidir params (carried across by
    state_dict_from_jax_params, as a model's conv1)."""
    sd = state_dict_from_jax_params({"conv1": np_params(params)})
    l2r = params["l2r"]
    conv = BidirGENConv(l2r["lin_src"]["w"].shape[0] if "lin_src" in l2r
                        else l2r["edge"]["w"].shape[1],
                        l2r["lin_dst"]["w"].shape[0] if "lin_dst" in l2r
                        else l2r["edge"]["w"].shape[1],
                        l2r["edge"]["w"].shape[1])
    conv.load_state_dict(OrderedDict((k[len("conv1."):], v)
                                     for k, v in sd.items()))
    return conv


def padded(x, rows):
    out = np.zeros((rows, x.shape[1]), np.float32)
    out[: x.shape[0]] = x
    return out


def side_inputs(seed, m, n, d_left, d_right):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, d_left).astype(np.float32),
            rng.randn(n, d_right).astype(np.float32))


def jax_bidir(params, pg, left, right, dtype):
    jdt = jnp.dtype(dtype)
    lo, ro = gen_bidir_apply(params, pg,
                             jnp.asarray(padded(left, pg.m_pad), jdt),
                             jnp.asarray(padded(right, pg.n_pad), jdt))
    return (np.asarray(lo.astype(jnp.float32))[: left.shape[0]],
            np.asarray(ro.astype(jnp.float32))[: right.shape[0]])


def port_run_bidir(conv, gt, left, right, dtype):
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        lo, ro = conv(gt, torch.from_numpy(left).to(tdt),
                      torch.from_numpy(right).to(tdt))
    return lo.float().numpy(), ro.float().numpy()


def within_jax_bf16_spread(got, want16, want32, factor=2.0):
    """The port's bf16 against JAX's fp32 no further than ``factor`` x
    JAX's own bf16 (mean and max)."""
    mine, theirs = np.abs(got - want32), np.abs(want16 - want32)
    assert np.isfinite(got).all()
    assert mine.mean() <= factor * theirs.mean(), (mine.mean(), theirs.mean())
    assert mine.max() <= factor * theirs.max(), (mine.max(), theirs.max())


@pytest.mark.parametrize("dims", [(16, 16, 16), (3, 3, 3), (8, 6, 16),
                                  (12, 5, 3)],
                         ids=["d16", "d3", "d16_lin", "d3_lin"])
def test_gen_direction_matches_jax(dims):
    """One direction (r2l: vars -> cons over the CSR), D=16 and D=3, with
    lin_src / lin_dst absent and present, over a graph with an isolated
    destination and a 120-edge segment; fp32 and bf16."""
    d_src, d_dst, d_out = dims
    g, jg = gen_graph(1)
    pg = pad_graph(jg)
    gt = GraphTensors.from_graph(g, "cpu")
    params = gen_bidir_init(jax.random.PRNGKey(2), d_dst, d_src, d_out)
    conv = port_bidir(params).right2left
    x_src, x_dst = side_inputs(3, g.nvars, g.ncons, d_src, d_dst)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        want = gen_dir_apply(
            params["r2l"], pg.col_r, pg.row_r, pg.val_r,
            jnp.asarray(padded(x_src, pg.n_pad), jdt),
            jnp.asarray(padded(x_dst, pg.m_pad), jdt), pg.m_pad, pg.nnz,
            pg.col_c, pg.eperm_c, pg.n_pad)
        with torch.no_grad():
            got = conv(gt.rowptr, gt.col, gt.val_r, gt.colptr, None,
                       torch.from_numpy(x_src).to(tdt),
                       torch.from_numpy(x_dst).to(tdt))
        assert got.dtype == tdt and got.shape == (g.ncons, d_out)
        outs[dtype] = (got.float().numpy(),
                       np.asarray(want.astype(jnp.float32))[: g.ncons])
    np.testing.assert_allclose(*outs["float32"], rtol=0, atol=1e-5)
    within_jax_bf16_spread(outs["bfloat16"][0], outs["bfloat16"][1],
                           outs["float32"][1])


@pytest.mark.parametrize("dims", [(8, 8, 16), (16, 16, 3)],
                         ids=["in_d16", "out_d3"])
def test_gen_bidir_matches_jax(dims):
    """Both directions, as conv_in (8 -> 16, lin_src and lin_dst on both
    sides) and as conv_out (16 -> 3)."""
    d_left, d_right, d_out = dims
    g, jg = gen_graph(4)
    pg = pad_graph(jg)
    gt = GraphTensors.from_graph(g, "cpu")
    params = gen_bidir_init(jax.random.PRNGKey(5), d_left, d_right, d_out)
    conv = port_bidir(params)
    left, right = side_inputs(6, g.ncons, g.nvars, d_left, d_right)
    want32 = jax_bidir(params, pg, left, right, "float32")
    want16 = jax_bidir(params, pg, left, right, "bfloat16")
    got32 = port_run_bidir(conv, gt, left, right, "float32")
    got16 = port_run_bidir(conv, gt, left, right, "bfloat16")
    for side in range(2):
        np.testing.assert_allclose(got32[side], want32[side], rtol=0,
                                   atol=1e-5)
        within_jax_bf16_spread(got16[side], want16[side], want32[side])


def test_gen_gradients_match_jax():
    """d/d(left, right, every parameter, t included) of a weighted sum of
    both directions' outputs, through GenSoftmaxAgg's backward and the
    gather's (the SpMM over the transpose ordering), against jax.grad
    through gen_bidir_apply, fp32."""
    g, jg = gen_graph(7)
    pg = pad_graph(jg)
    gt = GraphTensors.from_graph(g, "cpu", perms=True)
    params = gen_bidir_init(jax.random.PRNGKey(8), 6, 10, 16)
    conv = port_bidir(params)
    left, right = side_inputs(9, g.ncons, g.nvars, 6, 10)
    rng = np.random.RandomState(10)
    wl = rng.randn(g.ncons, 16).astype(np.float32)
    wr = rng.randn(g.nvars, 16).astype(np.float32)

    def jloss(ps, xl, xr):
        lo, ro = gen_bidir_apply(ps, pg, xl, xr)
        return (jnp.sum(lo * padded(wl, pg.m_pad))
                + jnp.sum(ro * padded(wr, pg.n_pad)))

    jg_p, jg_l, jg_r = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(padded(left, pg.m_pad)),
        jnp.asarray(padded(right, pg.n_pad)))
    tl = torch.from_numpy(left).requires_grad_()
    tr = torch.from_numpy(right).requires_grad_()
    lo, ro = conv(gt, tl, tr)
    ((lo * torch.from_numpy(wl)).sum()
     + (ro * torch.from_numpy(wr)).sum()).backward()

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)

    close(tl.grad.numpy(), np.asarray(jg_l)[: g.ncons], "left")
    close(tr.grad.numpy(), np.asarray(jg_r)[: g.nvars], "right")
    want = state_dict_from_jax_params({"conv1": np_params(jg_p)})
    for k, p in conv.named_parameters():
        close(p.grad.numpy(), want["conv1." + k].numpy(), k)
    assert conv.right2left.t.grad.abs() > 0 and conv.left2right.t.grad.abs() > 0


def test_gen_softmax_agg_gradcheck():
    """torch.autograd.gradcheck of GenSoftmaxAgg (x, w, b, t) in fp64 on the
    plain versions: 6 destinations (one empty, one of 9 edges), D=3; every
    pre-activation at least 0.05 from relu's kink."""
    rng = np.random.RandomState(14)
    counts = np.array([2, 0, 9, 1, 3, 4])
    ptr = np.zeros(7, np.int32)
    np.cumsum(counts, out=ptr[1:])
    e, s, d = int(ptr[-1]), 5, 3
    src = rng.randint(0, s, e).astype(np.int32)
    # the transpose ordering: edges sorted by source, and their positions
    order = np.argsort(src, kind="stable")
    t_ptr = np.zeros(s + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=s), out=t_ptr[1:])
    a = torch.from_numpy(rng.rand(e).astype(np.float32) - 0.5)
    x = torch.from_numpy(rng.randn(s, d)).requires_grad_()
    w = torch.from_numpy(rng.randn(d)).requires_grad_()
    b = torch.from_numpy(rng.randn(d) * 0.1).requires_grad_()
    t = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    args = [torch.from_numpy(v) for v in (ptr, src)] + [a]
    pre = (x.detach()[src] + a.double()[:, None] * w.detach() + b.detach())
    assert pre.abs().min() > 0.05
    tr = [torch.from_numpy(t_ptr), torch.from_numpy(order.astype(np.int32))]
    assert torch.autograd.gradcheck(
        lambda x_, w_, b_, t_: gen_agg.GenSoftmaxAgg.apply(
            *args, x_, w_, b_, t_, *tr), (x, w, b, t), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_logits_match_jax(arch, dtype):
    """Whole-model logits, weights carried across, eval mode (no
    dropout). The JAX models run on JAX arrays: on numpy params the first
    bf16 product of a model with numpy features would run in numpy."""
    g, jg = gen_graph(12)
    a = arch[:-1] + f",dtype='{dtype}')"
    jm = jax_build_model(a)
    params = np_params(jm.init(jax.random.PRNGKey(13)))
    model = build_model(a)
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.no_grad():
        got = np.concatenate(model.eval()(GraphTensors.from_graph(g, "cpu")))
    pg = pad_graph(jg)

    def jax_logits(arch_):
        lc, lv = jax_build_model(arch_).apply(
            jax.tree.map(jnp.asarray, params), pg)
        return np.concatenate([np.asarray(lc)[: g.ncons],
                               np.asarray(lv)[: g.nvars]])

    want = jax_logits(a)
    assert got.shape == (g.ncons + g.nvars, 3) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return
    exact = jax_logits(arch)
    assert np.isfinite(got).all()
    assert (np.abs(got - exact).mean()
            <= BF16_VS_JAX_BF16 * np.abs(want - exact).mean())


def test_gcn_rand_logits_mask_and_decode():
    """GCNRand: U[0, 1) logits from its generator (seeded 0 when none is
    given, so two forwards agree) through the knowledge mask: shapes, the
    -10 on LL / UL where a bound is infinite, and a valid top-m decode."""
    g, _ = gen_graph(14)
    gt = GraphTensors.from_graph(g, "cpu")
    model = build_model("GCNRand(dtype='bfloat16')").eval()
    lc, lv = model(gt)
    assert lc.shape == (g.ncons, 3) and lv.shape == (g.nvars, 3)
    assert lc.dtype == torch.float32
    assert torch.equal(lc, model(gt)[0])
    gen = torch.Generator().manual_seed(0)
    u_c = torch.rand((g.ncons, 3), generator=gen)
    norm = u_c * 10 / u_c.norm(dim=1, keepdim=True)
    ll = torch.from_numpy(np.abs(g.c_feas[:, -3]) > 0)
    ul = torch.from_numpy(np.abs(g.c_feas[:, -1]) > 0)
    torch.testing.assert_close(lc[:, 0], norm[:, 0] - 10 * ll.float())
    torch.testing.assert_close(lc[:, 2], norm[:, 2] - 10 * ul.float())
    other = model(gt, generator=torch.Generator().manual_seed(1))[0]
    assert not torch.equal(other, lc)
    pred = inference_gnn(np.concatenate([lc.numpy(), lv.numpy()]), g.ncons)
    assert (pred == 1).sum() == g.ncons
    assert (pred[g.ncons:] == 1).sum() == ((pred[: g.ncons] == 0)
                                          | (pred[: g.ncons] == 2)).sum()


@pytest.mark.parametrize("arch", ZOO + ["GCNRand()",
                                        "GCN_FC(8,8,hids=16,depth=4)"])
def test_state_dict_round_trip(arch):
    """JAX params -> state_dict -> the port's model (strict: every key,
    every shape) -> its state_dict: the same tensors, and every JAX leaf
    carried exactly once (the sorted values of both sides agree)."""
    params = np_params(jax_build_model(arch).init(jax.random.PRNGKey(15)))
    sd = state_dict_from_jax_params(params)
    model = build_model(arch)
    model.load_state_dict(sd)
    back = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    leaves = jax.tree.leaves(params)
    assert sum(v.numel() for v in sd.values()) == sum(x.size for x in leaves)
    np.testing.assert_array_equal(
        np.sort(np.concatenate([v.numpy().ravel() for v in sd.values()])),
        np.sort(np.concatenate([np.ravel(x) for x in leaves])))


def test_jax_gendeeper_ckpt_loads(tmp_path):
    """A JAX mdl.ckpt of GENDeeper (params and an optax state) loads with
    load_checkpoint and gives the JAX logits (fp32, atol 1e-4)."""
    arch = "GENDeeper(8,8,hids=16,depth=4)"
    jm = jax_build_model(arch)
    params = jm.init(jax.random.PRNGKey(16))
    opt = jtrainer.make_optimizer("adam")
    path = str(tmp_path / "mdl.ckpt")
    jtrainer.save_ckpt(path, params, opt.init(params), epoch=3)
    model = build_model(arch)
    model.load_state_dict(load_checkpoint(path))
    g, jg = gen_graph(17)
    with torch.no_grad():
        got = np.concatenate(model.eval()(GraphTensors.from_graph(g, "cpu")))
    lc, lv = jm.apply(params, pad_graph(jg))
    want = np.concatenate([np.asarray(lc)[: g.ncons],
                           np.asarray(lv)[: g.nvars]])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_layer_norm_matches_jax():
    from lp_gnn_tpu.models.layers import layer_norm_apply
    rng = np.random.RandomState(18)
    x = (rng.randn(20, 12) * 3 + 1).astype(np.float32)
    ln = LayerNorm(12)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(rng.randn(12).astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(rng.randn(12).astype(np.float32)))
    p = {"g": ln.weight.detach().numpy(), "b": ln.bias.detach().numpy()}
    for dtype in ("float32", "bfloat16"):
        want = layer_norm_apply(p, jnp.asarray(x, jnp.dtype(dtype)))
        got = ln(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-5 if dtype == "float32" else 2 ** -7,
                                   atol=1e-5)


# ---------------------------------------------------------- graph tensors
@pytest.mark.parametrize("shuffled", [False, True], ids=["csr", "shuffled"])
def test_edge_perms_match_jax(shuffled):
    """eperm_r / eperm_c equal pad_graph's (batching.py:236-244) on the real
    edges, on a row-major graph (the fast path) and on shuffled edges; and
    they carry one ordering's edges onto the other's."""
    g, jg = gen_graph(19)
    if shuffled:
        p = np.random.RandomState(20).permutation(g.nnz)
        g = BipartiteGraph(row=g.row[p], col=g.col[p], val=g.val[p],
                           c_feas=g.c_feas, v_feas=g.v_feas, y_s=g.y_s,
                           y_t=g.y_t)
    gt = GraphTensors.from_graph(g, "cpu", perms=True)
    pg = pad_graph(jg)
    assert gt.eperm_r.dtype == torch.int32
    np.testing.assert_array_equal(gt.eperm_r.numpy(), pg.eperm_r[: g.nnz])
    np.testing.assert_array_equal(gt.eperm_c.numpy(), pg.eperm_c[: g.nnz])
    er, ec = gt.eperm_r.long(), gt.eperm_c.long()
    assert torch.equal(gt.col[ec], torch.repeat_interleave(
        torch.arange(g.nvars), (gt.colptr[1:] - gt.colptr[:-1]).long())
        .int())
    assert torch.equal(gt.row[er], torch.repeat_interleave(
        torch.arange(g.ncons), (gt.rowptr[1:] - gt.rowptr[:-1]).long())
        .int())
    assert torch.equal(gt.val_c[er], gt.val_r)
    assert GraphTensors.from_graph(g, "cpu").eperm_r is None


def count_calls(monkeypatch, module, name):
    calls = [0]
    real = getattr(module, name)

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch,spmm,perms", [
    ("GENDeeper(8,8,hids=16,depth=3)", 0, True),
    ("GCN_FC(8,8,hids=16,depth=3)", 2, False)], ids=["gen", "gcn_fc"])
def test_train_graph_follows_the_model(monkeypatch, arch, spmm, perms):
    """The trainer's graph tensors: the input aggregation cache (2 SpMM
    calls, run on the card as 2 launches) only for a model that reads it,
    the edge permutations only for one that needs them."""
    g, _ = gen_graph(21)
    calls = count_calls(monkeypatch, tspmm, "spmm_csr")
    gt = ttrainer.train_graph(build_model(arch), g, "cpu")
    assert calls[0] == spmm
    assert (gt.in_agg_c is not None) == (spmm > 0)
    assert (gt.eperm_r is not None) == perms and gt.y_s is not None


# ------------------------------------------------------------- training
def test_gen_without_perms_refuses_a_gradient():
    g, _ = gen_graph(22)
    model = build_model("GENDeeper(8,8,hids=16,depth=3)").train()
    with pytest.raises(ValueError, match="perms=True"):
        model(GraphTensors.from_graph(g, "cpu", labels=True))


def jax_gen_steps(arch, params, jg, n_steps, monkeypatch, lr=1e-3):
    """n_steps of the JAX trainer's step with dropout off (the res+ block's
    rate is fixed at 0.1, gcn.py:200: its dropout is patched out)."""
    monkeypatch.setattr(jgcn, "dropout", lambda x, rate, key, train: x)
    model = jax_build_model(arch)
    opt = jtrainer.make_optimizer("adam")
    step = jtrainer.make_train_step(model, "balanced", opt)
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    pg = pad_graph(jg)
    losses = []
    for i in range(n_steps):
        p, state, lv, _ = step(p, state, pg, jax.random.PRNGKey(i),
                               jnp.float32(lr))
        losses.append(float(lv))
    return np_params(p), losses


def port_steps(model, gt, n_steps, generator=None, lr=1e-3):
    optimizer = ttrainer.make_optimizer(model.parameters(), "adam", lr)
    return [float(ttrainer.train_step(model, optimizer, gt,
                                      tlosses.LOSS_REGISTRY["balanced"],
                                      generator)[0])
            for _ in range(n_steps)]


def test_gendeeper_adam_steps_match_jax(monkeypatch):
    """3 Adam steps of GENDeeper from the same params, fp32, dropout 0,
    against the JAX trainer: losses rtol 1e-5, params atol ADAM_ATOL."""
    arch = "GENDeeper(8,8,hids=16,depth=3)"
    g, jg = gen_graph(42)
    params = np_params(jax_build_model(arch).init(jax.random.PRNGKey(24)))
    want_params, want_losses = jax_gen_steps(arch, params, jg, 3, monkeypatch)
    model = build_model(arch)
    model.load_state_dict(state_dict_from_jax_params(params))
    model.dp = 0.0
    got = port_steps(model, ttrainer.train_graph(model, g, "cpu"), 3)
    np.testing.assert_allclose(got, want_losses, rtol=1e-5)
    want = state_dict_from_jax_params(want_params)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=ADAM_ATOL, err_msg=k)


@pytest.mark.parametrize("variant", ["plain", "remat"])
def test_gendeeper_remat_bit_identical(monkeypatch, variant):
    """Remat changes neither the losses nor the params, bit for bit, over 3
    steps with dropout on (the masks drawn outside the recomputed conv).
    Calls a step: 6 aggregation forwards (3 convs x 2 directions; 6 more,
    the recompute, with remat), 6 backwards and 6 gather backwards (the
    SpMM)."""
    arch = "GENDeeper(8,8,hids=16,depth=3)"
    g, _ = gen_graph(25)
    sd = build_model(arch, torch.Generator().manual_seed(2)).state_dict()

    def run(arch_):
        model = build_model(arch_)
        model.load_state_dict(sd)
        model.dp = 0.3
        losses = port_steps(model, ttrainer.train_graph(model, g, "cpu"), 3,
                            generator=torch.Generator().manual_seed(6))
        return losses, model.state_dict()

    want_losses, want_sd = run(arch)
    fwd = count_calls(monkeypatch, gen_agg, "gen_agg_fwd")
    bwd = count_calls(monkeypatch, gen_agg, "gen_agg_bwd")
    spmm = count_calls(monkeypatch, tspmm, "spmm_csr")
    remat = variant == "remat"
    got = run(arch[:-1] + ",remat=True)" if remat else arch)
    assert (fwd[0], bwd[0], spmm[0]) == (3 * (12 if remat else 6), 18, 18)
    assert got[0] == want_losses
    for k, v in got[1].items():
        assert torch.equal(v, want_sd[k]), k


def test_gcn_rand_trains_as_a_no_op():
    """GCNRand's loss depends on no parameter: a step runs, and its one
    parameter stays 0 (as the JAX trainer's zero gradient leaves it)."""
    g, _ = gen_graph(26)
    model = build_model("GCNRand()")
    losses = port_steps(model, ttrainer.train_graph(model, g, "cpu"), 2,
                        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(losses).all() and losses[0] != losses[1]
    assert float(model.get_parameter("_").detach()) == 0.0


def test_cli_trains_and_serves_gendeeper(tmp_path):
    """The zoo through the entry points on the CPU: GENDeeper trained by
    ``python -m lp_gnn_tpu_torch.train`` for 2 epochs, then its mdl.pth
    serving bases through ``pred_basis``."""
    prefix = str(tmp_path / "lp-dataset")
    write_processed(osp.join(prefix, "tiny", "highs-inp_tgt"), 4, seed=5)
    arch = "GENDeeper(8,8,hids=16,depth=3)"
    common = ["--dataset", "tiny", "--data_prefix", prefix, "--log_prefix",
              str(tmp_path / "runs"), "--arch", arch, "--device", "cpu"]
    path = train_main.main(common + ["--exp_nm", "gen", "--epochs", "2",
                                     "--eval_every", "2"])
    assert osp.exists(path)
    out_dir = pred_basis.main(common + ["--exp_nm", "serve", "--load_from",
                                        path, "--warm_gate", "off",
                                        "--split", "trainval"])
    assert len([f for f in os.listdir(out_dir) if f.endswith(".bas")]) == 4


def split_case(rng, case):
    """Segment lengths: mixed (empty, short and long segments) or one
    segment holding every edge between empty ones."""
    if case == "one_segment":
        return np.array([0, 0, 700, 0])
    counts = rng.randint(0, 12, 60)
    counts[[3, 20, 41]] = [150, 90, 260]
    counts[30:36] = 0
    return counts


def merge_path_cuts(ptr, grid):
    """The edges where a merge path over f(r) = r + ptr[r] cuts the work
    into ``grid`` equal shares of its num_dst + E units (as the kernels'
    ``stage_cta`` does): share c starts at unit d = c U / grid, in the
    last segment r with r + ptr[r] <= d, at edge d - r."""
    f = np.arange(len(ptr)) + ptr
    d = np.arange(1, grid) * int(f[-1]) // grid
    return d - (np.searchsorted(f, d, "right") - 1)


@pytest.mark.parametrize("cuts", ["merge_path", "random"])
@pytest.mark.parametrize("case", ["mixed", "one_segment"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_forward_matches_plain_and_jax(dtype, case, cuts):
    """gen_agg_fwd_split_plain, the kernel's forward over parts merged in
    order, against gen_agg_fwd_plain and the JAX _segment_softmax_agg on the
    same inputs, with parts cut by the kernels' partition (7 CTAs) or at
    random edges (inside segments too). fp32: rtol max(1e-4, 2^-24 L),
    atol 1e-5 (base-2 exps and the merges against one exp pass); bf16: the
    plain version and JAX round the message and its exps to bf16, the split
    version keeps fp32: rtol 2^-6, atol 2^-5."""
    rng = np.random.RandomState(len(case) + len(cuts))
    counts = split_case(rng, case)
    ptr = np.zeros(len(counts) + 1, np.int32)
    np.cumsum(counts, out=ptr[1:])
    n_e, s, d = int(ptr[-1]), 40, 16
    src = rng.randint(0, s, n_e).astype(np.int32)
    a = (rng.rand(n_e) - 0.5).astype(np.float32)
    x = rng.randn(s, d).astype(np.float32)
    w, b = rng.randn(d).astype(np.float32), (rng.randn(d) * 0.3).astype(np.float32)
    t = np.float32(1.5)
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(v) for v in (ptr, src, a)] + [
        torch.from_numpy(v).to(tdt) for v in (x, w, b, np.array(t))]
    if cuts == "merge_path":
        cut = merge_path_cuts(ptr, 7)
    else:
        cut = np.sort(rng.choice(n_e, 9, replace=False))
    got, got_lse = gen_agg.gen_agg_fwd_split_plain(*args, cut)
    want, want_lse = gen_agg.gen_agg_fwd_plain(*args)
    rtol, atol = ((max(1e-4, 2 ** -24 * counts.max()), 1e-5)
                  if dtype == "float32" else (2 ** -6, 2 ** -5))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    full = torch.from_numpy(counts > 0)
    torch.testing.assert_close(got_lse[full], want_lse[full], rtol=rtol,
                               atol=atol)
    assert not got[~full].any() and not got_lse[~full].any()
    jdt = getattr(jnp, dtype)
    xj, wj, bj = (jnp.asarray(v).astype(jdt) for v in (x, w, b))
    msg = jax.nn.relu(xj[src] + (jnp.asarray(a).astype(jdt)[:, None] * wj
                                 + bj)) + jnp.asarray(1e-7, jdt)
    seg = np.repeat(np.arange(len(counts)), counts)
    jx = _segment_softmax_agg(msg * jnp.asarray(t, jdt), msg, seg, len(counts),
                              np.ones(n_e, bool))
    torch.testing.assert_close(got, torch.from_numpy(np.array(jx, np.float32)),
                               rtol=rtol, atol=atol)
