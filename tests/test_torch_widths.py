"""Widths the SpMM takes, and the plan of K1's device form.

The JAX package's ``blocked_spmm`` (lp_gnn_tpu/ops/spmm.py:77) sums rows
of any width, and its models take any ``hids``. The port's ``spmm_csr``
does too (``ops/spmm.py width_plan``: one launch up to 256 16-byte pieces
a row, column slabs above, a ragged width through padded copies); here
on the CPU its plain version and whole models at ragged and wide widths are
held against the JAX package, and the width plan and the device form's
plan (``parallel/halo.py device_orders``, ``device_shares``) are checked
as pure Python. The kernels themselves are held against their plain
versions on the card by tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.ops import spmm as jspmm
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.ops import spmm as tspmm
from lp_gnn_tpu_torch.parallel import halo as thalo
from tests.test_torch_gcn_fc import BF16_VS_JAX_BF16
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)


# ------------------------------------------------------------- width plan
@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("width", [1, 3, 8, 100, 1024, 1028, 2048, 2056,
                                   4101, 4104, 9000])
def test_width_plan_covers_the_row_once(width, itemsize):
    """The slabs cover [0, padded) once, in order, each at most MAX_PIECES
    16-byte pieces and starting 16-byte (indeed 4096-byte) aligned; the
    padded width is the width rounded up to whole pieces, and only a
    ragged width is padded."""
    vec = 16 // itemsize
    plan = tspmm.width_plan(width, itemsize)
    assert plan.padded % vec == 0 and width <= plan.padded < width + vec
    assert plan.copies == (width % vec != 0)
    cols = [c for c0, n in plan.slabs for c in range(c0, c0 + n)]
    assert cols == list(range(plan.padded))
    for c0, n in plan.slabs:
        assert 0 < n <= tspmm.MAX_PIECES * vec and n % vec == 0
        assert (c0 * itemsize) % 16 == 0 and (c0 * itemsize) % 4096 == 0
    # the widths the paths use keep one launch and no copy
    if width in (8, 1024) or (itemsize == 2 and width == 2048):
        assert len(plan.slabs) == 1 and not plan.copies
    assert len(plan.slabs) == -(-plan.padded // (tspmm.MAX_PIECES * vec))


# -------------------------------------------------- SpMM and models vs JAX
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [3, 100, 1030])
def test_spmm_at_ragged_and_wide_widths_matches_jax(dtype, d):
    """Both directions at widths the kernel runs through padded copies or
    column slabs, against JAX's blocked path on ``pad_graph``'s real rows
    (the tolerances of tests/test_torch_spmm.py); the gradient in fp32
    (through SpmmCSR, the same sum over the transpose ordering) against
    JAX's VJP of the same direction."""
    rng = np.random.RandomState(d + 3)
    g, jg = random_graph(rng)
    gt = GraphTensors.from_graph(g, "cpu")
    pg = pad_graph(jg)
    x_v = rng.randn(g.nvars, d).astype(np.float32)
    w_c = rng.randn(g.ncons, d).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    xp = np.zeros((pg.n_pad, d), np.float32)
    xp[: g.nvars] = x_v
    want = np.asarray(jspmm.spmm_vars_to_cons(pg, jnp.asarray(xp, jdt)),
                      np.float32)[: g.ncons]
    x = torch.from_numpy(x_v).to(tdt).requires_grad_()
    got = tspmm.spmm_vars_to_cons(gt, x)
    assert got.dtype == tdt and got.shape == (g.ncons, d)
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0, atol=2e-2 * np.abs(want).max())
        return
    wp = np.zeros((pg.m_pad, d), np.float32)
    wp[: g.ncons] = w_c
    _, vjp = jax.vjp(lambda a: jspmm.spmm_vars_to_cons(pg, a), jnp.asarray(xp))
    want_dx = np.asarray(vjp(jnp.asarray(wp))[0])[: g.nvars]
    dx, = torch.autograd.grad(got, x, torch.from_numpy(w_c))
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)


def np_params(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,hids", [("bfloat16", 20), ("float32", 1030)])
@pytest.mark.parametrize("arch", ["GCN_FC(8,8,hids={h},depth=3)",
                                  "GCN(8,8,hids={h})"])
def test_models_at_ragged_and_wide_hids_match_jax(arch, dtype, hids):
    """GCN_FC and GCN at a hidden width of no whole number of bf16 pieces
    (20) and one above the kernel's one-launch width in fp32 (1030), the
    weights carried across, eval mode: fp32 within atol 1e-4, bf16 by the
    rule of tests/test_torch_gcn_fc.py (mean |diff| against JAX's bf16
    within 0.25, and within BF16_VS_JAX_BF16 times JAX's own bf16 distance
    from its fp32 logits)."""
    g, jg = random_graph(np.random.RandomState(hids), m=40, n=64, e=300)
    base = arch.format(h=hids)
    a = base[:-1] + f",dtype='{dtype}')"
    params = np_params(jax_build_model(a).init(jax.random.PRNGKey(hids)))
    model = build_model(a)
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.no_grad():
        got = np.concatenate(model.eval()(GraphTensors.from_graph(g, "cpu")))
    pg = pad_graph(jg)

    def jax_logits(arch_):
        lc, lv = jax_build_model(arch_).apply(
            jax.tree.map(jnp.asarray, params), pg, train=False)
        return np.concatenate([np.asarray(lc)[: g.ncons],
                               np.asarray(lv)[: g.nvars]])

    want = jax_logits(a)
    assert got.shape == (g.ncons + g.nvars, 3) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return
    exact = jax_logits(base)
    assert np.isfinite(got).all()
    assert np.abs(got - want).mean() <= 0.25
    assert (np.abs(got - exact).mean()
            <= BF16_VS_JAX_BF16 * np.abs(want - exact).mean())


# ------------------------------------------------- the device form's plan
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_device_orders_follow_the_tpu_kernels_offsets(k):
    """Each source's destinations: the TPU kernel's remote copies in its
    order (lp_gnn_tpu/parallel/pallas_halo.py:48-52: for s in 1..K-1, peer
    (me + s) mod K), then its own block last; every destination once, and
    at each offset the K sources send to K distinct peers (no card is the
    target of two sources at one offset)."""
    orders = thalo.device_orders(k)
    assert len(orders) == k
    for me, row in enumerate(orders):
        assert row == [(me + s) % k for s in range(1, k)] + [me]
        assert sorted(row) == list(range(k))
    for s in range(k - 1):
        assert sorted(row[s] for row in orders) == list(range(k))


@pytest.mark.parametrize("indices,streams,shares", [
    ([0, 0, 0, 0], None, [4, 4, 4, 4]),   # cuda:0 four times, a stream each
    ([0, 0, 0, 0], [7, 7, 7, 7], [1, 1, 1, 1]),   # one stream: in turn
    ([0, 0, 0, 0], [7, 8, 7, 8], [2, 2, 2, 2]),
    ([0, 1, 2, 3], None, [1, 1, 1, 1]),   # a card each: a whole wave each
    ([0, 0, 1, 1], None, [2, 2, 2, 2]),
    ([0, 1, 1], None, [1, 2, 2]),
    ([5], None, [1])])
def test_device_shares_follow_the_launches_on_a_card(indices, streams,
                                                     shares):
    """A launch's grid is one wave over the streams that launch at once on
    its card: a quarter wave each for four sources on one card with a
    stream each, a whole wave for a card of its own or a stream shared by
    the sources (their launches run one after another)."""
    assert thalo.device_shares(indices, streams) == shares


def test_device_form_on_the_cpu_makes_no_plan():
    """On CPU tensors the device form is its plain version: no launch, no
    C plan, no peer access."""
    rng = np.random.RandomState(0)
    bufs = [torch.from_numpy(rng.randn(3 * 5, 4).astype(np.float32))
            for _ in range(3)]
    before = (thalo.halo_all_to_all_devices.launches, len(thalo._DEVICE_PLANS),
              set(thalo.PEER_PAIRS))
    got = thalo.halo_all_to_all_devices(bufs)
    want = thalo.halo_all_to_all_plain(bufs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (thalo.halo_all_to_all_devices.launches, len(thalo._DEVICE_PLANS),
            set(thalo.PEER_PAIRS)) == before
