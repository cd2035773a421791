"""The port's CSR SpMM (lp_gnn_tpu_torch/ops/spmm.py) and graph tensors
against the JAX package's SpMM (lp_gnn_tpu/ops/spmm.py), on the CPU.

On a CPU tensor the wrappers run their plain PyTorch versions; those are
what these tests hold against ``segment_spmm`` and the blocked MXU path on
``pad_graph``'s real rows. The kernels themselves are held against the
plain versions on the card by tests/test_torch_kernels.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
from lp_gnn_tpu.ops import spmm as jspmm
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.ops import spmm as tspmm
from tests.test_torch_kernels import port_graph

torch.set_num_threads(2)


def random_graph(rng, **kw):
    """``port_graph`` and the same graph as the JAX package's type."""
    g = port_graph(rng, **kw)
    return g, JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")})


def _jax_pg(jg, blocked):
    pg = pad_graph(jg)
    if not blocked:   # no block layout: the sorted segment_spmm path
        pg = dataclasses.replace(pg, blkr_src=None, blkc_src=None)
    return pg


@pytest.mark.parametrize("blocked", [False, True], ids=["segment", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32])
def test_spmm_matches_jax(blocked, dtype, d):
    rng = np.random.RandomState(d)
    g, jg = random_graph(rng)
    gt = GraphTensors.from_graph(g, "cpu")
    pg = _jax_pg(jg, blocked)
    x_c = rng.randn(g.ncons, d).astype(np.float32)
    x_v = rng.randn(g.nvars, d).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)

    def pad(x, rows):
        out = np.zeros((rows, d), np.float32)
        out[: x.shape[0]] = x
        return jnp.asarray(out, jdt)

    want_v = np.asarray(jspmm.spmm_cons_to_vars(pg, pad(x_c, pg.m_pad)),
                        np.float32)[: g.nvars]
    want_c = np.asarray(jspmm.spmm_vars_to_cons(pg, pad(x_v, pg.n_pad)),
                        np.float32)[: g.ncons]
    got_c, got_v = tspmm.bidir_spmm(gt, torch.from_numpy(x_c).to(tdt),
                                    torch.from_numpy(x_v).to(tdt))
    assert got_v.dtype == tdt and got_v.shape == (g.nvars, d)
    assert got_c.dtype == tdt and got_c.shape == (g.ncons, d)
    # the node with no edges aggregates to exactly zero
    assert not got_c[0].any() and not got_v[0].any()
    for got, want in ((got_v, want_v), (got_c, want_c)):
        got = got.float().numpy()
        if dtype == "float32":   # both sum in fp32, in another order
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            # the JAX path rounds each product x[src]*val to bf16 before its
            # fp32 sum (ops/spmm.py:108) and the port multiplies in fp32:
            # they differ by a few bf16 ulps of the terms
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["row_major", "shuffled"])
def test_graph_tensors_orderings_match_pad_graph(shuffled):
    """CSR / CSC hold pad_graph's two orderings (batching.py:231-234) on the
    real edges, and the pointers delimit each destination's edges, whether
    the edges come row-major (as LPDataset.get gives them) or not."""
    rng = np.random.RandomState(3)
    g, jg = random_graph(rng, e=400)   # duplicate (row, col) pairs too
    if shuffled:
        perm = rng.permutation(g.nnz)
        for gg in (g, jg):
            gg.row, gg.col, gg.val = gg.row[perm], gg.col[perm], gg.val[perm]
    gt = GraphTensors.from_graph(g, "cpu")
    pg = pad_graph(jg)
    e = g.nnz
    np.testing.assert_array_equal(gt.col.numpy(), pg.col_r[:e])
    np.testing.assert_array_equal(gt.val_r.numpy(), pg.val_r[:e])
    np.testing.assert_array_equal(gt.row.numpy(), pg.row_c[:e])
    np.testing.assert_array_equal(gt.val_c.numpy(), pg.val_c[:e])
    np.testing.assert_array_equal(
        np.repeat(np.arange(g.ncons), np.diff(gt.rowptr.numpy())), pg.row_r[:e])
    np.testing.assert_array_equal(
        np.repeat(np.arange(g.nvars), np.diff(gt.colptr.numpy())), pg.col_c[:e])
    assert gt.rowptr.dtype == gt.col.dtype == torch.int32
