"""The port's GCN_FC (lp_gnn_tpu_torch/models) against the JAX package's
``make_gcn_fc`` with the same weights, carried across by
``state_dict_from_jax_params``, on the CPU."""
import numpy as np
import pytest
import torch

import jax

from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.models.torch_import import gcn_fc_params_from_state_dict
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import GCN_FC, build_model
from lp_gnn_tpu_torch.models.gen import BidirGENConv
from lp_gnn_tpu_torch.parallel import edge_partition
from lp_gnn_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_import import fabricate_state_dict
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

ARCH = "GCN_FC(8,8,hids=32,depth=3)"


def jax_params(arch=ARCH, seed=0):
    """JAX GCN_FC params as numpy leaves."""
    model = jax_build_model(arch)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


def port_logits(arch, sd, g):
    model = build_model(arch)
    model.load_state_dict(sd)   # strict: every key of the reference layout
    model.eval()
    with torch.no_grad():
        lc, lv = model(GraphTensors.from_graph(g, "cpu"))
    return lc.numpy(), lv.numpy()


def jax_logits(arch, params, jg):
    lc, lv = jax_build_model(arch).apply(params, pad_graph(jg), train=False)
    return np.asarray(lc)[: jg.ncons], np.asarray(lv)[: jg.nvars]


# fp32: the same sums in another order, on logits scaled to norm 10; held
# row by row.
# bf16: the JAX SpMM rounds each product to bf16 before summing
# (ops/spmm.py:108) where the port multiplies in fp32, and XLA fuses the
# elementwise passes after each bf16 matmul in fp32 where eager PyTorch
# rounds after each op. Over three layers that is a few percent of a logit
# row before its scaling to norm 10; a row whose logits nearly cancel before
# that scaling swings further (single rows reach ~0.9 on some seeds, for
# JAX's bf16 as for the port's), so no per-row bound holds across seeds.
# What does hold: the mean |diff| against JAX's bf16 stays within atol
# (0.01-0.03 over seeds 0-11), and the port's bf16 lies within 3x the
# distance of JAX's own bf16 from the fp32 logits (1.5x-2.2x over seeds
# 0-11: the port rounds more often, not worse).
BF16_VS_JAX_BF16 = 3.0


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 0.25)])
def test_logits_match_jax(dtype, atol):
    g, jg = random_graph(np.random.RandomState(11), m=40, n=64, e=300)
    arch = ARCH[:-1] + f",dtype='{dtype}')"
    params = jax_params(arch)
    sd = state_dict_from_jax_params(params)
    got_c, got_v = port_logits(arch, sd, g)
    want_c, want_v = jax_logits(arch, params, jg)
    assert got_c.dtype == np.float32 and got_c.shape == (g.ncons, 3)
    assert got_v.shape == (g.nvars, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got_c, want_c, rtol=0, atol=atol)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=atol)
        return
    got = np.concatenate([got_c, got_v])
    want = np.concatenate([want_c, want_v])
    assert np.isfinite(got).all()
    assert np.abs(got - want).mean() <= atol
    exact = np.concatenate(jax_logits(ARCH, params, jg))   # JAX fp32
    assert (np.abs(got - exact).mean()
            <= BF16_VS_JAX_BF16 * np.abs(want - exact).mean())


def test_state_dict_round_trip_is_exact():
    """state_dict_from_jax_params is the exact inverse of
    lp_gnn_tpu/models/torch_import.py:56."""
    params = jax_params("GCN_FC(8,8,hids=16,depth=4)", seed=3)
    back = gcn_fc_params_from_state_dict(state_dict_from_jax_params(params))
    want, want_def = jax.tree.flatten(params)
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("zipfile", [True, False], ids=["zip", "legacy"])
def test_reference_mdl_pth_loads(tmp_path, zipfile):
    """A reference ``mdl.pth`` state_dict (either torch.save format) loads
    as it is and gives the logits of the JAX model on the same weights."""
    sd = fabricate_state_dict(np.random.RandomState(2), hids=16)
    path = str(tmp_path / "mdl.pth")
    torch.save(sd, path, _use_new_zipfile_serialization=zipfile)
    loaded = load_checkpoint(path)
    assert list(loaded) == list(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k])
    g, jg = random_graph(np.random.RandomState(12))
    arch = "GCN_FC(8,8,hids=16,depth=3)"
    got_c, got_v = port_logits(arch, loaded, g)
    want_c, want_v = jax_logits(arch, gcn_fc_params_from_state_dict(sd), jg)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-4)


def test_init_is_seeded_and_torch_linear_shaped():
    a = GCN_FC(hids=64, generator=torch.Generator().manual_seed(5))
    b = GCN_FC(hids=64, generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.layers[0].left2right.lin_rel.weight.detach()
    assert w.shape == (64, 64)
    bound = 1 / np.sqrt(64)
    assert float(w.abs().max()) <= bound
    # U(-b, b): mean 0, std b/sqrt(3), over 4096 draws
    assert abs(float(w.mean())) < 0.05 * bound
    assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.05 * bound


def test_build_model_parses_safely():
    m = build_model("GCN_FC(8,8,hids=16,depth=5,dtype='bfloat16')")
    assert len(m.layers) == 3 and m.cdtype == torch.bfloat16
    m = build_model("GENDeeper(8,8,hids=16,depth=3)")
    assert isinstance(m.conv_in, BidirGENConv) and len(m.blocks) == 1
    assert m.needs_edge_perms and not m.reads_input_agg
    with pytest.raises(ValueError, match="unknown arch"):
        build_model("MLP(8)")
    with pytest.raises(ValueError):
        build_model("GCN_FC(__import__('os').getpid())")
    with pytest.raises(TypeError):
        build_model("GCN_FC(8,8,hidden=16)")


@pytest.mark.parametrize("arch", ["GENDeeper(8,8,hids=16,depth=3)",
                                  "GCN(8,8,hids=16)",
                                  "GCNDeeper(8,8,hids=16,depth=3)",
                                  "GCNRand()"])
def test_dist_apply_refuses_the_rest_of_the_zoo(arch):
    """Every arch builds and has an edge-partitioned forward (the name dates
    from when only GCN_FC had one and the others raised): its dist logits
    equal the single-card ones in fp32 (atol 5e-4, JAX's own dist
    tolerance, tests/test_parallel.py:43); GCNRand's are random, finite and
    of the shape."""
    g, _ = random_graph(np.random.RandomState(13))
    dg = edge_partition.partition_graph(g, 2, halo=True)
    model = build_model(arch, generator=torch.Generator().manual_seed(13))
    model.eval()
    with torch.no_grad():
        lc, lv = edge_partition.dist_apply(model, dg, make_mesh(2, "cpu"))
        sc, sv = model(GraphTensors.from_graph(g, "cpu"))
    got = torch.cat([lc[:g.ncons], lv[:g.nvars]])
    assert got.shape == (g.ncons + g.nvars, 3) and torch.isfinite(got).all()
    if arch != "GCNRand()":
        np.testing.assert_allclose(got.numpy(), torch.cat([sc, sv]).numpy(),
                                   rtol=0, atol=5e-4)
