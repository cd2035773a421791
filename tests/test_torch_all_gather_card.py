"""The all-gather branch of the edge-partitioned path on the card: the
kernels at its new shapes (the SpMM over a shard's full-width CSRs,
``gen_agg_fwd`` / ``gen_agg_bwd`` over all ``n_pad`` variable rows,
``gen_lse_merge`` over K full-width parts) against their plain versions,
and one all-gather dist step (all shards on the card) against the same
step on the CPU. Each test needs an NVIDIA GPU (``cuda`` marker) and skips
without one.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card::

    python -m pytest --noconftest tests/test_torch_all_gather_card.py -q -m cuda

Tolerances: the SpMM fp32 rtol 1e-4 atol 1e-5, bf16 one bf16 ulp of the
fp32-summed plain result (tests/test_torch_kernels.py's); the GEN kernels
and the merge fp32 rtol 1e-4 atol 1e-5 (summation order, expf / logf); a
fp32 step's loss rtol 1e-5 and each tensor's update within UPDATE_RTOL of
its largest (the card's fp32 sums in another order than the CPU's).
"""
import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.ops import gen_agg
from lp_gnn_tpu_torch.ops import spmm as tspmm
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel.mesh import make_mesh
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced

torch.set_num_threads(2)

K = 4
UPDATE_RTOL = 1e-4


def port_graph(rng, m, n, e):
    """A random bipartite LP graph in the processed-blob value ranges,
    sorted by (row, col)."""
    row = rng.randint(0, m, e).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    val = (rng.rand(e) * 2 - 1).astype(np.float32)
    c_feas = (rng.rand(m, 8) - 0.5).astype(np.float32)
    v_feas = (rng.rand(n, 8) - 0.5).astype(np.float32)
    for fe in (c_feas, v_feas):   # bound tags in {-1, 0, 1}
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    order = np.lexsort((col, row))
    return BipartiteGraph(row=row[order], col=col[order], val=val[order],
                          c_feas=c_feas, v_feas=v_feas,
                          y_s=rng.randint(0, 3, m).astype(np.int32),
                          y_t=rng.randint(0, 3, n).astype(np.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def partition(gen=False, device="cuda"):
    g = port_graph(np.random.RandomState(5), m=900, n=1500, e=9000)
    return g, tEP.DistGraphTensors.from_partition(
        tEP.partition_graph(g, K), make_mesh(K, device), gen=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_on_full_width_csrs(cuda_device, dtype):
    """The SpMM over shard 0's full v2c (ms rows from all n_pad variables)
    and full c2v (all n_pad rows from its ms constraints), one launch each,
    against the plain version."""
    _, dgt = partition()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    for m, n_src in ((dgt.full_v2c[0], dgt.n_pad), (dgt.full_c2v[0], dgt.ms)):
        x = torch.randn(n_src, 64, device=cuda_device).to(dtype)
        before = tspmm.spmm_csr.launches
        out = tspmm.spmm_csr(*m, x)
        torch.cuda.synchronize()
        assert tspmm.spmm_csr.launches == before + 1
        torch.testing.assert_close(out.float(),
                                   tspmm.spmm_csr_plain(*m, x).float(),
                                   rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_gen_kernels_over_all_variable_rows(cuda_device):
    """gen_agg_fwd and gen_agg_bwd over shard 0's l2r CSR of all n_pad
    variable rows, and gen_lse_merge of the K shards' parts of every row
    (every part in ``parts``, no local part), fp32, against their plain
    versions."""
    _, dgt = partition(gen=True)
    gen, d = dgt.gen, 32
    x = torch.randn(dgt.ms, d, device=cuda_device)
    w = torch.randn(d, device=cuda_device)
    b = torch.randn(d, device=cuda_device)
    t = torch.tensor(1.1, device=cuda_device)
    parts = torch.empty(K, dgt.n_pad, 2 * d, device=cuda_device)
    for s in range(K):
        xs = torch.randn(dgt.ms, d, device=cuda_device) if s else x
        aggr, lse = gen_agg.gen_agg_fwd(*gen.l2r[s], xs, w, b, t)
        ra, rl = gen_agg.gen_agg_fwd_plain(*gen.l2r[s], xs, w, b, t)
        torch.testing.assert_close(aggr, ra, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-5)
        parts[s, :, :d], parts[s, :, d:] = aggr, lse
    g = torch.randn(dgt.n_pad, d, device=cuda_device)
    aggr, lse = parts[0, :, :d].contiguous(), parts[0, :, d:].contiguous()
    got = gen_agg.gen_agg_bwd(*gen.l2r[0], x, w, b, t, g, aggr, lse)
    want = gen_agg.gen_agg_bwd_plain(*gen.l2r[0], x, w, b, t, g, aggr, lse)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-5)
    flat = parts.view(-1, 2 * d)
    unread = flat.new_empty((dgt.n_pad, d))
    args = (gen.local_edges, unread, unread, gen.merge_ptr, gen.merge_idx,
            flat)
    before = gen_agg.gen_lse_merge.launches
    merged = gen_agg.gen_lse_merge(*args)
    torch.cuda.synchronize()
    assert gen_agg.gen_lse_merge.launches == before + 1
    for u, v in zip(merged, gen_agg.gen_lse_merge_plain(*args)):
        torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["GCN_FC(8,8,hids=64,depth=3,dp=0.0)",
                                  "GENDeeper(8,8,hids=32,depth=3)"])
def test_all_gather_step_on_card_matches_cpu(cuda_device, arch):
    """One fp32 all-gather dist step (SGD at lr 1, dropout 0, K=4 on the
    card) against the same step on the CPU; no K1 and no gather launched."""
    g = port_graph(np.random.RandomState(6), m=900, n=1500, e=9000)
    w0 = build_model(arch, generator=torch.Generator().manual_seed(0)
                     ).state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(arch)
        model.load_state_dict(w0)
        model.dp = 0.0
        model.to(dev)
        opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
        dgt = tEP.dist_tensors(model, tEP.partition_graph(g, K),
                               make_mesh(K, dev), input_agg=True)
        exchange = (tEP.halo_all_to_all.launches, tEP.gather_rows.launches)
        loss = tEP.dist_train_step(model, opt, dgt, balanced)
        assert (tEP.halo_all_to_all.launches,
                tEP.gather_rows.launches) == exchange
        out[dev] = (float(loss), {n: v.cpu() for n, v in
                                  model.state_dict().items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    worst = 0.0
    for name, v in w0.items():
        ua = v.double() - out["cuda"][1][name].double()
        ub = v.double() - out["cpu"][1][name].double()
        worst = max(worst, float((ua - ub).abs().max()
                                 / ub.abs().max().clamp(min=1e-30)))
    assert worst < UPDATE_RTOL
