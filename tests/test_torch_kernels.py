"""The port's kernel wrappers (lp_gnn_tpu_torch/ops, parallel/halo.py) and
edge mesh: argument checks and plain versions on the CPU, and, on a machine
with an NVIDIA GPU, each CUDA kernel against its plain version (``cuda``
marker; skipped without a card).

This file imports neither JAX nor the JAX package, so it runs where they
are not installed, such as the machine with the card::

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda
"""
import ctypes
import inspect
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.ops import _build
from lp_gnn_tpu_torch.ops import gen_agg
from lp_gnn_tpu_torch.ops import spmm as tspmm
from lp_gnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from lp_gnn_tpu_torch.parallel import dist_gen
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel.edge_partition import (compose_halo_src,
                                                      halo_gather,
                                                      halo_schedule,
                                                      pick_halo_schedule)
from lp_gnn_tpu_torch.parallel import halo as thalo
from lp_gnn_tpu_torch.parallel.halo import (HaloAllToAll, halo_all_to_all,
                                            halo_all_to_all_plain)
from lp_gnn_tpu_torch.parallel.mesh import EdgeMesh, make_mesh

torch.set_num_threads(2)


def port_graph(rng, m=23, n=37, e=150, empty_row=True, empty_col=True):
    """A random bipartite LP graph in the processed-blob value ranges, with
    constraint 0 and variable 0 left without edges when asked."""
    row = rng.randint(1 if empty_row else 0, m, e).astype(np.int32)
    col = rng.randint(1 if empty_col else 0, n, e).astype(np.int32)
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


def test_graph_tensors_reject_bad_indices():
    g = port_graph(np.random.RandomState(4))
    g.col = g.col.copy()
    g.col[-1] = g.nvars
    with pytest.raises(ValueError, match="outside the node range"):
        GraphTensors.from_graph(g, "cpu")


def test_spmm_wrapper_checks():
    g = port_graph(np.random.RandomState(5))
    gt = GraphTensors.from_graph(g, "cpu")
    x = torch.randn(g.nvars, 8)
    before = tspmm.spmm_csr.launches
    tspmm.spmm_vars_to_cons(gt, x)
    assert tspmm.spmm_csr.launches == before   # plain version: no launch
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tspmm.spmm_vars_to_cons(gt, x.double())
    with pytest.raises(TypeError, match="int32"):
        tspmm.spmm_csr(gt.rowptr.long(), gt.col, gt.val_r, x)
    with pytest.raises(ValueError, match="contiguous"):
        tspmm.spmm_csr(gt.rowptr, gt.col, gt.val_r,
                       torch.randn(8, g.nvars).t())
    # a gradient flows through the plain version on the CPU: the plain
    # SpMM over the transpose ordering, with no launch
    xg = x.clone().requires_grad_()
    w = torch.randn(g.ncons, 8)
    (tspmm.spmm_vars_to_cons(gt, xg) * w).sum().backward()
    assert torch.equal(xg.grad, tspmm.spmm_csr_plain(gt.colptr, gt.row,
                                                     gt.val_c, w))
    assert tspmm.spmm_csr.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_plain(dtype):
    rng = np.random.RandomState(6)
    table = torch.from_numpy(rng.randn(50, 16).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.randint(0, 50, 200).astype(np.int32))
    before = gather_rows.launches
    out = gather_rows(table, idx)
    assert gather_rows.launches == before
    np.testing.assert_array_equal(out.float().numpy(),
                                  table.float().numpy()[idx.numpy()])
    with pytest.raises(TypeError, match="int32"):
        gather_rows(table, idx.long())


def shuffled_ranges(rng, k, max_rows=300):
    """(n, 2) int32 ranges (first, rows) that cover k rows once, shuffled:
    some longer than any chunk a warp takes at once."""
    cuts = np.unique(np.concatenate([[0, k], rng.randint(0, k, k // 40 + 1)]))
    cuts = np.unique(np.concatenate([cuts, np.arange(0, k, max_rows)]))
    r = np.stack([cuts[:-1], np.diff(cuts)], 1).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(r[rng.permutation(len(r))]))


def test_gather_rows_out_and_schedule():
    """out= writes into a given (K, D) tensor, here a view at a row offset
    of a larger one; a schedule changes the order of the work only."""
    rng = np.random.RandomState(8)
    table = torch.from_numpy(rng.randn(40, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 40, 60).astype(np.int32))
    buf = torch.zeros(64, 8)
    got = gather_rows(table, idx, out=buf[2:62],
                      schedule=shuffled_ranges(rng, 60))
    assert got.data_ptr() == buf[2:62].data_ptr()
    assert torch.equal(buf[2:62], table[idx.long()])
    assert not buf[:2].any() and not buf[62:].any()


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguous", "device",
                                 "schedule"])
def test_gather_rows_refuses_out(bad):
    table = torch.randn(10, 8)
    idx = torch.arange(6, dtype=torch.int32)
    out, schedule = torch.empty(6, 8), None
    if bad == "shape":
        out = torch.empty(6, 4)
    elif bad == "dtype":
        out = torch.empty(6, 8, dtype=torch.bfloat16)
    elif bad == "contiguous":
        out = torch.empty(8, 6).t()
    elif bad == "device":
        out = torch.empty(6, 8, device="meta")
    else:
        schedule = torch.tensor([0, 6], dtype=torch.int32)   # not (n, 2)
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err, match=bad if bad == "schedule" else "out="):
        gather_rows(table, idx, out=out, schedule=schedule)


def test_big_sample_reference_is_order_free():
    """chip_smoke.py's big phase holds the SpMM on sampled rows of about
    1000 edges. The plain version's fp32 sums depend on the order the
    edges are added in (on the card index_add_'s atomics take a new order
    each call), and in bf16 two orders land apart; the check's reference
    (``exact_rows``) sums in fp64, which no order moves."""
    import chip_smoke
    g = torch.Generator().manual_seed(5)
    n_rows, deg, d, n_src = 64, 1000, 32, 5000
    ptr = torch.arange(0, (n_rows + 1) * deg, deg, dtype=torch.int32)
    idx = torch.randint(0, n_src, (n_rows * deg,), generator=g,
                        dtype=torch.int32)
    val = torch.randn(n_rows * deg, generator=g)
    x = torch.randn(n_src, d, generator=g).to(torch.bfloat16)
    perm = torch.cat([torch.randperm(deg, generator=g) + r * deg
                      for r in range(n_rows)])
    assert not torch.equal(tspmm.spmm_csr_plain(ptr, idx, val, x),
                           tspmm.spmm_csr_plain(ptr, idx[perm], val[perm], x))
    want = chip_smoke.exact_rows(ptr, idx, val, x)
    assert want.dtype == torch.bfloat16
    assert torch.equal(want, chip_smoke.exact_rows(ptr, idx[perm],
                                                   val[perm], x))


def test_spmm_csr_out():
    g = port_graph(np.random.RandomState(9))
    gt = GraphTensors.from_graph(g, "cpu")
    x = torch.randn(g.nvars, 8)
    buf = torch.zeros(2, g.ncons, 8)
    got = tspmm.spmm_csr(gt.rowptr, gt.col, gt.val_r, x, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr() and not buf[0].any()
    assert torch.equal(buf[1], tspmm.spmm_csr_plain(gt.rowptr, gt.col,
                                                    gt.val_r, x))
    for out, err in ((torch.empty(g.ncons, 4), ValueError),
                     (torch.empty(g.ncons, 8, dtype=torch.bfloat16), TypeError),
                     (torch.empty(8, g.ncons).t(), ValueError)):
        with pytest.raises(err, match="out="):
            tspmm.spmm_csr(gt.rowptr, gt.col, gt.val_r, x, out=out)


def gen_inputs(rng, counts, n_src, d, dtype, device="cpu"):
    """One GEN direction's kernel inputs: rows of ``counts`` edges from
    ``n_src`` sources, x (n_src, d), the encoder w, b and t in ``dtype``,
    and the transpose ordering (t_ptr over the sources, eperm the position
    of each of its edges in the row ordering)."""
    ptr, src, a = csr_from_counts(rng, counts, n_src, False)
    t_ptr = np.zeros(n_src + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=n_src), out=t_ptr[1:])
    eperm = np.argsort(src, kind="stable").astype(np.int32)
    gen = torch.Generator().manual_seed(len(counts) + d)
    x = torch.randn(n_src, d, generator=gen)
    w, b = torch.randn(d, generator=gen), torch.randn(d, generator=gen) * 0.3
    t = torch.tensor(1.5)
    dev = [torch.from_numpy(v).to(device) for v in (ptr, src, a)]
    dense = [v.to(dtype).to(device) for v in (x, w, b, t)]
    return dev + dense, [torch.from_numpy(v).to(device) for v in (t_ptr, eperm)]


def test_gen_agg_wrapper_checks():
    """On the CPU both wrappers run their plain versions (no launch); they
    refuse what the kernels do not take, and a direct call in grad mode."""
    rng = np.random.RandomState(30)
    args, _ = gen_inputs(rng, np.array([3, 0, 5, 1]), 6, 3, torch.float32)
    before = (gen_agg.gen_agg_fwd.launches, gen_agg.gen_agg_bwd.launches)
    aggr, lse = gen_agg.gen_agg_fwd(*args)
    assert aggr.shape == (4, 3) and aggr.dtype == torch.float32
    assert not aggr[1].any()   # the empty segment
    dpre, dw, db, dt = gen_agg.gen_agg_bwd(*args, torch.ones(4, 3), aggr, lse)
    assert dpre.shape == (9, 4) and not dpre[:, 3].any()   # 16-byte rows
    assert dw.shape == db.shape == (3,) and dt.shape == ()
    assert (gen_agg.gen_agg_fwd.launches,
            gen_agg.gen_agg_bwd.launches) == before
    ptr, src, a, x, w, b, t = args
    with pytest.raises(TypeError, match="int32"):
        gen_agg.gen_agg_fwd(ptr.long(), src, a, x, w, b, t)
    with pytest.raises(TypeError, match="x's dtype"):
        gen_agg.gen_agg_fwd(ptr, src, a, x, w.double(), b, t)
    with pytest.raises(ValueError, match="0-d"):
        gen_agg.gen_agg_fwd(ptr, src, a, x, w, b, t.reshape(1))
    with pytest.raises(ValueError, match="contiguous"):
        gen_agg.gen_agg_fwd(ptr, src, a, torch.randn(3, 6).t(), w, b, t)
    with pytest.raises(NotImplementedError, match="GenSoftmaxAgg"):
        gen_agg.gen_agg_fwd(ptr, src, a, x.clone().requires_grad_(), w, b, t)
    with pytest.raises(ValueError, match="g must be"):
        gen_agg.gen_agg_bwd(*args, torch.ones(4, 2), aggr, lse)


def test_lib_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited csrc/ header that a source includes names a new library,
    so a stale build is never reused."""
    (tmp_path / "k.cu").write_text('#include "row.cuh"\n#include <stdint.h>\n')
    (tmp_path / "row.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    (tmp_path / "row.cuh").write_text("// two\n")
    assert _build.lib_path("k") != first


def stacked_halo(k, bh, d, dtype, device="cpu", seed=0):
    """K halo buffers (K*bh, d) as views of one (K, K*bh, d) tensor."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(k, k * bh, d, generator=gen).to(dtype).to(device)
    return x, list(x.unbind(0))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_halo_all_to_all_plain(k):
    """Shard p's block q lands in shard q's block p: the stacked buffers
    with their first two block axes swapped."""
    x, bufs = stacked_halo(k, 5, 6, torch.float32)
    before = halo_all_to_all.launches
    out = halo_all_to_all(bufs)
    assert halo_all_to_all.launches == before   # plain version: no launch
    want = x.view(k, k, 5, 6).transpose(0, 1).reshape(k, k * 5, 6)
    assert torch.equal(torch.stack(out), want)
    assert torch.equal(torch.stack(halo_all_to_all_plain(bufs)), want)


def test_halo_all_to_all_checks():
    _, bufs = stacked_halo(2, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="one buffer per shard"):
        halo_all_to_all([])
    with pytest.raises(ValueError, match="share one shape"):
        halo_all_to_all([bufs[0], bufs[1][:6]])
    with pytest.raises(ValueError, match="equal blocks"):
        halo_all_to_all([b[:7] for b in bufs])
    with pytest.raises(ValueError, match="2-D"):
        halo_all_to_all([b.reshape(-1) for b in bufs])
    with pytest.raises(TypeError, match="fp32 or all bf16"):
        halo_all_to_all([b.double() for b in bufs])
    with pytest.raises(TypeError, match="fp32 or all bf16"):
        halo_all_to_all([bufs[0], bufs[1].bfloat16()])
    with pytest.raises(ValueError, match="contiguous"):
        halo_all_to_all([torch.randn(8, 8).t() for _ in range(2)])
    with pytest.raises(NotImplementedError, match="forward-only"):
        halo_all_to_all([b.clone().requires_grad_() for b in bufs])
    # buffers on distinct devices take the device form, which refuses a
    # device neither cuda nor cpu
    with pytest.raises(ValueError, match="halo_all_to_all_devices runs on"):
        halo_all_to_all([bufs[0], torch.empty(8, 8, device="meta")])
    with pytest.raises(ValueError, match="cuda or cpu"):
        halo_all_to_all([torch.empty(8, 8, device="meta")] * 2)


def test_halo_all_to_all_stacked_checks():
    x, _ = stacked_halo(2, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="one \\(K, K\\*Bh, F\\) tensor"):
        halo_all_to_all(x[0])
    with pytest.raises(ValueError, match="equal blocks"):
        halo_all_to_all(x[:, :7])
    with pytest.raises(TypeError, match="fp32 or all bf16"):
        halo_all_to_all(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        halo_all_to_all(x.transpose(1, 2))
    with pytest.raises(NotImplementedError, match="forward-only"):
        halo_all_to_all(x.clone().requires_grad_())
    with pytest.raises(ValueError, match="cuda or cpu"):
        halo_all_to_all(torch.empty(2, 8, 8, device="meta"))
    before = halo_all_to_all.launches
    assert torch.equal(halo_all_to_all(x), torch.stack(halo_all_to_all_plain(
        list(x.unbind(0)))))
    assert halo_all_to_all.launches == before   # plain version: no launch


def test_edge_mesh_one_device_only():
    """The stacked layout holds its K shards on one device; shards on
    distinct devices take the layout with one shard a device (its threads,
    from make_mesh over a device list), never the stacked one."""
    mesh = make_mesh(4, "cpu")
    assert mesh.n_shards == 4 and mesh.device == torch.device("cpu")
    assert not mesh.per_device and mesh.threads is None
    with pytest.raises(ValueError, match="without their threads"):
        EdgeMesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    devs = make_mesh(2, [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert devs.per_device and devs.device == torch.device("cuda", 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 64, 1024])
def test_kernels_match_plain_on_card(cuda_device, dtype, d):
    """Each kernel against its plain version on the card, at the path's
    widths (8, 1024) and at two others (24 leaves lanes of a group idle)
    (fp32 rtol 1e-4 atol 1e-5: summation order; bf16 one bf16 ulp of the
    fp32-summed plain result)."""
    g = port_graph(np.random.RandomState(d), m=300, n=500, e=4000)
    gt = GraphTensors.from_graph(g, cuda_device)
    x = torch.randn(g.nvars, d, device=cuda_device).to(dtype)
    before = tspmm.spmm_csr.launches
    out = tspmm.spmm_csr(gt.rowptr, gt.col, gt.val_r, x)
    ref = tspmm.spmm_csr_plain(gt.rowptr, gt.col, gt.val_r, x)
    torch.cuda.synchronize()
    assert tspmm.spmm_csr.launches == before + 1
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    got = gather_rows(x, gt.col)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_plain(x, gt.col))


WIDTHS = [(torch.float32, 3), (torch.float32, 6), (torch.bfloat16, 12),
          (torch.bfloat16, 100), (torch.float32, 1028),
          (torch.bfloat16, 2056), (torch.bfloat16, 4104),
          (torch.float32, 4101)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", WIDTHS)
def test_spmm_kernel_rejects_widths_it_does_not_take(cuda_device, dtype, d):
    """The kernel once refused these widths (a ragged D, or one above 256
    16-byte pieces) where JAX's blocked_spmm computes them; now it takes
    every width and refuses only what no route takes (a dtype other than
    fp32 / bf16, a non-contiguous x). At each width: the kernel against its
    plain version (the tolerances of test_kernels_match_plain_on_card), one
    launch a 256-piece column slab (ops/spmm.py width_plan), bit-identical
    over two calls, ``out=`` honoured; an x at a storage offset that breaks
    16-byte alignment is copied, not refused, and gives the same bits."""
    g = port_graph(np.random.RandomState(7), m=300, n=500, e=4000)
    gt = GraphTensors.from_graph(g, cuda_device)
    args = (gt.rowptr, gt.col, gt.val_r)
    x = torch.randn(g.nvars, d, device=cuda_device).to(dtype)
    plan = tspmm.width_plan(d, x.element_size())
    before = tspmm.spmm_csr.launches
    out = tspmm.spmm_csr(*args, x)
    assert tspmm.spmm_csr.launches == before + len(plan.slabs)
    ref = tspmm.spmm_csr_plain(*args, x)
    into = torch.full_like(out, float("nan"))
    assert tspmm.spmm_csr(*args, x, out=into) is into
    flat = torch.empty(x.numel() + 8, device=cuda_device, dtype=dtype)
    x_off = flat[1:1 + x.numel()].view(x.shape)
    x_off.copy_(x)
    odd = tspmm.spmm_csr(*args, x_off)
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for again in (into, odd):
        assert torch.equal(again.view(bits), out.view(bits))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tspmm.spmm_csr(*args, x.half())
    with pytest.raises(ValueError, match="contiguous"):
        tspmm.spmm_csr(*args, torch.empty(d, g.nvars, device=cuda_device,
                                          dtype=dtype).t())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 3),
                                     (torch.bfloat16, 100),
                                     (torch.bfloat16, 4104)])
def test_spmm_backward_at_any_width_on_card(cuda_device, dtype, d):
    """SpmmCSR's backward at a ragged and a wide width: the kernel over the
    transpose ordering (a launch a slab) against the fp32 gradient of the
    plain version rounded once, as test_spmm_backward_matches_plain_on_card
    holds it at the paths' widths."""
    g = port_graph(np.random.RandomState(d + 2), m=300, n=500, e=4000)
    gt = GraphTensors.from_graph(g, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn(g.nvars, d, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(g.ncons, d, generator=gen, device=cuda_device).to(dtype)
    x.requires_grad_()
    out = tspmm.spmm_vars_to_cons(gt, x)
    before = tspmm.spmm_csr.launches
    got, = torch.autograd.grad(out, x, w)
    assert tspmm.spmm_csr.launches == before + len(
        tspmm.width_plan(d, x.element_size()).slabs)
    xp = x.detach().float().requires_grad_()
    want, = torch.autograd.grad(tspmm.spmm_csr_plain(
        gt.rowptr, gt.col, gt.val_r, xp), xp, w.float())
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 1024])
def test_spmm_backward_matches_plain_on_card(cuda_device, dtype, d):
    """The gradient through SpmmCSR in both directions: one launch of the
    kernel over the transpose ordering per backward, within the forward's
    tolerance of the gradient through the plain version taken in fp32 and
    rounded to x's dtype once (in bf16, autograd through the plain version
    would scatter bf16 messages with a bf16 index_add_, summing in bf16;
    the kernel, like the JAX VJP, sums in fp32), bit-identical over two
    backward passes; a gradient at a misaligned offset is copied, not
    refused."""
    g = port_graph(np.random.RandomState(d + 1), m=300, n=500, e=4000)
    gt = GraphTensors.from_graph(g, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    for fwd, n_src, n_dst, plain in (
            (tspmm.spmm_vars_to_cons, g.nvars, g.ncons,
             (gt.rowptr, gt.col, gt.val_r)),
            (tspmm.spmm_cons_to_vars, g.ncons, g.nvars,
             (gt.colptr, gt.row, gt.val_c))):
        x = torch.randn(n_src, d, generator=gen, device=cuda_device).to(dtype)
        w = torch.randn(n_dst, d, generator=gen, device=cuda_device).to(dtype)
        x.requires_grad_()
        out = fwd(gt, x)
        before = tspmm.spmm_csr.launches
        got, = torch.autograd.grad(out, x, w, retain_graph=True)
        again, = torch.autograd.grad(out, x, w)
        assert tspmm.spmm_csr.launches == before + 2
        xp = x.detach().float().requires_grad_()
        want, = torch.autograd.grad(tspmm.spmm_csr_plain(*plain, xp), xp,
                                    w.float())
        want = want.to(dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(got.view(bits), again.view(bits))
        flat = torch.empty(n_dst * d + 1, device=cuda_device, dtype=dtype)
        w_off = flat[1:].view(n_dst, d)
        w_off.copy_(w)
        xo = x.detach().clone().requires_grad_()
        odd, = torch.autograd.grad(fwd(gt, xo), xo, w_off)
        assert torch.equal(odd, got)


def csr_from_counts(rng, counts, n_src, positive):
    """ptr, idx, val (int32, int32, fp32 numpy) of rows with ``counts``
    edges from ``n_src`` sources; ``positive`` keeps every val in [0.5, 1)."""
    ptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    idx = rng.randint(0, n_src, int(ptr[-1])).astype(np.int32)
    val = rng.rand(int(ptr[-1])).astype(np.float32)
    val = val * 0.5 + 0.5 if positive else val * 2 - 1
    return ptr.astype(np.int32), idx, val


def spmm_case_counts(name, rng):
    """Row lengths and (S, D, dtype) of the SpMM's edge cases: a dense row
    over hundreds of CTAs' shares, rows longer than the kernel's long-row
    threshold (split across CTAs, or summed by one), runs of empty rows,
    widths that leave a partial slab or idle lanes, one source row, and
    more source rows than three quarters of the L2 holds at D."""
    if name == "dense_row":
        counts = rng.randint(0, 9, 64)
        counts[17] = 65_536
        return counts, 4096, 1024, torch.bfloat16
    if name == "long_rows":            # each split over several CTAs
        counts = rng.randint(0, 20, 2000)
        counts[::50] = rng.randint(300, 3000, 40)
        return counts, 5000, 1024, torch.bfloat16
    if name == "long_rows_mixed":      # most within one CTA's share
        counts = rng.randint(0, 20, 100_000)
        counts[::1000] = rng.randint(300, 1000, 100)
        return counts, 5000, 64, torch.bfloat16
    if name.startswith("empty_rows"):
        counts = rng.randint(0, 6, 3000) * (rng.rand(3000) < 0.3)
        counts[:700] = 0
        counts[-500:] = 0
        d, dt = (8, torch.bfloat16) if name == "empty_rows_d8" else (
            1024, torch.float32)
        return counts, 500, d, dt
    if name == "partial_slab_d1016":   # 127 pieces: slabs of 32, the last 31
        return rng.randint(0, 12, 3000), 20_000, 1016, torch.bfloat16
    if name == "partial_slab_d24":     # 3 pieces: one lane of 4 idle
        return rng.randint(0, 12, 3000), 700, 24, torch.bfloat16
    if name == "tiny_src":
        return rng.randint(0, 12, 500), 1, 64, torch.float32
    if name == "large_src":            # 200,000 x 512 B: slabs of 8 pieces
        return rng.randint(0, 4, 50_000), 200_000, 256, torch.bfloat16
    raise KeyError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense_row", "long_rows", "long_rows_mixed",
                                  "empty_rows_d8",
                                  "empty_rows_d1024", "partial_slab_d1016",
                                  "partial_slab_d24", "tiny_src", "large_src"])
def test_spmm_edge_cases_on_card(cuda_device, name):
    """The SpMM's schedule at its edges against the plain version, and
    bit-identical over two calls (fp32 rtol 1e-4 atol 1e-5; bf16 one bf16
    ulp). Rows of hundreds to 65,536 edges take positive terms, so their
    fp32 sums in two orders differ by far less than the tolerance, as they
    would not where terms cancel to near 0."""
    rng = np.random.RandomState(len(name))
    counts, n_src, d, dtype = spmm_case_counts(name, rng)
    long_sums = counts.max() > 256
    ptr, idx, val = (torch.from_numpy(a).to(cuda_device)
                     for a in csr_from_counts(rng, counts, n_src, long_sums))
    gen = torch.Generator(device=cuda_device).manual_seed(len(name))
    x = (torch.rand(n_src, d, generator=gen, device=cuda_device) if long_sums
         else torch.randn(n_src, d, generator=gen, device=cuda_device))
    x = x.to(dtype)
    before = tspmm.spmm_csr.launches
    out = tspmm.spmm_csr(ptr, idx, val, x)
    again = tspmm.spmm_csr(ptr, idx, val, x)
    ref = tspmm.spmm_csr_plain(ptr, idx, val, x)
    torch.cuda.synchronize()
    assert tspmm.spmm_csr.launches == before + 2
    assert out.shape == (len(counts), d) and out.dtype == dtype
    assert not out[torch.from_numpy(counts == 0).to(cuda_device)].any()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), again.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 1024])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_halo_all_to_all_matches_plain_on_card(cuda_device, k, d, dtype):
    """K1 against its plain version on the card, exactly (a copy)."""
    _, bufs = stacked_halo(k, 104 + k, d, dtype, cuda_device, seed=k * d)
    before = halo_all_to_all.launches
    out = halo_all_to_all(bufs)
    ref = halo_all_to_all_plain(bufs)
    torch.cuda.synchronize()
    assert halo_all_to_all.launches == before + 1
    for a, b in zip(out, ref, strict=True):
        assert torch.equal(a, b)
    # the K outputs are views of one stacked allocation
    assert all(o.data_ptr() == out[0].data_ptr() + q * o.nbytes
               for q, o in enumerate(out))


@pytest.mark.cuda
def test_halo_all_to_all_kernel_rejects_misaligned(cuda_device):
    # 3 fp32 a row and 1 row a block: 12-byte blocks
    _, bufs = stacked_halo(2, 1, 3, torch.float32, cuda_device)
    before = halo_all_to_all.launches
    with pytest.raises(ValueError, match="aligned"):
        halo_all_to_all(bufs)
    assert halo_all_to_all.launches == before


def check_gather_on_card(table, idx, **kw):
    """gather_rows on the card against its plain version, exactly (a copy),
    with exactly one launch."""
    before = gather_rows.launches
    got = gather_rows(table, idx, **kw)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 8),      # one 16-byte piece a row, one lane a row
    (torch.bfloat16, 1016),   # 127 pieces: a warp a row, one lane short
    (torch.bfloat16, 136),    # 17 pieces: a warp a row, 15 lanes idle
    (torch.bfloat16, 520),    # 65 pieces: 4 pieces a lane, one slab
    (torch.bfloat16, 3),      # 6-byte rows: 2-byte pieces
    (torch.bfloat16, 6),      # 12-byte rows: 4-byte pieces
    (torch.float32, 5),       # 20-byte rows: 4-byte pieces
    (torch.float32, 8),       # two pieces a row
    (torch.float32, 1024),    # 256 pieces: two slabs a row
])
def test_gather_widths_on_card(cuda_device, dtype, d):
    """The redesigned gather at every group and slab shape, over contiguous
    tables and over one at an offset that allows only 2- or 4-byte
    pieces, in plain row order and over a shuffled schedule of ranges."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    table = torch.randn(3001, d, generator=gen, device=cuda_device).to(dtype)
    idx = torch.randint(0, 3001, (4096,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    check_gather_on_card(table, idx)
    check_gather_on_card(table, idx, schedule=shuffled_ranges(
        np.random.RandomState(d), 4096).to(cuda_device))
    flat = torch.randn(3001 * d + 1, generator=gen, device=cuda_device)
    check_gather_on_card(flat.to(dtype)[1:].view(3001, d), idx)


@pytest.mark.cuda
def test_gather_out_at_an_offset_on_card(cuda_device):
    """out= into rows 4.. of a larger tensor (still 16-byte aligned), the
    rows around it untouched; a misaligned out= raises with no launch."""
    table = torch.randn(500, 1024, device=cuda_device).bfloat16()
    idx = torch.randint(0, 500, (700,), device=cuda_device, dtype=torch.int32)
    buf = torch.zeros(710, 1024, device=cuda_device, dtype=torch.bfloat16)
    got = check_gather_on_card(table, idx, out=buf[4:704])
    assert got.data_ptr() == buf[4:704].data_ptr()
    assert not buf[:4].any() and not buf[704:].any()
    bad = torch.zeros(700 * 1024 + 1, device=cuda_device,
                      dtype=torch.bfloat16)[1:].view(700, 1024)
    before = gather_rows.launches
    with pytest.raises(ValueError, match="aligned"):
        gather_rows(table, idx, out=bad)
    assert gather_rows.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["repeated", "larger_than_l2", "k1"])
def test_gather_edge_cases_on_card(cuda_device, case):
    """One index repeated 10^5 times; a table of 82 MB (beyond the 50 MB
    L2); a single row."""
    gen = torch.Generator(device=cuda_device).manual_seed(len(case))
    if case == "repeated":
        table = torch.randn(64, 1024, generator=gen, device=cuda_device).bfloat16()
        idx = torch.full((100_000,), 17, device=cuda_device, dtype=torch.int32)
    elif case == "larger_than_l2":
        table = torch.randn(40_000, 1024, generator=gen,
                            device=cuda_device).bfloat16()
        idx = torch.randint(0, 40_000, (60_000,), generator=gen,
                            device=cuda_device, dtype=torch.int32)
    else:
        table = torch.randn(9, 1024, generator=gen, device=cuda_device).bfloat16()
        idx = torch.tensor([5], device=cuda_device, dtype=torch.int32)
    check_gather_on_card(table, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 1024])
def test_composed_halo_gather_on_card(cuda_device, d):
    """halo_gather at K=4 (one launch over the composed index) equals the
    JAX route, four send-row gathers and the all-to-all, exactly: at D=8
    in row order (the table fits L2), at D=1024 in the order of its
    schedule (a 64 MiB table)."""
    rng = np.random.RandomState(d)
    k, ns, bh = 4, 8192, 600
    halo_send = np.sort(rng.randint(0, ns, (k, k, bh)), axis=2).astype(np.int32)
    halo_send[:, :, 500:] = 0   # padding slots, last
    x = torch.randn(k * ns, d, device=cuda_device).bfloat16()
    src = compose_halo_src(halo_send, ns)
    sched = torch.from_numpy(halo_schedule(src)).to(cuda_device)
    src = torch.from_numpy(src).to(cuda_device)
    assert (pick_halo_schedule(x, sched) is sched) == (d == 1024)
    before = gather_rows.launches
    got = halo_gather(x, src, sched)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert got.shape == (k, k * bh, d)
    send = [gather_rows_plain(x[p * ns:(p + 1) * ns],
                              torch.from_numpy(halo_send[p].reshape(-1))
                              .to(cuda_device)) for p in range(k)]
    assert torch.equal(got, torch.stack(halo_all_to_all_plain(send)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 1024])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_halo_all_to_all_stacked_on_card(cuda_device, k, d):
    """The stacked form, one launch, equals the list form and the plain
    version exactly."""
    x, bufs = stacked_halo(k, 104 + k, d, torch.bfloat16, cuda_device,
                           seed=k + d)
    before = halo_all_to_all.launches
    got = halo_all_to_all(x)
    listed = halo_all_to_all(bufs)
    torch.cuda.synchronize()
    assert halo_all_to_all.launches == before + 2
    assert got.shape == x.shape
    assert torch.equal(got, torch.stack(listed))
    assert torch.equal(got, halo_all_to_all_plain(x))


@pytest.mark.cuda
def test_halo_all_to_all_stacked_rejects_misaligned(cuda_device):
    """A stacked tensor at a storage offset that breaks 16-byte alignment,
    and 12-byte blocks, raise before any launch."""
    k, bh, d = 4, 8, 8
    x = torch.zeros(k * k * bh * d + 1, device=cuda_device,
                    dtype=torch.bfloat16)[1:].view(k, k * bh, d)
    before = halo_all_to_all.launches
    with pytest.raises(ValueError, match="aligned"):
        halo_all_to_all(x)
    x, _ = stacked_halo(2, 1, 3, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        halo_all_to_all(x)
    assert halo_all_to_all.launches == before


# the GEN aggregation on the card against its plain version:
# - forward fp32: rtol 1e-4, atol 1e-5 (online vs two-pass softmax, the
#   kernel's fmaf and expf), rtol 2^-24 L where the longest segment has L
#   edges (a sum of L positive terms in fp32, in two orders: the dense
#   65,536-edge segment differs by 5.7e-4 relative on the H100);
# - forward bf16: the plain version rounds the message, its logits and
#   their exps to bf16 as JAX does, the kernel keeps them in fp32: rtol
#   2^-6, atol 2^-5 (a few bf16 ulps of O(1) values); and against the plain
#   version run in fp32 on the same bf16-valued inputs (the kernel's own
#   arithmetic) at the fp32 tolerance;
# - backward: both take fp32 from the same inputs: dpre fp32 rtol 1e-4,
#   atol 1e-6; bf16 one bf16 ulp (rtol 2^-7) of the rounded plain value;
#   dw, db, dt (sums over every edge, in another order) within 1e-5 (2^-24
#   L for a longest segment of L edges) of the sum of their terms'
#   magnitudes.
GEN_FWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -5)}
GEN_DPRE_TOL = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (2 ** -7, 1e-6)}
# forwards compared bit for bit, and seeded draws of dL/daggr for the
# backward, in each case of test_gen_agg_matches_plain_on_card
GEN_REPEATS, GEN_G_DRAWS = 8, 8


def gen_counts(rng, name):
    if name == "long":      # rows past a team's share, some over many CTAs
        counts = rng.randint(0, 20, 3000)
        counts[::97] = rng.randint(65, 3000, len(counts[::97]))
        counts[5:40] = 0
        return counts, 2000
    if name == "dense":     # one 65,536-edge segment
        counts = rng.randint(0, 9, 64)
        counts[17] = 65_536
        return counts, 4096
    if name == "spans":     # segments over 2 and over many CTAs' shares
        counts = rng.randint(0, 12, 3000)
        counts[500], counts[1000] = 100, 1500
        return counts, 2000
    if name == "half":      # one segment of half the edges
        counts = rng.randint(0, 9, 2000)
        counts[700] = counts.sum()
        return counts, 2000
    if name == "all":       # one segment of every edge, over every CTA
        return np.array([0, 0, 200_000, 0]), 3000
    if name == "side":      # long segments side by side, empty runs between
        counts = np.zeros(400, np.int64)
        counts[::4] = rng.randint(200, 2000, 100)
        counts[1::8] = rng.randint(65, 300, 50)
        return counts, 2000
    return rng.randint(0, 12, 5000), 3000


def sum_rtol(ptr) -> float:
    """fp32's relative limit for sums over the longest segment."""
    return max(1e-4, 2 ** -24 * int((ptr[1:] - ptr[:-1]).max()))


def fp32_reference_inputs(args):
    """The inputs as fp32 values of x's dtype (a rounded as the kernel
    rounds it): the plain version run on them computes the kernel's
    arithmetic."""
    ptr, src, a, x, w, b, t = args
    return [ptr, src, a.to(x.dtype).float()] + [v.float() for v in (x, w, b, t)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,name", [
    (torch.bfloat16, 256, "long"), (torch.float32, 256, "long"),
    (torch.bfloat16, 3, "long"), (torch.float32, 3, "short"),
    (torch.bfloat16, 16, "short"), (torch.float32, 20, "short"),
    (torch.bfloat16, 256, "dense"), (torch.bfloat16, 256, "spans"),
    (torch.bfloat16, 3, "spans"), (torch.float32, 256, "half"),
    (torch.bfloat16, 256, "half"), (torch.bfloat16, 3, "all"),
    (torch.float32, 256, "all"), (torch.float32, 3, "side"),
    (torch.bfloat16, 256, "side"), (torch.bfloat16, 256, "long-t"),
    (torch.float32, 16, "short-t")])
def test_gen_agg_matches_plain_on_card(cuda_device, dtype, d, name):
    """gen_agg_fwd and gen_agg_bwd against their plain versions (tolerances
    above), bit-identical over repeated calls (GEN_REPEATS forwards, two
    backwards), one launch each a call; empty segments give 0; with
    need_lse=False the same aggr and no lse; the backward over GEN_G_DRAWS
    seeded draws of dL/daggr. Segments split across CTAs: "long", "dense",
    "spans" (2 and many CTAs), "half" (E/2), "all" (every CTA), "side" (long
    ones between empty runs); "-t": a negative temperature (the chunk's max
    then comes from its least message)."""
    rng = np.random.RandomState(d)
    counts, n_src = gen_counts(rng, name.removesuffix("-t"))
    args, _ = gen_inputs(rng, counts, n_src, d, dtype, cuda_device)
    if name.endswith("-t"):
        args[6] = torch.tensor(-0.7).to(dtype).to(cuda_device)
    before = gen_agg.gen_agg_fwd.launches
    aggr, lse = gen_agg.gen_agg_fwd(*args)
    for rep in range(GEN_REPEATS - 1):
        aggr2, lse2 = gen_agg.gen_agg_fwd(*args)
        assert torch.equal(aggr, aggr2) and torch.equal(lse, lse2), \
            f"forward {rep + 2} differs from the first"
    torch.cuda.synchronize()
    assert gen_agg.gen_agg_fwd.launches == before + GEN_REPEATS
    served, none = gen_agg.gen_agg_fwd(*args, need_lse=False)
    assert none is None and torch.equal(served, aggr)
    empty = torch.from_numpy(counts == 0).to(cuda_device)
    assert not aggr[empty].any()
    want, want_lse = gen_agg.gen_agg_fwd_plain(*args)
    rtol, atol = GEN_FWD_TOL[dtype]
    long_rtol = sum_rtol(args[0])
    rtol = max(rtol, long_rtol)
    torch.testing.assert_close(aggr, want, rtol=rtol, atol=atol)
    torch.testing.assert_close(lse[~empty], want_lse[~empty], rtol=rtol,
                               atol=atol)
    exact, exact_lse = gen_agg.gen_agg_fwd_plain(*fp32_reference_inputs(args))
    torch.testing.assert_close(aggr, exact, rtol=long_rtol, atol=1e-5)
    torch.testing.assert_close(lse[~empty], exact_lse[~empty], rtol=long_rtol,
                               atol=1e-5)
    gen = torch.Generator(device=cuda_device)
    for draw in range(GEN_G_DRAWS):
        gen.manual_seed(1000 * d + draw)
        g = torch.randn(len(counts), d, generator=gen, device=cuda_device)
        before = gen_agg.gen_agg_bwd.launches
        got = gen_agg.gen_agg_bwd(*args, g, aggr, lse)
        again = gen_agg.gen_agg_bwd(*args, g, aggr, lse)
        torch.cuda.synchronize()
        assert gen_agg.gen_agg_bwd.launches == before + 2
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(got[0].view(bits), again[0].view(bits))
        assert all(torch.equal(u, v) for u, v in zip(got[1:], again[1:]))
        want = gen_agg.gen_agg_bwd_plain(*args, g, aggr, lse)
        rtol, atol = GEN_DPRE_TOL[dtype]
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=rtol, atol=atol,
                                   msg=lambda m: f"g draw {draw}: {m}")
        a_t = args[2].to(dtype).float().abs()[:, None]
        dp = want[0][:, :d].float().abs()
        mass = [(a_t * dp).sum(0), dp.sum(0), None]
        ptr = args[0]
        sums = max(1e-5, 2 ** -24 * int((ptr[1:] - ptr[:-1]).max()))
        for part, u, v, m in zip(("dw", "db", "dt"), got[1:], want[1:], mass):
            scale = m if m is not None else (v.abs() + 1)
            err = (u - v.float()).abs()
            assert (err <= sums * scale + 1e-6).all(), \
                (f"g draw {draw}: {part} max |err| {float(err.max())}, "
                 f"limit {float((sums * scale + 1e-6).min())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.bfloat16, 3),
                                     (torch.float32, 16)])
def test_gen_softmax_agg_gradient_on_card(cuda_device, dtype, d):
    """GenSoftmaxAgg's backward on the card: one gen_agg_bwd launch and one
    SpMM over the transpose ordering (dpre's rows padded to 16 bytes, the
    result cut to D), x's gradient equal to the SpMM's plain version over
    the kernel's dpre, the others to gen_agg_bwd's."""
    rng = np.random.RandomState(d + 1)
    counts, n_src = gen_counts(rng, "long")
    args, (t_ptr, eperm) = gen_inputs(rng, counts, n_src, d, dtype,
                                      cuda_device)
    ptr, src, a, x, w, b, t = args
    leaves = [v.clone().requires_grad_() for v in (x, w, b, t)]
    out = gen_agg.gen_softmax_agg(ptr, src, a, *leaves, t_ptr, eperm)
    g = torch.randn_like(out)
    counts_before = (gen_agg.gen_agg_bwd.launches, tspmm.spmm_csr.launches)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (gen_agg.gen_agg_bwd.launches - counts_before[0],
            tspmm.spmm_csr.launches - counts_before[1]) == (1, 1)
    with torch.no_grad():
        aggr, lse = gen_agg.gen_agg_fwd(*args)
        dpre, dw, db, dt = gen_agg.gen_agg_bwd(*args, g, aggr, lse)
        ones = torch.ones(eperm.shape[0], device=cuda_device)
        dx = tspmm.spmm_csr_plain(t_ptr, eperm, ones, dpre)[:, :d]
    rtol, atol = tspmm_tol(dtype)
    torch.testing.assert_close(grads[0].float(), dx.float(), rtol=rtol,
                               atol=atol)
    assert grads[0].dtype == dtype and grads[0].shape == x.shape
    for got, want in zip(grads[1:], (dw, db, dt)):
        assert torch.equal(got, want.to(dtype))


def tspmm_tol(dtype):
    """The SpMM kernel against its plain version (test_kernels_match_plain_on_card)."""
    return (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)


def test_gen_agg_lse_only_where_a_gradient_is_taken(monkeypatch):
    """gen_softmax_agg asks the forward for lse only where a gradient will
    be taken: not under no_grad (serving), yes in grad mode and in remat's
    recompute; gen_agg_fwd then returns lse None, and the backward refuses
    a missing lse."""
    from torch.utils.checkpoint import checkpoint
    rng = np.random.RandomState(31)
    args, (t_ptr, eperm) = gen_inputs(rng, np.array([3, 0, 5, 1, 7]), 6, 8,
                                      torch.float32)
    ptr, src, a, x, w, b, t = args
    seen = []
    fwd = gen_agg.gen_agg_fwd

    def spy(*a_, **kw):
        out = fwd(*a_, **kw)
        seen.append((a_[7] if len(a_) > 7 else kw.get("need_lse", True),
                     out[1] is None))
        return out

    monkeypatch.setattr(gen_agg, "gen_agg_fwd", spy)
    xg = x.clone().requires_grad_()

    def agg(xx):
        return gen_agg.gen_softmax_agg(ptr, src, a, xx, w, b, t, t_ptr, eperm)

    with torch.no_grad():
        served = agg(xg)
    assert seen == [(False, True)]
    seen.clear()
    agg(xg).sum().backward()
    plain_grad = xg.grad.clone()
    assert seen == [(True, False)]
    seen.clear()
    xg.grad = None
    checkpoint(agg, xg, use_reentrant=False).sum().backward()
    assert seen == [(True, False), (True, False)]   # forward, recompute
    assert torch.equal(xg.grad, plain_grad)
    assert torch.equal(served, agg(x))
    aggr, lse = fwd(*args, need_lse=False)
    assert lse is None and torch.equal(aggr, served)
    with pytest.raises(ValueError, match="need_lse=True"):
        gen_agg.gen_agg_bwd(*args, torch.ones_like(aggr), aggr, None)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gen_agg_fwd", "spmm_csr"])
def test_split_rows_after_a_smaller_grid(cuda_device, kernel):
    """A kernel that splits long rows across CTAs keeps its arrival counts
    in a workspace of their own: a launch of a small grid that splits a
    row, then one of a larger grid (several waves) that splits rows, gives
    the plain version's result."""
    rng = np.random.RandomState(40)
    small = rng.randint(0, 9, 400)
    small[200] = 6000
    large = rng.randint(0, 12, 60_000)
    large[::5000] = 9000
    for counts in (small, large):
        if kernel == "gen_agg_fwd":
            args, _ = gen_inputs(rng, counts, 3000, 64, torch.bfloat16,
                                 cuda_device)
            got = gen_agg.gen_agg_fwd(*args)[0]
            want = gen_agg.gen_agg_fwd_plain(*fp32_reference_inputs(args))[0]
            rtol = sum_rtol(args[0])
        else:
            ptr, idx, val = (torch.from_numpy(v).to(cuda_device) for v in
                             csr_from_counts(rng, counts, 3000, True))
            x = torch.rand(3000, 64, device=cuda_device)
            got = tspmm.spmm_csr(ptr, idx, val, x)
            want = tspmm.spmm_csr_plain(ptr, idx, val, x)
            rtol = 1e-4
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5)


def edgeless(num_dst, n_src, d, dtype, device):
    """A direction with ``num_dst`` rows and no edge (a sampled subgraph's
    seeds can have none), x (n_src, d) and GEN's w, b, t."""
    gen = torch.Generator().manual_seed(n_src + d)
    ptr = torch.zeros(num_dst + 1, dtype=torch.int32)
    idx = torch.zeros(0, dtype=torch.int32)
    val = torch.zeros(0, dtype=torch.float32)
    x, w, b = (torch.randn(*s, generator=gen) for s in ((n_src, d), (d,), (d,)))
    dense = [v.to(dtype) for v in (x, w, b, torch.tensor(1.5))]
    return [v.to(device) for v in (ptr, idx, val, *dense)]


def check_edgeless(device, n_src, dtype):
    ptr, idx, val, x, w, b, t = edgeless(300, n_src, 16, dtype, device)
    out = tspmm.spmm_csr(ptr, idx, val, x)
    aggr, lse = gen_agg.gen_agg_fwd(ptr, idx, val, x, w, b, t)
    g = torch.randn(300, 16, device=device)
    dpre, dw, db, dt = gen_agg.gen_agg_bwd(ptr, idx, val, x, w, b, t, g,
                                           aggr, lse)
    if device.type == "cuda":
        torch.cuda.synchronize()
    assert out.shape == (300, 16) and out.dtype == dtype and not out.any()
    assert aggr.shape == (300, 16) and not aggr.any()
    assert dpre.shape[0] == 0 and not (dw.any() or db.any() or dt.any())


@pytest.mark.parametrize("n_src", [0, 5])
def test_kernels_on_edgeless_graphs(n_src):
    """On the CPU the plain versions of an edgeless direction give zeros:
    the SpMM's rows, GEN's aggregation and its gradients."""
    check_edgeless(torch.device("cpu"), n_src, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_src", [0, 5])
def test_kernels_on_edgeless_graphs_on_card(cuda_device, n_src, dtype):
    """On the card the SpMM and GEN's two kernels launch once each over
    300 rows and no edge, with no source row or some, and write zeros:
    the plain versions' result."""
    before = (tspmm.spmm_csr.launches, gen_agg.gen_agg_fwd.launches,
              gen_agg.gen_agg_bwd.launches)
    check_edgeless(cuda_device, n_src, dtype)
    assert (tspmm.spmm_csr.launches, gen_agg.gen_agg_fwd.launches,
            gen_agg.gen_agg_bwd.launches) == tuple(n + 1 for n in before)


# ------------------------------------------- edge-partitioned training paths
def merge_inputs(rng, rows, d, n_parts, device="cpu"):
    """gen_lse_merge's inputs: rows with a local part or not, and 0-3 slot
    parts each (rows 0 and 1 without any), parts rows 2D + 2 wide."""
    local = rng.randint(0, 3, rows).astype(np.int32)
    per = rng.randint(0, 4, rows)
    local[:2], per[:2] = 0, 0
    ptr = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    idx = rng.randint(0, n_parts, ptr[-1]).astype(np.int32)
    parts = rng.randn(n_parts, 2 * d + 2).astype(np.float32)
    parts[:, d:2 * d] *= 4
    t = [torch.from_numpy(a).to(device) for a in (
        local, rng.randn(rows, d).astype(np.float32),
        (rng.randn(rows, d) * 4).astype(np.float32), ptr, idx, parts)]
    return t


def test_gen_lse_merge_checks():
    """The merge's wrapper refuses what the kernel does not take, and on the
    CPU runs its plain version: a row without parts gives 0 and 0."""
    t = merge_inputs(np.random.RandomState(1), 20, 3, 9)
    before = gen_agg.gen_lse_merge.launches
    aggr, lse = gen_agg.gen_lse_merge(*t)
    assert gen_agg.gen_lse_merge.launches == before
    assert not aggr[:2].any() and not lse[:2].any()
    with pytest.raises(TypeError, match="int32"):
        gen_agg.gen_lse_merge(t[0].long(), *t[1:])
    with pytest.raises(ValueError, match="2D"):
        gen_agg.gen_lse_merge(*t[:5], t[5][:, :5].contiguous())
    with pytest.raises(TypeError, match="one dtype"):
        gen_agg.gen_lse_merge(*t[:5], t[5].double())
    with pytest.raises(ValueError, match="contiguous"):
        gen_agg.gen_lse_merge(*t[:5], t[5].t().contiguous().t())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 256])
def test_gen_lse_merge_matches_plain_on_card(cuda_device, d):
    """gen_lse_merge on the card, one launch, against its plain version
    (rtol 1e-5 atol 1e-6: the online rescale and expf/logf against a
    max-first sum in another order), bit-identical over two calls."""
    t = merge_inputs(np.random.RandomState(d), 5000, d, 3000, cuda_device)
    before = gen_agg.gen_lse_merge.launches
    aggr, lse = gen_agg.gen_lse_merge(*t)
    again = gen_agg.gen_lse_merge(*t)
    torch.cuda.synchronize()
    assert gen_agg.gen_lse_merge.launches == before + 2
    want = gen_agg.gen_lse_merge_plain(*t)
    torch.testing.assert_close(aggr, want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want[1], rtol=1e-5, atol=1e-6)
    assert torch.equal(aggr, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 1024])
def test_halo_all_to_all_backward_on_card(cuda_device, d):
    """K1's backward (HaloAllToAll) is one more stacked launch, on the
    gradient: the exchange of the gradient, exactly."""
    x, _ = stacked_halo(4, 40, d, torch.bfloat16, cuda_device, seed=d)
    x.requires_grad_()
    ct, _ = stacked_halo(4, 40, d, torch.bfloat16, cuda_device, seed=d + 1)
    before = halo_all_to_all.launches
    out = HaloAllToAll.apply(x)
    assert halo_all_to_all.launches == before + 1
    out.backward(ct)
    torch.cuda.synchronize()
    assert halo_all_to_all.launches == before + 2
    assert torch.equal(x.grad, halo_all_to_all_plain(ct))


# What every rank worker checks of its group's form: the signalled form
# where the world's ranks each have a card of their own (as many cards as
# ranks: init_distributed puts rank r on cuda:r), else the flags form; and
# that ``exchanges`` exchanges launched that form's kernels alone (one
# launch an exchange, or two).
FORM_CHECK = r"""
import torch
from lp_gnn_tpu_torch.parallel import halo


def check_form(exchanges, before=(0, 0)):
    own = torch.cuda.device_count() >= torch.distributed.get_world_size()
    want = halo.SIGNALLED if own else halo.FLAGS
    forms = {w.form for w in halo._WINDOWS.values()}
    assert forms == {want}, (forms, want)
    got = (halo.halo_rank_signalled.launches - before[0],
           halo.halo_all_to_all_ranks.launches - before[1])
    assert got == ((exchanges, 0) if own else (0, 2 * exchanges)), got
    return want


def launches():
    return (halo.halo_rank_signalled.launches,
            halo.halo_all_to_all_ranks.launches)
"""

# one rank of test_halo_all_to_all_ranks_on_card: every rank makes all K
# buffers from one seed and holds its own result to the stacked plain
# version's, bit for bit (a copy), through three shapes, a repeat of the
# first (the windows reused) and HaloAllToAllRanks' backward; the group
# keeps one pair of windows, of the largest exchange (two windows and the
# counters on the card; the flag header is a page of host memory); the
# form of its layout, its launches alone
RANK_WORKER = FORM_CHECK + r"""
import sys
from lp_gnn_tpu_torch.parallel.mesh import init_distributed, leave_distributed

dev, _ = init_distributed(torch.device("cuda"))
k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
gen = torch.Generator(device="cpu").manual_seed(7)
cases = [(37, 8, torch.bfloat16), (37, 1024, torch.bfloat16),
         (21, 8, torch.float32), (37, 8, torch.bfloat16)]
for bh, f, dt in cases:
    bufs = [torch.randn(k * bh, f, generator=gen).to(dt) for _ in range(k)]
    want = halo.halo_all_to_all_plain(bufs)[me]
    got = halo.halo_all_to_all_ranks(bufs[me].to(dev))
    assert torch.equal(got.cpu(), want), (bh, f, dt)
x = torch.randn(k * 16, 64, generator=gen)
cts = [torch.randn(k * 16, 64, generator=gen) for _ in range(k)]
xr = x.to(dev).requires_grad_()
halo.HaloAllToAllRanks.apply(xr, None).backward(cts[me].to(dev))
assert torch.equal(xr.grad.cpu(), halo.halo_all_to_all_plain(cts)[me])
form = check_form(len(cases) + 2)
assert halo.halo_all_to_all.launches == 0
assert len(halo._WINDOWS) == 1
assert halo.window_bytes() == 2 * k * 37 * 1024 * 2 + halo.COUNTER_BYTES
leave_distributed(True)
print("rank", me, form, "ok")
"""

# Patches that make the host's collectives and synchronises raise while a
# worker's exchanges run (once its windows exist): the exchanges must make
# none of them.
NO_HOST_SYNC = r"""
import torch


class HostSync(AssertionError):
    pass


def refuse(name):
    def fn(*a, **kw):
        raise HostSync(f"{name} during the exchanges")
    return fn


SYNCS = [(torch.distributed, n) for n in ("barrier", "all_gather",
                                          "all_gather_object")] + [
    (torch.cuda.Stream, "synchronize"), (torch.cuda, "synchronize")]


def no_host_sync():
    saved = [(m, n, getattr(m, n)) for m, n in SYNCS]
    for m, n in SYNCS:
        setattr(m, n, refuse(f"{m.__name__}.{n}"))
    return saved


def restore(saved):
    for m, n, fn in saved:
        setattr(m, n, fn)
"""

# one rank of test_halo_all_to_all_ranks_stress_on_card: STRESS exchanges
# back to back, two shapes in turn within the windows, rank 0's card held
# back by torch.cuda._sleep before its write on every other exchange, no
# collective and no synchronise of the host among them (they raise); then
# every result against the stacked plain version, bit for bit
STRESS_WORKER = NO_HOST_SYNC + FORM_CHECK + r"""
from lp_gnn_tpu_torch.parallel.mesh import init_distributed, leave_distributed

STRESS = 64
dev, _ = init_distributed(torch.device("cuda"))
k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
gen = torch.Generator(device="cpu").manual_seed(13)
shapes = [(37, 256, torch.bfloat16), (13, 24, torch.float32)]
ins, wants = [], []
for i in range(STRESS):
    bh, f, dt = shapes[i % 2]
    bufs = torch.randn(k, k * bh, f, generator=gen).to(dt).to(dev)
    wants.append(halo.halo_all_to_all_plain(bufs)[me].clone())
    ins.append(bufs[me].clone())
    del bufs
halo.halo_all_to_all_ranks(ins[0])   # the windows, made with collectives
torch.cuda.synchronize()
before = launches()
saved = no_host_sync()
try:
    outs = []
    for i, x in enumerate(ins):
        if me == 0 and i % 2:
            torch.cuda._sleep(2_000_000)
        outs.append(halo.halo_all_to_all_ranks(x))
finally:
    restore(saved)
torch.cuda.synchronize()
bad = [i for i in range(STRESS) if not torch.equal(outs[i], wants[i])]
assert not bad, f"rank {me}: exchanges {bad} differ from the plain version"
form = check_form(STRESS, before)
assert halo.halo_all_to_all.launches == 0
assert [w.epoch for w in halo._WINDOWS.values()] == [STRESS + 1]
leave_distributed(True)
print("rank", me, form, "ok")
"""

# one rank of test_halo_all_to_all_ranks_abort_on_card: after two good
# exchanges, the last rank's buffer is misaligned (its launch refused at the
# C entry, cudaErrorInvalidValue); every rank must raise within three
# exchanges and DEADLINE_S, naming that rank and its error, with no
# collective or synchronise of the host in the exchanges; the windows are
# then released and made anew, and an exchange is exact again
ABORT_WORKER = NO_HOST_SYNC + FORM_CHECK + r"""
import time
from lp_gnn_tpu_torch.parallel.mesh import init_distributed, leave_distributed

dev, _ = init_distributed(torch.device("cuda"))
k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
gen = torch.Generator(device="cpu").manual_seed(17)
bufs = torch.randn(k, k * 40, 64, generator=gen).to(torch.bfloat16).to(dev)
want = halo.halo_all_to_all_plain(bufs)[me]
x = bufs[me].clone()
assert torch.equal(halo.halo_all_to_all_ranks(x), want)
form = check_form(1)
bad = x
if me == k - 1:
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=dev)
    bad = flat[1:1 + x.numel()].view(x.shape)   # 2 bytes off 16
    bad.copy_(x)
torch.cuda.synchronize()
saved = no_host_sync()
err, t0 = None, time.monotonic()
try:
    halo.halo_all_to_all_ranks(x)
    for _ in range(3):
        try:
            halo.halo_all_to_all_ranks(bad)
        except RuntimeError as e:
            err = str(e)
            break
finally:
    restore(saved)
took = time.monotonic() - t0
assert err is not None, f"rank {me} did not raise within three exchanges"
assert f"rank {k - 1}'s launch failed: CUDA error 1" in err, err
assert took < halo.DEADLINE_S, took
halo.release_windows()
assert torch.equal(halo.halo_all_to_all_ranks(x), want)
leave_distributed(True)
print("rank", me, form, "raised", repr(err), "after", took, "s")
"""

# one rank of test_halo_all_to_all_ranks_peer_leaves_on_card: after two good
# exchanges the last rank leaves between exchanges, on an error outside
# them whose way out releases its windows ("raise"), or killed ("kill"),
# while every other rank enqueues the next exchange and synchronises on its
# result (.item()). The synchronise must end within the deadline (5 s here;
# the watchdog's look included), and the next exchange must raise, naming
# the rank that left ("raise") or this rank's wait past the deadline
# ("kill": the dead rank's window stays mapped in its peers, and their
# writes into it land). A rank killed leaves gloo's teardown to its peers'
# exits, so they end with os._exit once they have printed.
LEAVE_WORKER = FORM_CHECK + r"""
import ctypes
import os
import signal
import sys
import time
from lp_gnn_tpu_torch.parallel.mesh import init_distributed, leave_distributed

mode = sys.argv[1]
halo.DEADLINE_S = 5.0
dev, _ = init_distributed(torch.device("cuda"))
k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
gen = torch.Generator(device="cpu").manual_seed(19)
bufs = torch.randn(k, k * 40, 64, generator=gen).to(torch.bfloat16).to(dev)
want = halo.halo_all_to_all_plain(bufs)[me]
x = bufs[me].clone()
for _ in range(2):
    assert torch.equal(halo.halo_all_to_all_ranks(x), want)
form = check_form(2)
torch.distributed.barrier()
if me == k - 1:
    if mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    try:
        try:
            raise MemoryError("a step's error outside the exchanges")
        finally:
            leave_distributed(True)
    except MemoryError:
        print("rank", me, "left")
    sys.exit(0)
t0 = time.monotonic()
out = halo.halo_all_to_all_ranks(x)
try:
    out.float().sum().item()
    synced = "returned"
except RuntimeError as e:
    synced = f"raised {e}"
took = time.monotonic() - t0
assert took < halo.DEADLINE_S + 10, (synced, took)
err = None
try:
    halo.halo_all_to_all_ranks(x)
except RuntimeError as e:
    err = str(e)
assert err is not None, f"rank {me}: the next exchange did not raise"
if mode == "raise":
    assert f"rank {k - 1} left the exchanges" in err, err
    leave_distributed(True)
else:
    assert f"rank {me} waited past the 5.0 s deadline" in err, err
print("rank", me, form, "synchronise", synced, "after", took, "s; raised",
      repr(err))
if mode == "kill":
    sys.stdout.flush()
    os._exit(0)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank_workers(worker: str, ranks: int, args=(), codes=None,
                     env_of=lambda r: {}) -> None:
    """``ranks`` processes of ``python -c worker *args`` joined by the
    LP_GNN_DIST_* contract on the card (rank r's environment also
    ``env_of(r)``); their exit codes asserted to be ``codes`` (every one 0
    by default)."""
    _build.build_all(["halo_a2a"])
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, *args], cwd=root,
        env=dict(os.environ, LP_GNN_DIST_COORD=f"localhost:{port}",
                 LP_GNN_DIST_NPROCS=str(ranks), LP_GNN_DIST_PROC_ID=str(r),
                 **env_of(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        finally:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == (codes or [0] * ranks), \
        "\n".join(o[-3000:] for o in outs)
    for o in outs:   # what each rank printed last (pytest -rA shows it)
        print(o[-1000:])


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_halo_all_to_all_ranks_on_card(cuda_device, ranks):
    """The rank form of K1 between ``ranks`` processes of the LP_GNN_DIST_*
    contract, sharing one card (gloo) or a card each (NCCL, as many cards
    as ranks): each rank's result equals the plain version's, bit for bit,
    each exchange is the launches of its layout's form (the flags form's
    write and copy-out, or the signalled form's one kernel) and no stacked
    one, and the group keeps one pair of windows, of the largest
    exchange."""
    run_rank_workers(RANK_WORKER, ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_halo_all_to_all_ranks_stress_on_card(cuda_device, ranks):
    """64 exchanges of the rank form back to back over ``ranks`` processes,
    two shapes in turn, one rank's card held back on every other exchange,
    with the host's collectives and synchronises made to raise: every
    result bit for bit the plain version's, two launches an exchange."""
    run_rank_workers(STRESS_WORKER, ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_halo_all_to_all_ranks_abort_on_card(cuda_device, ranks):
    """One rank's launch refused at the C entry (a misaligned buffer): every
    rank raises within three exchanges and the deadline, naming that rank
    and its CUDA error, with no host collective or synchronise in the
    exchanges and no process left waiting; the windows made anew after,
    the exchange exact again."""
    run_rank_workers(ABORT_WORKER, ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["raise", "kill"])
def test_halo_all_to_all_ranks_peer_leaves_on_card(cuda_device, mode):
    """Four ranks; the last leaves between exchanges while the others wait
    on the card for its blocks and synchronise: on an error outside the
    exchanges (its release of the windows tells the peers) or killed (the
    peers' watchdogs end their waits past the deadline). No process waits
    without end: each other rank's synchronise returns within the deadline
    and its next exchange raises, naming the rank that left or the
    deadline."""
    codes = [0, 0, 0, -signal.SIGKILL if mode == "kill" else 0]
    run_rank_workers(LEAVE_WORKER, 4, (mode,), codes)


# one rank of test_halo_all_to_all_ranks_grid_on_card: the (dp=2, edge=2)
# grid of 4 ranks; each row exchanges buffers of its own seed over its edge
# group, held bit for bit to the stacked plain version of the row's two
# buffers, which every rank of the row makes from the seed on its own host
# (no collective: over NCCL, a row group of cards cannot run gloo's host
# copies); the rank keeps one window, its row's, of its layout's form
GRID_RANK_WORKER = FORM_CHECK + r"""
from lp_gnn_tpu_torch.parallel.mesh import (init_distributed,
                                            leave_distributed, make_grid)

dev, _ = init_distributed(torch.device("cuda"))
grid = make_grid(2, 2)
gen = torch.Generator(device="cpu").manual_seed(11 + grid.d)
cases = [(37, 8, torch.bfloat16), (37, 1024, torch.bfloat16),
         (21, 8, torch.float32)]
for bh, f, dt in cases:
    bufs = [torch.randn(2 * bh, f, generator=gen).to(dt) for _ in range(2)]
    want = halo.halo_all_to_all_plain(bufs)[grid.e]
    got = halo.halo_all_to_all_ranks(bufs[grid.e].to(dev), grid.row)
    assert torch.equal(got.cpu(), want), (grid.d, grid.e, bh, f, dt)
assert list(halo._WINDOWS) == [(grid.row, dev.index)]
form = check_form(len(cases))
assert halo.halo_all_to_all.launches == 0
leave_distributed(True)
print("cell", grid.d, grid.e, form, "ok")
"""


@pytest.mark.cuda
def test_halo_all_to_all_ranks_grid_on_card(cuda_device):
    """The rank form of K1 on the (dp=2, edge=2) grid of 4 processes, on
    one card or on a card each: each row's edge group exchanges its own
    buffers, every rank's result equal to the stacked plain version of
    its row's buffers, bit for bit, the launches of its layout's form, and
    each rank's one window that of its row group."""
    run_rank_workers(GRID_RANK_WORKER, 4)


def four_cards() -> None:
    have = torch.cuda.device_count()
    if have < 4:
        pytest.skip(f"needs 4 cards for 4 ranks with a card each, has {have}")


@pytest.mark.cuda
@pytest.mark.parametrize("check", ["exact", "stress", "abort", "raise",
                                   "kill"])
def test_halo_rank_signalled_on_four_cards(cuda_device, check):
    """K1's rank form over 4 ranks with a card each, where the group takes
    the signalled form (each worker checks its form and its launches, one
    an exchange): exact through shapes and the backward, 64 exchanges back
    to back with one rank held back, an abort from a refused launch, and a
    peer that leaves on an error or is killed."""
    four_cards()
    if check in ("raise", "kill"):
        codes = [0, 0, 0, -signal.SIGKILL if check == "kill" else 0]
        run_rank_workers(LEAVE_WORKER, 4, (check,), codes)
    else:
        run_rank_workers({"exact": RANK_WORKER, "stress": STRESS_WORKER,
                          "abort": ABORT_WORKER}[check], 4)


# one rank of test_edge_hosts_on_four_cards: 4 ranks as 2 hosts of 2 (ranks
# 0-1 report host A, 2-3 host B; each host sees its own two cards), a card
# each over NCCL. edge=4 over both hosts takes the COLLECTIVE route: exact
# against the plain version, no window, no kernel of the repo. The (dp=2,
# edge=2) grid, a host a row, keeps the signalled form in its rows: one
# step (fp32, SGD at lr 1, dropout 0) against the stacked layout's step
# over the whole batch on this rank's card (taken after the group is left):
# the loss rtol 1e-5, each tensor's update within 1e-4 of its largest
HOSTS_WORKER = r"""
import os
import numpy as np
import torch
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import combined, halo, mesh
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel.dp import rank_block
from lp_gnn_tpu_torch.train import trainer
from lp_gnn_tpu_torch.train.losses import balanced

rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
mesh.host_key = lambda: "AABB"[rank]
dev, created = mesh.init_distributed(torch.device("cuda"))
pl = mesh.placement()
assert torch.distributed.get_backend() == "nccl", pl
assert pl.hosts == tuple("AABB") and pl.local == (0, 1, 0, 1), pl
k, me = 4, rank
gen = torch.Generator(device="cpu").manual_seed(7)
cases = [(37, 8, torch.bfloat16), (37, 1024, torch.bfloat16),
         (21, 8, torch.float32)]
for bh, f, dt in cases:
    bufs = [torch.randn(k * bh, f, generator=gen).to(dt) for _ in range(k)]
    want = halo.halo_all_to_all_plain(bufs)[me]
    got = halo.halo_all_to_all_ranks(bufs[me].to(dev))
    assert torch.equal(got.cpu(), want), (bh, f, dt)
assert mesh.ROUTES == {(0, 1, 2, 3): mesh.COLLECTIVE}, mesh.ROUTES
assert halo.window_bytes() == 0 and not halo._WINDOWS
assert halo.halo_all_to_all_ranks.collective_exchanges == len(cases)
assert halo.halo_rank_signalled.launches == 0
assert halo.halo_all_to_all_ranks.launches == 0

arch = "GCN_FC(8,8,hids=32,depth=3,dp=0.0)"
graphs = [port_graph(np.random.RandomState(20 + i), m=600, n=900, e=6000)
          for i in range(2)]
w0 = build_model(arch, generator=torch.Generator().manual_seed(3)
                 ).state_dict()


def step(grid):
    model = build_model(arch)
    model.load_state_dict(w0)
    model = model.to(dev)
    opt = trainer.make_optimizer(model.parameters(), "sgd", 1.0)
    if grid is None:
        parts = combined.partition_batch(graphs, 2, halo=True)
        dgs = [tEP.dist_tensors(model, p, mesh.make_mesh(2, dev),
                                input_agg=True) for p in parts]
    else:
        em = mesh.make_mesh(2, dev, grid.row, row=grid.d)
        parts = combined.partition_batch(
            graphs, 2, halo=True, own=rank_block([0, 1], 2, grid.d))
        dgs = [tEP.dist_tensors(model, p, em, input_agg=True) for p in parts]
    loss = combined.dp_edge_train_step(model, opt, dgs, balanced, None, grid)
    torch.cuda.synchronize(dev)
    return float(loss), {n: v.detach().cpu()
                         for n, v in model.state_dict().items()}


grid = mesh.make_grid(2, 2)
la, a = step(grid)
row = (0, 1) if rank < 2 else (2, 3)
assert mesh.ROUTES[row] == mesh.SIGNALLED, mesh.ROUTES
assert halo.halo_rank_signalled.launches > 0
assert halo.halo_all_to_all_ranks.collective_exchanges == len(cases)
mesh.leave_distributed(created)
ls, s = step(None)
np.testing.assert_allclose(la, ls, rtol=1e-5)
for n, v in w0.items():
    ua, us = v.double() - a[n].double(), v.double() - s[n].double()
    assert float((ua - us).abs().max()) <= 1e-4 * float(us.abs().max()), n
print("rank", rank, "hosts ok")
"""


@pytest.mark.cuda
def test_edge_hosts_on_four_cards(cuda_device):
    """Four ranks reported as two hosts of two, a card each (each host
    sees its own two of the first four visible cards): edge=4 over both
    hosts exchanges by the COLLECTIVE route (NCCL's all_to_all_single),
    bit for bit the plain version, with no window and no launch of K1;
    the (dp=2, edge=2) grid with a host a row keeps the signalled form in
    its rows and takes the stacked layout's step."""
    four_cards()
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    cards = vis.split(",") if vis else \
        [str(i) for i in range(torch.cuda.device_count())]
    worker = "import numpy as np\nfrom lp_gnn_tpu_torch.data.dataset " \
        "import BipartiteGraph\n" + inspect.getsource(port_graph) + \
        HOSTS_WORKER
    run_rank_workers(worker, 4, env_of=lambda r: {
        "CUDA_VISIBLE_DEVICES": ",".join(cards[2 * (r // 2):
                                               2 * (r // 2) + 2])})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh, d", [(37, 8), (37, 1024), (30_056, 8),
                                   (30_056, 1024)])   # and the bench halo
def test_halo_rank_signalled_streams_on_card(cuda_device, bh, d, dtype):
    """The signalled kernel of 4 ranks as 4 streams of one process on one
    card (``halo.StreamRanks``, a quarter wave a launch): three exchanges
    over the two windows, the second with one stream held back before its
    launch, each bit for bit the stacked plain version's; one launch a
    rank an exchange, no abort recorded."""
    k = 4
    gen = torch.Generator(device="cpu").manual_seed(bh + d)
    stacked = torch.randn(k, k * bh, d, generator=gen).to(dtype).to(
        cuda_device)
    want = halo_all_to_all_plain(stacked)
    streams = [torch.cuda.Stream() for _ in range(k)]
    ranks = thalo.StreamRanks(stacked.device, k, stacked[0].nbytes, streams)
    cur = torch.cuda.current_stream()
    before = thalo.halo_rank_signalled.launches
    for i in range(3):
        for q, s in enumerate(streams):
            s.wait_stream(cur)
            if i == 1 and q == 2:
                with torch.cuda.stream(s):
                    torch.cuda._sleep(2_000_000)
        out = ranks.exchange(list(stacked.unbind(0)))
        for s in streams:
            cur.wait_stream(s)
        torch.cuda.synchronize()
        assert all(torch.equal(o, want[q]) for q, o in enumerate(out)), i
    assert thalo.halo_rank_signalled.launches == before + 3 * k
    assert ranks.status() == 0


@pytest.mark.cuda
def test_halo_all_to_all_ranks_refuses_too_many_shards(cuda_device):
    """Above MAX_SHARDS ranks the wrapper raises before it launches, and
    the kernel's entry refuses the launch itself (cudaErrorInvalidValue)."""
    x = torch.zeros(65 * 2, 8, device=cuda_device)
    table = (thalo.ctypes.c_void_p * 65)(*[x.data_ptr()] * 65)
    with pytest.raises(ValueError, match="at most 64"):
        thalo._check_launch(65, 2 * 8 * 4, True)
    rc = thalo._rank_lib("lp_halo_a2a_rank")(
        x.data_ptr(), table, 0, 65, 2 * 8 * 4,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    assert rc == 1   # cudaErrorInvalidValue


def dist_case(device, k, gen=False):
    g = port_graph(np.random.RandomState(k), m=600, n=900, e=6000)
    dg = tEP.partition_graph(g, k, halo=True)
    return tEP.DistGraphTensors.from_partition(dg, make_mesh(k, device),
                                               gen=gen)


def launch_counts():
    return {"spmm_csr": tspmm.spmm_csr.launches,
            "gather_rows": gather_rows.launches,
            "halo_all_to_all": halo_all_to_all.launches,
            "gen_agg_fwd": gen_agg.gen_agg_fwd.launches,
            "gen_agg_bwd": gen_agg.gen_agg_bwd.launches,
            "gen_lse_merge": gen_agg.gen_lse_merge.launches}


def launched_since(before):
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_halo_pair_backward_on_card(cuda_device, k):
    """The halo pair's backwards on the card: HaloGather's is one stacked
    K1 and K owner-side SpMMs, no gather; HaloReduce's one gather. Both
    against the CPU's (fp32: the gather and K1 exact, the SpMM's sums rtol
    1e-5 atol 1e-6)."""
    on = {dev: dist_case(dev, k) for dev in ("cpu", cuda_device)}
    rng = np.random.RandomState(k)
    dgt = on["cpu"]
    real = torch.stack([torch.diff(m.ptr) > 0 for m in dgt.halo_c2v])
    ct_h = torch.from_numpy(rng.randn(k, dgt.nh, 16).astype(np.float32)) * \
        real[..., None]
    ct_r = torch.from_numpy(rng.randn(k * dgt.ns, 16).astype(np.float32))
    right = torch.from_numpy(rng.randn(k * dgt.ns, 16).astype(np.float32))
    parts = torch.from_numpy(rng.randn(k, dgt.nh, 16).astype(np.float32))
    grads = {}
    for dev, d in on.items():
        r = right.to(dev).detach().requires_grad_()
        p = parts.to(dev).detach().requires_grad_()
        hg, hr = tEP.HaloGather.apply(r, d), tEP.HaloReduce.apply(p, d)
        before = launch_counts()
        hg.backward(ct_h.to(dev))
        n_gather = launched_since(before)
        before = launch_counts()
        hr.backward(ct_r.to(dev))
        n_reduce = launched_since(before)
        grads[str(dev)] = (r.grad.cpu(), p.grad.cpu())
        if dev != "cpu":
            torch.cuda.synchronize()
            assert n_gather == {"halo_all_to_all": 1, "spmm_csr": k}
            assert n_reduce == {"gather_rows": 1}
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(card[1], cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.bfloat16, 16),
                                     (torch.float32, 3), (torch.bfloat16, 3)])
def test_dist_gen_l2r_on_card(cuda_device, dtype, d):
    """DistGenL2R on the card (K gen_agg_fwd, one K1 of the padded (aggr,
    lse) rows, one gen_lse_merge; backward one gather, K gen_agg_bwd, K
    SpMMs) against the CPU's plain versions on the same inputs: aggr and
    the gradients at the GEN kernels' tolerances (fp32 rtol 1e-4 atol
    1e-5; bf16 rtol 2^-6 atol 2^-5)."""
    k = 4
    on = {dev: dist_case(dev, k, gen=True) for dev in ("cpu", cuda_device)}
    rng = np.random.RandomState(d)
    x = torch.from_numpy(rng.randn(k * on["cpu"].ms, d).astype(np.float32))
    w, b = (torch.from_numpy(rng.randn(d).astype(np.float32)) for _ in "wb")
    t = torch.tensor(1.2)
    g = torch.from_numpy(rng.randn(k * on["cpu"].ns, d).astype(np.float32))
    got = {}
    for dev, dgt in on.items():
        leaves = [v.to(dev).to(dtype).detach().requires_grad_()
                  for v in (x, w, b, t)]
        before = launch_counts()
        aggr = dist_gen.DistGenL2R.apply(*leaves, dgt)
        fwd = launched_since(before)
        before = launch_counts()
        aggr.backward(g.to(dev))
        bwd = launched_since(before)
        got[str(dev)] = [aggr.detach().cpu()] + [v.grad.float().cpu()
                                                  for v in leaves]
        if dev != "cpu":
            torch.cuda.synchronize()
            assert fwd == {"gen_agg_fwd": k, "halo_all_to_all": 1,
                           "gen_lse_merge": 1}
            assert bwd == {"gather_rows": 1, "gen_agg_bwd": k, "spmm_csr": k}
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2 ** -6, 2 ** -5)
    for name, a, b_ in zip(("aggr", "dx", "dw", "db", "dt"),
                           got[str(cuda_device)], got["cpu"]):
        scale = b_.abs().max().clamp(min=1)
        torch.testing.assert_close(a / scale, b_ / scale, rtol=rtol, atol=atol,
                                   msg=name)


@pytest.mark.cuda
def test_dist_conv_step_on_card(cuda_device):
    """A dist GCN_FC and GENDeeper forward and backward on the card (K=4,
    fp32) against the CPU from the same weights: logits and gradients
    within the SpMM's fp32 tolerance of the scale (rtol 1e-4, atol 1e-5 of
    the largest)."""
    from lp_gnn_tpu_torch.models.gcn import build_model
    from lp_gnn_tpu_torch.train.losses import balanced
    g = port_graph(np.random.RandomState(9), m=600, n=900, e=6000)
    dg = tEP.partition_graph(g, 4, halo=True)
    for arch in ("GCN_FC(8,8,hids=32,depth=3,dp=0.0)",
                 "GENDeeper(8,8,hids=16,depth=3)"):
        out = {}
        for dev in ("cpu", cuda_device):
            model = build_model(arch, generator=torch.Generator().manual_seed(1))
            model = model.to(dev).train()
            model.dp = 0.0
            dgt = tEP.dist_tensors(model, dg, make_mesh(4, dev), input_agg=True)
            lc, lv = tEP.dist_forward(model, dgt)
            balanced(lc, lv, dgt.y_s, dgt.y_t, dgt.cons_mask,
                     dgt.vars_mask).backward()
            out[str(dev)] = [lc.detach().cpu(), lv.detach().cpu()] + [
                p.grad.cpu() for p in model.parameters()]
        for a, b_ in zip(out[str(cuda_device)], out["cpu"]):
            scale = b_.abs().max().clamp(min=1e-30)
            torch.testing.assert_close(a / scale, b_ / scale, rtol=1e-4,
                                       atol=1e-5, msg=arch)


# ---------------------------------------------- K1's device form on the card
BENCH_BH = 30_056   # the bench graph's halo width at K=4 (chip_smoke.py)


def sync_all(devs) -> None:
    """Wait for every device in ``devs`` (``torch.cuda.synchronize()``
    waits for the current one only)."""
    for dv in set(devs):
        torch.cuda.synchronize(dv)


def card_devices(k: int, distinct: bool) -> list[torch.device]:
    """K devices: cuda:0 repeated, or K distinct cards (skipped with fewer
    cards visible)."""
    if not distinct:
        return [torch.device("cuda", 0)] * k
    have = torch.cuda.device_count()
    if have < k:
        pytest.skip(f"needs {k} cards for {k} distinct devices, has {have}")
    return [torch.device("cuda", i) for i in range(k)]


def device_form_case(devs, bh, d, dtype, seed):
    """K buffers of (K*bh, d), buffer k made on shard k's stream on its
    device, the streams and the stacked tensor they copy (on cuda:0)."""
    k = len(devs)
    stacked, _ = stacked_halo(k, bh, d, dtype, devs[0], seed=seed)
    streams = [torch.cuda.Stream(device=dv) for dv in devs]
    bufs = []
    for q, (dv, s) in enumerate(zip(devs, streams)):
        s.wait_stream(torch.cuda.current_stream(devs[0]))
        with torch.cuda.device(dv), torch.cuda.stream(s):
            bufs.append(stacked[q].to(dv, copy=True))
    return stacked, bufs, streams


@pytest.mark.cuda
@pytest.mark.parametrize("distinct", [False, True],
                         ids=["repeated", "distinct"])
@pytest.mark.parametrize("d", [8, 1024])
@pytest.mark.parametrize("k", [2, 4])
def test_halo_all_to_all_devices_on_card(cuda_device, k, d, distinct):
    """K1's device form at the bench graph's halo (Bh = 30,056, bf16), one
    stream a shard, on cuda:0 repeated K times or on K distinct cards: bit
    for bit the stacked form's exchange of the same blocks, K launches an
    exchange, each output on its buffer's device; its backward is the same
    exchange."""
    devs = card_devices(k, distinct)
    stacked, bufs, streams = device_form_case(devs, BENCH_BH, d,
                                              torch.bfloat16, seed=k + d)
    want = halo_all_to_all(stacked)
    before = thalo.halo_all_to_all_devices.launches
    out = thalo.halo_all_to_all_devices(bufs, streams)
    assert thalo.halo_all_to_all_devices.launches == before + k
    for s in streams:
        torch.cuda.current_stream(s.device).wait_stream(s)
    sync_all(devs)
    for q, o in enumerate(out):
        assert o.device == devs[q]
        assert torch.equal(o.to(devs[0]), want[q])
    if distinct:
        assert {(a, b) for a in range(k) for b in range(k) if a != b} <= \
            thalo.PEER_PAIRS


@pytest.mark.cuda
@pytest.mark.parametrize("distinct", [False, True],
                         ids=["repeated", "distinct"])
@pytest.mark.parametrize("k", [2, 4])
def test_halo_all_to_all_devices_stress_on_card(cuda_device, k, distinct):
    """64 device-form exchanges back to back, two shapes in turn, every
    input made anew on its shard's stream and every output dropped after
    a check on its own stream, with torch.cuda._sleep holding back every
    other shard's stream before its write: each result bit for bit the
    plain exchange's (mismatches counted on the card, read once at the
    end). An output handed out again by the caching allocator while a
    delayed writer still stores into it would show here."""
    devs = card_devices(k, distinct)
    shapes = [(257, 64), (96, 200)]
    cases = [device_form_case(devs, bh, d, torch.float32, seed=i)
             for i, (bh, d) in enumerate(shapes)]
    wants = [[w.to(devs[q]) for q, w in enumerate(halo_all_to_all_plain(
        list(stacked.unbind(0))))] for stacked, _, _ in cases]
    streams = cases[0][2]
    bad = [torch.zeros((), dtype=torch.int64, device=dv) for dv in devs]
    sync_all(devs)
    for i in range(64):
        _, srcs, _ = cases[i % 2]
        bufs = []
        for q, (dv, s) in enumerate(zip(devs, streams)):
            with torch.cuda.device(dv), torch.cuda.stream(s):
                if q % 2 == i % 2:
                    torch.cuda._sleep(1_000_000)
                bufs.append(srcs[q].clone())
        out = thalo.halo_all_to_all_devices(bufs, streams)
        for q, (dv, s) in enumerate(zip(devs, streams)):
            with torch.cuda.device(dv), torch.cuda.stream(s):
                bad[q] += (out[q] != wants[i % 2][q]).sum()
        del out, bufs
    sync_all(devs)
    assert [int(b) for b in bad] == [0] * k


@pytest.mark.cuda
def test_device_form_redesign_exact_on_card(cuda_device, monkeypatch):
    """K1's device form on one card (cuda:0 four times, a stream a shard,
    then one stream for all four): bit for bit the stacked form's exchange
    at the bench halo (D=8) and at a block of no whole number of kernel
    tiles, K launches an exchange, one plan for the (devices, streams)
    whatever the shapes; with DEVICE_TIMING each source's launch timed
    (positive, the span on one card at least the longest launch); and the
    kernel's pair entry (lp_halo_pairs, what the link probe of
    chip_smoke.py launches) copying any list of blocks exactly."""
    monkeypatch.setattr(thalo, "DEVICE_TIMING", True)
    devs = [torch.device("cuda", 0)] * 4
    for bh, d in ((BENCH_BH, 8), (1001, 40)):
        stacked, bufs, streams = device_form_case(devs, bh, d,
                                                  torch.bfloat16, seed=d)
        want = halo_all_to_all(stacked)
        for ss in (streams, [torch.cuda.current_stream()] * 4):
            plans = len(thalo._DEVICE_PLANS)
            before = thalo.halo_all_to_all_devices.launches
            out = thalo.halo_all_to_all_devices(bufs, ss)
            assert thalo.halo_all_to_all_devices.launches == before + 4
            times = thalo.device_form_times(bufs, ss)
            for s in ss:
                torch.cuda.current_stream().wait_stream(s)
            torch.cuda.synchronize()
            assert all(torch.equal(o, want[q]) for q, o in enumerate(out))
            assert thalo.halo_all_to_all_devices(bufs, ss) is not None
            assert len(thalo._DEVICE_PLANS) <= plans + 1
            assert min(times["per_source_ms"]) > 0
            assert times["span_ms"] >= max(times["per_source_ms"]) - 1e-3
    # three pairs of one source, the first two round robin, as the probe
    src = torch.randn(3, 4096, 24, device=cuda_device).to(torch.bfloat16)
    dst = torch.zeros_like(src)
    vp = ctypes.c_void_p * 3
    rc = thalo._rank_lib("lp_halo_pairs")(
        vp(*(s.data_ptr() for s in src)), vp(*(t.data_ptr() for t in dst)),
        2, 3, src[0].nbytes, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(dst, src)


# ------------------------------------------- the (dp, edge) grid of devices
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["GCN_FC(8,8,hids=32,depth=3,dp=0.0)",
                                  "GENDeeper(8,8,hids=16,depth=3)"])
def test_grid_step_on_card(cuda_device, arch):
    """One dp x edge step on the (dp=2, edge=2) grid of devices, cell (d, e)
    on cuda:(2d + e) mod the cards visible, a thread and stream a cell
    (fp32, SGD at lr 1, dropout 0), against the stacked layout's step over
    the whole batch on cuda:0: the loss rtol 1e-5, each tensor's update
    within 1e-4 of its largest; and bit for bit the same step when taken
    again from the same state on a fresh grid."""
    from lp_gnn_tpu_torch.models.gcn import build_model
    from lp_gnn_tpu_torch.parallel import combined
    from lp_gnn_tpu_torch.parallel.dp import rank_block
    from lp_gnn_tpu_torch.parallel.mesh import (make_device_grid,
                                                shard_devices)
    from lp_gnn_tpu_torch.train import trainer
    from lp_gnn_tpu_torch.train.losses import balanced
    graphs = [port_graph(np.random.RandomState(20 + i), m=600, n=900,
                         e=6000) for i in range(2)]
    parts = combined.partition_batch(graphs, 2, halo=True)
    w0 = build_model(arch, generator=torch.Generator().manual_seed(3)
                     ).state_dict()
    devs = shard_devices(torch.device("cuda", 0), 4)

    def step(grid):
        model = build_model(arch)
        model.load_state_dict(w0)
        model.dp = 0.0
        model = model.to(cuda_device)
        opt = trainer.make_optimizer(model.parameters(), "sgd", 1.0)
        if grid is None:
            dgs = [tEP.dist_tensors(model, p, make_mesh(2, cuda_device),
                                    input_agg=True) for p in parts]
        else:
            dgs = [[tEP.dist_tensors(model, parts[i], row, input_agg=True)
                    for i in rank_block([0, 1], 2, d)]
                   for d, row in enumerate(grid.rows)]
        loss = combined.dp_edge_train_step(
            model, opt, dgs, balanced,
            torch.Generator(device=cuda_device).manual_seed(1), grid)
        sync_all(devs)
        return float(loss), {k: v.detach().cpu()
                             for k, v in model.state_dict().items()}

    la, a = step(make_device_grid(2, 2, devs))
    lb, b = step(make_device_grid(2, 2, devs))
    ls, s = step(None)
    assert la == lb and all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_allclose(la, ls, rtol=1e-5)
    for k, v in w0.items():
        ua, us = v.double() - a[k].double(), v.double() - s[k].double()
        assert float((ua - us).abs().max()) <= \
            1e-4 * float(us.abs().max()), k
