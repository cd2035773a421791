"""Edge shards on their own ranks (lp_gnn_tpu_torch/parallel: the rank form
of K1 in halo.py, EdgeMesh over a group in mesh.py, the rank route of the
halo pair, the losses' psums and the gradient sum in edge_partition.py; the
trainer's and pred_basis' --mesh_shape edge=K under the LP_GNN_DIST_*
contract) against the JAX package's edge axis on the conftest's virtual CPU
devices and against the port's one-process stacked path, on the CPU, where
K1's rank form runs its plain version (all_to_all_single over gloo).

The ranks are processes of this module (``python -m
tests.test_torch_edge_ranks MODE PAYLOAD``), which imports JAX only inside
the tests: a session of K ranks computes every rank-side case at once and
writes each rank's results to a file; the tests read them. Inputs are made
with numpy from a seed: a graph of 150 x 250 nodes and 1,200 edges, width
16, depth 3.

Tolerances, stated where they are used:
- K1's rank form: bit for bit (a copy), against JAX's pallas_all_to_all in
  interpret mode and the stacked plain version;
- fp32 logits: against JAX's dist_apply atol DIST_ATOL (JAX's own
  dist-vs-single tolerance, tests/test_parallel.py:43), GENDeeper's
  GEN_ATOL (tests/test_torch_dist_zoo.py's); against the stacked path atol
  STACKED_ATOL (the same sums; the linears run over one shard's rows
  instead of all K shards', which may round otherwise);
- one dist SGD step at lr 1, dropout 0: the loss rtol 1e-5 and each
  tensor's update within UPDATE_RTOL of its largest, against JAX's
  make_dist_train_step (GraphConv archs) and against the stacked
  dist_train_step (tests/test_torch_dist_train.py's rule); every rank's
  weights equal;
- a whole run (Adam, 2 epochs) against the one-process run: each step's
  loss rtol 1e-5, the final params atol RUN_ATOL, val/acc equal; the
  bases that pred_basis writes equal, byte for byte.
"""
import ctypes
import filecmp
import json
import logging
import os
import os.path as osp
import subprocess
import sys
import time
import types
import zlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.infer.predict import mesh_from_cfg
from lp_gnn_tpu_torch.models.convert import load_checkpoint
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel import halo as thalo
from lp_gnn_tpu_torch.parallel.mesh import (EdgeMesh, init_distributed,
                                            leave_distributed, make_mesh,
                                            world_and_rank)
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import LOSS_REGISTRY
from tests.test_torch_kernels import port_graph

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
GRAPH = dict(m=150, n=250, e=1200)
DIST_ATOL = 5e-4
GEN_ATOL = 5e-5
STACKED_ATOL = 1e-5
UPDATE_RTOL = 1e-4
RUN_ATOL = 1e-6
ARCH = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
GEN = "GENDeeper(8,8,hids=16,depth=3)"
ZOO = ["GCN(8,8,hids=16)", "GCNDeeper(8,8,hids=16,depth=3)"]
FWD_ARCHS = [ARCH, *ZOO, GEN, "GCNRand()"]
# (arch, loss) of the one-step cases a session of K ranks takes
STEPS = {2: [(ARCH, loss) for loss in LOSS_REGISTRY]
         + [(a, "balanced") for a in (*ZOO, GEN, "GCNRand()")],
         4: [(ARCH, "balanced"), (GEN, "balanced")]}
A2A = dict(bh=6, f=5)
# exchanges of the host-card run, two shapes in turn
EXCHANGES = 16


def graph(k):
    return port_graph(np.random.RandomState(60 + k), **GRAPH)


def a2a_inputs(k):
    rng = np.random.RandomState(40 + k)
    shape = (k, k * A2A["bh"], A2A["f"])
    return rng.randn(*shape).astype(np.float32), \
        rng.randn(*shape).astype(np.float32)


def weights_path(tmp, arch):
    return osp.join(tmp, f"w0_{arch.split('(')[0]}.pt")


def fake_solve(mps, method=1, basis_in_path=None, basis_out_path=None,
               log_path=None):
    """A stand-in for the solver in the warm gate: the iterations a CRC of
    the basis it is given, so that two gates agree only on equal bases."""
    with open(basis_in_path, "rb") as f:
        niter = zlib.crc32(f.read()) % 97
    return types.SimpleNamespace(niter=niter, basis_rejected=False,
                                 status="Optimal")


def no_dropout(model):
    """dropout 0 in the models whose rate is fixed (GCN, GCNDeeper)."""
    if hasattr(model, "dp"):
        model.dp = 0.0
    return model


# -------------------------------------- K1's flags, with the card on the host
def u64(addr):
    return ctypes.c_uint64.from_address(addr)


class HostCard:
    """The C entries of the rank form's transport (``ops/csrc/halo_a2a.cu``)
    on the host, for ``halo._exchange`` over CPU tensors in rank processes:
    each rank's window pair a ``multiprocessing.shared_memory`` block (its
    name the IPC handle), the status word a host word, the kernels
    ``memmove``s and the stream operations done at once (a wait polls the
    word). The protocol (epochs, windows, the flags, the abort) is the
    wrapper's own; what the card adds, the order of its streams, is not
    here. ``hold`` sleeps that many seconds inside every copy-out, so that
    the peers run ahead of this rank. Use as a context: it patches
    ``halo`` and ``torch.cuda`` of this process and restores them."""

    def __init__(self, hold=0.0):
        self.hold, self.shm, self.keep = hold, {}, {}

    # the entries, called as halo calls the loaded library's
    def a2a_rank(self, src, table, me, k, block_bytes, stream):
        if src % 16:
            return 1   # cudaErrorInvalidValue, as the entry refuses it
        for q in range(k):
            ctypes.memmove(table[q] + me * block_bytes, src + q * block_bytes,
                           block_bytes)
        return 0

    def copy_out(self, src, dst, nbytes, arrival, k, status, stream):
        time.sleep(self.hold * np.random.rand())
        for p in range(k):
            v = u64(arrival + 8 * p).value
            if v & thalo.ABORT:
                if not u64(status).value:
                    u64(status).value = v
                break
        ctypes.memmove(dst, src, nbytes)
        return 0

    def wait(self, words, n, value, stream):
        """Until each word is at least ``value`` as the card compares:
        cyclically, (int64)(word - value) >= 0."""
        t0 = time.monotonic()
        for i in range(n):
            while (u64(words[i]).value - value) % 2 ** 64 >= 2 ** 63:
                assert time.monotonic() - t0 < 60, "a flag wait hung"
                time.sleep(1e-4)
        return 0

    def write(self, words, n, value, stream=None):
        for i in range(n):
            u64(words[i]).value = value
        return 0

    def alloc(self, nbytes, ptr, handle):
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(create=True, size=nbytes)
        view = ctypes.c_char.from_buffer(shm.buf)
        ptr._obj.value = ctypes.addressof(view)
        self.shm[ptr._obj.value] = (shm, view, True)
        handle.raw = shm.name.encode().ljust(len(handle.raw), b"\0")
        return 0

    def open(self, handle, ptr):
        from multiprocessing import shared_memory
        from multiprocessing import resource_tracker
        shm = shared_memory.SharedMemory(name=handle.rstrip(b"\0").decode())
        # the owner unlinks it; this process's tracker must not
        resource_tracker.unregister(shm._name, "shared_memory")
        view = ctypes.c_char.from_buffer(shm.buf)
        ptr._obj.value = ctypes.addressof(view)
        self.shm[ptr._obj.value] = (shm, view, False)
        return 0

    def release(self, addr):
        shm, view, own = self.shm.pop(addr)
        del view
        shm.close()
        if own:
            shm.unlink()
        return 0

    def register(self, host, nbytes, dev):
        """A flag header reaches the host's card at its host address."""
        dev._obj.value = host
        return 0

    def status_alloc(self, host, dev):
        word = ctypes.c_uint64(0)
        self.keep[ctypes.addressof(word)] = word
        host._obj.value = dev._obj.value = ctypes.addressof(word)
        return 0

    def lib(self, name):
        return {"lp_halo_a2a_rank": self.a2a_rank,
                "lp_halo_copy_out": self.copy_out,
                "lp_halo_flags_wait": self.wait,
                "lp_halo_flags_write": self.write,
                "lp_halo_flags_register": self.register,
                "lp_halo_flags_unregister": lambda host: 0,
                "lp_halo_ipc_handle_bytes": lambda: 64,
                "lp_halo_window_alloc": self.alloc,
                "lp_halo_window_open": self.open,
                "lp_halo_window_close": self.release,
                "lp_halo_window_free": self.release,
                "lp_halo_status_alloc": self.status_alloc,
                "lp_halo_status_free": self.status_free}[name]

    def status_free(self, addr):
        del self.keep[addr]
        return 0

    def __enter__(self):
        import contextlib
        self.saved = [(thalo, n, getattr(thalo, n)) for n in (
            "_rank_lib", "launch_on", "_record")] + [
            (torch.cuda, n, getattr(torch.cuda, n)) for n in (
                "device", "synchronize")]
        thalo._rank_lib = self.lib
        thalo.launch_on = lambda dev, fn, *a: fn(*a, 0)
        thalo._record = lambda dev, win, w: None
        torch.cuda.device = lambda dev: contextlib.nullcontext()
        torch.cuda.synchronize = lambda *a: None
        return self

    def __exit__(self, *exc):
        thalo.release_windows()
        for mod, name, v in self.saved:
            setattr(mod, name, v)


def host_exchanges(k, me):
    """K1's rank form through ``halo._exchange`` on a ``HostCard``: (1)
    EXCHANGES exchanges of two alternating shapes, rank 0 held back in its
    copy-outs, each result against the stacked plain version; (2) rank
    k-1's buffer misaligned (its launch refused at the entry) at the
    first exchange of a new pair: the error each rank raises within three
    exchanges."""
    rng = np.random.RandomState(70 + k)
    shapes = [(7, 8), (3, 4)]
    bufs = [torch.from_numpy(rng.randn(k, k * bh, f).astype(np.float32))
            for bh, f in shapes for _ in range(EXCHANGES // 2)]
    order = [bufs[i // 2 + (i % 2) * (EXCHANGES // 2)]
             for i in range(EXCHANGES)]
    got = {"exact": [], "epochs": []}
    with HostCard(hold=0.01 if me == 0 else 0.0):
        for x in order:
            out = thalo._exchange(x[me].clone(), None)
            got["exact"].append(torch.equal(
                out, thalo.halo_all_to_all_plain(x)[me]))
        got["epochs"] = [w.epoch for w in thalo._WINDOWS.values()]
    errors = []
    with HostCard():
        x = order[0][me].clone()
        if me == k - 1:
            flat = torch.zeros(x.numel() + 1)
            x = flat[1:].view(x.shape).copy_(x)   # 4 bytes off 16
        for _ in range(3):
            try:
                thalo._exchange(x, None)
            except RuntimeError as e:
                errors.append(str(e))
                break
    got["abort"] = errors
    return got


# ------------------------------------------------------------ the rank side
def rank_session(payload):
    """Every rank-side case of a session of K ranks: the rank form of K1
    and its backward, each arch's dist forward (eval) and the logits
    gathered to rank 0, one dist step a case, and the refusals that need a
    group; writes this rank's results."""
    k, me = world_and_rank()
    tmp = payload["dir"]
    mesh = make_mesh(k, "cpu", dist.group.WORLD)
    bufs, cts = a2a_inputs(k)
    out = {"a2a": thalo.halo_all_to_all_ranks(torch.from_numpy(bufs[me]))}
    x = torch.from_numpy(bufs[me]).requires_grad_()
    thalo.HaloAllToAllRanks.apply(x, dist.group.WORLD).backward(
        torch.from_numpy(cts[me]))
    out["a2a_grad"] = x.grad
    g = graph(k)
    dg = tEP.partition_graph(g, k, halo=True)
    for arch in FWD_ARCHS:
        model = build_model(arch)
        model.load_state_dict(torch.load(weights_path(tmp, arch)))
        model.eval()
        with torch.no_grad():
            local = tEP.dist_apply(model, dg, mesh)
            out[f"fwd/{arch}"] = tEP.gather_logits(*local, mesh)
        out[f"fwd_local/{arch}"] = local
    for arch, loss in STEPS[k]:
        model = no_dropout(build_model(arch))
        model.load_state_dict(torch.load(weights_path(tmp, arch)))
        opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
        dgt = tEP.dist_tensors(model, dg, mesh, input_agg=True)
        step_loss = tEP.dist_train_step(model, opt, dgt, LOSS_REGISTRY[loss],
                                        torch.Generator().manual_seed(1))
        out[f"step/{arch}/{loss}"] = (float(step_loss), model.state_dict())
    refused = {}
    try:
        mesh_from_cfg(Config(mesh_shape=f"edge={2 * k}"), torch.device("cpu"))
    except ValueError as e:
        refused["edge_vs_world"] = str(e)
    out["refused"] = refused
    out["host_card"] = host_exchanges(k, me)
    out["launches"] = thalo.halo_all_to_all.launches
    torch.save(out, osp.join(tmp, f"rank{me}.pt"))


def rank_run(payload):
    """One rank of the whole-run case: the train entry point, then the
    pred_basis entry point (a new group, on a port of its own; the warm
    gate's solver ``fake_solve``), each with a log prefix of the rank's
    own; each dist step's loss recorded. The metrics go to metrics.jsonl
    alone: importing TensorBoard takes seconds here and is not what the
    test holds."""
    from lp_gnn_tpu_torch import pipeline
    from lp_gnn_tpu_torch.pred_basis import main as pred_main
    from lp_gnn_tpu_torch.train.__main__ import main as train_main
    sys.modules["torch.utils.tensorboard"] = None
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    losses = []
    real = ttrainer.dist_train_step

    def recorded(*a, **kw):
        loss = real(*a, **kw)
        losses.append(float(loss))
        return loss

    ttrainer.dist_train_step = recorded
    train_main([*payload["train"], "--log_prefix",
                osp.join(payload["dir"], f"rank{rank}")])
    os.environ["LP_GNN_DIST_COORD"] = payload["coord2"]
    pipeline.solve_backend = lambda cfg: fake_solve
    pred_main([*payload["pred"], "--log_prefix",
               osp.join(payload["dir"], f"pred{rank}")])
    with open(osp.join(payload["dir"], f"losses_rank{rank}.json"), "w") as f:
        json.dump(losses, f)


def run_ranks(mode, payload, tmp_path, k, timeout=300):
    """``k`` processes of this module in ``mode``, joined over gloo by the
    LP_GNN_DIST_* contract; each rank's exit code 0 asserted."""
    from tests.test_torch_dp import free_port
    path = str(tmp_path / f"{mode}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    port = free_port()
    procs = []
    for rank in range(k):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   LP_GNN_DIST_COORD=f"localhost:{port}",
                   LP_GNN_DIST_NPROCS=str(k), LP_GNN_DIST_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_edge_ranks", mode, path],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0] * k, \
        "\n".join(o[-3000:] for o in outs)
    return outs


def main(argv):
    mode, path = argv
    with open(path) as f:
        payload = json.load(f)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if mode == "run":   # the entry points join and leave the group
        return rank_run(payload)
    _, created = init_distributed(torch.device("cpu"))
    try:
        rank_session(payload)
    finally:
        leave_distributed(created)


# ------------------------------------------------------------- the JAX side
def jax_params(arch):
    import jax
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    return jax.tree.map(np.asarray, jax_build_model(arch).init(
        jax.random.PRNGKey(0)))


def jax_mesh(k):
    import jax
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    return jax_make_mesh({"edge": k}, devices=jax.devices()[:k])


def jax_partition(k):
    from lp_gnn_tpu.data.batching import pad_graph
    from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
    from lp_gnn_tpu.parallel import edge_partition as jEP
    g = graph(k)
    jg = JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")})
    return jEP.partition_graph(pad_graph(jg), k, halo=True)


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def session(request, tmp_path_factory):
    """The JAX weights of every arch (as port state_dicts), one session of
    K ranks over them; returns (K, the weights, each rank's results)."""
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    k = request.param
    tmp = tmp_path_factory.mktemp(f"edge_ranks_k{k}")
    weights = {}
    for arch in FWD_ARCHS:
        weights[arch] = build_model(arch).state_dict() \
            if arch == "GCNRand()" else \
            state_dict_from_jax_params(jax_params(arch))
        torch.save(weights[arch], weights_path(str(tmp), arch))
    run_ranks("session", {"dir": str(tmp)}, tmp, k)
    ranks = [torch.load(osp.join(tmp, f"rank{r}.pt")) for r in range(k)]
    return k, weights, ranks


# ------------------------------------------------------------------- tests
def test_rank_exchange_matches_jax_pallas_and_plain(session):
    """K1's rank form over K gloo ranks, each rank's buffer against JAX's
    pallas_all_to_all in interpret mode (the remote-copy kernel,
    parallel/pallas_halo.py:69) under shard_map and against the stacked
    plain version, bit for bit; its backward is the same exchange of the
    cotangent; no stacked launch."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from lp_gnn_tpu.parallel.pallas_halo import pallas_all_to_all
    k, _, ranks = session
    bufs, cts = a2a_inputs(k)
    fn = jax.jit(shard_map(
        lambda a: pallas_all_to_all(a[0], "edge", k, A2A["bh"])[None],
        mesh=jax_mesh(k), in_specs=P("edge"), out_specs=P("edge"),
        check_vma=False))
    want = np.asarray(fn(bufs))
    plain = thalo.halo_all_to_all_plain(torch.from_numpy(bufs))
    grad = thalo.halo_all_to_all_plain(torch.from_numpy(cts))
    for me, r in enumerate(ranks):
        np.testing.assert_array_equal(r["a2a"].numpy(), want[me])
        assert torch.equal(r["a2a"], plain[me])
        assert torch.equal(r["a2a_grad"], grad[me])
        assert r["launches"] == 0


def stacked_logits(model, k):
    g = graph(k)
    with torch.no_grad():
        lc, lv = tEP.dist_apply(model,
                                tEP.partition_graph(g, k, halo=True),
                                make_mesh(k, "cpu"))
    return lc, lv


@pytest.mark.parametrize("arch", FWD_ARCHS)
def test_rank_forward_matches_jax_and_stacked(session, arch):
    """Each arch's dist forward with shard k on rank k (fp32, eval): the
    logits rank 0 gathers against JAX's dist_apply at edge=K with the same
    weights (DIST_ATOL) and against the one-process stacked path
    (STACKED_ATOL), each rank's own rows those of its shard; the other
    ranks hold no gathered logits. GCNRand draws from the port's
    generator, not JAX's keys: against JAX its knowledge mask (the signs),
    against the stacked path exactly."""
    import jax
    from lp_gnn_tpu.parallel import edge_partition as jEP
    k, weights, ranks = session
    g = graph(k)
    model = build_model(arch)
    model.load_state_dict(weights[arch])
    model.eval()
    lc, lv = stacked_logits(model, k)
    got_c, got_v = ranks[0][f"fwd/{arch}"]
    assert all(r[f"fwd/{arch}"] == (None, None) for r in ranks[1:])
    params = jax_params(arch)
    dg = jax_partition(k)
    jc, jv = jax.jit(lambda p, d: jEP.dist_apply(
        p, d, jax_mesh(k), arch=arch.split("(")[0]))(params, dg)
    want = np.concatenate([np.asarray(jc)[:g.ncons], np.asarray(jv)[:g.nvars]])
    got = np.concatenate([got_c[:g.ncons].numpy(), got_v[:g.nvars].numpy()])
    stacked = np.concatenate([lc[:g.ncons].numpy(), lv[:g.nvars].numpy()])
    ms, ns = got_c.shape[0] // k, got_v.shape[0] // k
    for me, r in enumerate(ranks):
        loc_c, loc_v = r[f"fwd_local/{arch}"]
        assert torch.equal(loc_c, got_c[me * ms:(me + 1) * ms])
        assert torch.equal(loc_v, got_v[me * ns:(me + 1) * ns])
    if arch == "GCNRand()":
        np.testing.assert_array_equal(got < 0, want < 0)
        np.testing.assert_array_equal(got, stacked)
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GEN_ATOL if arch == GEN else DIST_ATOL)
    np.testing.assert_allclose(got, stacked, rtol=0, atol=STACKED_ATOL)


def update_rel(w0, a, b):
    from tests.test_torch_dist_train import update_rel as rel
    return rel(w0, a, b)


def stacked_step(arch, loss, w0, k):
    model = no_dropout(build_model(arch))
    model.load_state_dict(w0)
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
    dgt = tEP.dist_tensors(model,
                           tEP.partition_graph(graph(k), k, halo=True),
                           make_mesh(k, "cpu"), input_agg=True)
    got = tEP.dist_train_step(model, opt, dgt, LOSS_REGISTRY[loss],
                              torch.Generator().manual_seed(1))
    return float(got), model.state_dict()


def jax_step(arch, loss, k):
    import jax
    import jax.numpy as jnp
    from lp_gnn_tpu.parallel import edge_partition as jEP
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    params = jax_params(arch)
    optimizer = jtrainer.make_optimizer("sgd")
    step = jax.jit(jEP.make_dist_train_step(
        loss, optimizer, jax_mesh(k), dp_rate=0.0, arch=arch.split("(")[0]))
    p1, _, jloss = step(params, optimizer.init(params), jax_partition(k),
                        jax.random.PRNGKey(1), jnp.float32(1.0))
    return float(jloss), state_dict_from_jax_params(
        jax.tree.map(np.asarray, p1))


def test_rank_train_steps_match_jax_and_stacked(session):
    """One dist step a case with shard k on rank k (SGD at lr 1, dropout
    0, fp32), from the JAX weights: the loss (the whole graph's, on every
    rank) and every tensor's update against JAX's make_dist_train_step at
    edge=K and against the stacked dist_train_step; every rank ends with
    the same weights. GCNRand's weights depend on no gradient: its loss
    against the stacked step's only (its logits are the port's draws).
    GENDeeper against the stacked step (which tests/test_torch_dist_zoo.py
    holds to the single-card step): the owners' merge over ranks."""
    k, weights, ranks = session
    for arch, loss in STEPS[k]:
        key = f"step/{arch}/{loss}"
        got_loss, got = ranks[0][key]
        for r in ranks[1:]:
            assert r[key][0] == got_loss
            assert all(torch.equal(v, r[key][1][n]) for n, v in got.items())
        w0 = weights[arch]
        s_loss, stacked = stacked_step(arch, loss, w0, k)
        np.testing.assert_allclose(got_loss, s_loss, rtol=1e-5, err_msg=key)
        if arch == "GCNRand()":
            assert all(torch.equal(v, w0[n]) for n, v in got.items())
            continue
        assert update_rel(w0, got, stacked) < UPDATE_RTOL, key
        if arch == GEN:
            continue
        j_loss, want = jax_step(arch, loss, k)
        np.testing.assert_allclose(got_loss, j_loss, rtol=1e-5, err_msg=key)
        assert update_rel(w0, got, want) < UPDATE_RTOL, key


def test_refusals_over_ranks(session):
    """An edge mesh whose K is not the group's size raises."""
    _, _, ranks = session
    for r in ranks:
        assert "one shard a rank" in r["refused"]["edge_vs_world"]


def test_rank_launch_failure_raises_on_every_rank(session):
    """K1's rank form ordered by flags alone (halo._exchange over the
    HostCard, the card's entries on the host): EXCHANGES exchanges of two
    shapes in turn, one rank held back, each result bit for bit the
    plain version's, the window pair's epoch counting them; then one
    rank's launch refused at the entry (a misaligned buffer,
    cudaErrorInvalidValue): every rank raises within three exchanges and
    names that rank and its CUDA error (none waits for the one that
    failed)."""
    k, _, ranks = session
    for r in ranks:
        got = r["host_card"]
        assert got["exact"] == [True] * EXCHANGES
        assert got["epochs"] == [EXCHANGES]
        assert len(got["abort"]) == 1
        assert f"rank {k - 1}'s launch failed: CUDA error 1" in \
            got["abort"][0]


def test_refusals_in_one_process():
    """Several devices in one process, once refused as queue item 7c's
    rest: an edge mesh over a device list builds, one shard a device, and
    K1's list form over buffers on distinct devices takes the device form
    (which names itself refusing a device neither cuda nor cpu;
    tests/test_torch_edge_devices.py runs the layout); a world of dp*E
    ranks (the grid) and --graph_batch over edge ranks, once refused as
    queue item 7f, take their batch shapes (tests/test_torch_grid.py runs
    them)."""
    mesh = make_mesh(2, [torch.device("cpu")] * 2)
    assert isinstance(mesh, EdgeMesh) and mesh.per_device and \
        mesh.shards == (0, 1)
    with pytest.raises(ValueError, match="halo_all_to_all_devices runs on"):
        thalo.halo_all_to_all([torch.zeros(4, 4),
                               torch.zeros(4, 4, device="meta")])
    assert ttrainer.batch_shape(Config(mesh_shape="dp=2,edge=2"), 4) == \
        (2, 1)
    assert ttrainer.batch_shape(Config(mesh_shape="edge=2", graph_batch=2),
                                2) == (1, 2)
    assert ttrainer.batch_shape(Config(mesh_shape="edge=2"), 2) == (1, 1)


def test_rank_windows_grow_and_stay_one(monkeypatch):
    """The rank form's receive windows: one pair a (group, device), the two
    windows grown together to the largest exchange so far and never kept
    beside a smaller pair, so a run over many graph sizes holds one pair
    of the largest (its flag header and two windows). The CUDA allocation
    and the peers' mapping are stubbed; their order is what is held (the
    old pair dropped before the new one is made)."""
    calls = []

    def make(nbytes, group, dev):
        calls.append(("make", nbytes))
        return thalo._Window(0, nbytes, [1], group, [2], [3])

    def drop(key, failing=False):
        calls.append(("drop", thalo._WINDOWS.pop(key).nbytes))

    monkeypatch.setattr(thalo, "_WINDOWS", {})
    monkeypatch.setattr(thalo, "_make_window", make)
    monkeypatch.setattr(thalo, "_drop_window", drop)
    dev, other = torch.device("cuda", 0), torch.device("cuda", 1)
    for nbytes in (4096, 1024, 8192, 4096, 8192, 2048):
        w = thalo._window(nbytes, None, dev)
        assert w.nbytes >= nbytes and len(thalo._WINDOWS) == 1
        assert w.data(0, 1) - w.data(0, 0) == w.nbytes
    assert calls == [("make", 4096), ("drop", 4096), ("make", 8192)]
    assert thalo.window_bytes() == 2 * 8192
    thalo._window(64, None, other)   # another device: a pair of its own
    assert thalo.window_bytes() == 2 * (8192 + 64)
    thalo.release_windows()
    assert thalo._WINDOWS == {} and thalo.window_bytes() == 0


REAL_DROP = thalo._drop_window


class FakeEvent:
    """A CUDA event whose completion the test sets."""

    def __init__(self, done=True):
        self.done = done

    def query(self):
        return self.done


@pytest.fixture
def flag_calls(monkeypatch):
    """halo._exchange as rank 0 of 2 on stand-in entries that record each
    call (name, the words' addresses or the window's table, the value)
    and do nothing; the pair's two allocations and flag headers, as the
    card reaches them, at 1 MiB and 2 MiB, the headers as the host does
    two host arrays, its status word a host word; each window's event a
    FakeEvent, all done unless the test says otherwise. Returns (calls,
    status word, pair maker's count, events made)."""
    calls, made, events, keep = [], [], [], []
    status = ctypes.c_uint64(0)

    def lib(name):
        def fn(*a):
            if name in ("lp_halo_flags_wait", "lp_halo_flags_write",
                        "lp_halo_flags_poison"):
                words, n, value = a[:3]
                calls.append((name, [words[i] for i in range(n)], value))
            elif name == "lp_halo_a2a_rank":
                calls.append((name, list(a[1]), None))
            else:
                calls.append((name, a[0], None))
            return 0
        return fn

    def make(nbytes, group, dev):
        made.append(nbytes)
        keep[:] = [(ctypes.c_uint64 * (thalo.HEADER_BYTES // 8))()
                   for _ in range(2)]
        return thalo._Window(0, nbytes, [1 << 20, 2 << 20], group,
                             [1 << 20, 2 << 20],
                             [ctypes.addressof(h) for h in keep],
                             ctypes.addressof(status),
                             ctypes.addressof(status))

    def record(dev, win, w):
        win.events[w] = FakeEvent()
        events.append(win.events[w])

    monkeypatch.setattr(thalo, "_WINDOWS", {})
    monkeypatch.setattr(thalo, "_rank_lib", lib)
    monkeypatch.setattr(thalo, "launch_on", lambda dev, fn, *a: fn(*a, 0))
    monkeypatch.setattr(thalo, "_group_shape", lambda group: (2, 0))
    monkeypatch.setattr(thalo, "_make_window", make)
    monkeypatch.setattr(thalo, "_drop_window",
                        lambda key, failing=False: thalo._WINDOWS.pop(key))
    monkeypatch.setattr(thalo, "_record", record)
    monkeypatch.setattr(thalo.dist, "group",
                        types.SimpleNamespace(WORLD="world"))
    return calls, status, made, events


def test_rank_exchange_epochs_and_windows_follow_the_order(flag_calls):
    """Exchange e of a pair runs over window e mod 2: the stream waits
    for the peer's done word of that window at e - 2 (from e = 3), writes
    its blocks into the window's table, announces arrival e in the peer's
    header, waits for the peer's arrival e in its own, copies its window
    out and writes done e into the peer's header. Two counted launches an
    exchange; a larger exchange makes a new pair, whose epochs start at 1
    again."""
    calls, _, made, _ = flag_calls
    before = thalo.halo_all_to_all_ranks.launches
    small, big = torch.zeros(2 * 4, 8), torch.zeros(2 * 8, 8)
    own, peer = 1 << 20, 2 << 20
    for e in range(1, 6):
        del calls[:]
        thalo._exchange(small, None)
        win = thalo._WINDOWS[("world", None)]
        w = e % 2
        want = [("lp_halo_flags_wait", [thalo._done(own, w, 1)], e - 2)] \
            if e > 2 else []
        want += [
            ("lp_halo_a2a_rank", [win.data(0, w), win.data(1, w)], None),
            ("lp_halo_flags_write", [thalo._arrival(peer, w, 0)], e),
            ("lp_halo_flags_wait", [thalo._arrival(own, w, 1)], e),
            ("lp_halo_copy_out", win.data(0, w), None),
            ("lp_halo_flags_write", [thalo._done(peer, w, 0)], e)]
        assert calls == want, e
        assert win.epoch == e
    assert thalo.halo_all_to_all_ranks.launches == before + 10
    thalo._exchange(big, None)
    assert made == [small.nbytes, big.nbytes]
    assert thalo._WINDOWS[("world", None)].epoch == 1
    assert thalo._arrival(own, 0, 0) == own
    assert thalo._arrival(own, 1, 0) - own == thalo.HEADER_BYTES // 2
    assert thalo._done(own, 1, 63) + 8 - own == thalo.HEADER_BYTES


def test_rank_exchange_deadline_raises(flag_calls, monkeypatch):
    """Before exchange e the host polls exchange e - 2's copy-out; past
    DEADLINE_S it aborts (its abort word, DEADLINE_CODE, into the peer's
    flags of both windows on its stream, and into its own header by host
    stores) and raises, naming the exchange."""
    calls, _, _, events = flag_calls
    monkeypatch.setattr(thalo, "DEADLINE_S", 0.05)
    x = torch.zeros(2 * 4, 8)
    thalo._exchange(x, None)
    thalo._exchange(x, None)
    events[0].done = False
    del calls[:]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exchange 1 of the group did "
                                           "not complete within 0.05 s"):
        thalo._exchange(x, None)
    assert 0.05 <= time.monotonic() - t0 < 5
    word = thalo.ABORT | thalo.DEADLINE_CODE
    peer = 2 << 20
    assert calls == [("lp_halo_flags_write", [
        a for w in (0, 1) for a in (thalo._arrival(peer, w, 0),
                                    thalo._done(peer, w, 0))], word)]
    # nothing of exchange 3 issued; the own header holds the word
    win = thalo._WINDOWS[("world", None)]
    assert [u64(a).value for a in win.own_host] == [word] * 8
    assert win.broken
    events[0].done = True
    thalo._exchange(x, None)   # a broken pair is made anew
    assert thalo._WINDOWS[("world", None)].epoch == 1


def test_rank_exchange_abort_in_status_raises(flag_calls):
    """An abort word that a copy-out recorded in the status word makes the
    next exchange raise, naming the rank and its CUDA error, after it
    passed the word on to the peer."""
    calls, status, _, _ = flag_calls
    x = torch.zeros(2 * 4, 8)
    thalo._exchange(x, None)
    word = thalo.ABORT | 3 << 32 | 700
    status.value = word
    del calls[:]
    with pytest.raises(RuntimeError, match="on rank 0: the exchange was "
                       "aborted: rank 3's launch failed: CUDA error 700"):
        thalo._exchange(x, None)
    assert [c[0] for c in calls] == ["lp_halo_flags_write"]
    assert calls[0][2] == word
    win = thalo._WINDOWS[("world", None)]
    assert [u64(a).value for a in win.own_host] == [word] * 8


@pytest.fixture
def real_release(flag_calls, monkeypatch):
    """flag_calls with the real ``_drop_window``, the card's device and
    synchronise stubbed, no process group."""
    import contextlib
    monkeypatch.setattr(thalo, "_drop_window", REAL_DROP)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(thalo.dist, "is_initialized", lambda: False)
    return flag_calls


FREED = ["lp_halo_window_close", "lp_halo_window_free", "lp_halo_status_free"]


def test_rank_windows_release_waits_until_the_deadline(real_release,
                                                      monkeypatch):
    """Releasing a pair waits for its last copy-outs until DEADLINE_S; past
    it (a peer that died leaves this rank's stream waiting) it stores its
    abort word into its own flags, so that its stream's waits end, and
    into the peers', frees the pair and raises; a pair whose copy-outs
    completed is freed without a word."""
    calls, _, _, events = real_release
    monkeypatch.setattr(thalo, "DEADLINE_S", 0.05)
    x = torch.zeros(2 * 4, 8)
    thalo._exchange(x, None)
    del calls[:]
    thalo.release_windows()
    assert [c[0] for c in calls] == FREED
    thalo._exchange(x, None)
    win = thalo._WINDOWS[("world", None)]
    events[-1].done = False
    del calls[:]
    with pytest.raises(RuntimeError, match="the last exchanges did not "
                       "complete within 0.05 s of the windows' release"):
        thalo.release_windows()
    word = thalo.ABORT | thalo.DEADLINE_CODE
    assert [u64(a).value for a in win.own_host] == [word] * 8
    assert [u64(a).value for a in win.abort_host] == [word] * 4
    assert [c[0] for c in calls] == FREED
    assert thalo._WINDOWS == {}


def test_rank_windows_release_on_an_error_tells_the_peers(real_release):
    """Releasing the pairs while an error is on its way out (inside a
    ``finally`` as it propagates: a step raised outside the exchanges)
    first writes this rank's abort word, LEFT_CODE, into the peers' flags,
    which ends a peer's wait for an exchange this rank will not make; the
    peer's next exchange names it. Released with no error, or after an
    exchange of its own raised (the peers were told then), it writes
    nothing."""
    calls, status, _, _ = real_release
    x = torch.zeros(2 * 4, 8)
    thalo._exchange(x, None)
    win = thalo._WINDOWS[("world", None)]
    del calls[:]
    with pytest.raises(MemoryError):
        try:
            raise MemoryError("a step outside the exchanges")
        finally:
            thalo.release_windows()
    word = thalo.ABORT | thalo.LEFT_CODE
    assert [u64(a).value for a in win.abort_host] == [word] * 4
    assert [c[0] for c in calls] == FREED
    thalo._exchange(x, None)
    status.value = thalo.ABORT | 1 << 32 | thalo.LEFT_CODE
    with pytest.raises(RuntimeError, match="on rank 0: the exchange was "
                       "aborted: rank 1 left the exchanges on an error "
                       "outside them"):
        thalo._exchange(x, None)
    win = thalo._WINDOWS[("world", None)]
    told = [u64(a).value for a in win.abort_host]
    del calls[:]
    with pytest.raises(MemoryError):
        try:
            raise MemoryError("after the exchange's own error")
        finally:
            thalo.release_windows()
    assert [c[0] for c in calls] == FREED
    assert [u64(a).value for a in win.abort_host] == told


def test_rank_watchdog_ends_a_wait_past_the_deadline(real_release,
                                                    monkeypatch):
    """The watchdog's look (``halo._watch_once``): a pair whose newest
    copy-out is still unfinished DEADLINE_S after it was enqueued (a peer
    died between exchanges, and a synchronise of this rank's would wait
    for it) gets this rank's deadline word in its own flags, once, by
    host stores alone; the next exchange raises and names it. A copy-out
    that completed, or that is younger than the deadline, is left
    alone."""
    calls, status, _, events = real_release
    monkeypatch.setattr(thalo, "DEADLINE_S", 30.0)
    x = torch.zeros(2 * 4, 8)
    thalo._exchange(x, None)
    win = thalo._WINDOWS[("world", None)]
    del calls[:]
    thalo._watch_once()   # done
    events[-1].done = False
    thalo._watch_once()   # not done, but enqueued just now
    assert calls == [] and not win.poisoned
    win.enqueued_at -= 31.0
    thalo._watch_once()
    word = thalo.ABORT | thalo.DEADLINE_CODE
    assert calls == []   # host stores alone
    assert [u64(a).value for a in win.own_host] == [word] * 8
    assert win.poisoned
    u64(win.own_host[0]).value = 0
    thalo._watch_once()
    assert u64(win.own_host[0]).value == 0   # once
    status.value = word   # what the released copy-out records
    events[-1].done = True
    with pytest.raises(RuntimeError, match="rank 0 waited past the 30.0 s "
                                           "deadline for an exchange"):
        thalo._exchange(x, None)


# ---------------------------------------------------------- whole entries
@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """3 tiny LPs (2 train, 1 val), each with a cold solve's log (the
    warm gate reads its iterations), and a seeded checkpoint."""
    from tests.test_torch_sampling import write_family
    root = tmp_path_factory.mktemp("edge_ranks_run")
    prefix = root / "lp-dataset"
    write_family(str(prefix / "fam" / "highs-inp_tgt"),
                 [(30, 50, 300), (24, 40, 260), (36, 44, 320)], seed=13)
    logs = prefix / "fam" / "log" / "highs-no-bas"
    logs.mkdir(parents=True)
    for i in range(3):
        (logs / f"lp_{i}.log").write_text(
            f"Solution time =  0.5 sec.  Iterations = {40 + i}\n")
    ckpt = str(root / "seeded.pth")
    torch.save(build_model(ARCH, generator=torch.Generator().manual_seed(5))
               .state_dict(), ckpt)
    return str(prefix), ckpt


def test_run_and_serve_over_ranks_equal_one_process(family, tmp_path,
                                                    monkeypatch):
    """The train and pred_basis entry points with --mesh_shape edge=2
    --edge_num_thresh 0 over 2 ranks against the same in one process (all
    shards stacked): the same steps' losses, val/acc and final params
    (Adam, 2 epochs); the same .bas files and the same warm gate (rank 0
    decides and tells rank 1, LP by LP: one LP run, then the stop, with
    --warm_gate_k 1 --warm_gate_kmax 1); rank 1 writes nothing."""
    from lp_gnn_tpu_torch.pipeline import stage_pred_basis
    from tests.test_torch_dp import free_port
    from tests.test_torch_train import metrics
    data_prefix, ckpt = family
    common = ["--dataset", "fam", "--data_prefix", data_prefix,
              "--device", "cpu", "--arch", ARCH, "--mesh_shape", "edge=2",
              "--edge_num_thresh", "0"]
    train = [*common, "--exp_nm", "run", "--epochs", "2", "--eval_every",
             "2", "--seed", "3"]
    pred = [*common, "--exp_nm", "pred", "--load_from", ckpt, "--split",
            "val", "--warm_gate", "auto", "--warm_gate_k", "1",
            "--warm_gate_kmax", "1"]
    run_ranks("run", {"dir": str(tmp_path), "train": train, "pred": pred,
                      "coord2": f"localhost:{free_port()}"}, tmp_path, 2)
    assert not osp.exists(tmp_path / "rank1") and \
        not osp.exists(tmp_path / "pred1")
    with open(tmp_path / "losses_rank0.json") as f:
        rank_losses = json.load(f)
    with open(tmp_path / "losses_rank1.json") as f:
        assert json.load(f) == rank_losses

    seen = []
    real = ttrainer.dist_train_step

    def recorded(*a, **kw):
        loss = real(*a, **kw)
        seen.append(float(loss))
        return loss

    monkeypatch.setattr(ttrainer, "dist_train_step", recorded)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from lp_gnn_tpu_torch.config import parse_args
    one = parse_args([*train, "--log_prefix", str(tmp_path / "one")])
    path = ttrainer.run_exp(one)
    assert len(seen) == len(rank_losses) == 4
    np.testing.assert_allclose(rank_losses, seen, rtol=1e-5)
    ranks_dir = tmp_path / "rank0" / "run"
    assert metrics(str(ranks_dir))["val/acc"] == \
        metrics(one.log_dir)["val/acc"]
    want = load_checkpoint(path)
    for name, v in load_checkpoint(str(ranks_dir / "mdl.pth")).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    from lp_gnn_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "solve_backend", lambda cfg: fake_solve)
    one_pred = parse_args([*pred, "--log_prefix", str(tmp_path / "one_pred")])
    out_dir = stage_pred_basis(one_pred)
    with open(osp.join(one_pred.log_dir, "warm_gate.json")) as f:
        want_gate = json.load(f)
    with open(tmp_path / "pred0" / "pred" / "warm_gate.json") as f:
        got_gate = json.load(f)
    assert got_gate == want_gate and want_gate["k"] == 1
    names = sorted(os.listdir(out_dir))
    got_dir = tmp_path / "pred0" / "pred" / osp.basename(out_dir)
    assert names and sorted(os.listdir(got_dir)) == names
    assert all(filecmp.cmp(got_dir / n, osp.join(out_dir, n), shallow=False)
               for n in names)


if __name__ == "__main__":
    main(sys.argv[1:])
