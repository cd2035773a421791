"""Edge shards on several devices of one process (lp_gnn_tpu_torch/parallel:
EdgeMesh with one shard a device in mesh.py, the shards' threads, joint
nodes and parameter broadcast in shard_threads.py, K1's device form in
halo.py, the device ops of the halo and all-gather pairs in
edge_partition.py and of GEN's l2r in dist_gen.py; the trainer's and
pred_basis' --mesh_shape edge=K with K cards visible) against the JAX
package's edge axis on the conftest's virtual CPU devices and against the
port's stacked path, on the CPU, with the device list repeating the CPU:
every shard's forward runs in its own thread, and K1's device form runs its
plain version. Inputs are made with numpy from a seed: the graph of
tests/test_torch_edge_ranks.py (150 x 250 nodes, 1,200 edges), width 16,
depth 3; ``ops/spmm.py sddmm`` against JAX's on one input.

Tolerances, stated where they are used:
- K1's device form: bit for bit (a copy), against JAX's pallas_all_to_all
  in interpret mode and the stacked plain version, its gradient through a
  joint node too;
- fp32 logits: against JAX's dist_apply atol DIST_ATOL (JAX's own
  dist-vs-single tolerance, tests/test_parallel.py:43), GENDeeper's
  GEN_ATOL; against the stacked path atol STACKED_ATOL (the linears run
  over one shard's rows instead of all K shards', which may round
  otherwise); GCNRand as tests/test_torch_edge_ranks.py holds it;
- one dist SGD step at lr 1, dropout 0: the loss rtol 1e-5 and each
  tensor's update within UPDATE_RTOL of its largest, against JAX's
  make_dist_train_step (GraphConv archs) and the stacked step;
- train (Adam, 2 epochs) and pred_basis through the API against the same
  on the stacked layout: the losses rtol 1e-5, the final params atol
  RUN_ATOL, the .bas files byte for byte;
- sddmm: atol 1e-5 in fp32.
"""
import filecmp
import json
import os
import os.path as osp
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch.config import Config, parse_args
from lp_gnn_tpu_torch.infer.predict import mesh_from_cfg
from lp_gnn_tpu_torch.models.convert import load_checkpoint
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.ops.spmm import sddmm
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel import halo as thalo
from lp_gnn_tpu_torch.parallel import mesh as tmesh
from lp_gnn_tpu_torch.parallel import shard_threads
from lp_gnn_tpu_torch.parallel.mesh import (EdgeMesh, make_mesh,
                                            one_shard_a_device)
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import LOSS_REGISTRY
from tests.test_torch_edge_ranks import (ARCH, FWD_ARCHS, GEN, a2a_inputs,
                                         fake_solve, graph, jax_mesh,
                                         jax_params, no_dropout, update_rel)
from tests.test_torch_edge_ranks import family  # noqa: F401 (a fixture)

torch.set_num_threads(2)

DIST_ATOL = 5e-4
GEN_ATOL = 5e-5
STACKED_ATOL = 1e-5
UPDATE_RTOL = 1e-4
RUN_ATOL = 1e-6
ZOO = [a for a in FWD_ARCHS if a not in (ARCH, GEN, "GCNRand()")]
# (arch, loss, K) of the one-step cases
STEPS = [(ARCH, loss, 2) for loss in LOSS_REGISTRY] + \
    [(a, "balanced", 2) for a in (*ZOO, GEN, "GCNRand()")] + \
    [(ARCH, "balanced", 4), (GEN, "balanced", 4)]


def devices_mesh(k):
    return make_mesh(k, ["cpu"] * k)


def halo_of(arch):
    return arch != "GCNRand()"


def jax_partition(k, halo):
    from lp_gnn_tpu.data.batching import pad_graph
    from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
    from lp_gnn_tpu.parallel import edge_partition as jEP
    g = graph(k)
    jg = JaxGraph(**{f: getattr(g, f) for f in (
        "row", "col", "val", "c_feas", "v_feas", "y_s", "y_t")})
    return jEP.partition_graph(pad_graph(jg), k, halo=halo)


def port_model(arch):
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    model = build_model(arch)
    if arch != "GCNRand()":
        model.load_state_dict(state_dict_from_jax_params(jax_params(arch)))
    return model


def logits(model, k, mesh, halo):
    g = graph(k)
    with torch.no_grad():
        lc, lv = tEP.dist_apply(model, tEP.partition_graph(g, k, halo=halo),
                                mesh)
    return np.concatenate([lc[:g.ncons].numpy(), lv[:g.nvars].numpy()])


# ------------------------------------------------------------- the layout
def test_mesh_layouts_and_the_entry_points_choice(monkeypatch):
    """make_mesh over a device list holds every shard here, one a device
    (the list may repeat one), the lead first; the entry points take that
    layout in one process where K cards are visible (JAX's rule; none
    here, so the rule is patched in), also under dp=D,edge=E, whose
    serving JAX lays over the first K devices whatever dp says."""
    mesh = devices_mesh(3)
    assert mesh.per_device and mesh.group is None and mesh.n_shards == 3
    assert mesh.shards == (0, 1, 2) and mesh.device == torch.device("cpu")
    m1 = mesh.member(1)
    assert m1.n_shards == 3 and m1.shards == (1,) and not m1.per_device
    assert not make_mesh(3, "cpu").per_device
    with pytest.raises(ValueError, match="without their threads"):
        EdgeMesh((torch.device("cpu"), torch.device("meta")))
    with pytest.raises(ValueError, match="over 2 devices"):
        make_mesh(3, ["cpu", "cpu"])
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert not mesh_from_cfg(Config(mesh_shape="edge=2"), cpu).per_device
    assert not one_shard_a_device(cpu, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert one_shard_a_device(card, 2) and not one_shard_a_device(card, 4)
    assert not one_shard_a_device(cpu, 2)
    monkeypatch.setattr(tmesh, "one_shard_a_device", lambda d, k: True)
    got = mesh_from_cfg(Config(mesh_shape="edge=2"), cpu)
    assert got.per_device and got.devices == (cpu, cpu)
    got = mesh_from_cfg(Config(mesh_shape="dp=2,edge=2"), cpu)
    assert got.per_device and got.devices == (cpu, cpu)


class _Exchange:
    """K1's device form alone as a joint node: its backward is the same
    exchange of the cotangents."""

    @staticmethod
    def forward(threads, metas, ins):
        return tEP._a2a_devices([x for x, in ins], threads), ()

    @staticmethod
    def backward(threads, metas, saved, grads, needs):
        return [(g,) for g in tEP._a2a_devices(grads, threads)]


@pytest.mark.parametrize("k", [2, 4])
def test_device_exchange_matches_jax_pallas_and_stacked(k):
    """K1's device form over K buffers on (repeated) devices against JAX's
    pallas_all_to_all in interpret mode under shard_map and against the
    stacked plain version, bit for bit; the list form with the same
    buffers; as one joint node of K shard threads, its gradient the same
    exchange of the cotangents; no kernel launch on the CPU."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from lp_gnn_tpu.parallel.pallas_halo import pallas_all_to_all
    from tests.test_torch_edge_ranks import A2A
    bufs, cts = a2a_inputs(k)
    fn = jax.jit(shard_map(
        lambda a: pallas_all_to_all(a[0], "edge", k, A2A["bh"])[None],
        mesh=jax_mesh(k), in_specs=P("edge"), out_specs=P("edge"),
        check_vma=False))
    want = np.asarray(fn(bufs))
    plain = thalo.halo_all_to_all_plain(torch.from_numpy(bufs))
    launches = thalo.halo_all_to_all_devices.launches
    got = thalo.halo_all_to_all_devices(list(torch.from_numpy(bufs)))
    mesh = devices_mesh(k)
    xs = [torch.from_numpy(b).requires_grad_() for b in bufs]
    outs = mesh.threads.run(lambda s: shard_threads.joint(
        _Exchange, mesh.threads.member(s), "exchange", (xs[s],), None))
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    grad = thalo.halo_all_to_all_plain(torch.from_numpy(cts))
    for q in range(k):
        np.testing.assert_array_equal(got[q].numpy(), want[q])
        assert torch.equal(got[q], plain[q])
        assert torch.equal(outs[q], plain[q])
        assert torch.equal(xs[q].grad, grad[q])
    assert thalo.halo_all_to_all_devices.launches == launches


def test_list_form_over_distinct_devices_takes_the_device_form(monkeypatch):
    """halo_all_to_all of buffers on two distinct devices hands them to the
    device form (which refuses a device that is neither cuda nor cpu)."""
    seen = []
    real = thalo.halo_all_to_all_devices
    monkeypatch.setattr(thalo, "halo_all_to_all_devices",
                        lambda bufs: seen.append(len(bufs)) or real(bufs))
    with pytest.raises(ValueError, match="cuda or cpu"):
        thalo.halo_all_to_all([torch.zeros(4, 4),
                               torch.zeros(4, 4, device="meta")])
    assert seen == [2]


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", FWD_ARCHS)
@pytest.mark.parametrize("k", [2, 4])
def test_forward_matches_jax_and_stacked(arch, k):
    """Each arch's dist forward with one shard a device (fp32, eval), on
    the halo route and on the all-gather route (GCNRand: the all-gather
    partition alone, as the trainer and predict take it), against JAX's
    dist_apply at edge=K with the same weights (DIST_ATOL, GENDeeper
    GEN_ATOL) and against the stacked path (STACKED_ATOL). GCNRand draws
    from the port's generator, not JAX's keys: against JAX its knowledge
    mask (the signs), against the stacked path exactly."""
    import jax
    from lp_gnn_tpu.parallel import edge_partition as jEP
    model = port_model(arch).eval()
    params = None if arch == "GCNRand()" else jax_params(arch)
    for halo in ((True, False) if halo_of(arch) else (False,)):
        got = logits(model, k, devices_mesh(k), halo)
        stacked = logits(model, k, make_mesh(k, "cpu"), halo)
        g = graph(k)
        jc, jv = jax.jit(lambda p, d: jEP.dist_apply(
            p, d, jax_mesh(k), arch=arch.split("(")[0]))(
            params or jax_params(arch), jax_partition(k, halo))
        want = np.concatenate([np.asarray(jc)[:g.ncons],
                               np.asarray(jv)[:g.nvars]])
        if arch == "GCNRand()":
            np.testing.assert_array_equal(got < 0, want < 0)
            np.testing.assert_array_equal(got, stacked)
            continue
        np.testing.assert_allclose(got, want, rtol=0, err_msg=str(halo),
                                   atol=GEN_ATOL if arch == GEN else DIST_ATOL)
        np.testing.assert_allclose(got, stacked, rtol=0, atol=STACKED_ATOL,
                                   err_msg=str(halo))


def test_serving_builds_no_graph_in_any_thread(monkeypatch):
    """A forward under no_grad and one under inference_mode: every shard's
    thread runs with grad off (inference mode on in the second), and the
    logits carry no graph; in training mode each thread has grad on."""
    modes = []
    real = tEP._dist_aggs

    def seen(dg, left, right):
        modes.append((dg.shards, torch.is_grad_enabled(),
                      torch.is_inference_mode_enabled(), left.requires_grad))
        return real(dg, left, right)

    monkeypatch.setattr(tEP, "_dist_aggs", seen)
    model = port_model(ARCH).eval()
    dgt = tEP.dist_tensors(model, tEP.partition_graph(graph(4), 4, halo=True),
                           devices_mesh(4))
    for ctx, inf in ((torch.no_grad, False), (torch.inference_mode, True)):
        modes.clear()
        with ctx():
            lc, lv = tEP.dist_forward(model, dgt)
        assert not lc.requires_grad and lc.grad_fn is None
        assert sorted(m[0] for m in modes) == [(s,) for s in range(4)
                                               for _ in range(2)]
        assert all(m[1:] == (False, inf, False) for m in modes)
    modes.clear()
    lc, lv = tEP.dist_forward(model.train(), dgt)
    assert lc.requires_grad and all(m[1] and not m[2] for m in modes)


def test_a_shard_that_raises_reaches_the_caller(monkeypatch):
    """Shard 2 raises in its first conv, before any collective: the other
    shards, waiting at the first collective, are released at once (well
    within MEET_S), the caller gets shard 2's error and no shard thread is
    left alive; the mesh serves again afterwards."""
    real = tEP._dist_aggs

    def boom(dg, left, right):
        if dg.shards == (2,):
            time.sleep(0.2)   # the others wait at the collective first
            raise ValueError("shard 2 fails")
        return real(dg, left, right)

    model = port_model(ARCH).eval()
    dgt = tEP.dist_tensors(model, tEP.partition_graph(graph(4), 4, halo=True),
                           devices_mesh(4))
    monkeypatch.setattr(tEP, "_dist_aggs", boom)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 2 fails"):
        with torch.no_grad():
            tEP.dist_forward(model, dgt)
    assert time.monotonic() - t0 < 10 < shard_threads.MEET_S
    assert not [t for t in threading.enumerate()
                if t.name.startswith("edge-shard")]
    monkeypatch.setattr(tEP, "_dist_aggs", real)
    with torch.no_grad():
        again = tEP.dist_forward(model, dgt)
        want = tEP.dist_apply(model, tEP.partition_graph(graph(4), 4,
                                                         halo=True),
                              make_mesh(4, "cpu"))
    assert all(torch.allclose(a, b, rtol=0, atol=STACKED_ATOL)
               for a, b in zip(again, want))


def test_a_collective_that_a_shard_never_reaches_raises():
    """Shards that meet at a collective which another shard, already
    ended, never reaches raise at once, and those that meet at different
    collectives raise: no thread waits."""
    threads = make_mesh(3, ["cpu"] * 3).threads

    def work(k):
        if k == 0:
            return None
        time.sleep(0.2)
        return threads.meet(k, "a", k, lambda vs: vs)

    with pytest.raises(RuntimeError, match="never will|finished while"):
        threads.run(work)
    with pytest.raises(RuntimeError, match="different collectives"):
        threads.run(lambda k: threads.meet(k, k % 2, k, lambda vs: vs))
    assert threads.run(lambda k: threads.meet(k, "b", k, lambda vs: vs[::-1])) \
        == [2, 1, 0]


def test_one_shard_thread_runs_at_a_time():
    """Between two collectives only the shard holding the turn runs: the
    stretches the K threads spend outside the rendezvous never overlap,
    and every shard still gets every collective's result."""
    threads = make_mesh(4, ["cpu"] * 4).threads
    spans, running = [], []
    lock = threading.Lock()

    def stretch(k):
        with lock:
            running.append(k)
            spans.append(len(running))
        time.sleep(0.01)
        with lock:
            running.remove(k)

    def work(k):
        got = []
        for tag in range(3):
            stretch(k)
            got.append(threads.meet(k, tag, k, lambda vs: [sum(vs)] * 4))
        stretch(k)
        return got

    assert threads.run(work) == [[6, 6, 6]] * 4
    assert len(spans) == 16 and max(spans) == 1


# ------------------------------------------------------------------- steps
def port_step(arch, loss, k, mesh):
    model = no_dropout(port_model(arch))
    w0 = {n: v.clone() for n, v in model.state_dict().items()}
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
    dgt = tEP.dist_tensors(model, tEP.partition_graph(
        graph(k), k, halo=halo_of(arch)), mesh, input_agg=True)
    got = tEP.dist_train_step(model, opt, dgt, LOSS_REGISTRY[loss],
                              torch.Generator().manual_seed(1))
    return float(got), w0, model.state_dict()


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
    p1, _, jloss = step(params, optimizer.init(params),
                        jax_partition(k, True), jax.random.PRNGKey(1),
                        jnp.float32(1.0))
    return float(jloss), state_dict_from_jax_params(
        jax.tree.map(np.asarray, p1))


@pytest.mark.parametrize("arch,loss,k", STEPS,
                         ids=[f"{a.split('(')[0]}-{l}-k{k}"
                              for a, l, k in STEPS])
def test_step_matches_jax_and_stacked(arch, loss, k):
    """One dist step with one shard a device (SGD at lr 1, dropout 0,
    fp32), from the JAX weights: the loss and every tensor's update
    against the stacked dist_train_step and, for the GraphConv archs,
    against JAX's make_dist_train_step at edge=K. GCNRand's weights depend
    on no gradient; GENDeeper against the stacked step (which
    tests/test_torch_dist_zoo.py holds to the single-card step)."""
    got_loss, w0, got = port_step(arch, loss, k, devices_mesh(k))
    s_loss, _, stacked = port_step(arch, loss, k, make_mesh(k, "cpu"))
    np.testing.assert_allclose(got_loss, s_loss, rtol=1e-5)
    if arch == "GCNRand()":
        assert all(torch.equal(v, w0[n]) for n, v in got.items())
        return
    assert update_rel(w0, got, stacked) < UPDATE_RTOL
    if arch == GEN:
        return
    j_loss, want = jax_step(arch, loss, k)
    np.testing.assert_allclose(got_loss, j_loss, rtol=1e-5)
    assert update_rel(w0, got, want) < UPDATE_RTOL


def test_dropout_draws_as_the_rank_path():
    """In training mode shard k's dropout draws from a generator seeded
    with one draw of the run's generator plus k, as shard k's rank does
    (dp.step_generator): the logits equal the one-shard forwards run with
    those generators, and the run's generator moves by one draw."""
    model = build_model("GCN_FC(8,8,hids=16,depth=3)",
                        generator=torch.Generator().manual_seed(2)).train()
    mesh = devices_mesh(2)
    dgt = tEP.dist_tensors(model, tEP.partition_graph(graph(2), 2, halo=True),
                           mesh)
    gen = torch.Generator().manual_seed(5)
    got = tEP.dist_forward(model, dgt, gen)
    ref = torch.Generator().manual_seed(5)
    seed = int(torch.randint(2 ** 62, (1,), generator=ref))
    assert torch.equal(gen.get_state(), ref.get_state())
    reps = shard_threads.replicas(model, mesh.threads)
    gens = [torch.Generator().manual_seed(seed + k) for k in range(2)]
    want = mesh.threads.run(lambda k: reps[k](dgt.parts[k],
                                              generator=gens[k]))
    assert torch.equal(got[0], torch.cat([w[0] for w in want]))
    assert torch.equal(got[1], torch.cat([w[1] for w in want]))


# ---------------------------------------------------------- whole entries
def test_train_and_pred_basis_equal_the_stacked_layout(family, tmp_path,  # noqa: F811
                                                       monkeypatch):
    """The train and pred_basis entry points with --mesh_shape edge=2
    --edge_num_thresh 0 on the per-device layout (JAX's rule patched to
    take it over the CPU) against the same with the stacked layout: the
    same steps' losses, val/acc and final params (Adam, 2 epochs); the
    same .bas files and warm gate."""
    from lp_gnn_tpu_torch import pipeline
    from lp_gnn_tpu_torch.pipeline import stage_pred_basis
    from tests.test_torch_train import metrics
    data_prefix, ckpt = family
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(pipeline, "solve_backend", lambda cfg: fake_solve)
    seen = []
    real = ttrainer.dist_train_step

    def recorded(model, optimizer, dg, *a, **kw):
        loss = real(model, optimizer, dg, *a, **kw)
        seen.append((dg.mesh.per_device, float(loss)))
        return loss

    monkeypatch.setattr(ttrainer, "dist_train_step", recorded)
    common = ["--dataset", "fam", "--data_prefix", data_prefix,
              "--device", "cpu", "--arch", ARCH, "--mesh_shape", "edge=2",
              "--edge_num_thresh", "0"]
    runs, preds = {}, {}
    for layout in ("devices", "stacked"):
        monkeypatch.setattr(tmesh, "one_shard_a_device",
                            lambda d, k, on=layout == "devices": on)
        cfg = parse_args([*common, "--exp_nm", "run", "--epochs", "2",
                          "--eval_every", "2", "--seed", "3",
                          "--log_prefix", str(tmp_path / layout)])
        runs[layout] = (ttrainer.run_exp(cfg), cfg.log_dir)
        pred = parse_args([*common, "--exp_nm", "pred", "--load_from", ckpt,
                           "--split", "val", "--warm_gate", "auto",
                           "--warm_gate_k", "1", "--warm_gate_kmax", "1",
                           "--log_prefix", str(tmp_path / f"pred_{layout}")])
        preds[layout] = (stage_pred_basis(pred), pred.log_dir)
    assert [s[0] for s in seen] == [True] * 4 + [False] * 4
    np.testing.assert_allclose([s[1] for s in seen[:4]],
                               [s[1] for s in seen[4:]], rtol=1e-5)
    assert metrics(runs["devices"][1])["val/acc"] == \
        metrics(runs["stacked"][1])["val/acc"]
    want = load_checkpoint(runs["stacked"][0])
    for name, v in load_checkpoint(runs["devices"][0]).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    gates = []
    for layout in ("devices", "stacked"):
        with open(osp.join(preds[layout][1], "warm_gate.json")) as f:
            gates.append(json.load(f))
    assert gates[0] == gates[1]
    got_dir, want_dir = preds["devices"][0], preds["stacked"][0]
    names = sorted(os.listdir(want_dir))
    assert names and sorted(os.listdir(got_dir)) == names
    assert all(filecmp.cmp(osp.join(got_dir, n), osp.join(want_dir, n),
                           shallow=False) for n in names)


# ------------------------------------------------------------------ sddmm
def test_sddmm_matches_jax():
    """ops/spmm.py sddmm against lp_gnn_tpu/ops/spmm.py:289 on the same
    edges and features (fp32, atol 1e-5)."""
    from lp_gnn_tpu.ops.spmm import sddmm as jax_sddmm
    rng = np.random.RandomState(7)
    m, n, e, d = 30, 50, 400, 6
    row = rng.randint(0, m, e).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    xc = rng.randn(m, d).astype(np.float32)
    xv = rng.randn(n, d).astype(np.float32)
    want = np.asarray(jax_sddmm(row, col, xc, xv))
    got = sddmm(*map(torch.from_numpy, (row, col, xc, xv)))
    assert got.shape == (e,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
