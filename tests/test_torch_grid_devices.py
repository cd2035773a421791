"""dp and the (dp, edge) grid over the devices of one process (lp_gnn_tpu_torch/
parallel/mesh.py DeviceGrid and its rule one_shard_a_device, dp.py's step
over the dp devices, combined.py's step on the grid, the trainer's and
pred_basis' --mesh_shape dp=D[,edge=E] with D*E cards visible) against the
JAX package's dp and (dp, edge) meshes on the conftest's virtual CPU
devices and against the port's single-device layouts, on the CPU: the
device list repeats the CPU (the rule is patched in: no card here), every
cell runs in its thread, and K1's device form runs its plain version.
Inputs are made with numpy from a seed: the graph of
tests/test_torch_edge_ranks.py (150 x 250 nodes, 1,200 edges; the batch of
tests/test_torch_grid.py, two of them), width 16, depth 3, fp32, dropout 0.

Tolerances, stated where they are used:
- the grid's cells: exact, JAX's device ids;
- one dp step over D devices (Adam at lr 1e-3) from the JAX weights: the
  loss rtol 1e-5 and the params atol 1e-6 against JAX's
  make_dp_train_step at dp=D (tests/test_torch_dp.py's);
- one grid step (SGD at lr STEP_LR) from the JAX weights: the loss rtol
  1e-5, the params atol RUN_ATOL and each tensor's update within
  UPDATE_RTOL of its largest, against JAX's make_dp_edge_train_step on the
  (2, 2) mesh and against the stacked layout's dp_edge_train_step over the
  whole batch (tests/test_torch_grid.py's); GCNRand, whose logits are
  draws: its weights unchanged, its loss rtol 1e-5 against the stacked
  layout's rows drawn from the same generators;
- a step repeated from one state: bit for bit, also from a calling thread
  far on in its autograd count and from a fresh one (there on two graphs
  of 600 x 900 nodes and 6,000 edges, GCN_FC width 32, where the order of
  the sums shows);
- whole runs (Adam, 2 epochs, --cache_in_agg 0): each step's loss rtol
  1e-5, the final params atol RUN_ATOL, val/acc equal; pred_basis: the
  .bas files byte for byte and the warm gate equal.
"""
import filecmp
import json
import os
import os.path as osp
import sys
import threading

import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch.config import Config, parse_args
from lp_gnn_tpu_torch.data.graph import union
from lp_gnn_tpu_torch.infer.predict import mesh_from_cfg
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import combined as tcombined
from lp_gnn_tpu_torch.parallel import dp as tdp
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel import mesh as tmesh
from lp_gnn_tpu_torch.parallel.dp import rank_block
from lp_gnn_tpu_torch.parallel.mesh import (DeviceGrid, make_device_grid,
                                            make_mesh, shard_devices)
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced
from tests.test_torch_edge_ranks import no_dropout
from tests.test_torch_grid import (ARCH, DP, EDGE, GEN, RUN_ATOL, STEP_LR,
                                   UPDATE_RTOL, jax_params, jax_run,
                                   jax_step, pred_argv, step_graphs,
                                   train_argv, update_rel)
from tests.test_torch_grid import family  # noqa: F401 (a fixture)

torch.set_num_threads(2)

CPU = torch.device("cpu")
RAND = "GCNRand()"
# the grid steps: (arch, halo, the case of tests/test_torch_grid.py's
# jax_step, None where JAX's logits are other draws)
GRID_STEPS = [(ARCH, True, 0), (RAND, False, None), (GEN, True, 2)]


def cpu_grid(dp, edge):
    return make_device_grid(dp, edge, [CPU] * (dp * edge))


def on_devices(monkeypatch, on=True):
    """The entry points' rule patched: a device a cell (the CPU repeated)
    or none."""
    monkeypatch.setattr(tmesh, "one_shard_a_device", lambda d, n: on)


# ------------------------------------------------------------- the layout
@pytest.mark.parametrize("dp,edge", [(2, 2), (2, 4)])
def test_grid_cells_follow_jax_device_order(dp, edge, monkeypatch):
    """Cell (d, e) on cuda:(i + d*E + e) mod n from the run's card i: from
    cuda:0 over 8 cards (the count patched; no CUDA call is made) the ids
    of JAX's make_mesh({"dp": D, "edge": E}) over the conftest's virtual
    devices, row by row and column 0; each row an edge mesh of one shard a
    device, its grid row named; the rows and the column on the cells'
    streams."""
    import jax
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(
        {"dp": dp, "edge": edge}, devices=jax.devices()[:dp * edge]).devices)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    grid = make_device_grid(dp, edge, shard_devices(
        torch.device("cuda", 0), dp * edge))
    assert np.array_equal(np.reshape([d.index for d in grid.devices],
                                     (dp, edge)), ids)
    assert [[d.index for d in row.devices] for row in grid.rows] == \
        ids.tolist()
    assert [d.index for d in grid.col.devices] == ids[:, 0].tolist()
    assert all(row.per_device and row.row == d and row.n_shards == edge
               for d, row in enumerate(grid.rows))
    shifted = shard_devices(torch.device("cuda", 3), dp * edge)
    assert [d.index for d in shifted] == [(3 + c) % 8
                                          for c in range(dp * edge)]
    grid = cpu_grid(dp, edge)
    grid.threads._streams = [object() for _ in range(dp * edge)]
    assert grid.rows[1].threads.streams == grid.threads.streams[edge:2 * edge]
    assert grid.col.streams == grid.threads.streams[::edge]
    with pytest.raises(ValueError, match="over 3 devices"):
        make_device_grid(2, 2, [CPU] * 3)


def test_entry_points_take_jax_layout_and_fallbacks(monkeypatch, caplog):
    """The entry points' rule, the card count patched (no CUDA call is
    made): with at least D*E cards batch_shape keeps dp (the grid of
    devices); below, JAX's two fallbacks with their warnings: dp*edge above
    the cards drops dp, dp alone above them falls back to single-device
    steps, graph_batch dropped too; predict's edge mesh takes the first
    `edge` cards whatever dp says. On the CPU and over ranks the rule
    holds no devices."""
    cards = {"n": 4}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards["n"])
    card = torch.device("cuda", 0)
    grid_cfg = Config(mesh_shape="dp=2,edge=2", graph_batch=3)
    dp_cfg = Config(mesh_shape="dp=4", graph_batch=3)
    assert ttrainer.batch_shape(grid_cfg, 1, card) == (2, 3)
    assert ttrainer.batch_shape(dp_cfg, 1, card) == (4, 3)
    got = mesh_from_cfg(grid_cfg, card)
    assert got.per_device and got.devices == (card, torch.device("cuda", 1))
    cards["n"] = 3
    with caplog.at_level("WARNING"):
        assert ttrainer.batch_shape(grid_cfg, 1, card) == (1, 3)
        assert ttrainer.batch_shape(dp_cfg, 1, card) == (1, 1)
    assert "mesh_shape dp=2,edge=2 exceeds 3 card(s) — dropping the dp " \
        "axis" in caplog.text
    assert "mesh_shape dp=4 exceeds 3 card(s) — falling back to " \
        "single-device steps (graph_batch dropped too)" in caplog.text
    cards["n"] = 1
    assert not mesh_from_cfg(grid_cfg, card).per_device
    cards["n"] = 8
    assert ttrainer.batch_shape(grid_cfg, 1, CPU) == (1, 3)
    assert not mesh_from_cfg(grid_cfg, CPU).per_device
    assert not tmesh.one_shard_a_device(CPU, 2)
    assert tmesh.one_shard_a_device(card, 8)
    monkeypatch.setattr(tmesh, "world_and_rank", lambda: (2, 0))
    assert not tmesh.one_shard_a_device(card, 2)


# -------------------------------------------------------------- dp steps
def dp_step_on_devices(sd, graphs, d, gen_seed=1):
    """One dp_train_step over d devices (the CPU repeated) on ``graphs``
    from the state ``sd``, Adam at lr 1e-3: (loss, weights)."""
    model = build_model(ARCH)
    model.load_state_dict(sd)
    opt = ttrainer.make_optimizer(model.parameters(), "adam", 1e-3)
    stack = list(range(len(graphs)))
    unions = [union([ttrainer.train_graph(model, graphs[i], CPU)
                     for i in rank_block(stack, d, c)]) for c in range(d)]
    loss = tdp.dp_train_step(model, opt, unions, balanced,
                             torch.Generator().manual_seed(gen_seed),
                             threads=cpu_grid(d, 1).col)
    return float(loss), {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("d", [2, 4])
def test_dp_step_on_devices_matches_jax(d):
    """One dp step over D devices, block c of the 4 graphs of
    tests/test_torch_dp.py one union on device c, against JAX's
    make_dp_train_step(train=False) on a dp=D mesh of virtual devices,
    from the JAX weights."""
    import jax
    import jax.numpy as jnp
    from lp_gnn_tpu.data.batching import pad_graph
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    from lp_gnn_tpu.parallel.dp import make_dp_train_step, stack_graphs
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from lp_gnn_tpu.train import trainer as jtrainer
    from tests.test_torch_dp import graphs
    from tests.test_torch_sampling import jax_graph
    gs = graphs()
    jm = jax_build_model(ARCH)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    opt = jtrainer.make_optimizer("adam")
    step = make_dp_train_step(jm, "balanced", opt, jax_make_mesh(
        {"dp": d}, devices=jax.devices()[:d]), train=False)
    jp, _, jloss = step(params, opt.init(params),
                        stack_graphs([pad_graph(jax_graph(g)) for g in gs]),
                        jax.random.PRNGKey(0), jnp.float32(1e-3))
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jp))
    loss, got = dp_step_on_devices(state_dict_from_jax_params(params), gs, d)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------ grid steps
def port_weights(arch):
    return state_dict_from_jax_params(jax_params(arch)) \
        if arch != RAND else build_model(arch).state_dict()


def grid_step(arch, halo, grid: DeviceGrid | None, w0):
    """One dp_edge_train_step of ``arch`` from ``w0`` (SGD at STEP_LR,
    dropout 0) on tests/test_torch_grid.py's batch of two graphs: on
    ``grid`` (block d on row d) or, with None, on the stacked layout over
    the whole batch. Returns (loss, weights, the model, the tensors)."""
    model = no_dropout(build_model(arch))
    model.load_state_dict(w0)
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", STEP_LR)
    parts = tcombined.partition_batch(step_graphs(), EDGE, halo=halo)
    if grid is None:
        dgs = [tEP.dist_tensors(model, p, make_mesh(EDGE, "cpu"),
                                input_agg=True) for p in parts]
    else:
        dgs = [[tEP.dist_tensors(model, parts[i], row, input_agg=True)
                for i in rank_block([0, 1], DP, d)]
               for d, row in enumerate(grid.rows)]
    loss = tcombined.dp_edge_train_step(model, opt, dgs, balanced,
                                        torch.Generator().manual_seed(1),
                                        grid)
    return float(loss), {k: v.clone() for k, v in
                         model.state_dict().items()}, model, dgs


@pytest.mark.parametrize("arch,halo,case", GRID_STEPS,
                         ids=[f"{a.split('(')[0]}-{'halo' if h else 'ag'}"
                              for a, h, _ in GRID_STEPS])
def test_grid_step_matches_jax_and_stacked(arch, halo, case):
    """One step on the (dp=2, edge=2) grid of devices, row d block d, shard
    e of its graph on cell (d, e), from the JAX weights, against JAX's
    make_dp_edge_train_step on the (2, 2) mesh of virtual devices and
    against the stacked layout's step over the whole batch in one process.
    GCNRand over the all-gather partition, its logits the port's draws:
    its weights unchanged, its loss the mean over the rows of the stacked
    layout's loss of row d's graph drawn from dp.cell_generators' d-th."""
    w0 = port_weights(arch)
    got_loss, got, _, _ = grid_step(arch, halo, cpu_grid(DP, EDGE), w0)
    s_loss, stacked, model, dgs = grid_step(arch, halo, None, w0)
    if arch == RAND:
        assert all(torch.equal(v, w0[k]) for k, v in got.items())
        gens = tdp.cell_generators(torch.Generator().manual_seed(1),
                                   [CPU] * DP)
        with torch.no_grad():
            want = np.mean([float(balanced(
                *tEP.dist_forward(model, dgs[d], gens[d]), dgs[d].y_s,
                dgs[d].y_t, dgs[d].cons_mask, dgs[d].vars_mask))
                for d in range(DP)])
        np.testing.assert_allclose(got_loss, want, rtol=1e-5)
        return
    np.testing.assert_allclose(got_loss, s_loss, rtol=1e-5)
    assert update_rel(w0, got, stacked) < UPDATE_RTOL
    jloss, want = jax_step(None, case)
    np.testing.assert_allclose(got_loss, jloss, rtol=1e-5)
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    assert update_rel(w0, got, want) < UPDATE_RTOL


@pytest.mark.parametrize("kind", ["dp", ARCH, GEN])
def test_step_repeats_bit_for_bit(kind):
    """A step of each kind taken twice from one state (fresh models and
    tensors, a fresh grid): the loss and every weight bit for bit (one
    broadcast node sums the cells' gradients on the lead in (d, e) order,
    whatever order the cells' backward work finishes in)."""
    if kind == "dp":
        from tests.test_torch_dp import graphs
        sd = build_model(ARCH).state_dict()
        runs = [dp_step_on_devices(sd, graphs(), 2) for _ in range(2)]
    else:
        w0 = port_weights(kind)
        runs = [grid_step(kind, True, cpu_grid(DP, EDGE), w0)[:2]
                for _ in range(2)]
    (la, a), (lb, b) = runs
    assert la == lb
    assert all(torch.equal(a[k], b[k]) for k in a)


def step_from_the_calling_thread(kind):
    """One fp32 SGD step of GCN_FC(hids=32) from seeded weights on two
    graphs of 600 x 900 nodes and 6,000 edges (where the order of a
    gradient's sums shows in its last bits): ``grid`` the (2, 2) grid
    step, ``edge`` the dist step of one shard a device (edge=2) on the
    first graph, ``dp`` the dp=2 step on devices. (loss, weights)."""
    from tests.test_torch_kernels import port_graph
    arch = "GCN_FC(8,8,hids=32,depth=3,dp=0.0)"
    graphs = [port_graph(np.random.RandomState(20 + i), m=600, n=900,
                         e=6000) for i in range(2)]
    model = build_model(arch, generator=torch.Generator().manual_seed(3))
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", 1.0)
    if kind == "dp":
        g = [union([ttrainer.train_graph(model, x, CPU)]) for x in graphs]
        loss = tdp.dp_train_step(model, opt, g, balanced, None,
                                 cpu_grid(2, 1).col)
    elif kind == "edge":
        dg = tEP.dist_tensors(model, tEP.partition_graph(graphs[0], 2,
                                                         halo=True),
                              make_mesh(2, [CPU] * 2), input_agg=True)
        loss = tEP.dist_train_step(model, opt, dg, balanced)
    else:
        grid = cpu_grid(DP, EDGE)
        parts = tcombined.partition_batch(graphs, EDGE, halo=True)
        dgs = [[tEP.dist_tensors(model, parts[d], row, input_agg=True)]
               for d, row in enumerate(grid.rows)]
        loss = tcombined.dp_edge_train_step(model, opt, dgs, balanced, None,
                                            grid)
    return float(loss), {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kind", ["grid", "edge", "dp"])
def test_step_bits_do_not_depend_on_the_calling_thread(kind):
    """A step with a thread a cell, taken from a thread that has made many
    autograd nodes and from a fresh one, from the same state: the loss and
    every weight bit for bit. The engine takes ready nodes by per-thread
    sequence numbers; a step whose forward ran in the calling thread
    summed conv1's gradients in another order in the two, one fp32 ulp
    apart (shard_threads.numbered_afresh)."""
    x = torch.zeros(1, requires_grad=True)
    for _ in range(20000):   # the calling thread's count far on
        x * 1.0
    la, a = step_from_the_calling_thread(kind)
    out = []
    t = threading.Thread(target=lambda: out.append(
        step_from_the_calling_thread(kind)))
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and out
    lb, b = out[0]
    assert la == lb
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_cell_that_raises_reaches_the_caller(monkeypatch):
    """Cell (1, 1) raises in its first conv of a grid step, and replica 1
    of a dp step in its forward: the caller gets that error, no cell
    thread is left alive, and the grid steps again afterwards."""
    real_aggs, real_losses = tEP._dist_aggs, tdp.member_losses

    def aggs(dg, left, right):
        if dg.mesh.row == 1 and dg.shards == (1,):
            raise ValueError("cell (1, 1) fails")
        return real_aggs(dg, left, right)

    def losses(lc, lv, g, loss_fn):
        if threading.current_thread().name == "edge-shard-1":
            raise ValueError("replica 1 fails")
        return real_losses(lc, lv, g, loss_fn)

    w0 = port_weights(ARCH)
    grid = cpu_grid(DP, EDGE)
    monkeypatch.setattr(tEP, "_dist_aggs", aggs)
    with pytest.raises(ValueError, match=r"cell \(1, 1\) fails"):
        grid_step(ARCH, True, grid, w0)
    monkeypatch.setattr(tEP, "_dist_aggs", real_aggs)
    monkeypatch.setattr(tdp, "member_losses", losses)
    from tests.test_torch_dp import graphs
    with pytest.raises(ValueError, match="replica 1 fails"):
        dp_step_on_devices(build_model(ARCH).state_dict(), graphs(), 2)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("edge-shard")]
    monkeypatch.setattr(tdp, "member_losses", real_losses)
    loss, _, _, _ = grid_step(ARCH, True, grid, w0)
    assert np.isfinite(loss)


# ------------------------------------------------------------ whole runs
def record_steps(monkeypatch):
    """Each step of the trainer: (kind, its layout, loss), in order."""
    seen = []

    def wrap(name, layout):
        real = getattr(ttrainer, name)

        def run(*a, **kw):
            out = real(*a, **kw)
            loss = out[0] if isinstance(out, tuple) else out
            seen.append((name, layout(*a, **kw), float(loss)))
            return out
        monkeypatch.setattr(ttrainer, name, run)

    wrap("train_step", lambda *a, **kw: "one device")
    wrap("dist_train_step", lambda m, o, dg, *a, **kw:
         "row 0" if dg.mesh.per_device and dg.mesh.row == 0 else "stacked")
    wrap("dp_train_step", lambda m, o, g, *a, **kw:
         "devices" if isinstance(g, list) else "one device")
    wrap("dp_edge_train_step", lambda m, o, dgs, lf, gen, grid=None:
         "grid" if isinstance(grid, DeviceGrid) else "stacked")
    return seen


def run_train(argv, tmp, exp):
    cfg = parse_args([*argv, "--exp_nm", exp, "--log_prefix",
                      osp.join(tmp, exp)])
    return ttrainer.run_exp(cfg), cfg.log_dir


def test_dp_run_on_devices_equals_graph_batch(family, tmp_path,  # noqa: F811
                                              monkeypatch):
    """The train entry point with --mesh_shape dp=2 on two devices (the
    CPU twice) against --graph_batch 2 on one device, 2 epochs of Adam
    from one JAX mdl.ckpt on tests/test_torch_grid.py's family (all its
    graphs small here: two dp stacks and one graph left single an epoch):
    the same steps' losses, val/acc and final weights."""
    from tests.test_torch_train import metrics
    _, data_prefix, ckpt = family
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    on_devices(monkeypatch)
    seen = record_steps(monkeypatch)
    argv = train_argv(data_prefix, ckpt, "dp=2")
    argv[argv.index("--edge_num_thresh") + 1] = "1e9"
    dev = run_train(argv, str(tmp_path), "devices")
    on_one = seen[:]
    seen.clear()
    argv[argv.index("--mesh_shape") + 1] = ""
    one = run_train([*argv, "--graph_batch", "2"], str(tmp_path), "one")
    assert [s[:2] for s in on_one] == ([("dp_train_step", "devices")] * 2
                                       + [("train_step", "one device")]) * 2
    assert [s[:2] for s in seen] == ([("dp_train_step", "one device")] * 2
                                     + [("train_step", "one device")]) * 2
    np.testing.assert_allclose([s[2] for s in on_one], [s[2] for s in seen],
                               rtol=1e-5)
    assert metrics(dev[1])["val/acc"] == metrics(one[1])["val/acc"]
    want = load_checkpoint(one[0])
    for name, v in load_checkpoint(dev[0]).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)


def test_grid_run_on_devices_matches_jax(family, tmp_path,  # noqa: F811
                                         monkeypatch):
    """The train entry point with --mesh_shape dp=2,edge=2 on the grid of
    4 devices (the CPU repeated) against JAX's run_exp with the same flags
    on its (dp, edge) mesh of virtual devices, 2 epochs of Adam from one
    JAX mdl.ckpt: an epoch takes one grid batch, one dp stack over column
    0's devices and the graph left over once, over row 0's devices; the
    same steps' losses, val/acc and final weights."""
    from tests.test_torch_train import metrics
    root, data_prefix, ckpt = family
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    on_devices(monkeypatch)
    seen = record_steps(monkeypatch)
    path, log_dir = run_train(train_argv(data_prefix, ckpt,
                                         f"dp={DP},edge={EDGE}"),
                              str(tmp_path), "grid")
    assert [s[:2] for s in seen] == [
        ("dp_edge_train_step", "grid"), ("dp_train_step", "devices"),
        ("dist_train_step", "row 0")] * 2
    j_seen, jcfg, want = jax_run(data_prefix, ckpt,
                                 osp.join(str(tmp_path), "jax"))
    np.testing.assert_allclose([s[2] for s in seen], j_seen, rtol=1e-5)
    assert metrics(log_dir)["val/acc"] == metrics(jcfg.log_dir)["val/acc"]
    for name, v in load_checkpoint(path).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)


def test_pred_basis_on_devices_equals_stacked(family, tmp_path,  # noqa: F811
                                              monkeypatch):
    """pred_basis with --mesh_shape dp=2,edge=2 in one process serving over
    the first 2 devices, one shard a device (JAX's serving ignores dp),
    against the same flags on the stacked layout: the same .bas files,
    byte for byte, and the same warm gate."""
    from lp_gnn_tpu_torch import pipeline
    from tests.test_torch_edge_ranks import fake_solve
    _, data_prefix, ckpt = family
    monkeypatch.setattr(pipeline, "solve_backend", lambda cfg: fake_solve)
    layouts = []
    real = tEP.dist_apply

    def seen(model, dg, mesh, *a, **kw):
        layouts.append(mesh.per_device)
        return real(model, dg, mesh, *a, **kw)

    monkeypatch.setattr(tEP, "dist_apply", seen)
    out = {}
    for on in (True, False):
        on_devices(monkeypatch, on)
        cfg = parse_args([*pred_argv(data_prefix, ckpt), "--log_prefix",
                          str(tmp_path / str(on))])
        out[on] = (pipeline.stage_pred_basis(cfg), cfg.log_dir)
    n = len(layouts) // 2
    assert n and layouts == [True] * n + [False] * n
    gates = []
    for on in (True, False):
        with open(osp.join(out[on][1], "warm_gate.json")) as f:
            gates.append(json.load(f))
    assert gates[0] == gates[1]
    names = sorted(os.listdir(out[False][0]))
    assert len(names) == 6 and sorted(os.listdir(out[True][0])) == names
    assert all(filecmp.cmp(osp.join(out[True][0], f),
                           osp.join(out[False][0], f), shallow=False)
               for f in names)
