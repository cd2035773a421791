"""Edge shards and the (dp, edge) grid over ranks on several hosts
(lp_gnn_tpu_torch/parallel/mesh.py ``Placement``, ``init_distributed``,
``rank_form`` and ``group_route``, halo.py's COLLECTIVE route, the entry
points' reads under the LP_GNN_DIST_* contract) against the JAX package's
edge axis and (dp, edge) mesh on the conftest's virtual CPU devices, on
the CPU, where every route of K1 runs its plain version
(all_to_all_single over gloo): the route each rank takes is what this file
holds; tests/test_torch_kernels.py and chip_smoke.py hold the exchange on
the card.

The ranks are processes of this module (``python -m
tests.test_torch_edge_hosts PAYLOAD``), 4 ranks as 2 hosts of 2: before
each join a rank replaces ``mesh.host_key``, the one function its host is
read from, so that ranks 0-1 report host A and ranks 2-3 host B (or, for
the interleaved layout, ranks 0 and 2 host A). For the entry points each
host runs in a working directory of its own with its own copy of the
dataset; only host A holds the checkpoint. Inputs are made with numpy from
a seed: tests/test_torch_grid.py's graphs (150 x 250 nodes, 1,200 edges)
and family, width 16, depth 3, fp32, dropout 0.

Tolerances:
- the placement, backends and routes: exact;
- edge=4 over two hosts, fp32 logits against JAX's dist_apply at edge=4:
  GCN_FC atol DIST_ATOL, GENDeeper GEN_ATOL (tests/test_torch_edge_ranks.py's);
  GCNRand (all-gather layout), whose draws are the port's: its signs
  against JAX, its values against the port's stacked path exactly;
- one SGD step there (dropout 0), every rank's weights equal: GCN_FC at lr 1
  against make_dist_train_step, the loss rtol 1e-5 and each tensor's
  update within UPDATE_RTOL of its largest (tests/test_torch_edge_ranks.py's);
  GENDeeper at lr 1e-3, the loss rtol 1e-5 and the weights atol 1e-5
  (tests/test_torch_all_gather.py's); GCNRand, whose logits depend on no
  parameter: the loss rtol 1e-5 against the stacked step, the weights
  unchanged;
- one dp=2,edge=2 step (SGD at lr 1e-3) with a host a row, against
  make_dp_edge_train_step (tests/test_torch_grid.py's): the loss rtol 1e-5,
  the params atol RUN_ATOL, each tensor's update within UPDATE_RTOL; with
  the hosts interleaved (rows over both hosts), bit for bit the same step;
- a 2-epoch Adam run of dp=2,edge=2 through the trainer against JAX's
  run_exp (tests/test_parallel.py:653's counterpart): each step's loss
  rtol 1e-5, val/acc equal, the final params atol RUN_ATOL;
- pred_basis --mesh_shape edge=4 over both hosts: the .bas files equal the
  one-process run's, byte for byte.
"""
import filecmp
import json
import logging
import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.parallel import combined as tcombined
from lp_gnn_tpu_torch.parallel import edge_partition as tEP
from lp_gnn_tpu_torch.parallel import halo as thalo
from lp_gnn_tpu_torch.parallel import mesh as tmesh
from lp_gnn_tpu_torch.parallel.dp import rank_block
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import balanced
from tests.test_torch_grid import (ARCH, RUN_SIZES, RUN_THRESH, free_port,
                                   jax_graph, jax_params, recorded_losses,
                                   step_graphs, train_argv, update_rel)

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RANKS = 4
HOSTS = "AABB"         # a host a grid row
INTERLEAVED = "ABAB"   # each grid row over both hosts
GEN = "GENDeeper(8,8,hids=16,depth=3)"
RAND = "GCNRand()"
EDGE_ARCHS = [ARCH, GEN, RAND]
STEP_LR = {ARCH: 1.0, GEN: 1e-3, RAND: 1.0}
DIST_ATOL = 5e-4
GEN_ATOL = 5e-5
GEN_STEP_ATOL = 1e-5
UPDATE_RTOL = 1e-4
RUN_ATOL = 1e-6
GRID_LR = 1e-3


def weights_path(tmp, arch):
    return osp.join(tmp, f"w0_{arch.split('(')[0]}.pt")


def halo_of(arch) -> bool:
    return arch.split("(")[0] in tEP.DIST_HALO_ARCHS


def placement_of(hosts, cards=None) -> tmesh.Placement:
    """The placement of ranks on ``hosts`` (one host key a character) on
    ``cards`` (UUIDs, None off the card: the CPU by default)."""
    cards = [None] * len(hosts) if cards is None else cards
    return tmesh.Placement(
        tuple(hosts), tuple(tmesh.local_indices(hosts)),
        tuple("cpu" if c is None else "cuda" for c in cards), tuple(cards),
        tuple(0 if c is None else 4 for c in cards))


# ---------------------------------------------------------- pure functions
@pytest.mark.parametrize("hosts, local", [
    ("AAAA", [0, 1, 2, 3]), ("AABB", [0, 1, 0, 1]), ("ABAB", [0, 0, 1, 1]),
    ("ABBA", [0, 0, 1, 1]), ("A", [0]), ("ABCABC", [0, 0, 0, 1, 1, 1])])
def test_local_indices_by_host(hosts, local):
    """A rank's index among the ranks of its host, in rank order: its card
    is cuda:(index % the host's cards), whatever the order of the hosts'
    ranks."""
    assert tmesh.local_indices(hosts) == local
    assert placement_of(hosts).n_hosts() == len(set(hosts))


@pytest.mark.parametrize("hosts, cards, backend", [
    ("AAAA", list("abcd"), "nccl"),   # a card a rank
    ("AABB", list("abab"), "nccl"),   # two hosts, each card once a host
    ("AABB", list("aaab"), "gloo"),   # host A's two ranks share card a
    ("ABAB", list("aabb"), "nccl"),   # interleaved, a card each
    ("AAAA", list("abab"), "gloo"),   # more ranks than cards on one host
    ("AABB", [None] * 4, "gloo"),     # the CPU
])
def test_backend_from_host_card_pairs(hosts, cards, backend):
    """NCCL where no two ranks share a (host, card) pair, gloo otherwise:
    the same card UUID on two hosts is two cards."""
    assert placement_of(hosts, cards).backend == backend


@pytest.mark.parametrize("hosts, cards, group, route", [
    # rows, columns and the world of dp=2,edge=2 with a host a row
    ("AABB", list("abab"), [0, 1], thalo.SIGNALLED),
    ("AABB", list("abab"), [2, 3], thalo.SIGNALLED),
    ("AABB", list("abab"), [0, 2], thalo.COLLECTIVE),
    ("AABB", list("abab"), [0, 1, 2, 3], thalo.COLLECTIVE),
    ("AABB", list("aaaa"), [0, 1], thalo.FLAGS),     # every rank on one card
    ("AABB", [None] * 4, [2, 3], thalo.FLAGS),       # the CPU
    # the hosts interleaved: every row spans both
    ("ABAB", list("aabb"), [0, 1], thalo.COLLECTIVE),
    ("ABAB", list("aabb"), [0, 2], thalo.SIGNALLED),
    ("ABAB", list("aabb"), [1, 3], thalo.SIGNALLED),
])
def test_route_of_rows_columns_and_world(hosts, cards, group, route):
    """A group's route from the placement: COLLECTIVE where its ranks span
    hosts, else the signalled form where no card of the world is shared,
    else the flags form."""
    assert tmesh.rank_form(placement_of(hosts, cards), group) == route


def test_interleaved_hosts_cards_and_rows():
    """Ranks 0 and 2 on host A, 1 and 3 on host B (each host's ranks not
    contiguous in rank order): ranks 0 and 1 take cuda:0 of their hosts,
    ranks 2 and 3 cuda:1; the grid's rows (rank order) span both hosts
    and take COLLECTIVE, its columns stay on a host each."""
    local = tmesh.local_indices(INTERLEAVED)
    assert [f"cuda:{i % 2}" for i in local] == \
        ["cuda:0", "cuda:0", "cuda:1", "cuda:1"]
    pl = placement_of(INTERLEAVED, ["a", "a", "b", "b"])
    rows, cols = tmesh.grid_ranks(2, 2)
    assert [tmesh.rank_form(pl, r) for r in rows] == [thalo.COLLECTIVE] * 2
    assert [tmesh.rank_form(pl, c) for c in cols] == [thalo.SIGNALLED] * 2


@pytest.mark.parametrize("world, cards", [(1, 1), (2, 4), (4, 4), (4, 2),
                                          (8, 1), (2, 0)])
def test_one_host_keeps_the_old_rule(world, cards):
    """Every rank on one host: the backend and the form of every group are
    the rule of one host (NCCL and the signalled form where the world's
    ranks fit the host's cards, each rank on cuda:(rank % cards); else
    gloo and the flags form; the CPU, 0 cards, gloo and flags)."""
    hosts = "H" * world
    local = tmesh.local_indices(hosts)
    assert local == list(range(world))
    cards_of = [None] * world if cards == 0 else \
        [f"uuid{i % cards}" for i in local]
    pl = placement_of(hosts, cards_of)
    own = cards > 0 and world <= cards
    assert pl.backend == ("nccl" if own else "gloo")
    for group in ([0], list(range(world)), list(range(0, world, 2))):
        assert tmesh.rank_form(pl, group) == \
            (thalo.SIGNALLED if own else thalo.FLAGS)


def test_group_routes_of_the_mesh_shapes(monkeypatch):
    """The edge groups the entry points log: the world for edge=4, the
    rows for dp=2,edge=2, none for dp alone."""
    monkeypatch.setattr(tmesh, "_PLACEMENT", [placement_of(HOSTS)])
    monkeypatch.setattr(tmesh, "world_and_rank", lambda: (4, 0))
    assert tmesh.group_routes({"edge": 4}) == [([0, 1, 2, 3],
                                                 thalo.COLLECTIVE)]
    assert tmesh.group_routes({"dp": 2, "edge": 2}) == [
        ([0, 1], thalo.FLAGS), ([2, 3], thalo.FLAGS)]
    assert tmesh.group_routes({"dp": 4}) == []


def test_partition_cache_written_at_once(tmp_path):
    """Ranks of one host (8 threads here) writing one ``.tpart.npz`` at
    once (``edge_partition._store_partition``), each through a temporary
    file of its own renamed over the path: one whole file is left, equal
    to the partition, and no temporary file."""
    import threading
    dg = tEP.partition_graph(step_graphs()[0], 2, halo=True)
    path = str(tmp_path / "g-D2-h1.tpart.npz")
    errors = []

    def store():
        try:
            tEP._store_partition(path, dg)
        except Exception as e:   # asserted empty below
            errors.append(e)

    threads = [threading.Thread(target=store) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and os.listdir(tmp_path) == [osp.basename(path)]
    back = tEP._load_partition(path)
    for kind in tEP.CSR_KINDS + tEP.FULL_KINDS:
        for m1, m2 in zip(getattr(back, kind), getattr(dg, kind)):
            for x, y in zip(m1, m2):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(back.halo_send, dg.halo_send)


def test_bf16_gemms_reduce_in_fp32():
    """The port's models sum a bf16 GEMM's split-K partials in fp32 on the
    card (models/layers.py), so a rank's shard and the stacked shards round
    alike but for the order of fp32 sums."""
    import lp_gnn_tpu_torch.models.layers  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_partition_cache_mode_follows_umask(tmp_path):
    """The ``.tpart.npz`` beside a shared dataset gets the mode that
    ``open()`` gives a new file under the process's umask, not the
    temporary file's private 0600."""
    dg = tEP.partition_graph(step_graphs()[0], 2, halo=True)
    path = tmp_path / "g-D2-h1.tpart.npz"
    tEP._store_partition(str(path), dg)
    plain = tmp_path / "plain"
    plain.write_bytes(b"")
    assert path.stat().st_mode & 0o777 == plain.stat().st_mode & 0o777
    assert path.stat().st_mode & 0o044   # readable beyond its owner


# ------------------------------------------------------------ the rank side
def join(rank, hosts, coord):
    """Join the group at ``coord`` as a rank of host ``hosts[rank]``."""
    tmesh.host_key = lambda: hosts[rank]
    os.environ["LP_GNN_DIST_COORD"] = coord
    _, created = tmesh.init_distributed(torch.device("cpu"))
    pl = tmesh.placement()
    return created, {"hosts": pl.hosts, "local": pl.local,
                     "backend": dist.get_backend()}


def edge_cases(weights) -> dict:
    """edge=4 over the world: each arch's forward (eval; the logits
    gathered to rank 0) and one SGD step from the weights in ``weights``;
    the routes this rank took."""
    mesh = tmesh.make_mesh(RANKS, "cpu", dist.group.WORLD)
    g = step_graphs()[0]
    out = {}
    for arch in EDGE_ARCHS:
        dg = tEP.partition_graph(g, RANKS, halo=halo_of(arch))
        model = build_model(arch)
        model.load_state_dict(torch.load(weights_path(weights, arch),
                                         weights_only=True))
        model.eval()
        with torch.no_grad():
            out[f"fwd/{arch}"] = tEP.gather_logits(
                *tEP.dist_apply(model, dg, mesh), mesh)
        if hasattr(model, "dp"):
            model.dp = 0.0
        opt = ttrainer.make_optimizer(model.parameters(), "sgd",
                                      STEP_LR[arch])
        dgt = tEP.dist_tensors(model, dg, mesh, input_agg=True)
        loss = tEP.dist_train_step(model, opt, dgt, balanced,
                                   torch.Generator().manual_seed(1))
        out[f"step/{arch}"] = (float(loss), model.state_dict())
    out["routes"] = dict(tmesh.ROUTES)
    out["window_bytes"] = thalo.window_bytes()
    return out


def grid_step(weights) -> dict:
    """One dp=2,edge=2 step of GCN_FC (halo) on this rank's cell, from the
    weights in ``weights``; the routes this rank took."""
    grid = tmesh.make_grid(2, 2)
    mesh = tmesh.make_mesh(2, "cpu", grid.row, row=grid.d)
    parts = tcombined.partition_batch(step_graphs(), 2, halo=True,
                                      own=rank_block([0, 1], 2, grid.d))
    model = build_model(ARCH)
    model.load_state_dict(torch.load(weights_path(weights, ARCH),
                                     weights_only=True))
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", GRID_LR)
    dgs = [tEP.dist_tensors(model, dg, mesh, input_agg=True) for dg in parts]
    loss = tcombined.dp_edge_train_step(model, opt, dgs, balanced, grid=grid)
    return {"loss": float(loss), "state": model.state_dict(),
            "routes": dict(tmesh.ROUTES)}


def session(payload):
    """Every rank-side case: edge=4 and the grid step with a host a row,
    the grid step with the hosts interleaved, then the train and
    pred_basis entry points in this rank's host's directory (the warm
    gate's solver ``fake_solve``); writes this rank's results."""
    from lp_gnn_tpu_torch import pipeline
    from lp_gnn_tpu_torch.pred_basis import main as pred_main
    from lp_gnn_tpu_torch.train.__main__ import main as train_main
    from tests.test_torch_edge_ranks import fake_solve
    sys.modules["torch.utils.tensorboard"] = None   # metrics.jsonl alone
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    coords, weights = payload["coords"], payload["weights"]
    out = {}
    created, out["placement"] = join(rank, HOSTS, coords[0])
    try:
        out["edge"] = edge_cases(weights)
        tmesh.forget_routes()
        out["grid"] = grid_step(weights)
    finally:
        tmesh.leave_distributed(created)
    created, out["interleaved_placement"] = join(rank, INTERLEAVED,
                                                 coords[1])
    try:
        out["interleaved"] = grid_step(weights)
    finally:
        tmesh.leave_distributed(created)
    # the entry points join and leave themselves, as host HOSTS[rank]
    os.chdir(payload["host_dirs"][HOSTS[rank]])
    losses = recorded_losses()
    os.environ["LP_GNN_DIST_COORD"] = coords[2]
    train_main([*payload["train"], "--exp_nm", "run", "--log_prefix",
                "runs"])
    out["run"] = list(losses)
    os.environ["LP_GNN_DIST_COORD"] = coords[3]
    pipeline.solve_backend = lambda cfg: fake_solve
    pred_main([*payload["pred"], "--log_prefix", "runs"])
    torch.save(out, osp.join(payload["dir"], f"rank{rank}.pt"))


def main(argv):
    (path,) = argv
    with open(path) as f:
        payload = json.load(f)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    session(payload)


# ------------------------------------------------------------- the JAX side
def jax_edge(arch, params, step=True):
    """JAX's dist_apply and, with ``step``, one make_dist_train_step at
    edge=4 on the virtual devices, from the arch's JAX ``params``: (logits,
    loss, weights after the step as a port state_dict)."""
    import jax
    import jax.numpy as jnp
    from lp_gnn_tpu.parallel import edge_partition as jEP
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    name = arch.split("(")[0]
    mesh = jax_make_mesh({"edge": RANKS}, devices=jax.devices()[:RANKS])
    g = step_graphs()[0]
    dg = jEP.partition_graph(jax_graph(g), RANKS, halo=halo_of(arch))
    jc, jv = jax.jit(lambda p, d: jEP.dist_apply(p, d, mesh, arch=name))(
        params, dg)
    logits = np.concatenate([np.asarray(jc)[:g.ncons],
                             np.asarray(jv)[:g.nvars]])
    if not step:
        return logits, None, None
    opt = jtrainer.make_optimizer("sgd")
    step = jax.jit(jEP.make_dist_train_step("balanced", opt, mesh,
                                            dp_rate=0.0, arch=name))
    p1, _, loss = step(params, opt.init(params), dg, jax.random.PRNGKey(1),
                       jnp.float32(STEP_LR[arch]))
    return logits, float(loss), state_dict_from_jax_params(
        jax.tree.map(np.asarray, p1))


def jax_grid_step():
    """JAX's make_dp_edge_train_step on the (dp=2, edge=2) grid of virtual
    devices from GCN_FC's JAX weights: (loss, the weights after it)."""
    from tests.test_torch_grid import jax_step
    return jax_step(None, 0)


def stacked(arch, w0):
    """The port's one-process stacked path at edge=4: (logits, loss and
    weights after one step)."""
    g = step_graphs()[0]
    dg = tEP.partition_graph(g, RANKS, halo=halo_of(arch))
    mesh = tmesh.make_mesh(RANKS, "cpu")
    model = build_model(arch)
    model.load_state_dict(w0)
    model.eval()
    with torch.no_grad():
        lc, lv = tEP.dist_apply(model, dg, mesh)
    logits = np.concatenate([lc[:g.ncons].numpy(), lv[:g.nvars].numpy()])
    opt = ttrainer.make_optimizer(model.parameters(), "sgd", STEP_LR[arch])
    loss = tEP.dist_train_step(model, opt, tEP.dist_tensors(
        model, dg, mesh, input_agg=True), balanced,
        torch.Generator().manual_seed(1))
    return logits, float(loss), model.state_dict()


def pred_argv(data_prefix, ckpt):
    return ["--dataset", "fam", "--data_prefix", data_prefix, "--device",
            "cpu", "--arch", ARCH, "--mesh_shape", f"edge={RANKS}",
            "--edge_num_thresh", str(RUN_THRESH), "--exp_nm", "pred",
            "--load_from", ckpt, "--split", "val", "--warm_gate", "auto",
            "--warm_gate_k", "1", "--warm_gate_kmax", "1"]


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """Two hosts' directories: each a copy of tests/test_torch_grid.py's
    family (RUN_SIZES' LPs with their cold solves' logs); host A's also the
    run's JAX mdl.ckpt. The JAX weights of every arch, as JAX params and
    as port state_dicts."""
    import jax
    from lp_gnn_tpu.models.gcn import build_model as jax_build_model
    from lp_gnn_tpu.train import trainer as jtrainer
    from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
    from tests.test_torch_sampling import write_family
    root = str(tmp_path_factory.mktemp("edge_hosts"))
    dirs = {h: osp.join(root, f"host{h}") for h in "AB"}
    prefix = osp.join(dirs["A"], "lp-dataset")
    write_family(osp.join(prefix, "fam", "highs-inp_tgt"), RUN_SIZES,
                 seed=17)
    logs = osp.join(prefix, "fam", "log", "highs-no-bas")
    os.makedirs(logs)
    for i in range(len(RUN_SIZES)):
        with open(osp.join(logs, f"lp_{i}.log"), "w") as f:
            f.write(f"Solution time =  0.5 sec.  Iterations = {40 + i}\n")
    shutil.copytree(prefix, osp.join(dirs["B"], "lp-dataset"))
    jtrainer.save_ckpt(osp.join(dirs["A"], "init.ckpt"), jax.tree.map(
        np.asarray, jax_build_model(ARCH).init(jax.random.PRNGKey(9))))
    params = {a: jax_params(a) for a in EDGE_ARCHS}
    for arch in EDGE_ARCHS:
        sd = build_model(arch).state_dict() if arch == RAND else \
            state_dict_from_jax_params(params[arch])
        torch.save(sd, weights_path(root, arch))
    return root, dirs, params


@pytest.fixture(scope="module")
def results(hosts):
    """The 4 ranks' session, and the JAX side computed while it runs."""
    from tests.test_torch_grid import jax_run
    root, dirs, params = hosts
    tmp = osp.join(root, "ranks")
    os.makedirs(tmp)
    payload = {"dir": tmp, "weights": root, "host_dirs": dirs,
               "coords": [f"localhost:{free_port()}" for _ in range(4)],
               "train": train_argv("lp-dataset", "init.ckpt",
                                   "dp=2,edge=2"),
               "pred": pred_argv("lp-dataset", "init.ckpt")}
    path = osp.join(tmp, "payload.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_edge_hosts", path],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2",
                           LP_GNN_DIST_COORD=payload["coords"][0],
                           LP_GNN_DIST_NPROCS=str(RANKS),
                           LP_GNN_DIST_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    try:
        edge = {a: jax_edge(a, params[a], step=a != RAND)
                for a in EDGE_ARCHS}
        grid = jax_grid_step()
        run = jax_run(osp.join(dirs["A"], "lp-dataset"),
                      osp.join(dirs["A"], "init.ckpt"),
                      osp.join(root, "jax"))
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            finally:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * RANKS, \
        "\n".join(o[-3000:] for o in outs)
    ranks = [torch.load(osp.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(RANKS)]
    return {"ranks": ranks, "jax_edge": edge, "jax_grid": grid,
            "jax_run": run, "logs": outs}


# ------------------------------------------------------------------- tests
def test_placement_over_two_hosts(results):
    """Each rank's placement, as init_distributed swapped it through the
    store: the host of every rank, each rank's index on its host (host
    A's ranks first, or interleaved) and the backend, gloo on the CPU;
    the same on every rank."""
    for r in results["ranks"]:
        assert r["placement"] == {"hosts": tuple(HOSTS),
                                  "local": (0, 1, 0, 1), "backend": "gloo"}
        assert r["interleaved_placement"] == {
            "hosts": tuple(INTERLEAVED), "local": (0, 0, 1, 1),
            "backend": "gloo"}


def test_routes_over_two_hosts(results):
    """Every rank records the route the placement gives each group it
    exchanged over: edge=4 over both hosts COLLECTIVE (no window made); a
    grid row on one host the flags form (the CPU has no cards); a row over
    both hosts, with the hosts interleaved, COLLECTIVE."""
    for rank, r in enumerate(results["ranks"]):
        assert r["edge"]["routes"] == {(0, 1, 2, 3): thalo.COLLECTIVE}
        assert r["edge"]["window_bytes"] == 0
        row = (0, 1) if rank < 2 else (2, 3)
        assert r["grid"]["routes"] == {row: thalo.FLAGS}
        assert r["interleaved"]["routes"] == {row: thalo.COLLECTIVE}


@pytest.mark.parametrize("arch", EDGE_ARCHS)
def test_edge_forward_over_hosts_matches_jax(hosts, results, arch):
    """edge=4 over two hosts, each arch's dist forward (eval, fp32): the
    logits rank 0 gathers against JAX's dist_apply at edge=4 (GCNRand:
    its signs, and the port's stacked path exactly); the other ranks hold
    none."""
    root = hosts[0]
    g = step_graphs()[0]
    lc, lv = results["ranks"][0]["edge"][f"fwd/{arch}"]
    assert all(r["edge"][f"fwd/{arch}"] == (None, None)
               for r in results["ranks"][1:])
    got = np.concatenate([lc[:g.ncons].numpy(), lv[:g.nvars].numpy()])
    want = results["jax_edge"][arch][0]
    if arch == RAND:
        w0 = torch.load(weights_path(root, arch), weights_only=True)
        np.testing.assert_array_equal(got < 0, want < 0)
        np.testing.assert_array_equal(got, stacked(arch, w0)[0])
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GEN_ATOL if arch == GEN else DIST_ATOL)


@pytest.mark.parametrize("arch", EDGE_ARCHS)
def test_edge_step_over_hosts_matches_jax(hosts, results, arch):
    """One dist SGD step of edge=4 over two hosts (dropout 0, fp32) from
    the JAX weights: every rank's loss and weights equal; the loss and the
    weights against JAX's make_dist_train_step (GCNRand: against the
    stacked step, its weights unchanged)."""
    root = hosts[0]
    key = f"step/{arch}"
    ranks = results["ranks"]
    got_loss, got = ranks[0]["edge"][key]
    for r in ranks[1:]:
        assert r["edge"][key][0] == got_loss
        assert all(torch.equal(v, r["edge"][key][1][n])
                   for n, v in got.items())
    w0 = torch.load(weights_path(root, arch), weights_only=True)
    if arch == RAND:
        np.testing.assert_allclose(got_loss, stacked(arch, w0)[1],
                                   rtol=1e-5)
        assert all(torch.equal(v, w0[n]) for n, v in got.items())
        return
    _, j_loss, want = results["jax_edge"][arch]
    np.testing.assert_allclose(got_loss, j_loss, rtol=1e-5)
    if arch == GEN:
        for name, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=0, atol=GEN_STEP_ATOL,
                                       err_msg=name)
    else:
        assert update_rel(w0, got, want) < UPDATE_RTOL


def test_grid_step_over_hosts_matches_jax(hosts, results):
    """One dp=2,edge=2 step (GCN_FC, halo, SGD at lr 1e-3) with a host a
    row (rows over the flags form, the gradient sum over both hosts)
    against JAX's make_dp_edge_train_step on the same grid of virtual
    devices; every rank's loss and weights equal; with the hosts
    interleaved (rows over COLLECTIVE) the same step, bit for bit."""
    w0 = torch.load(weights_path(hosts[0], ARCH), weights_only=True)
    jloss, want = results["jax_grid"]
    got = results["ranks"][0]["grid"]
    for r in results["ranks"]:
        for step in (r["grid"], r["interleaved"]):
            assert step["loss"] == got["loss"]
            assert all(torch.equal(v, step["state"][n])
                       for n, v in got["state"].items())
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    for name, v in got["state"].items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)
    assert update_rel(w0, got["state"], want) < UPDATE_RTOL


def test_grid_run_over_hosts_matches_jax(hosts, results):
    """The train entry point with --mesh_shape dp=2,edge=2 over two hosts,
    a row a host, each host in its own directory (its own dataset copy;
    the checkpoint on host A alone, read by rank 0 and sent on) against
    JAX's run_exp on its (dp, edge) mesh, 2 epochs of Adam: the same
    losses on every rank, the same steps' losses, val/acc and final
    weights; host A's rank 0 alone writes."""
    from lp_gnn_tpu_torch.models.convert import load_checkpoint
    from tests.test_torch_train import metrics
    _, dirs, _ = hosts
    seen, jcfg, want = results["jax_run"]
    losses = results["ranks"][0]["run"]
    assert all(r["run"] == losses for r in results["ranks"][1:])
    assert len(losses) == len(seen) == 6
    np.testing.assert_allclose(losses, seen, rtol=1e-5)
    log_dir = osp.join(dirs["A"], "runs", "run")
    assert metrics(log_dir)["val/acc"] == metrics(jcfg.log_dir)["val/acc"]
    for name, v in load_checkpoint(osp.join(log_dir, "mdl.pth")).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=name)


def test_pred_basis_over_hosts_equals_one_process(hosts, results, tmp_path,
                                                  monkeypatch):
    """pred_basis with --mesh_shape edge=4 over two hosts (COLLECTIVE),
    each host in its own directory: host A's rank 0 writes .bas files
    equal to the one-process run's, byte for byte, and the same warm gate;
    host B holds no checkpoint and no file of the runs (none of its ranks
    read one or wrote one)."""
    from lp_gnn_tpu_torch import pipeline
    from lp_gnn_tpu_torch.config import parse_args
    from tests.test_torch_edge_ranks import fake_solve
    _, dirs, _ = hosts
    monkeypatch.setattr(pipeline, "solve_backend", lambda cfg: fake_solve)
    one = parse_args([*pred_argv(osp.join(dirs["A"], "lp-dataset"),
                                 osp.join(dirs["A"], "init.ckpt")),
                      "--log_prefix", str(tmp_path)])
    out_dir = pipeline.stage_pred_basis(one)
    got_dir = osp.join(dirs["A"], "runs", "pred", osp.basename(out_dir))
    names = sorted(os.listdir(out_dir))
    assert len(names) == 6 and sorted(os.listdir(got_dir)) == names
    assert all(filecmp.cmp(osp.join(got_dir, n), osp.join(out_dir, n),
                           shallow=False) for n in names)
    with open(osp.join(one.log_dir, "warm_gate.json")) as f:
        want_gate = json.load(f)
    with open(osp.join(dirs["A"], "runs", "pred", "warm_gate.json")) as f:
        assert json.load(f) == want_gate
    assert sorted(os.listdir(dirs["B"])) == ["lp-dataset"]


if __name__ == "__main__":
    main(sys.argv[1:])
