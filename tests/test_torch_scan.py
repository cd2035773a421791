"""The port's K-step training call (lp_gnn_tpu_torch/train/scan.py), the
trainer's ``--steps_per_call`` and ``--trace`` and the optimizer's two
forms, against the JAX package on the same inputs, on the CPU, where the
K-step call is the plain loop of ``train_step`` and every kernel wrapper
runs its plain version. The captured CUDA graphs are tested on the card
(tests/test_torch_scan_card.py).

Tolerances, stated where they are used:
- the K-step call against JAX's ``make_scan_train_step``, fp32, dropout
  0: losses rtol 1e-5, params atol ADAM_ATOL, accuracies exact;
- ``run_exp --steps_per_call 2`` against JAX's: losses rtol 1e-5, val/acc
  and the logged accuracies exactly, params atol RUN_ATOL;
- the K-step call against K single steps, a resumed run against a whole
  one: bit for bit.
"""
import glob
import json
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.data.dataset import BipartiteGraph as JaxGraph
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.parallel.dp import stack_graphs
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu_torch import pipeline, prep
from lp_gnn_tpu_torch.config import Config, parse_args
from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.train import scan as tscan
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import LOSS_REGISTRY
from tests.test_torch_dist_train import record_dist_steps
from tests.test_torch_train import (ADAM_ATOL, ARCH, RESUME_ARCH, RUN_ATOL,
                                    metrics, port_cfg)
from tests.test_torch_train import family  # noqa: F401  (a fixture)

torch.set_num_threads(2)


def twin_graph(seed, m=12, n=20, e=60):
    """The graph ``tests/test_models.py make_pg`` draws from
    ``RandomState(seed)``, as the port's type and the JAX package's."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, m, e).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    val = (rng.rand(e).astype(np.float32) - 0.5)
    c_feas = (rng.rand(m, 8).astype(np.float32) - 0.5)
    v_feas = (rng.rand(n, 8).astype(np.float32) - 0.5)
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    fields = dict(row=row, col=col, val=val, c_feas=c_feas, v_feas=v_feas,
                  y_s=rng.randint(0, 3, m).astype(np.int32),
                  y_t=rng.randint(0, 3, n).astype(np.int32))
    return BipartiteGraph(**fields), JaxGraph(**fields)


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "single"])
def test_scan_step_matches_jax(stacked):
    """K=3 steps of Adam in one call against JAX's make_scan_train_step
    from the same params (fp32, dropout 0), on 3 graphs (stacked) or the
    first one 3 times: losses rtol 1e-5, params ADAM_ATOL; the accuracy -1
    exactly where not asked for, JAX's where asked."""
    from lp_gnn_tpu.data.batching import pad_graph
    from tests.test_models import make_pg
    pairs = [twin_graph(s) for s in range(3)]
    pgs = [jax.tree.map(np.asarray, make_pg(np.random.RandomState(s),
                                            m=12, n=20, e=60))
           for s in range(3)]
    assert all(np.array_equal(a.c_feas, b.c_feas) for a, b in zip(
        pgs, (pad_graph(jg) for _, jg in pairs)))
    acc_on = [True, False, True]
    jmodel = jax_build_model(ARCH)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    opt = jtrainer.make_optimizer("adam")
    jscan = jtrainer.make_scan_train_step(jmodel, "balanced", opt,
                                          stacked=stacked)
    p = jax.tree.map(jnp.asarray, params)
    p, _, jlosses, jaccs = jscan(
        p, opt.init(p), stack_graphs(pgs) if stacked else pgs[0],
        jax.random.split(jax.random.PRNGKey(7), 3), jnp.float32(1e-3),
        jnp.asarray(acc_on))

    model = build_model(ARCH)
    model.load_state_dict(state_dict_from_jax_params(params))
    optimizer = ttrainer.make_optimizer(model.parameters(), "adam", 1e-3)
    gts = [ttrainer.train_graph(model, g, "cpu") for g, _ in pairs]
    step = tscan.make_scan_train_step(model, "balanced", optimizer,
                                      stacked=stacked)
    losses, accs = step(gts if stacked else gts[0], lr=1e-3, acc_on=acc_on,
                        k=3)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    assert accs.tolist() == np.asarray(jaccs).tolist()
    assert accs[1] == -1.0 and accs[0] >= 0 and accs[2] >= 0
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, p))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=ADAM_ATOL, err_msg=k)


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "single"])
def test_k_step_call_equals_single_steps(stacked):
    """On the CPU the K-step call is K train_step calls: the same losses,
    accuracies, params, Adam state and generator state, bit for bit, with
    dropout on."""
    arch = "GCN_FC(8,8,hids=16,depth=3,dp=0.3)"
    sd = build_model(arch, torch.Generator().manual_seed(4)).state_dict()
    runs = []
    for _ in range(2):
        model = build_model(arch)
        model.load_state_dict(sd)
        runs.append((model, ttrainer.make_optimizer(model.parameters()),
                     torch.Generator().manual_seed(9)))
    gts = [ttrainer.train_graph(runs[0][0], twin_graph(s, 30, 40, 200)[0],
                                "cpu") for s in range(4)]
    stack = gts if stacked else [gts[0]] * 4
    acc_on = [False, True, False, False]
    step = tscan.make_scan_train_step(runs[0][0], "balanced", runs[0][1],
                                      stacked=stacked, generator=runs[0][2])
    got = [step(gts if stacked else gts[0], acc_on=acc_on, k=4)
           for _ in range(2)]
    model, optimizer, gen = runs[1]
    want_l, want_a = [], []
    for _ in range(2):
        for gt, on in zip(stack, acc_on):
            loss, acc = ttrainer.train_step(model, optimizer, gt,
                                            LOSS_REGISTRY["balanced"], gen, on)
            want_l.append(float(loss))
            want_a.append(float(acc) if on else -1.0)
    assert [v for losses, _ in got for v in losses.tolist()] == want_l
    assert [v for _, accs in got for v in accs.tolist()] == want_a
    for (k, a), b in zip(runs[0][0].state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k
    for pa, pb in zip(runs[0][0].parameters(), model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(runs[0][1].state[pa][key],
                               optimizer.state[pb][key])
    assert torch.equal(runs[0][2].get_state(), gen.get_state())


def test_run_exp_steps_per_call_matches_jax(family, tmp_path):
    """Both packages' run_exp with --steps_per_call 2 from one JAX mdl.ckpt
    (a fresh optimizer) on the tiny family: 4 train graphs of one stack
    key, 2 stacks a epoch in the drawn order, 3 epochs, a val pass. The
    logged losses agree to rtol 1e-5, the logged accuracies, val/acc, lr
    and epoch exactly, the final params to RUN_ATOL."""
    data_prefix, ckpt = family
    kw = dict(dataset="tiny", data_prefix=data_prefix,
              log_prefix=str(tmp_path), arch=ARCH, epochs=3, eval_every=3,
              load_from=ckpt, steps_per_call=2)
    jcfg = JaxConfig(exp_nm="jax", **kw).finalize()
    jpath = jtrainer.run_exp(jcfg)
    calls = []
    real = tscan.ScanTrainStep.__call__

    def counted(self, *a, **k):
        calls.append(len(a[0]))
        return real(self, *a, **k)
    tscan.ScanTrainStep.__call__ = counted
    try:
        tpath = ttrainer.run_exp(Config(exp_nm="port", device="cpu", **kw)
                                 .finalize())
    finally:
        tscan.ScanTrainStep.__call__ = real
    assert calls == [2] * 6
    jm, tm = metrics(jcfg.log_dir), metrics(osp.dirname(tpath))
    assert [s for s, _ in tm["train/loss"]] == [1, 10]
    for tag in ("epoch", "train/lr", "train/acc", "val/acc"):
        assert tm[tag] == jm[tag], tag
    for (ts, tv), (js, jv) in zip(tm["train/loss"], jm["train/loss"],
                                  strict=True):
        assert ts == js
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
    with open(jpath, "rb") as f:
        want = state_dict_from_jax_params(pickle.load(f)["params"])
    for k, v in load_checkpoint(tpath).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=k)


def test_steps_per_call_with_an_edge_mesh_matches_jax(family, tmp_path,
                                                      monkeypatch):
    """--steps_per_call 2 --mesh_shape edge=2 with a threshold (170 edges)
    that leaves train graphs 1 and 2 (140, 160 edges) to one stack and
    sends 3 and 5 (180, 220) through the dist step: each epoch one K-step
    call first, then the two dist steps, in their stacking order; the same
    losses as JAX's run_exp with the same flags (rtol 1e-5), val/acc
    exactly, params RUN_ATOL."""
    data_prefix, ckpt = family
    seen = record_dist_steps(monkeypatch)
    kinds = []
    real = tscan.ScanTrainStep.__call__

    def counted(self, *a, **k):
        kinds.append("scan")
        return real(self, *a, **k)
    monkeypatch.setattr(tscan.ScanTrainStep, "__call__", counted)
    real_dist = ttrainer.dist_train_step

    def dist_step(*a, **k):
        kinds.append(("dist", a[2].n_shards))
        return real_dist(*a, **k)
    monkeypatch.setattr(ttrainer, "dist_train_step", dist_step)
    kw = dict(dataset="tiny", data_prefix=data_prefix,
              log_prefix=str(tmp_path), arch=ARCH, epochs=2, eval_every=2,
              load_from=ckpt, steps_per_call=2, mesh_shape="edge=2",
              edge_num_thresh=170)
    jcfg = JaxConfig(exp_nm="jax", **kw).finalize()
    jpath = jtrainer.run_exp(jcfg)
    tpath = ttrainer.run_exp(Config(exp_nm="port", device="cpu", **kw)
                             .finalize())
    assert kinds == ["scan", ("dist", 2), ("dist", 2)] * 2
    assert len(seen["port"]) == len(seen["jax"]) == 4
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-5)
    jm, tm = metrics(jcfg.log_dir), metrics(osp.dirname(tpath))
    assert tm["val/acc"] == jm["val/acc"]
    for (ts, tv), (js, jv) in zip(tm["train/loss"], jm["train/loss"],
                                  strict=True):
        assert ts == js
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
    with open(jpath, "rb") as f:
        want = state_dict_from_jax_params(pickle.load(f)["params"])
    for k, v in load_checkpoint(tpath).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=RUN_ATOL, err_msg=k)


class _Stop(Exception):
    pass


def test_resume_of_a_steps_per_call_run(family, tmp_path, monkeypatch):
    """A --steps_per_call 2 run stopped after epoch 2 of 4 and resumed from
    its mdl.pth ends bit-identical to a run that was not stopped (dropout
    on: the generator's state is part of the train state)."""
    data_prefix, _ = family
    kw = dict(arch=RESUME_ARCH, epochs=4, steps_per_call=2)
    whole = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "whole", **kw))
    real = ttrainer.save_checkpoint
    saves = [0]

    def stopping(*a, **k):
        saves[0] += 1
        if saves[0] == 3:
            raise _Stop
        return real(*a, **k)
    monkeypatch.setattr(ttrainer, "save_checkpoint", stopping)
    with pytest.raises(_Stop):
        ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "cut", **kw))
    monkeypatch.setattr(ttrainer, "save_checkpoint", real)
    cut = osp.join(str(tmp_path), "cut", "mdl.pth")
    assert torch.load(osp.join(str(tmp_path), "cut", "train_state.pth"),
                      weights_only=True)["epoch"] == 2
    resumed = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "resumed",
                                        load_from=cut, **kw))
    a, b = load_checkpoint(whole), load_checkpoint(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert metrics(osp.dirname(whole))["train/loss"][-1] == \
        metrics(osp.dirname(resumed))["train/loss"][-1]


def test_trace_writes_a_trace_and_logs_resources(family, tmp_path, caplog):
    """--trace 1 over 2 epochs: a Chrome trace of epoch 1 (the one after
    the first) under {log_dir}/trace, holding the step's host ops; the
    resources logged at epoch 0."""
    data_prefix, _ = family
    with caplog.at_level("INFO"):
        path = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "tr",
                                         epochs=2, trace=1,
                                         steps_per_call=2))
    files = glob.glob(osp.join(osp.dirname(path), "trace", "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    assert "resources:" in caplog.text and "MemTotal" in caplog.text


def test_optimizer_state_loads_into_either_form(tmp_path):
    """train_state.pth's optimizer state, written by the default Adam or by
    the capturable one (a tensor lr, step counts where the params are),
    loads into both; each keeps its own form and takes the saved values."""
    model = build_model(ARCH, torch.Generator().manual_seed(0))
    g = ttrainer.train_graph(model, twin_graph(3)[0], "cpu")
    plain = ttrainer.make_optimizer(model.parameters(), "adam", 1e-3)
    ttrainer.train_step(model, plain, g, LOSS_REGISTRY["balanced"])
    ttrainer.set_lr(plain, 1e-4)
    cap = ttrainer.make_optimizer(model.parameters(), "adam", 5e-3,
                                  capturable=True)
    ttrainer.load_optimizer_state(cap, plain.state_dict())
    p0 = next(model.parameters())
    group = cap.param_groups[0]
    assert group["capturable"] and torch.is_tensor(group["lr"])
    assert float(group["lr"]) == pytest.approx(1e-4)
    assert cap.state[p0]["step"].dtype == torch.float32
    assert torch.equal(cap.state[p0]["exp_avg"], plain.state[p0]["exp_avg"])
    path = str(tmp_path / "opt.pth")
    torch.save(cap.state_dict(), path)
    back = ttrainer.make_optimizer(model.parameters(), "adam", 1e-3)
    ttrainer.load_optimizer_state(back, torch.load(path, weights_only=True))
    group = back.param_groups[0]
    assert not group["capturable"] and isinstance(group["lr"], float)
    assert group["lr"] == pytest.approx(1e-4)
    assert float(back.state[p0]["step"]) == 1.0
    ttrainer.set_lr(cap, 2e-3)
    assert float(cap.param_groups[0]["lr"]) == pytest.approx(2e-3)


def test_flags_reach_every_entry_point(family, tmp_path, monkeypatch):
    """--steps_per_call and --trace are fields of the port's Config, parsed
    by every stage's CLI; the train CLI runs them (K-step calls, a trace),
    and pred_basis takes them and serves as without them."""
    data_prefix, _ = family
    cfg = parse_args(["--steps_per_call", "3", "--trace", "1"],
                     make_log_dir=False)
    assert (cfg.steps_per_call, cfg.trace) == (3, 1)
    from lp_gnn_tpu_torch.train import __main__ as train_main
    argv = ["--dataset", "tiny", "--data_prefix", data_prefix,
            "--log_prefix", str(tmp_path), "--arch", ARCH, "--epochs", "2",
            "--steps_per_call", "2", "--trace", "1", "--device", "cpu"]
    path = train_main.main(argv + ["--exp_nm", "cli"])
    with open(osp.join(osp.dirname(path), "args.json")) as f:
        args = json.load(f)
    assert (args["steps_per_call"], args["trace"]) == (2, 1)
    assert glob.glob(osp.join(osp.dirname(path), "trace", "*.json"))
    from lp_gnn_tpu_torch import pred_basis
    served = {}
    for flags in ([], ["--steps_per_call", "2", "--trace", "1"]):
        out = pred_basis.main(
            ["--dataset", "tiny", "--data_prefix", data_prefix,
             "--log_prefix", str(tmp_path), "--arch", ARCH,
             "--exp_nm", f"pb{len(flags)}", "--load_from", path,
             "--warm_gate", "off", "--device", "cpu", *flags])
        served[len(flags)] = {osp.basename(f): open(f).read()
                              for f in glob.glob(osp.join(out, "*.bas"))}
    assert served[0] and served[0] == served[4]


@pytest.fixture(scope="module")
def mirp_tiny(tmp_path_factory):
    """A tiny mirp_like family prepped by the port (10 LPs)."""
    root = str(tmp_path_factory.mktemp("torch_scan_mirp"))
    cfg = Config(dataset="mirp_like", seed=0, device="cpu",
                 data_prefix=osp.join(root, "lp-dataset")).finalize(
                     make_log_dir=False)
    prep.stage_prep_data(cfg, family="mirp_like", n_instances=10, n_ports=4,
                         n_periods=6)
    return root


def test_run_train_test_with_steps_per_call_and_trace(mirp_tiny):
    """run_train_test --steps_per_call 2 --trace 1 on the CPU: the K-step
    calls train, the trace is written, and the pipeline reports."""
    cfg = Config(exp_nm="scan", dataset="mirp_like",
                 arch="GCN_FC(8,8,hids=16,depth=3)", epochs=2,
                 steps_per_call=2, trace=1, device="cpu",
                 data_prefix=osp.join(mirp_tiny, "lp-dataset"),
                 log_prefix=osp.join(mirp_tiny, "runs")).finalize()
    out = pipeline.run_train_test(cfg)
    assert "gnn-bas-0/impr_niter" in out["summary"]["val"]
    assert glob.glob(osp.join(cfg.log_dir, "trace", "*.pt.trace.json"))
    with open(osp.join(cfg.log_dir, "args.json")) as f:
        assert json.load(f)["steps_per_call"] == 2
