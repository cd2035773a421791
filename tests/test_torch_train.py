"""The port's training slice (lp_gnn_tpu_torch/train, the SpMM's backward,
dropout, remat, the input aggregation cache, checkpoints) against the JAX
package's on the same inputs, on the CPU, where every kernel wrapper runs
its plain version.

Tolerances, stated where they are used:
- losses, fp32 logits: values rtol 1e-5, gradients w.r.t. the logits rtol
  1e-5 atol 1e-7 (the same sums in another order);
- the SpMM's gradient, fp32: rtol 1e-5 atol 1e-6;
- a few Adam steps of GCN_FC from the same params, fp32, dropout 0: losses
  rtol 1e-5, params atol ADAM_ATOL;
- decode, accuracy, step_lr, the bisection threshold: exact.
"""
import dataclasses
import json
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.data.batching import pad_graph
from lp_gnn_tpu.data.dataset import LPDataset as JaxDataset
from lp_gnn_tpu.infer.decode import decode_topm_device as jax_decode_topm
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.ops import spmm as jspmm
from lp_gnn_tpu.train import losses as jlosses
from lp_gnn_tpu.train import trainer as jtrainer
from lp_gnn_tpu.train.metrics import accuracy as jax_accuracy
from lp_gnn_tpu_torch import pipeline
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data.dataset import LPDataset
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.infer.decode import decode_topm_device
from lp_gnn_tpu_torch.models.convert import (load_checkpoint,
                                             state_dict_from_jax_params)
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.models.layers import dropout
from lp_gnn_tpu_torch.ops import spmm as tspmm
from lp_gnn_tpu_torch.train import __main__ as train_main
from lp_gnn_tpu_torch.train import losses as tlosses
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.metrics import accuracy
from tests.test_torch_predict import write_processed
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

ARCH = "GCN_FC(8,8,hids=16,depth=3,dp=0.0)"
# Adam divides each gradient by its own running magnitude, so the fp32
# round-off of the two frameworks' gradients reaches the params at the
# scale of lr times its relative size: after 3 steps at lr 1e-3, within
# 1e-6 (an entry whose gradient sits within round-off of 0, or a ReLU input
# within round-off of 0, would move further; this graph has none)
ADAM_ATOL = 1e-6


def jax_params(arch=ARCH, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_model(arch).init(jax.random.PRNGKey(seed)))


def port_model(arch, params):
    model = build_model(arch)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


# ------------------------------------------------------------------ losses
def loss_inputs(case, seed=0, m=30, n=50):
    """Logits, labels and masks of one case: 'three' (3 classes both
    sides, random masks), 'two_class' (the constraint side holds 2
    classes: the LL/UL merge rule keeps its weights), 'masked_side' (every
    variable masked out)."""
    rng = np.random.RandomState(seed)
    lc = (rng.randn(m, 3) * 3).astype(np.float32)
    lv = (rng.randn(n, 3) * 3).astype(np.float32)
    ys = rng.randint(0, 3, m).astype(np.int32)
    yt = rng.randint(0, 3, n).astype(np.int32)
    ms, mt = rng.rand(m) < 0.8, rng.rand(n) < 0.8
    if case == "two_class":
        ys = rng.randint(0, 2, m).astype(np.int32)
    elif case == "masked_side":
        mt[:] = False
    return lc, lv, ys, yt, ms, mt


@pytest.mark.parametrize("case", ["three", "two_class", "masked_side"])
@pytest.mark.parametrize("name", ["unbalanced", "balanced", "focal",
                                  "critical"])
def test_loss_and_logit_gradient_match_jax(name, case):
    lc, lv, ys, yt, ms, mt = loss_inputs(case)
    jfn = jlosses.LOSS_REGISTRY[name]
    jv, (jgc, jgv) = jax.value_and_grad(
        lambda a, b: jfn(a, b, jnp.asarray(ys), jnp.asarray(yt),
                         jnp.asarray(ms), jnp.asarray(mt)),
        argnums=(0, 1))(jnp.asarray(lc), jnp.asarray(lv))
    tc = torch.from_numpy(lc).requires_grad_()
    tv = torch.from_numpy(lv).requires_grad_()
    tval = tlosses.LOSS_REGISTRY[name](
        tc, tv, torch.from_numpy(ys).long(), torch.from_numpy(yt).long(),
        torch.from_numpy(ms), torch.from_numpy(mt))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["three", "two_class", "masked_side"])
def test_balanced_weights_match_jax(case):
    """Exact: counts and one division a class, the merge rule
    merge_lu & (n_present != 2) (losses.py:26-37)."""
    _, _, ys, yt, ms, mt = loss_inputs(case)
    for y, mk in ((ys, ms), (yt, mt)):
        for merge in (True, False):
            want = jlosses.labels_to_balanced_weights(
                jnp.asarray(y), jnp.asarray(mk), merge_lu=merge)
            got = tlosses.labels_to_balanced_weights(
                torch.from_numpy(y).long(), torch.from_numpy(mk),
                merge_lu=merge)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m_int", [1, 17, 40, 80])
def test_decode_threshold_matches_jax(m_int):
    """The 24-pass bisection gives JAX's threshold exactly on the same
    P(basic), ties and masked (-inf) entries included."""
    rng = np.random.RandomState(m_int)
    p = rng.rand(80).astype(np.float32)
    p[::7] = p[3]
    p[rng.rand(80) < 0.2] = -np.inf
    want = jlosses._decode_threshold(jnp.asarray(p), jnp.int32(m_int))
    got = tlosses._decode_threshold(torch.from_numpy(p), torch.tensor(m_int))
    assert float(got) == float(want)


# ------------------------------------------------------- decode, accuracy, lr
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_topm_device_matches_jax(seed):
    """Labels equal JAX's exactly, with tied P(basic) rows and masked
    rows."""
    rng = np.random.RandomState(seed)
    m, n = 25, 40
    lc = rng.randn(m, 3).astype(np.float32)
    lv = rng.randn(n, 3).astype(np.float32)
    lv[::5] = lc[0]          # ties across the two sides
    lc[3:6] = lc[2]
    ms, mt = rng.rand(m) < 0.9, rng.rand(n) < 0.9
    k = int(ms.sum()) - seed
    want_c, want_v = jax_decode_topm(jnp.asarray(lc), jnp.asarray(lv),
                                     jnp.asarray(ms), jnp.asarray(mt), k)
    got_c, got_v = decode_topm_device(torch.from_numpy(lc),
                                      torch.from_numpy(lv),
                                      torch.from_numpy(ms),
                                      torch.from_numpy(mt), torch.tensor(k))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("dataset", ["mirp", "stoch-sc"])
def test_accuracy_matches_jax(dataset):
    rng = np.random.RandomState(4)
    m, n = 20, 35
    logits = rng.randn(m + n, 3).astype(np.float32)
    gt = rng.randint(0, 3, m + n)
    for pr in (False, True):
        assert accuracy(logits, gt, m, return_pr=pr, dataset_name=dataset) == \
            jax_accuracy(logits, gt, m, return_pr=pr, dataset_name=dataset)


def test_step_lr_matches_jax():
    for epochs in (1, 3, 4, 10, 800):
        for epoch in range(min(epochs, 40)):
            assert ttrainer.step_lr(1e-3, epochs, epoch) == \
                jtrainer.step_lr(1e-3, epochs, epoch)


# ----------------------------------------------------------- SpMM gradient
@pytest.mark.parametrize("blocked", [False, True], ids=["segment", "blocked"])
def test_spmm_gradient_matches_jax(blocked):
    """d/dx of <w, A x> and <w, A^T x> through the port's SpmmCSR against
    jax.grad through the JAX SpMM's custom VJP; the port's gradient is
    exactly the plain SpMM over the transpose ordering."""
    rng = np.random.RandomState(7)
    g, jg = random_graph(rng)
    gt = GraphTensors.from_graph(g, "cpu")
    pg = pad_graph(jg)
    if not blocked:
        pg = dataclasses.replace(pg, blkr_src=None, blkc_src=None)
    d = 8
    xv = rng.randn(g.nvars, d).astype(np.float32)
    xc = rng.randn(g.ncons, d).astype(np.float32)
    wc = rng.randn(g.ncons, d).astype(np.float32)
    wv = rng.randn(g.nvars, d).astype(np.float32)

    def pad(a, rows):
        out = np.zeros((rows, d), np.float32)
        out[: a.shape[0]] = a
        return jnp.asarray(out)

    jgv = jax.grad(lambda x: jnp.sum(jspmm.spmm_vars_to_cons(pg, x)
                                     * pad(wc, pg.m_pad)))(pad(xv, pg.n_pad))
    jgc = jax.grad(lambda x: jnp.sum(jspmm.spmm_cons_to_vars(pg, x)
                                     * pad(wv, pg.n_pad)))(pad(xc, pg.m_pad))
    tv = torch.from_numpy(xv).requires_grad_()
    tc = torch.from_numpy(xc).requires_grad_()
    ((tspmm.spmm_vars_to_cons(gt, tv) * torch.from_numpy(wc)).sum()
     + (tspmm.spmm_cons_to_vars(gt, tc) * torch.from_numpy(wv)).sum()
     ).backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv)[: g.nvars],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc)[: g.ncons],
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(tv.grad, tspmm.spmm_csr_plain(
        gt.colptr, gt.row, gt.val_c, torch.from_numpy(wc)))
    assert torch.equal(tc.grad, tspmm.spmm_csr_plain(
        gt.rowptr, gt.col, gt.val_r, torch.from_numpy(wv)))


def test_spmm_backward_takes_noncontiguous_gradients():
    """A gradient that reaches the SpMM as a strided view (here through a
    transpose) is made contiguous for the kernel's wrapper."""
    g, _ = random_graph(np.random.RandomState(3))
    gt = GraphTensors.from_graph(g, "cpu")
    x = torch.randn(g.nvars, 8, requires_grad=True)
    w = torch.randn(8, g.ncons)
    (tspmm.spmm_vars_to_cons(gt, x).t() * w).sum().backward()
    assert torch.equal(x.grad, tspmm.spmm_csr_plain(
        gt.colptr, gt.row, gt.val_c, w.t().contiguous()))


# ----------------------------------------------------------- train steps
def jax_steps(params, jg, loss, n_steps, lr=1e-3):
    model = jax_build_model(ARCH)
    opt = jtrainer.make_optimizer("adam")
    step = jtrainer.make_train_step(model, loss, opt)
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    pg = jspmm.attach_input_agg(pad_graph(jg))
    losses = []
    for i in range(n_steps):
        p, state, lv, _ = step(p, state, pg, jax.random.PRNGKey(i),
                               jnp.float32(lr))
        losses.append(float(lv))
    return jax.tree.map(np.asarray, p), losses


def port_steps(model, gt, loss, n_steps, lr=1e-3, generator=None,
               opt="adam"):
    optimizer = ttrainer.make_optimizer(model.parameters(), opt, lr)
    losses = []
    for _ in range(n_steps):
        lv, _ = ttrainer.train_step(model, optimizer, gt,
                                    tlosses.LOSS_REGISTRY[loss], generator)
        losses.append(float(lv))
    return losses


@pytest.mark.parametrize("loss", ["balanced", "critical"])
def test_three_adam_steps_match_jax(loss):
    g, jg = random_graph(np.random.RandomState(21), m=40, n=64, e=300)
    params = jax_params()
    want_params, want_losses = jax_steps(params, jg, loss, 3)
    model = port_model(ARCH, params)
    gt = tspmm.attach_input_agg(GraphTensors.from_graph(g, "cpu",
                                                        labels=True),
                                torch.float32)
    got_losses = port_steps(model, gt, loss, 3)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want = state_dict_from_jax_params(want_params)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=ADAM_ATOL, err_msg=k)


def test_sgd_step_matches_jax():
    """--opt sgd: g + 5e-4 p, then -lr times it (trainer.py:53). At lr 0.1
    the gradients' fp32 round-off (relative ~1e-6 of entries up to ~20)
    reaches the params as is: atol 1e-5."""
    g, jg = random_graph(np.random.RandomState(22), m=30, n=40, e=200)
    params = jax_params()
    model = jax_build_model(ARCH)
    opt = jtrainer.make_optimizer("sgd")
    p = jax.tree.map(jnp.asarray, params)
    p, _, want_loss, _ = jtrainer.make_train_step(model, "balanced", opt)(
        p, opt.init(p), pad_graph(jg), jax.random.PRNGKey(0),
        jnp.float32(0.1))
    tm = port_model(ARCH, params)
    got = port_steps(tm, GraphTensors.from_graph(g, "cpu", labels=True),
                     "balanced", 1, lr=0.1, opt="sgd")
    np.testing.assert_allclose(got[0], float(want_loss), rtol=1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, p))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def count_spmm(monkeypatch):
    """Counts the calls of spmm_csr (on the CPU its plain version runs, so
    the wrapper's launch count stays 0; the calls are what launch on the
    card)."""
    calls = [0]
    real = tspmm.spmm_csr

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(tspmm, "spmm_csr", counted)
    return calls


@pytest.mark.parametrize("variant,per_step", [("cache", 4), ("no_cache", 6),
                                              ("remat", 6)])
def test_cache_and_remat_bit_identical(monkeypatch, variant, per_step):
    """The input aggregation cache and remat change neither the losses nor
    the params, bit for bit, over 3 steps with dropout on (the mask drawn
    outside the recomputed conv); SpMM calls a step: 2 forward + 2 backward
    with the cache, 2 more (conv1's) without, 2 more (the recompute) with
    remat."""
    g, _ = random_graph(np.random.RandomState(23), m=30, n=50, e=250)
    arch = "GCN_FC(8,8,hids=16,depth=3,dp=0.3)"
    sd = build_model(arch, torch.Generator().manual_seed(1)).state_dict()
    gt = GraphTensors.from_graph(g, "cpu", labels=True)
    gt_cached = tspmm.attach_input_agg(gt, torch.float32)

    def run(arch_, gt_):
        model = build_model(arch_)
        model.load_state_dict(sd)
        losses = port_steps(model, gt_, "balanced", 3,
                            generator=torch.Generator().manual_seed(5))
        return losses, model.state_dict()

    want_losses, want_sd = run(arch, gt_cached)
    calls = count_spmm(monkeypatch)
    if variant == "remat":
        got = run(arch[:-1] + ",remat=True)", gt_cached)
    else:
        got = run(arch, gt_cached if variant == "cache" else gt)
    assert calls[0] == 3 * per_step
    assert got[0] == want_losses
    for k, v in got[1].items():
        assert torch.equal(v, want_sd[k]), k


def test_input_agg_cache_is_the_conv1_aggregation():
    g, _ = random_graph(np.random.RandomState(24))
    gt = GraphTensors.from_graph(g, "cpu")
    for dt in (torch.float32, torch.bfloat16):
        cached = tspmm.attach_input_agg(gt, dt)
        assert cached.in_agg_c.dtype == dt and not cached.in_agg_c.requires_grad
        assert torch.equal(cached.in_agg_c,
                           tspmm.spmm_vars_to_cons(gt, gt.v_feas.to(dt)))
        assert torch.equal(cached.in_agg_v,
                           tspmm.spmm_cons_to_vars(gt, gt.c_feas.to(dt)))


def test_dropout_draws_from_its_generator():
    x = torch.randn(200, 16).bfloat16()
    a = dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    b = dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    kept = a != 0
    assert 0.65 < float(kept.float().mean()) < 0.85
    assert torch.equal(a[kept], (x / 0.75).to(torch.bfloat16)[kept])
    assert dropout(x, 0.25, None, False) is x
    assert dropout(x, 0.0, None, True) is x


# ---------------------------------------------------------------- run_exp
@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """6 tiny LPs (4 train, 2 val) and a JAX mdl.ckpt holding params only."""
    root = tmp_path_factory.mktemp("torch_train")
    prefix = root / "lp-dataset"
    write_processed(str(prefix / "tiny" / "highs-inp_tgt"), 6, seed=3)
    ckpt = str(root / "init.ckpt")
    jtrainer.save_ckpt(ckpt, jax_params(seed=2))
    return str(prefix), ckpt


def metrics(log_dir):
    with open(osp.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    out = {}
    for r in rows:
        out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


def port_cfg(data_prefix, log_prefix, exp, **kw):
    kw.setdefault("arch", ARCH)
    kw.setdefault("epochs", 3)
    return Config(exp_nm=exp, dataset="tiny", data_prefix=data_prefix,
                  log_prefix=str(log_prefix), device="cpu", **kw).finalize()


def test_run_exp_matches_jax(family, tmp_path):
    """Both packages' run_exp from one JAX mdl.ckpt (params only: a fresh
    optimizer): 12 steps over 4 graphs, a val pass at the end. The logged
    losses agree to rtol 1e-5, val/acc exactly, the final params to
    RUN_ATOL."""
    data_prefix, ckpt = family
    kw = dict(dataset="tiny", data_prefix=data_prefix,
              log_prefix=str(tmp_path), arch=ARCH, epochs=3, eval_every=3,
              load_from=ckpt)
    jcfg = JaxConfig(exp_nm="jax", **kw).finalize()
    jpath = jtrainer.run_exp(jcfg)
    tcfg = Config(exp_nm="port", device="cpu", **kw).finalize()
    tpath = ttrainer.run_exp(tcfg)
    jm, tm = metrics(jcfg.log_dir), metrics(tcfg.log_dir)
    assert [s for s, _ in tm["train/loss"]] == [1, 10]
    for tag in ("epoch", "train/lr", "val/acc"):
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
    for f in ("mdl.pth", "train_state.pth", "metrics.jsonl", "args.json"):
        assert osp.exists(osp.join(tcfg.log_dir, f))


# 12 Adam steps, 2 of them at lr 1e-4, 1 at 1e-5 (StepLR over 3 epochs)
RUN_ATOL = 1e-6


class _Stop(Exception):
    pass


RESUME_ARCH = "GCN_FC(8,8,hids=16,depth=3,dp=0.2)"


def cut_and_resume(data_prefix, tmp_path, monkeypatch, name, stop_at):
    """Runs 4 epochs whole; again with ``ttrainer.<name>`` raising _Stop at
    its ``stop_at(args)``-th true call, then resumed from that run's
    mdl.pth. Asserts the resumed run ends bit-identical to the whole one
    (dropout on: the generator's state is part of the train state) and
    returns the cut run's (mdl.pth path, train_state)."""
    whole = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "whole",
                                      arch=RESUME_ARCH, epochs=4))
    real = getattr(ttrainer, name)

    def stopping(*a, **kw):
        if stop_at(a):
            raise _Stop
        return real(*a, **kw)
    monkeypatch.setattr(ttrainer, name, stopping)
    with pytest.raises(_Stop):
        ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "cut",
                                  arch=RESUME_ARCH, epochs=4))
    monkeypatch.setattr(ttrainer, name, real)
    cut = osp.join(str(tmp_path), "cut", "mdl.pth")
    state = torch.load(osp.join(str(tmp_path), "cut", "train_state.pth"),
                       weights_only=True)
    resumed = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "resumed",
                                        arch=RESUME_ARCH, epochs=4,
                                        load_from=cut))
    a, b = load_checkpoint(whole), load_checkpoint(resumed)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert metrics(osp.dirname(whole))["train/loss"][-1] == \
        metrics(osp.dirname(resumed))["train/loss"][-1]
    return cut, state


def nth_call(n, pred=lambda a: True):
    calls = [0]

    def at(a):
        calls[0] += bool(pred(a))
        return bool(pred(a)) and calls[0] == n
    return at


def test_resume_equals_an_uninterrupted_run(family, tmp_path, monkeypatch):
    """A run stopped after epoch 2 of 4 (before its third save) and resumed
    from its mdl.pth + train_state.pth ends bit-identical to a run that was
    not stopped."""
    _, state = cut_and_resume(family[0], tmp_path, monkeypatch,
                              "save_checkpoint", nth_call(3))
    assert state["epoch"] == 2 and state["extra"]["arch"] == RESUME_ARCH


def test_resume_after_a_save_cut_between_its_two_files(family, tmp_path,
                                                       monkeypatch):
    """A run that dies in epoch 2's save, after train_state.pth was
    replaced and before mdl.pth was, leaves mdl.pth at epoch 1's weights;
    a resume from it takes epoch 2's weights from train_state.pth and ends
    bit-identical to a run that was not stopped."""
    cut, state = cut_and_resume(
        family[0], tmp_path, monkeypatch, "_save_atomic",
        nth_call(2, lambda a: a[1].endswith("mdl.pth")))
    assert state["epoch"] == 2
    stale = load_checkpoint(cut)
    assert any(not torch.equal(stale[k], state["model"][k]) for k in stale)


def test_port_mdl_pth_loads_in_jax(family, tmp_path):
    """The port's trained mdl.pth, read by the JAX load_ckpt, gives the
    port's logits through the JAX model (fp32, atol 1e-4 as
    tests/test_torch_gcn_fc.py)."""
    data_prefix, ckpt = family
    path = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "x", epochs=1,
                                     load_from=ckpt))
    params = jtrainer.load_ckpt(path)["params"]
    model = build_model(ARCH)
    model.load_state_dict(load_checkpoint(path))
    g = LPDataset(osp.join(data_prefix, "tiny", "highs-inp_tgt"))[0]
    jg = JaxDataset(osp.join(data_prefix, "tiny", "highs-inp_tgt"))[0]
    with torch.no_grad():
        lc, lv = model.eval()(GraphTensors.from_graph(g, "cpu"))
    jc, jv = jax_build_model(ARCH).apply(params, pad_graph(jg))
    np.testing.assert_allclose(lc.numpy(), np.asarray(jc)[: g.ncons],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jv)[: g.nvars],
                               rtol=0, atol=1e-4)


def test_cli_trains_on_the_cpu_and_needs_a_gpu_otherwise(family, tmp_path,
                                                         monkeypatch):
    data_prefix, _ = family
    argv = ["--dataset", "tiny", "--data_prefix", data_prefix,
            "--log_prefix", str(tmp_path), "--exp_nm", "cli", "--arch",
            "GCN_FC(8,8,hids=16,depth=3)", "--epochs", "2", "--loss",
            "focal", "--eval_every", "1"]
    path = train_main.main(argv + ["--device", "cpu"])
    log_dir = osp.dirname(path)
    for f in ("mdl.pth", "train_state.pth", "metrics.jsonl", "args.json"):
        assert osp.exists(osp.join(log_dir, f)), f
    with open(osp.join(log_dir, "args.json")) as f:
        args = json.load(f)
    assert args["loss"] == "focal" and args["device"] == "cpu"
    assert len(metrics(log_dir)["val/acc"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(argv)


def test_dp_and_edge_trains_through_the_train_stage(family, tmp_path,
                                                    monkeypatch, caplog):
    """--mesh_shape dp=2,edge=2 (refused by the stage until dp x edge was
    ported) trains through the pipeline's train stage: without 2 ranks it
    drops the dp axis with a warning (trainer.py:350-353) and trains every
    graph edge-partitioned, one dist step a graph."""
    data_prefix, _ = family
    steps = []
    real = ttrainer.dist_train_step

    def counted(*a, **kw):
        steps.append(float(real(*a, **kw)))
        return steps[-1]
    monkeypatch.setattr(ttrainer, "dist_train_step", counted)
    cfg = port_cfg(data_prefix, tmp_path, "dpe", mesh_shape="dp=2,edge=2",
                   edge_num_thresh=0, epochs=1)
    with caplog.at_level("WARNING"):
        path = pipeline.stage_train(cfg)
    assert "dropping the dp axis" in caplog.text and osp.exists(path)
    assert len(steps) == 4 and np.isfinite(steps).all()


def test_cache_in_agg_is_a_parsed_field(caplog):
    """--cache_in_agg (config.py:116) is a field of the port's Config, not
    an unknown arg."""
    from lp_gnn_tpu_torch.config import parse_args
    with caplog.at_level("WARNING"):
        cfg = parse_args(["--cache_in_agg", "0"], make_log_dir=False)
    assert cfg.cache_in_agg == 0 and Config().cache_in_agg == 1
    assert "unknown args" not in caplog.text


@pytest.mark.parametrize("mesh_shape,per_step", [
    ("", {"spmm": 2}),
    ("edge=2", {"spmm": 5 * 2, "gather": 1, "a2a": 1}),
], ids=["single", "edge2"])
def test_cache_in_agg_off_trains_the_same(family, tmp_path, monkeypatch,
                                          mesh_shape, per_step):
    """--cache_in_agg 0 trains as 1 does, bit for bit (the cache is
    exact), with the input conv's launches in every step instead of once a
    graph: on one device its 2 SpMMs, edge-partitioned one dist conv's (a
    gather, a K1, 5 SpMMs a shard). On the CPU the wrappers' calls are
    counted: those are what launch on the card."""
    from lp_gnn_tpu_torch.parallel import edge_partition as tEP
    data_prefix, ckpt = family
    calls = dict.fromkeys(("spmm", "gather", "a2a"), 0)
    for mod, name, key in ((tspmm, "spmm_csr", "spmm"),
                           (tEP, "spmm_csr", "spmm"),
                           (tEP, "gather_rows", "gather"),
                           (tEP, "halo_all_to_all", "a2a")):
        def counted(*a, _real=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    steps = []   # (loss, calls) of each step of the current run
    for name in ("train_step", "dist_train_step"):
        def step(*a, _real=getattr(ttrainer, name), **kw):
            before = dict(calls)
            out = _real(*a, **kw)
            loss = out[0] if isinstance(out, tuple) else out
            steps.append((float(loss),
                          {k: calls[k] - before[k] for k in calls}))
            return out
        monkeypatch.setattr(ttrainer, name, step)
    runs = {}
    for cache in (1, 0):
        steps.clear()
        path = ttrainer.run_exp(port_cfg(
            data_prefix, tmp_path, f"cache{cache}", epochs=2,
            load_from=ckpt, cache_in_agg=cache, mesh_shape=mesh_shape,
            edge_num_thresh=0 if mesh_shape else 4e6 * 3))
        runs[cache] = (list(steps), load_checkpoint(path))
    (on, w_on), (off, w_off) = runs[1], runs[0]
    assert len(on) == len(off) == 8
    assert [lv for lv, _ in on] == [lv for lv, _ in off]
    for (_, a), (_, b) in zip(on, off):
        assert {k: b[k] - a[k] for k in a} == {k: per_step.get(k, 0)
                                                for k in a}
    assert all(torch.equal(w_on[k], w_off[k]) for k in w_on)


def test_dp_beyond_the_ranks_falls_back_with_a_warning(family, tmp_path,
                                                       caplog):
    """--mesh_shape dp=2 without a process group of 2 ranks warns and
    trains single-graph steps, graph_batch dropped too (trainer.py:477-481):
    the run equals one without either flag."""
    data_prefix, ckpt = family
    kw = dict(epochs=1, load_from=ckpt)
    with caplog.at_level("WARNING"):
        path = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "dp",
                                         mesh_shape="dp=2", graph_batch=2,
                                         **kw))
    assert "mesh_shape dp=2 exceeds 1 rank(s)" in caplog.text
    assert "graph_batch dropped too" in caplog.text
    plain = ttrainer.run_exp(port_cfg(data_prefix, tmp_path, "plain", **kw))
    a, b = load_checkpoint(path), load_checkpoint(plain)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_raw_spmm_stays_forward_only():
    """spmm_csr called directly refuses a gradient and points at SpmmCSR,
    through which every path that trains (the dist convs too) takes its
    gradient."""
    g, _ = random_graph(np.random.RandomState(5))
    gt = GraphTensors.from_graph(g, "cpu")
    x = torch.randn(g.nvars, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only.*SpmmCSR"):
        tspmm.spmm_csr(gt.rowptr, gt.col, gt.val_r, x)
