"""The system under test, driven as ``lp_gnn_tpu_torch.train.trainer
run_exp``'s ``run_one`` drives it: one ``train_step`` a graph on the
tensors ``train_graph`` builds (the input conv's cached aggregations
where the model reads them, the edge permutations for GEN), Adam from
``make_optimizer``, the configuration's loss from ``LOSS_REGISTRY``,
dropout from a ``torch.Generator`` on the device, the decode accuracy on
the trainer's logging steps, and one host read of the loss (and of that
accuracy) after each step. The only module of the benchmark that imports
the program.

The check's first steps keep the dropout masks the program applies
(:func:`tapped_dropout`), so that the reference applies the same ones
however the program draws them.
"""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.train import losses, trainer

from .check import Record


class Trainer:
    """One model, its optimizer and its graphs on ``device``, built once
    and stepped by :meth:`step`."""

    def __init__(self, cfg: dict, lps: list, weights: dict, dropout_seed: int,
                 device: torch.device):
        with torch.device("meta"):
            model = build_model(cfg["arch"])
        model = model.to_empty(device=device)
        model.load_state_dict(weights, strict=True)
        self.model = model.train()
        self.beta1 = cfg["betas"][0]
        self.optimizer = trainer.make_optimizer(
            model.parameters(), cfg["opt"], cfg["lr"],
            weight_decay=cfg["weight_decay"])
        self.loss_fn = losses.LOSS_REGISTRY[cfg["loss"]]
        self.gen = torch.Generator(device=device).manual_seed(dropout_seed)
        t0 = time.perf_counter()
        self.graphs = [trainer.train_graph(model, to_program(lp, i), device)
                       for i, lp in enumerate(lps)]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.graphs_s = time.perf_counter() - t0   # train_graph's share
        self.glstep = 0

    def step(self, i: int) -> float:
        """One training step on graph ``i``; returns its loss, read on the
        host."""
        self.glstep += 1
        with_acc = self.glstep % trainer.LOG_EVERY == 1
        loss, acc = trainer.train_step(self.model, self.optimizer,
                                       self.graphs[i], self.loss_fn,
                                       self.gen, with_acc)
        value = float(loss)
        if acc is not None:
            float(acc)
        return value

    def first_steps(self, order: list[int], weights: dict) -> Record:
        """The first ``len(order)`` steps, read as the check compares them:
        each loss, each leaf's first gradient from Adam's state after step
        1 (its norm, and itself on the host), each leaf's change from
        ``weights`` after the last, and the dropout masks the steps
        applied."""
        names = [k for k, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        losses_, grad1, grad1_vec, masks = [], {}, {}, []
        for i in order:
            with tapped_dropout(self.model, masks):
                losses_.append(self.step(i))
            if len(losses_) == 1:
                moments = [self.optimizer.state.get(p, {}).get("exp_avg")
                           for p in params]
                vecs = [torch.zeros(p.shape) if m is None
                        else m.float().cpu() / (1 - self.beta1)
                        for m, p in zip(moments, params)]
                grad1 = {k: float(v.norm()) for k, v in zip(names, vecs)}
                grad1_vec = dict(zip(names, vecs))
        with torch.no_grad():
            change = torch.stack([(p.float() - weights[k].float()).norm()
                                  for k, p in zip(names, params)]).tolist()
        return Record(losses=losses_, grad1=grad1,
                      change=dict(zip(names, change)), masks=masks,
                      grad1_vec=grad1_vec)


@contextlib.contextmanager
def tapped_dropout(model, masks: list):
    """Every dropout mask ``model`` applies meanwhile, appended to
    ``masks`` on the host in the order applied: the program's ``dropout``
    as the model's module calls it, wrapped. An entry is kept where the
    output is nonzero or the input zero (where kept and dropped agree)."""
    module = sys.modules[type(model).__module__]
    applied = getattr(module, "dropout", None)
    if applied is None:
        raise RuntimeError(f"{module.__name__} calls no dropout to tap: "
                           f"the check needs the masks it applies")

    def tap(x, rate, generator, train):
        out = applied(x, rate, generator, train)
        if out is not x:
            masks.append(_kept(x, out))
        return out

    module.dropout = tap
    try:
        yield
    finally:
        module.dropout = applied


def _kept(x: torch.Tensor, out: torch.Tensor, rows: int = 1 << 16):
    """The mask of ``out = dropout(x)`` on the host, a block of rows at a
    time so that the device holds no mask of the whole."""
    mask = torch.empty(x.shape, dtype=torch.bool)
    for s in range(0, x.shape[0], rows):
        mask[s:s + rows] = ((out[s:s + rows] != 0) |
                            (x[s:s + rows] == 0)).cpu()
    return mask


def to_program(lp, i: int) -> BipartiteGraph:
    """The program's host graph of an LP the benchmark drew."""
    return BipartiteGraph(row=lp.row, col=lp.col, val=lp.val,
                          c_feas=lp.c_feas, v_feas=lp.v_feas, y_s=lp.y_s,
                          y_t=lp.y_t, fn=f"lp{i}")
