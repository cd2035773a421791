"""Training engine (counterpart of ``lp_gnn_tpu/train/trainer.py``; reference
train.py:55-172): the single-device, full-graph path of ``run_exp``.

- Optimizer: ``torch.optim.Adam(weight_decay=5e-4)``, the coupled L2 decay
  the JAX package builds as optax ``add_decayed_weights`` +
  ``scale_by_adam`` (trainer.py:45-53); StepLR(max(epochs // 4, 1), 0.1)
  set on the param groups each epoch (trainer.py:56), so a resume is exact.
- One step a graph, graphs in the order ``np.random.RandomState(seed)
  .permutation(n_train)`` draws each epoch, as the JAX package does. Graph
  tensors are built once a graph and kept across epochs, with what the
  model reads (``train_graph``): the input conv's aggregations
  (``attach_input_agg``, exact) for the models that use them, the edge
  permutations for GEN's backward.
- Dropout draws from one ``torch.Generator`` seeded with ``--seed`` on the
  run's device (the JAX package splits a PRNG key a step; the masks
  differ).
- Checkpoints every epoch, each written atomically: ``{log_dir}/mdl.pth``,
  the model's fp32 ``state_dict`` under the reference key names (the JAX
  ``load_ckpt`` reads it), and ``{log_dir}/train_state.pth``: the same
  weights, optimizer state, the next epoch, the step count and the random
  states, so a resume continues the run exactly. A resume reads the
  weights from ``train_state.pth``: a save cut between the two files
  leaves ``mdl.pth`` an epoch behind, never a pair from two epochs.

What the JAX ``run_exp`` also does and the port does not yet raises and
names its ROADMAP item: sampled training of a graph above
``edge_num_thresh``, ``--mesh_shape`` dp / edge training, ``--graph_batch``
and ``--steps_per_call`` above 1, ``--trace 1``.
"""
from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from collections import OrderedDict

import numpy as np
import torch

from ..config import Config
from ..data.dataset import LPDataset, split_train_val
from ..data.graph import GraphTensors
from ..device import resolve_device
from ..infer.decode import decode_topm_device
from ..infer.predict import model_inference
from ..models.convert import is_torch_checkpoint, load_checkpoint
from ..models.gcn import build_model
from ..ops.spmm import attach_input_agg
from ..parallel.mesh import parse_mesh_shape
from ..utils.misc import AverageMeter
from ..utils.serialize import json_dump
from .losses import LOSS_REGISTRY
from .metrics import accuracy

LOG_EVERY = 9   # steps glstep % 9 == 1 reach the log (trainer.py:529)


# ------------------------------------------------------------------ optimizer
def make_optimizer(params, opt: str = "adam", lr: float = 1e-3,
                   weight_decay: float = 5e-4) -> torch.optim.Optimizer:
    """torch.optim.Adam / SGD with coupled weight decay (trainer.py:45):
    ``adam``, and anything else SGD without momentum, as there."""
    if opt == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)


def step_lr(base_lr: float, epochs: int, epoch: int,
            gamma: float = 0.1) -> float:
    """StepLR(step_size=max(epochs // 4, 1), gamma) (trainer.py:56)."""
    return base_lr * gamma ** (epoch // max(epochs // 4, 1))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


# ----------------------------------------------------------------- train step
def seed_masks(g: GraphTensors):
    """The loss masks (trainer.py:63): every node of a full graph."""
    ones = torch.ones((), dtype=torch.bool, device=g.device)
    return ones.expand(g.ncons), ones.expand(g.nvars)


def step_accuracy(g: GraphTensors, lc, lv, ms, mt):
    """The top-m decode's accuracy over the seed nodes, on the device
    (trainer.py:70)."""
    pc, pv = decode_topm_device(lc, lv, ms, mt, ms.sum())
    correct = ((pc == g.y_s) & ms).sum() + ((pv == g.y_t) & mt).sum()
    return correct / (ms.sum() + mt.sum()).clamp(min=1)


def train_step(model, optimizer, g: GraphTensors, loss_fn,
               generator: torch.Generator | None = None,
               with_acc: bool = False):
    """One step on one graph (trainer.py:80 make_train_step): forward in
    training mode, the loss over the seed nodes, backward, the optimizer's
    update. Returns the loss before the update and, if ``with_acc``, the
    decode accuracy of the same forward (else None), both 0-d tensors on
    the device: reading them is the caller's synchronization."""
    model.train()
    lc, lv = model(g, generator=generator)
    ms, mt = seed_masks(g)
    loss = loss_fn(lc, lv, g.y_s, g.y_t, ms, mt)
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:   # GCNRand's logits depend on no parameter
        loss.backward()
    optimizer.step()
    acc = None
    if with_acc:
        with torch.no_grad():
            acc = step_accuracy(g, lc.detach(), lv.detach(), ms, mt)
    return loss.detach(), acc


def train_graph(model, g, device) -> GraphTensors:
    """One training graph's tensors on ``device`` with its labels and what
    ``model`` reads: the edge permutations where its backward needs them
    (GEN's gather), the input conv's cached aggregations where its input
    conv uses them (not GEN's: its aggregation depends on its parameters,
    trainer.py:457-459; not GCNRand's, which reads no graph)."""
    gt = GraphTensors.from_graph(g, device, labels=True,
                                 perms=model.needs_edge_perms)
    if model.reads_input_agg:
        gt = attach_input_agg(gt, model.cdtype)
    return gt


# ------------------------------------------------------------------ metrics IO
class MetricsWriter:
    """``{log_dir}/metrics.jsonl``, one ``{tag, value, step, t}`` a line,
    and TensorBoard where it imports (trainer.py:168)."""

    def __init__(self, log_dir: str, use_tb: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = osp.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(osp.join(log_dir, "tb_logs"))
            except ImportError:   # no tensorboard package: jsonl only
                self.tb = None

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "t": time.time()}) + "\n")
        self._f.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


# ---------------------------------------------------------------- checkpoints
def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(log_dir: str, model, optimizer, epoch: int,
                    extra: dict | None = None,
                    run_state: dict | None = None) -> str:
    """``{log_dir}/train_state.pth`` (``model``: the state_dict as it is,
    ``opt_state``, ``epoch`` = the next epoch to run, ``extra``, and
    ``run_state``: what an exact resume needs beyond them), then
    ``{log_dir}/mdl.pth`` (the fp32 state_dict, reference key names).
    Returns the ``mdl.pth`` path."""
    mdl = osp.join(log_dir, "mdl.pth")
    _save_atomic({"model": OrderedDict((k, v.detach().cpu())
                                       for k, v in model.state_dict().items()),
                  "opt_state": optimizer.state_dict(), "epoch": int(epoch),
                  "extra": extra or {}, "run_state": run_state or {}},
                 osp.join(log_dir, "train_state.pth"))
    _save_atomic(OrderedDict((k, v.detach().float().cpu())
                             for k, v in model.state_dict().items()), mdl)
    return mdl


def load_for_training(path: str):
    """(state_dict, train state or None) from ``--load_from``: a port
    ``mdl.pth`` with ``train_state.pth`` beside it resumes fully, with the
    weights that ``train_state.pth`` holds (they and its optimizer state
    come from one save, whatever ``mdl.pth`` holds); a reference ``mdl.pth``
    or a JAX ``mdl.ckpt`` gives the weights only (a JAX checkpoint's optax
    moments cannot be read without optax)."""
    state_path = osp.join(osp.dirname(path) or ".", "train_state.pth")
    if is_torch_checkpoint(path) and osp.exists(state_path):
        # on the CPU: Optimizer.load_state_dict moves the moments to their
        # params' device and keeps Adam's step counts on the host
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        return state["model"], state
    logging.warning("%s: weights only, no train_state.pth beside it: fresh "
                    "optimizer from epoch 0", path)
    return load_checkpoint(path), None


def _rng_state(rng_np: np.random.RandomState, gen: torch.Generator,
               glstep: int) -> dict:
    name, keys, pos, has_gauss, gauss = rng_np.get_state()
    return {"glstep": glstep, "generator": gen.get_state(),
            "np_rng": [name, torch.from_numpy(keys.astype(np.int64)), pos,
                       has_gauss, gauss]}


def _restore_rng(state: dict, rng_np: np.random.RandomState,
                 gen: torch.Generator) -> int:
    if not state:
        return 0
    name, keys, pos, has_gauss, gauss = state["np_rng"]
    rng_np.set_state((name, keys.numpy().astype(np.uint32), pos,
                      has_gauss, gauss))
    gen.set_state(state["generator"])
    return int(state["glstep"])


# -------------------------------------------------------------------- run_exp
def _refuse_unported(cfg: Config) -> None:
    mesh = parse_mesh_shape(cfg.mesh_shape or "")
    if mesh.get("dp", 1) > 1 or mesh.get("edge", 1) > 1:
        raise NotImplementedError(
            f"--mesh_shape {cfg.mesh_shape}: data-parallel and "
            "edge-partitioned training are not ported to lp_gnn_tpu_torch "
            "yet (ROADMAP.md, queue item 6: dp; queue item 7: edge "
            "partition, the rest)")
    if cfg.graph_batch > 1:
        raise NotImplementedError(
            f"--graph_batch {cfg.graph_batch}: several graphs a step go "
            "through the batched (dp) step, which is not ported yet "
            "(ROADMAP.md, queue item 6: dp)")
    if cfg.steps_per_call > 1:
        raise NotImplementedError(
            f"--steps_per_call {cfg.steps_per_call}: several steps a "
            "dispatch is not ported yet (ROADMAP.md, later: a multi-step "
            "dispatch analog of make_scan_train_step)")
    if cfg.trace:
        raise NotImplementedError(
            "--trace 1: the profiler trace of an epoch is not ported yet "
            "(ROADMAP.md, later: profiling on torch.profiler)")
    if cfg.loss not in LOSS_REGISTRY:
        raise ValueError(f"loss {cfg.loss!r}: one of {sorted(LOSS_REGISTRY)}")


def quick_val(model, val_ds: LPDataset, cfg: Config) -> float:
    """Mean decode accuracy over the val split, one full-graph forward a
    graph (trainer.py:711 _quick_val)."""
    model.eval()
    total = 0.0
    for i in range(len(val_ds)):
        g = val_ds[i]
        lc, lv = model_inference(model, g)
        total += accuracy(np.concatenate([lc, lv]),
                          np.concatenate([g.y_s, g.y_t]), g.ncons,
                          dataset_name=cfg.dataset)
    model.train()
    return total / max(len(val_ds), 1)


def run_exp(cfg: Config, dataset: LPDataset | None = None) -> str:
    """A full training run on ``cfg.device`` (trainer.py:282, the
    single-device full-graph branch); returns the ``mdl.pth`` path."""
    device = resolve_device(cfg.device)
    _refuse_unported(cfg)
    log_dir = cfg.log_dir
    writer = MetricsWriter(log_dir)
    json_dump(cfg.to_dict(), osp.join(log_dir, "args.json"))

    ds = dataset or LPDataset(cfg.dataset_processed_prefix)
    train_ds, val_ds = split_train_val(ds, cfg.seed)
    model = build_model(cfg.arch_with_dtype(),
                        generator=torch.Generator().manual_seed(cfg.seed))
    state = None
    if cfg.load_from.lower() != "none":
        sd, state = load_for_training(cfg.load_from)
        model.load_state_dict(sd)
    model.to(device).train()
    optimizer = make_optimizer(model.parameters(), cfg.opt, cfg.lr)
    loss_fn = LOSS_REGISTRY[cfg.loss]
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    rng_np = np.random.RandomState(cfg.seed)
    start_epoch, glstep = 0, 0
    if state is not None:
        optimizer.load_state_dict(state["opt_state"])
        start_epoch = int(state["epoch"])
        glstep = _restore_rng(state.get("run_state"), rng_np, gen)
        logging.info("resumed from %s at epoch %d", cfg.load_from,
                     start_epoch)

    graphs: dict[int, GraphTensors] = {}

    def graph_for(idx: int) -> GraphTensors:
        """``train_graph``'s tensors, built once a graph and kept."""
        if idx not in graphs:
            g = train_ds[idx]
            if g.nnz > cfg.edge_num_thresh:
                raise NotImplementedError(
                    f"{g.fn}: {g.nnz} edges > edge_num_thresh="
                    f"{cfg.edge_num_thresh:g} takes sampled training, which "
                    "is not ported to lp_gnn_tpu_torch yet (ROADMAP.md, "
                    "queue item 5: sampling)")
            graphs[idx] = train_graph(model, g, device)
        return graphs[idx]

    loss_meter, acc_meter = AverageMeter(), AverageMeter()
    n_train = len(train_ds)
    extra = {"arch": cfg.arch, "loss": cfg.loss}
    mdl_path = osp.join(log_dir, "mdl.pth")
    for epoch in range(start_epoch, cfg.epochs):
        lr = step_lr(cfg.lr, cfg.epochs, epoch)
        set_lr(optimizer, lr)
        loss_meter.reset(), acc_meter.reset()
        for idx_graphs, gi in enumerate(rng_np.permutation(n_train)):
            gt = graph_for(int(gi))
            glstep += 1
            want_acc = bool(cfg.step_acc) or glstep % LOG_EVERY == 1
            loss, acc = train_step(model, optimizer, gt, loss_fn, gen,
                                   want_acc)
            loss_v = float(loss)
            if np.isnan(loss_v):
                raise FloatingPointError(
                    f"nan loss at step {glstep} (reference train.py:126)")
            loss_meter.update(loss_v)
            if acc is not None:
                acc_meter.update(float(acc))
            if glstep % LOG_EVERY == 1:
                logging.info("ep %d %d/%d step %d loss %.4f acc %.4f lr %g",
                             epoch, idx_graphs, n_train, glstep,
                             loss_meter.avg, acc_meter.avg, lr)
                writer.scalar("epoch", epoch, glstep)
                writer.scalar("train/loss", loss_meter.avg, glstep)
                writer.scalar("train/acc", acc_meter.avg, glstep)
                writer.scalar("train/lr", lr, glstep)
        # the NEXT epoch to run, so a resume does not repeat this one
        save_checkpoint(log_dir, model, optimizer, epoch + 1, extra,
                        _rng_state(rng_np, gen, glstep))
        if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0 and \
                len(val_ds):
            va = quick_val(model, val_ds, cfg)
            writer.scalar("val/acc", va, glstep)
            logging.info("epoch %d val acc %.4f", epoch, va)
    if start_epoch >= cfg.epochs:   # no epoch ran: the loaded weights
        save_checkpoint(log_dir, model, optimizer, cfg.epochs, extra,
                        _rng_state(rng_np, gen, glstep))
    writer.close()
    return mdl_path
