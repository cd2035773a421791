"""Training engine (counterpart of ``lp_gnn_tpu/train/trainer.py``; reference
train.py:55-172): ``run_exp`` on one device or over the ranks of a process
group (dp, edge shards a rank, or both on a grid), on full graphs, sampled
subgraphs and graph-batched unions.

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

- A graph above ``edge_num_thresh`` is sampled afresh every epoch
  (``data/sampling.py``, fanout ``[6] * max(depth - 1, 1)``, ``--batch_size``
  seeds, trainer.py:467-470) at its place in the epoch, from the run's
  numpy stream, and takes one step a subgraph over the subgraph's seeds;
  its tensors are built a subgraph at a time, with the input cache (2 SpMM
  launches a subgraph, as many as the input conv would run inline).
- ``--graph_batch B`` and ``--mesh_shape dp=K`` (trainer.py:472-490,
  649-671): the graphs at or below ``edge_num_thresh`` are grouped as the
  JAX trainer groups them (``parallel/dp.py stack_groups``), each stack of
  K*B graphs one step over the disjoint union of this rank's B
  (``dp_train_step``), in the order ``rng_np.permutation(len(stacks))``
  draws; then the graphs left single, then the sampled ones. ``dp=K``
  runs K ranks of the ``LP_GNN_DIST_*`` contract (``parallel/mesh.py``),
  or, in one process that sees K cards, JAX's own layout: block d of each
  stack one union on card d, its replica's forward in a thread of its own
  (``parallel/mesh.py DeviceGrid``, column 0; ``dp_train_step`` with
  ``threads``). With neither it falls back to single-graph steps with a
  warning, as trainer.py:477-481 does. Only rank 0 writes files.

- ``--mesh_shape edge=K`` (trainer.py:356-391, 445-461, 611-620): the
  graphs above ``edge_num_thresh`` are partitioned once
  (``parallel/edge_partition.py cached_partition_graph``, the dataset's
  ``partitions/`` cache; with the halo lists for every arch in
  ``DIST_HALO_ARCHS``, the all-gather layout for GCNRand, trainer.py:368),
  their K shards' tensors built on the run's
  device (or, one process with K cards visible, shard k on
  cuda:k as trainer.py:346-387 lays out its devices)
  with the input conv's aggregations (not for GEN) and kept, and
  each takes one ``dist_train_step`` a visit, without per-step accuracy;
  smaller graphs keep the full-graph step. The val pass sends graphs above
  the threshold through the dist forward. Under the contract with K ranks
  (trainer.py:356-391, the edge axis across processes) shard k lives on
  rank k: every rank partitions each graph and keeps its shard, K1 runs
  in its rank form, the losses' sums and the gradients are summed over
  the ranks (``dist_train_step``), the smaller graphs' steps run the same
  on every rank, and the val pass gathers the logits to rank 0, which
  alone writes. ``--graph_batch B`` there stacks the smaller graphs into
  B-graph unions that every rank runs alike (``dp_step`` with
  ``dp_mesh={"dp": 1}``, trainer.py:482-490); the oversize graphs keep
  the single-graph dist step.
- ``--mesh_shape dp=K,edge=E`` (trainer.py:356-387, 570-671): the graphs
  above ``edge_num_thresh`` are grouped by bucket into batches of
  K*graph_batch (``parallel/combined.py dist_stack_groups``), built once;
  each rank partitions its block of each batch at the batch's shared
  sizes (``partition_batch``, outside the partition cache) and keeps its
  tensors; each batch is one ``dp_edge_train_step``, the batches in the
  order ``rng_np.permutation`` draws before the dp stacks'. An oversize
  graph left over takes ``dist_train_step`` on every rank; the rest is the
  dp path above. Over K ranks each rank holds all E shards of its graphs;
  over K*E ranks the ranks are JAX's (dp, edge) grid (trainer.py:371-387,
  ``parallel/mesh.py RankGrid``): row d takes block d of each batch, rank
  (d, e) shard e of each of its graphs, over the row's edge group, and
  the gradients are reduced over the grid (``combined.grid_average``); an
  oversize graph left over runs over each row's edge group, every row the
  same graph (dp replicated); the dp stacks of smaller graphs run over
  each column, every rank of a row the same union (edge replicated), their
  gradients averaged over every rank (``dp_train_step``). The
  val pass runs on row 0's edge group, and rank 0 scores and writes. In
  one process that sees K*E cards the grid is one of devices
  (``parallel/mesh.py DeviceGrid``, trainer.py:346-387): row d takes block
  d of each batch on its edge mesh of one shard a device, one step over
  every row (``dp_edge_train_step`` with the grid); a leftover oversize
  graph takes ``dist_train_step`` once, over row 0's devices (JAX
  replicates it over dp with equal keys, so every row computes the same
  gradient); the dp stacks run over column 0's devices; the val pass over
  row 0. With neither the ranks nor the cards the dp axis is dropped with
  a warning (trainer.py:350-353) and the run is edge-only.
- ``--cache_in_agg 0`` (config.py:116) builds no input aggregation cache:
  the input conv aggregates in every step.

- ``--steps_per_call K`` above 1 (trainer.py:492-500, 672-691), without
  dp and ``--graph_batch``: the graphs at or below ``edge_num_thresh`` are
  grouped as for a batched step (``stack_groups`` with K), each stack one
  call of ``train/scan.py``'s K-step function (one CUDA graph a stack on
  the card after its first visit; Adam built ``capturable``), in the order
  ``rng_np.permutation(len(stacks))`` draws, with one read of the K losses
  and ``log_step`` for each; then the graphs left single and those above
  the threshold (sampled, or their dist step under ``--mesh_shape
  edge=K``), in their stacking order.
- ``--trace 1`` (trainer.py:507-520, 693-695): ``torch.profiler`` over the
  epoch after the first (the first if only one runs) into
  ``{log_dir}/trace`` (``utils/profiling.py``); ``show_resource`` at every
  epoch divisible by 99.
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
import torch.distributed as dist

from ..config import Config
from ..data.dataset import LPDataset, split_train_val
from ..data.graph import GraphTensors, seed_masks as _seed_masks, union
from ..data.sampling import sample_subgraphs
from ..device import resolve_device
from ..infer.decode import decode_topm_device
from ..infer.predict import (mesh_from_cfg, model_inference, part_cache_dir,
                             runs_here)
from ..models.convert import is_torch_checkpoint, load_checkpoint
from ..models.gcn import build_model
from ..ops.spmm import attach_input_agg
from ..parallel.combined import (dist_stack_groups, dp_edge_train_step,
                                 partition_batch)
from ..parallel.dp import (dp_train_step, rank_block, stack_groups,
                           step_generator)
from ..parallel import mesh as pmesh
from ..parallel.edge_partition import (DIST_HALO_ARCHS, DistGraphTensors,
                                       cached_partition_graph,
                                       dist_tensors, dist_train_step)
from ..parallel.mesh import (from_primary, grid_from_shape,
                             init_distributed, is_primary,
                             leave_distributed, log_routes, make_device_grid,
                             parse_mesh_shape, world_and_rank)
from ..utils.misc import AverageMeter
from ..utils.profiling import show_resource, trace
from ..utils.serialize import json_dump
from .losses import LOSS_REGISTRY
from .metrics import accuracy
from .scan import make_scan_train_step

LOG_EVERY = 9   # steps glstep % 9 == 1 reach the log (trainer.py:529)


# ------------------------------------------------------------------ optimizer
def make_optimizer(params, opt: str = "adam", lr: float = 1e-3,
                   weight_decay: float = 5e-4,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """torch.optim.Adam / SGD with coupled weight decay (trainer.py:45):
    ``adam``, and anything else SGD without momentum, as there.
    ``capturable`` (for CUDA graphs, ``train/scan.py``) builds Adam with its
    step counts on the parameters' device and its learning rate a tensor
    there, which :func:`set_lr` writes in place (the bias corrections are
    then computed on the device in fp32)."""
    params = list(params)
    if opt == "adam":
        if capturable:
            lr = torch.tensor(float(lr), device=params[0].device)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay,
                                capturable=capturable)
    return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)


def step_lr(base_lr: float, epochs: int, epoch: int,
            gamma: float = 0.1) -> float:
    """StepLR(step_size=max(epochs // 4, 1), gamma) (trainer.py:56)."""
    return base_lr * gamma ** (epoch // max(epochs // 4, 1))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate; a tensor one is written in place."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state: dict) -> None:
    """``optimizer.load_state_dict(state)`` keeping the optimizer's own
    form, whichever form wrote ``state``: torch takes the saved groups'
    settings, so each group gets back its ``capturable`` flag and its own
    learning rate object (a tensor filled in place, or a float) with the
    saved value, and Adam's step counts move to where that form keeps them
    (the parameter's device if capturable, else the host)."""
    own = [(g["lr"], g.get("capturable")) for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (lr, capturable) in zip(optimizer.param_groups, own):
        saved = float(group["lr"])
        if torch.is_tensor(lr):
            lr.fill_(saved)
            group["lr"] = lr
        else:
            group["lr"] = saved
        if capturable is None:
            continue
        group["capturable"] = capturable
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = torch.tensor(
                    float(st["step"]), dtype=torch.float32,
                    device=p.device if capturable else "cpu")


# ----------------------------------------------------------------- train step
def seed_masks(g: GraphTensors):
    """The loss masks (trainer.py:63): the seed prefix, every node of a
    full graph."""
    return _seed_masks(g.ncons, g.nvars, g.s_bs, g.t_bs, g.device)


def step_accuracy(g: GraphTensors, lc, lv, ms, mt):
    """The top-m decode's accuracy over the seed nodes, on the device
    (trainer.py:70)."""
    pc, pv = decode_topm_device(lc, lv, ms, mt, ms.sum())
    correct = ((pc == g.y_s) & ms).sum() + ((pv == g.y_t) & mt).sum()
    return correct / (ms.sum() + mt.sum()).clamp(min=1)


def train_step(model, optimizer, g: GraphTensors, loss_fn,
               generator: torch.Generator | None = None,
               with_acc: bool = False, logits_out=None):
    """One step on one graph (trainer.py:80 make_train_step): forward in
    training mode, the loss over the seed nodes, backward, the optimizer's
    update. Returns the loss before the update and, if ``with_acc``, the
    decode accuracy of the same forward (else None), both 0-d tensors on
    the device: reading them is the caller's synchronization.
    ``logits_out``: a (cons, vars) pair of fp32 tensors the forward's
    logits are copied into (a CUDA graph's outputs, ``train/scan.py``)."""
    model.train()
    lc, lv = model(g, generator=generator)
    if logits_out is not None:
        logits_out[0].copy_(lc.detach())
        logits_out[1].copy_(lv.detach())
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


def train_graph(model, g, device, s_bs: int | None = None,
                t_bs: int | None = None,
                input_agg: bool = True) -> GraphTensors:
    """One training graph's tensors on ``device`` with its labels, its
    seeds (a sampled subgraph's prefix; all nodes by default) and what
    ``model`` reads: the edge permutations where its backward needs them
    (GEN's gather), and with ``input_agg`` (``--cache_in_agg``) the input
    conv's cached aggregations where its input conv uses them (not GEN's:
    its aggregation depends on its parameters, trainer.py:457-459; not
    GCNRand's, which reads no graph)."""
    gt = GraphTensors.from_graph(g, device, labels=True,
                                 perms=model.needs_edge_perms,
                                 s_bs=s_bs, t_bs=t_bs)
    if input_agg and model.reads_input_agg:
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


class NullWriter:
    """The writer of a rank other than 0, which writes no file
    (trainer.py:201)."""

    def scalar(self, tag: str, value: float, step: int):
        pass

    def close(self):
        pass


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
def quick_val(model, val_ds: LPDataset, cfg: Config, mesh) -> float | None:
    """Mean decode accuracy over the val split, one full-graph forward a
    graph (trainer.py:711 _quick_val); under ``--mesh_shape edge=K`` the
    graphs above ``edge_num_thresh`` take the dist forward over ``mesh``
    (the run's edge mesh, or None), as ``model_inference`` does given a
    mesh. Over an edge mesh of ranks, rank 0 scores (the others take part
    in the dist forwards and return None); on a (dp, edge) grid of ranks,
    row 0's ranks run the forwards and the other rows nothing
    (``runs_here``); on a grid of devices, row 0's edge mesh serves."""
    model.eval()
    thresh = cfg.edge_num_thresh if mesh is not None else np.inf
    total = 0.0
    for i in range(len(val_ds)):
        g = val_ds[i]
        if not runs_here(g, thresh, mesh):
            continue
        lc, lv = model_inference(model, g, thresh, mesh=mesh,
                                 part_dir=part_cache_dir(cfg))
        if lc is None:
            continue
        total += accuracy(np.concatenate([lc, lv]),
                          np.concatenate([g.y_s, g.y_t]), g.ncons,
                          dataset_name=cfg.dataset)
    model.train()
    if mesh is not None and mesh.group is not None and not is_primary():
        return None   # rank 0 scored
    return total / max(len(val_ds), 1)


def batch_shape(cfg: Config, world: int,
                device: torch.device | None = None) -> tuple[int, int]:
    """(dp, graph_batch) of the run: ``--mesh_shape dp=K`` over K ranks
    of the process group, or ``dp=K,edge=E`` over K (each rank holding all
    E shards) or K*E ranks (the grid); in one process on ``device``, over
    the devices of the process where ``parallel/mesh.py
    one_shard_a_device`` grants K (or K*E) of them (the grid of devices);
    with neither, single-graph steps with a warning, graph_batch dropped
    too (trainer.py:477-481); under dp x edge, the dp axis alone is
    dropped with a warning (trainer.py:350-353), and the run is
    edge-only. With edge shards on their own ranks (``edge=K`` over K
    ranks) dp is 1 and ``--graph_batch`` stacks the smaller graphs alike on
    every rank."""
    mesh = parse_mesh_shape(cfg.mesh_shape or "")
    dp_size = int(mesh.get("dp", 1))
    graph_batch = max(int(cfg.graph_batch), 1)
    edge_size = int(mesh.get("edge", 1))
    if world > 1 and dp_size == 1 and edge_size == world:
        return 1, graph_batch   # one shard a rank: no dp axis
    if world > 1 and dp_size > 1 and edge_size > 1 and \
            dp_size * edge_size == world:
        return dp_size, graph_batch   # the (dp, edge) grid
    if world == 1 and dp_size > 1 and device is not None and \
            pmesh.one_shard_a_device(device, dp_size * edge_size):
        return dp_size, graph_batch   # the grid of devices
    # JAX's fallbacks, over what the run lays its mesh on: the ranks, or in
    # one process on a card the cards
    have, what = world, "rank(s)"
    if world == 1 and device is not None and device.type == "cuda":
        have, what = torch.cuda.device_count(), "card(s)"
    if dp_size > 1 and edge_size > 1 and dp_size > world:
        logging.warning("mesh_shape dp=%d,edge=%d exceeds %d %s — "
                        "dropping the dp axis", dp_size, edge_size, have,
                        what)
        dp_size = 1
    if dp_size > world:
        logging.warning("mesh_shape dp=%d exceeds %d %s — falling back "
                        "to single-device steps%s", dp_size, have, what,
                        " (graph_batch dropped too)" if graph_batch > 1
                        else "")
        return 1, 1
    if world > 1 and dp_size != world:
        raise ValueError(f"the process group has {world} ranks: "
                         f"--mesh_shape dp={dp_size} must name them all, "
                         f"edge={world} one shard each, or dp=D,edge=E "
                         "with D*E of them")
    return dp_size, graph_batch


def run_exp(cfg: Config, dataset: LPDataset | None = None) -> str:
    """A full training run on ``cfg.device`` (trainer.py:282); returns the
    ``mdl.pth`` path. Under the ``LP_GNN_DIST_*`` contract it joins the
    process group first (and leaves a group it created when it ends)."""
    device = resolve_device(cfg.device)
    if cfg.loss not in LOSS_REGISTRY:
        raise ValueError(f"loss {cfg.loss!r}: one of {sorted(LOSS_REGISTRY)}")
    device, own_group = init_distributed(device)
    try:
        return _run(cfg, dataset, device)
    finally:
        if dist.is_initialized():
            leave_distributed(own_group)


def _run(cfg: Config, dataset: LPDataset | None, device) -> str:
    world, rank = world_and_rank()
    dp_size, graph_batch = batch_shape(cfg, world, device)
    stack_size = dp_size * graph_batch
    spec = parse_mesh_shape(cfg.mesh_shape or "")
    # this rank's place on the dp axis: its grid row, its rank for dp
    # ranks, 0 for one process or edge ranks alone
    grid = grid_from_shape(spec)
    dp_rank = grid.d if grid is not None else rank if dp_size > 1 else 0
    # dp in one process: JAX's (dp, edge) grid over the cards from this one
    cells = None
    if world == 1 and dp_size > 1:
        edge_size = max(int(spec.get("edge", 1)), 1)
        cells = make_device_grid(dp_size, edge_size, pmesh.shard_devices(
            device, dp_size * edge_size))
    primary = rank == 0
    log_dir = cfg.log_dir
    writer = MetricsWriter(log_dir) if primary else NullWriter()
    if primary:
        json_dump(cfg.to_dict(), osp.join(log_dir, "args.json"))

    ds = dataset or LPDataset(cfg.dataset_processed_prefix)
    train_ds, val_ds = split_train_val(ds, cfg.seed)
    model = build_model(cfg.arch_with_dtype(),
                        generator=torch.Generator().manual_seed(cfg.seed))
    state = None
    if cfg.load_from.lower() != "none":
        sd, state = from_primary(load_for_training, cfg.load_from)
        model.load_state_dict(sd)
    model.to(device).train()
    # --steps_per_call K: K steps a call (trainer.py:492-500), not with dp
    # or --graph_batch, which batch their own steps
    scan_k = max(int(cfg.steps_per_call), 1)
    use_scan = stack_size == 1 and scan_k > 1
    optimizer = make_optimizer(model.parameters(), cfg.opt, cfg.lr,
                               capturable=use_scan and device.type == "cuda")
    loss_fn = LOSS_REGISTRY[cfg.loss]
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    rng_np = np.random.RandomState(cfg.seed)
    start_epoch, glstep = 0, 0
    if state is not None:
        load_optimizer_state(optimizer, state["opt_state"])
        start_epoch = int(state["epoch"])
        glstep = _restore_rng(state.get("run_state"), rng_np, gen)
        logging.info("resumed from %s at epoch %d", cfg.load_from,
                     start_epoch)
    if stack_size > 1:
        logging.info("batched training: %d %s x %d graphs a step", dp_size,
                     "rank(s)" if cells is None else "device(s)",
                     graph_batch)
    scan = None
    if use_scan:
        scan = make_scan_train_step(model, cfg.loss, optimizer, stacked=True,
                                    generator=gen)
        logging.info("scanned training: %d steps a call", scan_k)

    graphs: dict = {}   # tensors kept across epochs: graphs and unions
    hops = max(cfg.arch_depth() - 1, 1)
    input_agg = bool(cfg.cache_in_agg)
    # on a grid of devices the leftover oversize graphs' steps and the val
    # pass run over row 0 (trainer.py:336-338)
    mesh = cells.rows[0] if cells is not None and cells.edge > 1 else \
        mesh_from_cfg(cfg, device)
    # the halo exchange for the archs that exchange anything, the
    # all-gather partition for GCNRand (trainer.py:368)
    dist_halo = model.name in DIST_HALO_ARCHS
    if cells is not None:
        logging.info("device grid: dp=%d x edge=%d cells in this process, "
                     "cell (d, e) on %s", cells.dp, cells.edge, ", ".join(
                         f"({i // cells.edge}, {i % cells.edge}) {dev}"
                         for i, dev in enumerate(cells.devices)))
    if mesh is not None:
        logging.info("edge-partitioned training: %d shards on %s, graphs "
                     "above %g edges, %s", mesh.n_shards,
                     f"their own devices {[str(d) for d in mesh.devices]}"
                     if mesh.per_device else device if mesh.group is None
                     else f"their own ranks (this rank's on {device})",
                     cfg.edge_num_thresh,
                     "halo" if dist_halo else "all-gather")
    combined = mesh is not None and dp_size > 1
    log_routes(spec)
    if grid is not None:
        logging.info("combined dp x edge training: a grid of %d x %d ranks, "
                     "this rank's cell (%d, %d)", grid.dp, grid.edge,
                     grid.d, grid.e)
    elif combined and cells is not None:
        logging.info("combined dp x edge training: a grid of %d x %d "
                     "devices of this process", cells.dp, cells.edge)
    elif combined:
        logging.info("combined dp x edge training: %d rank(s) x %d shards",
                     dp_size, mesh.n_shards)

    def graph_for(idx: int) -> GraphTensors:
        """``train_graph``'s tensors, built once a graph and kept."""
        if idx not in graphs:
            graphs[idx] = train_graph(model, train_ds[idx], device,
                                      input_agg=input_agg)
        return graphs[idx]

    def batches_for(idx: int):
        """The graph's tensors, or, above ``edge_num_thresh``, its
        partition's (built once and kept) under an edge mesh, else those of
        a fresh sample of its subgraphs, built one at a time (trainer.py
        :426-470)."""
        g = train_ds[idx]
        if g.nnz <= cfg.edge_num_thresh:
            yield graph_for(idx)
            return
        if mesh is not None:
            if idx not in graphs:
                dg = cached_partition_graph(g, mesh.n_shards,
                                            part_cache_dir(cfg), g.fn,
                                            halo=dist_halo)
                graphs[idx] = dist_tensors(model, dg, mesh,
                                           input_agg=input_agg)
            yield graphs[idx]
            return
        for sub in sample_subgraphs(g, rng_np, fanout=[6] * hops,
                                    batch_size=cfg.batch_size):
            yield train_graph(model, sub.g, device, sub.s_bs, sub.t_bs,
                              input_agg=input_agg)

    def block_union(stack: list, d: int, dev) -> GraphTensors:
        return union([
            train_graph(model, train_ds[i], dev, input_agg=input_agg)
            for i in rank_block(stack, dp_size, d)])

    def union_for(stack: list):
        """The union of this rank's block of a stack, built once; on a grid
        of devices, each block's on its dp device."""
        key = ("stack", *stack)
        if key not in graphs:
            graphs[key] = block_union(stack, dp_rank, device) \
                if cells is None else [block_union(stack, d, dev) for d, dev
                                       in enumerate(cells.col.devices)]
        return graphs[key]

    def dist_block_for(batch: list) -> list:
        """This rank's block of a dp x edge batch: its graphs' partitions
        at the batch's shared sizes, on the device, built once; on a grid
        of devices, each row's block on the row's edge mesh."""
        key = ("dist_stack", *batch)
        if key not in graphs:
            blocks = [rank_block(list(range(len(batch))), dp_size, d)
                      for d in range(dp_size)]
            own = blocks[dp_rank] if cells is None else None
            parts = partition_batch([train_ds[i] for i in batch],
                                    mesh.n_shards, halo=dist_halo, own=own)
            if cells is None:
                graphs[key] = [dist_tensors(model, dg, mesh,
                                            input_agg=input_agg)
                               for dg in parts]
            else:
                graphs[key] = [[dist_tensors(model, parts[i], row,
                                             input_agg=input_agg)
                                for i in blocks[d]]
                               for d, row in enumerate(cells.rows)]
        return graphs[key]

    def step_gen() -> torch.Generator:
        """A batched step's dropout generator: this rank's, or on a grid of
        devices the run's, into which the step folds each row itself."""
        return gen if cells is not None else step_generator(gen, dp_rank)

    loss_meter, acc_meter = AverageMeter(), AverageMeter()
    n_train = len(train_ds)
    extra = {"arch": cfg.arch, "loss": cfg.loss}
    mdl_path = osp.join(log_dir, "mdl.pth")
    groups = dist_groups = None
    # --trace: the first epoch after the one that warms up (trainer.py:507)
    trace_epoch = start_epoch + 1 if cfg.epochs - start_epoch > 1 \
        else start_epoch
    for epoch in range(start_epoch, cfg.epochs):
        lr = step_lr(cfg.lr, cfg.epochs, epoch)
        set_lr(optimizer, lr)
        if epoch % 99 == 0:   # the reference's cadence (train.py:99-100)
            show_resource()
        loss_meter.reset(), acc_meter.reset()
        order = rng_np.permutation(n_train)

        def log_step(idx_graphs, loss_v, acc):
            if np.isnan(loss_v):
                raise FloatingPointError(
                    f"nan loss at step {glstep} (reference train.py:126)")
            loss_meter.update(loss_v)
            if acc is not None:   # batched steps report no accuracy
                acc_meter.update(float(acc))
            if glstep % LOG_EVERY == 1:
                logging.info("ep %d %d/%d step %d loss %.4f acc %.4f lr %g",
                             epoch, idx_graphs, n_train, glstep,
                             loss_meter.avg, acc_meter.avg, lr)
                writer.scalar("epoch", epoch, glstep)
                writer.scalar("train/loss", loss_meter.avg, glstep)
                writer.scalar("train/acc", acc_meter.avg, glstep)
                writer.scalar("train/lr", lr, glstep)

        def run_one(idx_graphs, gt):
            nonlocal glstep
            glstep += 1
            if isinstance(gt, DistGraphTensors):
                loss = dist_train_step(model, optimizer, gt, loss_fn, gen)
                log_step(idx_graphs, float(loss), None)
                return
            want_acc = bool(cfg.step_acc) or glstep % LOG_EVERY == 1
            loss, acc = train_step(model, optimizer, gt, loss_fn, gen,
                                   want_acc)
            log_step(idx_graphs, float(loss), acc)

        with trace(osp.join(log_dir, "trace"),
                   enabled=bool(cfg.trace) and epoch == trace_epoch):
            if stack_size > 1:
                # trainer.py:649-671: under dp x edge the oversize graphs'
                # batches in a drawn order, then the stacks in a drawn order,
                # then the graphs left single, then the oversize ones left
                if groups is None:
                    groups = stack_groups(train_ds, stack_size,
                                          cfg.edge_num_thresh)
                    dist_groups = dist_stack_groups(
                        train_ds, stack_size, cfg.edge_num_thresh) \
                        if combined else ([], set())
                stacks, singles, sampled = groups
                dist_batches, covered = dist_groups
                if combined:
                    for bi in rng_np.permutation(len(dist_batches)):
                        dgs = dist_block_for(dist_batches[int(bi)])
                        glstep += 1
                        loss = dp_edge_train_step(
                            model, optimizer, dgs, loss_fn, step_gen(),
                            grid or cells)
                        log_step(0, float(loss), None)
                for bi in rng_np.permutation(len(stacks)):
                    gt = union_for(stacks[int(bi)])
                    glstep += 1
                    loss = dp_train_step(
                        model, optimizer, gt, loss_fn, step_gen(),
                        cells.col if cells is not None else None)
                    log_step(0, float(loss), None)
                for gi in [*singles,
                           *(i for i in sampled if i not in covered)]:
                    for gt in batches_for(gi):
                        run_one(0, gt)
            elif scan is not None:
                # trainer.py:672-691: the stacks in a drawn order, one read
                # of the K losses a stack, then the graphs left single and
                # those above the threshold, in their stacking order
                if groups is None:
                    groups = stack_groups(train_ds, scan_k,
                                          cfg.edge_num_thresh)
                stacks, singles, sampled = groups
                for bi in rng_np.permutation(len(stacks)):
                    acc_on = [bool(cfg.step_acc)
                              or (glstep + i + 1) % LOG_EVERY == 1
                              for i in range(scan_k)]
                    losses, accs = scan(
                        [graph_for(i) for i in stacks[int(bi)]],
                        acc_on=acc_on)
                    for loss_v, acc_v in torch.stack((losses, accs),
                                                     1).tolist():
                        glstep += 1
                        log_step(0, loss_v, acc_v if acc_v >= 0 else None)
                for gi in [*singles, *sampled]:
                    for gt in batches_for(gi):
                        run_one(0, gt)
            else:
                for idx_graphs, gi in enumerate(order):
                    for gt in batches_for(int(gi)):
                        run_one(idx_graphs, gt)
        # the NEXT epoch to run, so a resume does not repeat this one
        if primary:
            save_checkpoint(log_dir, model, optimizer, epoch + 1, extra,
                            _rng_state(rng_np, gen, glstep))
        if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0 and \
                len(val_ds):
            va = quick_val(model, val_ds, cfg, mesh)
            if va is not None:
                writer.scalar("val/acc", va, glstep)
                logging.info("epoch %d val acc %.4f", epoch, va)
    if start_epoch >= cfg.epochs and primary:   # no epoch ran
        save_checkpoint(log_dir, model, optimizer, cfg.epochs, extra,
                        _rng_state(rng_np, gen, glstep))
    writer.close()
    return mdl_path
