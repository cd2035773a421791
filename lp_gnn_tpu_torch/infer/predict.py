"""Prediction, validation and timing passes (counterpart of
``lp_gnn_tpu/infer/predict.py``).

``model_inference`` (:116) runs one LP's full-graph forward on the model's
device, or, under ``--mesh_shape edge=K`` for graphs above
``edge_num_thresh``, its edge-partitioned forward (:133-137) over K shards
with the halo exchange. As the JAX package, one process with K cards
visible puts shard k on card k (``mesh_from_cfg`` :35-48), whatever
``dp`` says. It builds no
mesh when K exceeds its device count; the port places all K shards on the
model's one device instead (``parallel/mesh.py``), so the path runs on one
GPU, or, under the ``LP_GNN_DIST_*`` contract with K ranks, shard k on
rank k: each rank runs its shard's forward, the logits go to rank 0 (a
gather), and rank 0 alone decodes and writes; the other ranks take part in
the forwards of the partitioned graphs only. Graphs above
``edge_num_thresh`` without a mesh take the exact
sampled branch (:142-162): fanout -1 shards over seed batches of
``batch_size`` nodes in index order, one forward a shard, each shard's
seed logits written back in place, which equals the full-graph forward.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..data.dataset import BipartiteGraph, LPDataset
from ..data.graph import GraphTensors
from ..data.sampling import sample_subgraphs
from ..io.bas import read_bas, write_bas_highs
from ..parallel import edge_partition
from ..parallel import mesh as pmesh
from ..parallel.mesh import (EdgeMesh, grid_from_shape, is_primary,
                             make_mesh, parse_mesh_shape, world_and_rank)
from ..train.metrics import accuracy
from ..utils.serialize import json_dump, json_load, table_dump
from .decode import inference_gnn, parse_inference_manager


def mesh_from_cfg(cfg, device: torch.device) -> EdgeMesh | None:
    """The edge mesh ``--mesh_shape edge=K`` asks for (K > 1), or None
    (predict.py:35): over the ranks of the process group, one shard a rank,
    where the group has ranks and ``dp`` names none of them (K must then be
    the group's size); over this rank's row of the (dp, edge) grid where
    ``dp=D,edge=K`` names D*K ranks (``mesh.grid_from_shape``: JAX serves
    over the edge axis alone, :35-50, so row 0 serves and the other rows
    skip, ``runs_here``); else, in one process with at least K cards
    visible, one shard a device (``mesh.one_shard_a_device``), shard k on
    cuda:k as JAX's ``make_mesh`` lays out its devices (:47), also under
    ``dp=D``, which JAX's serving ignores (:45-48: the first K devices);
    else with every shard on ``device`` (one process, or a rank of dp x
    edge over D ranks, ``parallel/combined.py``)."""
    spec = parse_mesh_shape(cfg.mesh_shape)
    edge = spec.get("edge", 1)
    if edge <= 1:
        return None
    world, _ = world_and_rank()
    grid = grid_from_shape(spec)
    if grid is not None:
        return make_mesh(edge, device, grid.row, row=grid.d)
    if world > 1 and spec.get("dp", 1) == 1:
        if edge != world:
            raise ValueError(
                f"--mesh_shape edge={edge} over a process group of {world} "
                f"ranks: one shard a rank needs edge={world}")
        return make_mesh(edge, device, dist.group.WORLD)
    if world == 1 and pmesh.one_shard_a_device(device, edge):
        return make_mesh(edge, pmesh.shard_devices(device, edge))
    return make_mesh(edge, device)


def _uses_dist_path(g: BipartiteGraph, edge_num_thresh,
                    mesh: EdgeMesh | None) -> bool:
    """predict.py:65: every arch has a distributed forward
    (``edge_partition.DIST_MODELS``)."""
    return mesh is not None and g.nnz > edge_num_thresh


def runs_here(g: BipartiteGraph, edge_num_thresh,
              mesh: EdgeMesh | None) -> bool:
    """Whether this process runs ``g``'s forward: always, but on a rank
    other than 0 of an edge mesh over ranks only the partitioned graphs,
    whose forwards every rank of the mesh takes part in (rank 0 runs the
    rest), and on a grid row other than 0 none."""
    if mesh is not None and mesh.row != 0:
        return False
    return mesh is None or mesh.group is None or is_primary() or \
        _uses_dist_path(g, edge_num_thresh, mesh)


def part_cache_dir(cfg) -> str | None:
    """The partition cache beside the dataset's processed/ blobs, or None
    when ``--part_cache 0`` (predict.py:71)."""
    if cfg.part_cache and cfg.dataset_processed_prefix:
        return osp.join(cfg.dataset_processed_prefix, "partitions")
    return None


def _dist_partition(g: BipartiteGraph, mesh: EdgeMesh, model,
                    dist_cache: dict | None = None,
                    cache_dir: str | None = None):
    """The host partition of one graph, once per dataset pass
    (predict.py:80), with the halo lists for the archs that exchange
    anything (``DIST_HALO_ARCHS``, predict.py:106), else the all-gather
    layout: ``dist_cache`` holds the most recent graph and its partition
    (its callers visit graphs one after another)."""
    halo = model.name in edge_partition.DIST_HALO_ARCHS
    if dist_cache and dist_cache["g"] is g and dist_cache["halo"] == halo:
        return dist_cache["dg"]
    dg = edge_partition.cached_partition_graph(
        g, mesh.n_shards, cache_dir=cache_dir, fn=g.fn, halo=halo)
    if dist_cache is not None:
        dist_cache.update(g=g, halo=halo, dg=dg)
    return dg


def model_inference(model: nn.Module, g: BipartiteGraph,
                    edge_num_thresh: float = np.inf,
                    batch_size: int = 10240 * 32, depth: int | None = None,
                    rng=None, mesh: EdgeMesh | None = None,
                    dist_cache: dict | None = None,
                    part_dir: str | None = None):
    """Exact logits for every node of one graph (reference val.py:12-41):
    one full-graph forward on the model's device; for graphs above
    ``edge_num_thresh``, edge-partitioned over ``mesh`` (``dist_cache``,
    one dict per dataset pass, holds the host partition) or, without a
    mesh, exact sampled shards (:142-162): fanout -1 over ``max(depth - 1,
    1)`` hops from seed batches of ``batch_size`` nodes in index order,
    each shard's seed logits scattered back. ``rng`` (default
    ``RandomState(0)``) is the sampler's, which an exact unshuffled pass
    never draws from. Returns (logit_cons (m, 3), logit_vars (n, 3)) numpy
    fp32; over an edge mesh of ranks, on rank 0, and (None, None) on the
    others, which take part in the forward and gather."""
    if _uses_dist_path(g, edge_num_thresh, mesh):
        dg = _dist_partition(g, mesh, model, dist_cache,
                             cache_dir=part_dir)
        with torch.inference_mode():
            lc, lv = edge_partition.gather_logits(
                *edge_partition.dist_apply(model, dg, mesh), mesh)
        if lc is None:
            return None, None
        return lc[:g.ncons].cpu().numpy(), lv[:g.nvars].cpu().numpy()
    device = next(model.parameters()).device
    if g.nnz <= edge_num_thresh:
        gt = GraphTensors.from_graph(g, device)
        with torch.inference_mode():
            lc, lv = model(gt)
        return lc.cpu().numpy(), lv.cpu().numpy()
    rng = rng or np.random.RandomState(0)
    hops = max((depth or 3) - 1, 1)
    shards = sample_subgraphs(g, rng, fanout=[-1] * hops,
                              batch_size=batch_size, shuffle=False,
                              drop_last=False, exact=True)
    lc_out = np.zeros((g.ncons, 3), np.float32)
    lv_out = np.zeros((g.nvars, 3), np.float32)
    # the shards' seeds run through the nodes in index order (no shuffle):
    # constraints first, then variables
    c_ptr = v_ptr = 0
    for sub in shards:
        gt = GraphTensors.from_graph(sub.g, device)
        with torch.inference_mode():
            lc, lv = model(gt)
        lc_out[c_ptr:c_ptr + sub.s_bs] = lc[:sub.s_bs].cpu().numpy()
        lv_out[v_ptr:v_ptr + sub.t_bs] = lv[:sub.t_bs].cpu().numpy()
        c_ptr += sub.s_bs
        v_ptr += sub.t_bs
    return lc_out, lv_out


def validation(model: nn.Module, ds: LPDataset, cfg,
               table: str | None = None, wrt_converged: bool = False):
    """Per-LP accuracy/precision/recall of the decoded prediction against
    the optimal-basis labels (reference val.py:43-68), or with
    ``wrt_converged`` against the basis the warm-started solver converged
    to (val.py:70-104; LPs without one are skipped), into the columns
    ``acc|prec|recl`` (``cvg/acc|prec|recl``) of the results table
    ``table``. Returns the mean accuracy over the LPs scored."""
    rows = json_load(table) if table and osp.exists(table) else None
    by_fn = {r["fn"]: r for r in rows} if rows is not None else {}
    mesh = mesh_from_cfg(cfg, next(model.parameters()).device)
    dist_cache: dict = {}
    part_dir = part_cache_dir(cfg)
    avg_acc, n_eval = 0.0, 0
    prefix = "cvg/" if wrt_converged else ""
    if wrt_converged:
        # the warm-start stage writes converged bases to
        # opt-from-{basis_folder} (pipeline.stage_warm_start)
        basis_folder = parse_inference_manager(
            cfg.inference_manager, cfg.dataset).get_basis_folder()
    for i in range(len(ds)):
        g = ds[i]
        if not runs_here(g, cfg.edge_num_thresh, mesh):
            continue
        lc, lv = model_inference(model, g, cfg.edge_num_thresh,
                                 cfg.batch_size, cfg.arch_depth(), mesh=mesh,
                                 dist_cache=dist_cache, part_dir=part_dir)
        if lc is None:   # a rank other than 0: rank 0 scores
            continue
        if wrt_converged:
            tgt = f"{cfg.log_dir}/opt-from-{basis_folder}/{g.fn}.bas"
            if not osp.exists(tgt):
                continue
            con_lbls, var_lbls = read_bas(tgt)
            gt = np.concatenate([con_lbls, var_lbls])
        else:
            gt = np.concatenate([g.y_s, g.y_t])
        acc, prec, recl = accuracy(np.concatenate([lc, lv]), gt, g.ncons,
                                   return_pr=True, dataset_name=cfg.dataset)
        avg_acc += acc
        n_eval += 1
        if g.fn in by_fn:
            by_fn[g.fn].update({prefix + "acc": acc, prefix + "prec": prec,
                                prefix + "recl": recl})
        if i % 9 == 1:
            logging.info("val %d/%d %s acc %.4f prec %.4f recl %.4f",
                         i, len(ds), g.fn, acc, prec, recl)
    if rows is not None:
        table_dump(rows, table)
    return avg_acc / max(n_eval, 1)


def predict_and_write_bases(model: nn.Module, ds: LPDataset, cfg,
                            out_dir: str, decode_fn=inference_gnn,
                            decode_kwargs: dict | None = None) -> None:
    """Decode every graph and write HiGHS .bas + .sort files
    (reference scripts/pred_basis.py:70-111); over an edge mesh of ranks,
    rank 0 alone decodes and writes."""
    mesh = mesh_from_cfg(cfg, next(model.parameters()).device)
    if is_primary():
        os.makedirs(out_dir, exist_ok=True)
    dist_cache: dict = {}
    part_dir = part_cache_dir(cfg)
    for i in range(len(ds)):
        g = ds[i]
        if not runs_here(g, cfg.edge_num_thresh, mesh):
            continue
        lc, lv = model_inference(model, g, cfg.edge_num_thresh,
                                 cfg.batch_size, cfg.arch_depth(), mesh=mesh,
                                 dist_cache=dist_cache, part_dir=part_dir)
        if lc is None:
            continue
        logits = np.concatenate([lc, lv]).astype(np.float32)
        m = g.ncons
        pred = decode_fn(logits, m, nnzs=_nnzs_for_decode(g, decode_fn),
                         **(decode_kwargs or {}))
        fn = osp.join(out_dir, f"{g.fn}.bas")
        write_bas_highs(fn, vbas=pred[m:], cbas=pred[:m])
        _write_sort_vars(fn + ".sort", logits, m)


def _nnzs_for_decode(g: BipartiteGraph, decode_fn):
    if decode_fn is inference_gnn:
        return None
    # sparsity decode: slacks count 1, structural vars their column nnz
    # (reference pred_basis.py:71-77)
    deg = np.zeros(g.nvars)
    np.add.at(deg, g.col, 1)
    return np.concatenate([np.ones(g.ncons), deg])


def _write_sort_vars(fn: str, logits: np.ndarray, m: int):
    """P(basic) sidecar for Bixby-crash experiments
    (reference pred_basis.py:57-67): vars first, then cons."""
    x = logits - logits.max(-1, keepdims=True)
    e = np.exp(x)
    pr = e / e.sum(-1, keepdims=True)
    pv, pc = pr[m:, 1], pr[:m, 1]
    with open(fn, "w") as f:
        f.write(f"{len(pv)} \n")
        f.write(" ".join(str(float(v)) for v in pv) + "\n")
        f.write(f"{len(pc)} \n")
        f.write(" ".join(str(float(v)) for v in pc) + "\n")


def timed_inference(model: nn.Module, ds: LPDataset, cfg,
                    table: str | None = None) -> dict:
    """Pure-inference timing pass -> per-LP ``inf_time`` in seconds
    (reference pred_basis.py:158-176).

    ``inf_time`` covers the forward (graph tensors, or the partition's
    tensors, built on the device included, as the JAX package's includes
    ``pad_graph``; on the sampled path the host sampling of the shards and
    each shard's forward) plus the top-m decode: the median of 3 timed passes after
    one warm-up, each ending with ``torch.cuda.synchronize()`` on the card.
    The host partition of an edge-partitioned graph is a per-graph constant,
    timed once into ``part_time`` and kept out of ``inf_time`` (predict.py
    :290-295). Both go to ``{log_dir}/inf_time.json`` and into the
    ``inf_time`` / ``part_time`` columns of the results table ``table``.
    Over an edge mesh of ranks the times are rank 0's: every rank leaves a
    barrier before each timed pass, so a pass spans the partition tensors
    of the first rank to start through the exchanges, the gather and rank
    0's decode; rank 0 alone writes."""
    device = next(model.parameters()).device
    mesh = mesh_from_cfg(cfg, device)
    dist_cache: dict = {}
    part_dir = part_cache_dir(cfg)
    ranks = mesh is not None and mesh.group is not None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times, part_times = {}, {}
    for i in range(len(ds)):
        g = ds[i]
        if not runs_here(g, cfg.edge_num_thresh, mesh):
            continue
        dist_path = _uses_dist_path(g, cfg.edge_num_thresh, mesh)
        if dist_path:
            t0 = time.perf_counter()
            _dist_partition(g, mesh, model, dist_cache, cache_dir=part_dir)
            part_times[g.fn] = time.perf_counter() - t0

        def infer():
            return model_inference(model, g, cfg.edge_num_thresh,
                                   cfg.batch_size, cfg.arch_depth(),
                                   mesh=mesh, dist_cache=dist_cache,
                                   part_dir=part_dir)

        infer()   # warm-up
        sync()
        reps = []
        for _ in range(3):
            if ranks and dist_path:
                dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            lc, lv = infer()
            if lc is not None:
                inference_gnn(np.concatenate([lc, lv]), g.ncons)
            sync()
            reps.append(time.perf_counter() - t0)
        times[g.fn] = sorted(reps)[1]
        logging.info("inf_time %s %.6f s", g.fn, times[g.fn])
    if not is_primary():
        return times
    json_dump({"device": str(device), "inf_time": times,
               "part_time": part_times},
              osp.join(cfg.log_dir, "inf_time.json"))
    if table and osp.exists(table):
        rows = json_load(table)
        for r in rows:
            if r["fn"] in times:
                r["inf_time"] = times[r["fn"]]
            if r["fn"] in part_times:
                r["part_time"] = part_times[r["fn"]]
        table_dump(rows, table)
    return times
