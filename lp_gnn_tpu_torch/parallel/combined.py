"""dp x edge training: a batch of same-bucket graphs over the ``dp`` axis,
each graph edge-partitioned over the ``edge`` axis (counterpart of
``lp_gnn_tpu/parallel/combined.py``, the JAX package's full multi-chip
configuration).

The JAX package stacks a batch's partitions into one pytree of (B, D, ...)
leaves and shards it over a (dp, edge) device grid, so every leaf must have
one shape across the batch: ``partition_batch`` (:29) gives each graph the
batch's shard sizes and halo width, then pads what still differs (each
shard's edge pad, the blocked layouts' chunk counts) with no-op fills
(:62-107). The port stacks nothing. Each rank runs its own block's dist
forwards one after another, each over CSRs of its graph's own edges, so
the fills have no counterpart; what carries over is the shared ``ms``,
``ns`` and Bh, which give every node and halo field of the batch one shape,
as there.

Three layouts (``mesh.py``):

- D ranks (``--mesh_shape dp=D,edge=E`` over D ranks): rank d holds block
  d of the batch with all E shards of each graph on its device
  (``mesh.EdgeMesh`` without a group); the gradients are averaged over the
  ranks;
- the (dp, edge) grid of D*E ranks, JAX's own layout (``mesh.RankGrid``):
  rank (d, e) holds shard e of each graph of block d. The E ranks of row d
  run each graph's dist forward together over the row's edge group (K1's
  rank form, the losses' psum), and the gradients are reduced over the
  whole grid (:func:`grid_average`);
- the (dp, edge) grid of D*E devices of one process, JAX's layout on one
  host (``mesh.DeviceGrid``): row d takes block d, each graph's shards on
  row d's edge mesh, shard e on cell (d, e) in a thread of its own. The
  rows run one after another from the calling thread, the kernels they
  queue on their devices at once. The loss is the mean over the rows of
  each row's mean of dist losses: JAX's ``pmean(psum(g, edge), dp)``, where
  the psum within a row is the sum of its joint and broadcast nodes (every
  shard is here, as on the stacked path: no ``psum_over``) and the mean
  over the rows is the pmean. One broadcast of the parameters over every
  cell a step sums the D*E gradients on the lead in (d, e) order.
"""
from __future__ import annotations

import torch

from ..data.dataset import BipartiteGraph
from ..data.stacking import bucket_key
from .dp import _all_reduce_grads, average_over_ranks, cell_generators
from .edge_partition import (PartitionedGraph, _shard_sizes,
                             compute_halo_width, dist_forward,
                             partition_graph, psum_over)
from .mesh import DeviceGrid, RankGrid
from .shard_threads import numbered_afresh, replicas


def dist_stack_groups(ds, size: int, edge_num_thresh: float):
    """The trainer's dp x edge work units (``trainer.py:570-612
    dist_stacked_groups``): the graphs above ``edge_num_thresh``, in index
    order, grouped by ``bucket_key`` (buckets in first-seen order), each
    group cut into batches of ``size``. Returns (batches: lists of
    ``size`` indices of ``ds``, the set of indices they cover); the rest of
    the oversize graphs keep the single-graph dist step."""
    by_bucket: dict = {}
    for gi in range(len(ds)):
        g = ds[gi]
        if g.nnz > edge_num_thresh:
            by_bucket.setdefault(bucket_key(g), []).append(gi)
    batches = []
    for group in by_bucket.values():
        while len(group) >= size:
            batches.append(group[:size])
            group = group[size:]
    return batches, {gi for b in batches for gi in b}


def partition_batch(graphs: list[BipartiteGraph], n_edge: int,
                    halo: bool = False,
                    own: list[int] | None = None) -> list[PartitionedGraph]:
    """The partitions of a batch's graphs into ``n_edge`` shards, all with
    the batch's shard sizes (the largest ``_shard_sizes``) and, with
    ``halo``, halo width (the largest ``compute_halo_width`` at those
    sizes), as ``combined.py :29-61`` builds them: every node and halo
    field then has one shape across the batch. ``own`` lists the positions
    in ``graphs`` to partition (a rank's block; all by default): the shared
    sizes come from every graph of the batch. One ``PartitionedGraph`` a
    graph, nothing padded or stacked (module docstring)."""
    ms = max(_shard_sizes(g, n_edge)[0] for g in graphs)
    ns = max(_shard_sizes(g, n_edge)[1] for g in graphs)
    bh = max(compute_halo_width(g, n_edge, ms=ms, ns=ns)
             for g in graphs) if halo else None
    return [partition_graph(graphs[i], n_edge, halo=halo, halo_width=bh,
                            ms=ms, ns=ns)
            for i in (range(len(graphs)) if own is None else own)]


def grid_average(model, loss: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    """JAX's ``pmean(psum(g, edge), dp)`` (:142-143) on the grid, after
    each rank's backward: the sum of every rank's gradient (its shard's
    part of its row's) over all D*E ranks, divided by D, written back in
    place; returns the mean of the rows' losses (each row's ``loss`` is
    the same on its E ranks, so it enters the sum as ``loss / E``). One
    all-reduce over the world, not a row sum and then a column mean: the
    same sum, one collective in place of two."""
    return _all_reduce_grads(model, loss / grid.edge,
                             divide=grid.dp)[-1]


def dp_edge_train_step(model, optimizer: torch.optim.Optimizer,
                       dgs: list, loss_fn,
                       generator: torch.Generator | None = None,
                       grid: RankGrid | DeviceGrid | None = None):
    """One dp x edge step on this rank's block ``dgs`` of a batch
    (``make_dp_edge_train_step`` :108): the dist forward of each graph in
    training mode, the mean of their dist losses, one backward, then one
    optimizer step, every rank's weights equal after it. Returns the mean
    loss over every rank's graphs, a 0-d tensor on the device (before the
    update).

    Without ``grid`` (D ranks, each holding all E shards) the gradients
    and the loss are averaged over the ranks (``dp.py
    average_over_ranks``: with blocks of equal size, the mean of the
    ranks' means is JAX's ``pmean(mean(losses))``); with every shard on one
    device there is no psum, so JAX's ``loss / n_edge`` and ``loss *
    n_edge`` (:135, :144), which undo the transpose of the edge axis'
    psum, have no counterpart. On the ``grid`` the psum happens: each
    graph's loss sums over the row's edge group (``psum_over``, whose
    backward passes the cotangent on as it is, so each rank's gradient is
    its shard's part with no 1/E to undo) and :func:`grid_average` reduces
    the gradients over the grid.

    On a :class:`mesh.DeviceGrid` ``dgs`` lists the D rows' blocks (each
    graph's tensors on its row's edge mesh) and ``generator`` is the run's:
    row d draws from :func:`dp.cell_generators`' d-th, what rank (d, e) of
    the grid of ranks is given before it folds in its shard."""
    if isinstance(grid, DeviceGrid):
        return _grid_step_on_devices(model, optimizer, dgs, loss_fn,
                                     generator, grid)
    model.train()
    kw = {} if grid is None else {"psum": psum_over(grid.row)}
    loss = torch.stack([
        loss_fn(*dist_forward(model, dg, generator), dg.y_s, dg.y_t,
                dg.cons_mask, dg.vars_mask, **kw) for dg in dgs]).mean()
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:   # GCNRand's logits depend on no parameter
        loss.backward()
    if grid is not None:
        loss = grid_average(model, loss.detach(), grid)
    else:
        loss = average_over_ranks(model, loss.detach())
    optimizer.step()
    return loss


def _grid_step_on_devices(model, optimizer, blocks: list, loss_fn,
                          generator, grid: DeviceGrid):
    """The dp x edge step on the device grid: one broadcast of the
    parameters to every cell, each row's dist forwards over its cells'
    replicas and its mean of dist losses, the rows' means averaged on the
    lead, one backward, one optimizer step on the lead."""
    if len(blocks) != grid.dp:
        raise ValueError(f"{len(blocks)} blocks for a grid of {grid.dp} rows")
    model.train()

    def forward():
        reps = replicas(model, grid.threads)
        gens = cell_generators(generator, [row.device for row in grid.rows])
        e = grid.edge
        means = []
        for d, dgs in enumerate(blocks):
            row_reps = reps[d * e:(d + 1) * e]
            means.append(torch.stack([
                loss_fn(*dist_forward(model, dg, gens[d], row_reps),
                        dg.y_s, dg.y_t, dg.cons_mask, dg.vars_mask)
                for dg in dgs]).mean().to(grid.device))
        return torch.stack(means).mean()

    loss = numbered_afresh(forward)
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:   # GCNRand's logits depend on no parameter
        loss.backward()
    optimizer.step()
    return loss.detach()
