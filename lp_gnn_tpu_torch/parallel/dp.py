"""Graph-batched and data-parallel training steps (counterpart of
``lp_gnn_tpu/parallel/dp.py``).

The JAX package stacks same-shape padded graphs on a leading axis, shards
the stack over the ``dp`` mesh axis and vmaps the loss over the graphs of
each shard (``make_dp_train_step`` :46): the gradient of the mean of the
per-graph losses, averaged over the shards. The port has no padding, so a
stack is one disjoint union of its graphs (``data/graph.py union``) that
the model runs in one forward: a step launches each kernel as often as one
graph's step does, whatever the number of graphs. Under ``--mesh_shape
dp=K`` every rank builds the same stacks of K*B graphs and takes the
contiguous block ``[r*B, (r+1)*B)`` of each (as ``P("dp")`` splits the
leading axis); after its backward the ranks average their gradients by
one all-reduce and step the same optimizer, so they stay equal. On a
(dp, edge) grid of ranks (``mesh.RankGrid``) the dp axis is a column:
row d takes block d, and every rank of a row runs the same union (the
edge axis replicated, as JAX's dp step on its combined grid); with edge
shards on their own ranks every rank runs the same union. Either way the
average is over every rank of the process group: the mean over the
column of the rows' gradients, with no rank's weights left to depend on
its row's kernels being bitwise deterministic.

In one process with D cards (``mesh.DeviceGrid``, JAX's own layout of
``dp=D``) block d of a stack is one union built on device d; replica d of
the model (its parameters broadcast from the lead,
``shard_threads.replicas``) runs the forward and the per-graph losses in
thread d, on device d's stream; the D block means are averaged on the lead
and one ``backward()`` sums the D gradients there in order: JAX's ``pmean``
of the per-shard means, the ranks' arithmetic without a process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..data.graph import GraphTensors, seed_masks
from ..data.stacking import stack_key
from .mesh import world_and_rank
from .shard_threads import ShardThreads, numbered_afresh, replicas


def stack_groups(ds, size: int, edge_num_thresh: float):
    """Group the graphs of ``ds`` as the JAX trainer does
    (``trainer.py:538-568``): graphs above ``edge_num_thresh`` are sampled
    every epoch and stack with none; the rest, in index order, fall into
    groups of one stack key (``data/stacking.py``), each group cut into
    stacks of ``size``, its remainder left to single steps. Returns
    (stacks: lists of ``size`` indices, singles, sampled), all indices of
    ``ds``, in the JAX package's order."""
    by_key: dict = {}
    sampled = []
    for gi in range(len(ds)):
        g = ds[gi]
        if g.nnz > edge_num_thresh:
            sampled.append(gi)
            continue
        by_key.setdefault(stack_key(g), []).append(gi)
    stacks, singles = [], []
    for group in by_key.values():
        while len(group) >= size:
            stacks.append(group[:size])
            group = group[size:]
        singles.extend(group)
    return stacks, singles, sampled


def rank_block(stack: list, world: int, rank: int) -> list:
    """This rank's contiguous share of a stack of ``world`` x B graphs."""
    per_rank = len(stack) // world
    return stack[rank * per_rank:(rank + 1) * per_rank]


def member_losses(lc, lv, g: GraphTensors, loss_fn) -> torch.Tensor:
    """Each graph's loss over its own seeds, from the union's logits
    (the per-graph ``loss_fn`` that ``jax.vmap`` maps, dp.py:52-58)."""
    out = []
    for mb in g.members:
        cs = slice(mb.c0, mb.c0 + mb.ncons)
        vs = slice(mb.v0, mb.v0 + mb.nvars)
        ms, mt = seed_masks(mb.ncons, mb.nvars, mb.s_bs, mb.t_bs, g.device)
        out.append(loss_fn(lc[cs], lv[vs], g.y_s[cs], g.y_t[vs], ms, mt))
    return torch.stack(out)


def step_generator(gen: torch.Generator | None,
                   rank: int) -> torch.Generator | None:
    """A dropout generator for one batched step on this rank: seeded from
    one draw of the run's ``gen`` (the same draw on every rank) plus
    ``rank``, this rank's place on the axis whose cells must draw other
    masks, so that their masks differ but the run generators stay equal,
    whatever the size of each rank's graphs. On a (dp, edge) grid the
    trainer passes the row d and the dist forward folds the shard e into
    this generator the same way (``edge_partition.module_forward``)."""
    if gen is None:
        return None
    return torch.Generator(device=gen.device).manual_seed(step_seed(gen)
                                                          + rank)


def step_seed(gen: torch.Generator) -> int:
    """One draw of the run's ``gen``: the seed :func:`step_generator` adds
    a rank to (with one edge shard a device, each shard's generator adds
    its shard index, ``edge_partition._forward_on_devices``)."""
    return int(torch.randint(2 ** 62, (1,), generator=gen, device=gen.device))


def cell_generators(gen: torch.Generator | None, devices) -> list:
    """A dropout generator for each cell of an axis held in this process,
    cell c on ``devices[c]``: seeded with one draw of ``gen`` plus c, what
    :func:`step_generator` gives rank c (None each without ``gen``)."""
    if gen is None:
        return [None] * len(devices)
    seed = step_seed(gen)
    return [torch.Generator(device=d).manual_seed(seed + c)
            for c, d in enumerate(devices)]


def _all_reduce_grads(model, extra: torch.Tensor | None = None,
                      group=None, divide: int = 1) -> torch.Tensor:
    """Every gradient of ``model`` (and ``extra``, a 0-d tensor) summed over
    the ranks of ``group`` by one all-reduce of one flat fp32 buffer, then
    divided by ``divide``, each gradient written back in place; returns the
    buffer."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([t.reshape(-1) for t in grads]
                     + ([] if extra is None else [extra.reshape(1).float()]))
    dist.all_reduce(flat, group=group)
    if divide != 1:
        flat /= divide
    off = 0
    for t in grads:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return flat


def average_over_ranks(model, loss: torch.Tensor) -> torch.Tensor:
    """Across the ranks of a process group, after each rank's backward:
    every gradient of ``model`` and ``loss`` (this rank's mean) averaged
    over the ranks, by one all-reduce of one flat fp32 buffer, each
    gradient then written back in place. Returns the mean loss over the
    ranks; ``loss`` itself without a group."""
    world, _ = world_and_rank()
    if world == 1:
        return loss
    return _all_reduce_grads(model, loss, divide=world)[-1]


def sum_over_ranks(model, group) -> None:
    """Every gradient of ``model`` summed over the ranks of ``group`` (one
    all-reduce, as :func:`average_over_ranks`): the edge axis' gradient
    psum when each rank holds one shard of a graph."""
    _all_reduce_grads(model, group=group)


def dp_train_step(model, optimizer: torch.optim.Optimizer, g: GraphTensors,
                  loss_fn, generator: torch.Generator | None = None,
                  threads: ShardThreads | None = None):
    """One step on a union of graphs (``make_dp_train_step`` :46): one
    forward in training mode, the mean of the per-graph losses, one
    backward; across the ranks of a process group the gradients are
    averaged (``average_over_ranks``), then the optimizer steps. Returns
    the mean loss over every rank's graphs, a 0-d tensor on the device
    (before the update).

    With ``threads`` (the dp devices of this process, the column of a
    ``mesh.DeviceGrid``) ``g`` lists the D blocks' unions, union d on
    device d, and ``generator`` is the run's: replica d draws its dropout
    from :func:`cell_generators`' d-th, as rank d does."""
    if threads is not None:
        return _dp_step_on_devices(model, optimizer, g, loss_fn, generator,
                                   threads)
    model.train()
    lc, lv = model(g, generator=generator)
    loss = member_losses(lc, lv, g, loss_fn).mean()
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:   # GCNRand's logits depend on no parameter
        loss.backward()
    loss = average_over_ranks(model, loss.detach())
    optimizer.step()
    return loss


def _dp_step_on_devices(model, optimizer, unions: list, loss_fn,
                        generator, threads: ShardThreads):
    """The dp step over D devices of one process: each replica's forward
    and block mean in its thread, the D means averaged on the lead, one
    backward (one broadcast node sums the D gradients on the lead, in
    order), one optimizer step on the lead."""
    if len(unions) != threads.size:
        raise ValueError(f"{len(unions)} unions for {threads.size} dp "
                         "devices")
    model.train()

    def forward():
        reps = replicas(model, threads)
        gens = cell_generators(generator, threads.devices)

        def block_mean(d):
            lc, lv = reps[d](unions[d], generator=gens[d])
            return member_losses(lc, lv, unions[d], loss_fn).mean()

        means = threads.run(block_mean)
        for m in means:
            if m.is_cuda:   # read on this thread's stream below
                m.record_stream(torch.cuda.current_stream(m.device))
        return torch.stack([m.to(threads.devices[0]) for m in means]).mean()

    loss = numbered_afresh(forward)
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:   # GCNRand's logits depend on no parameter
        loss.backward()
    optimizer.step()
    return loss.detach()
