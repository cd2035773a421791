"""GEN's two-direction layer over a partition: over the compact halo space,
or over the all-gather layout.

**The halo layout**, counterpart of
``lp_gnn_tpu/parallel/edge_partition.py:880 _dist_gen_bidir_halo`` (with
``_dist_gen_softmax_agg_local`` :829). Each shard's edges address the
concatenated space of its own variables and its halo slots, ``[local (ns);
slots (nh)]`` (the JAX package's ``hcol_r``, ``hseg``): local variable j
is compact row j, and halo slot ``owner*bh + rank`` is compact row ``ns +
owner*bh + rank``.

- r2l (dst = constraints, every edge of a row on its shard, so the softmax
  is local): one :class:`~.edge_partition.HaloGather` of the projected
  sources, then one :class:`~lp_gnn_tpu_torch.ops.gen_agg.GenSoftmaxAgg` a
  shard over a CSR of ``ms`` rows whose sources index ``[r_src_shard;
  hbuf_shard]``.
- l2r (dst = variables, whose edges spread over shards): ``gen_agg_fwd`` a
  shard over a CSR of ``ns + nh`` compact rows with sources in the shard's
  constraints gives each part of a variable its (aggr, lse); the slot rows'
  parts go to their owners with one K1 (fp32, 2D wide, padded to 16
  bytes; the stacked form, or over ranks its rank form), and
  ``gen_lse_merge`` merges them with the local part by log-sum-exp: ``lse =
  logsumexp_p lse_p``, ``aggr = sum_p exp(lse_p - lse) aggr_p``, the exact
  single-card softmax. The JAX layer combines maxes at the owners, sends
  them back, and sums the exps there; the two differ in rounding only.
- l2r's backward needs no merge backward: one halo gather brings each
  owner's (g, aggr, lse) back to its slots, and ``gen_agg_bwd`` runs over
  all ``ns + nh`` compact rows with the merged statistics, which recomputes
  each edge's global alpha: the single-card gradient. The sources'
  gradient is the SpMM over the transpose ordering with the edge
  permutation (``ops/gen_agg.py gather_backward``).

**The all-gather layout**, counterpart of :960 ``_dist_gen_bidir`` (with
:829 and :847 ``_dist_gen_softmax_agg_global``). A shard's edges address
the global variable axis of ``n_pad = K*ns`` rows.

- r2l: the projected sources' ``all_gather``
  (:class:`~.edge_partition.AllGatherVars`: with every shard here the
  stacked rows themselves), then one ``GenSoftmaxAgg`` a shard over a CSR
  of ``ms`` rows with sources in ``[0, n_pad)``.
- l2r: ``gen_agg_fwd`` a shard over a CSR of all ``n_pad`` variable rows
  gives the shard's part of every variable, (aggr, lse); ``gen_lse_merge``
  merges the K parts of each variable, one launch over all rows (over
  ranks, after an exchange that brings each rank the K parts of its own
  rows, ``edge_partition.exchange_var_blocks``). Every part goes in the
  merge's ``parts``: no row has a local part. The JAX layer takes the
  max with ``pmax`` and sums the exps with one ``psum_scatter``; the
  merge by log-sum-exp is the same softmax, rounded otherwise.
- l2r's backward: the merged (g, aggr, lse) of every variable row
  (``all_gather``: with every shard here the rows themselves), then one
  ``gen_agg_bwd`` a shard over its ``n_pad`` rows, and the sources'
  gradient by the SpMM over the transpose ordering.

The two CSRs of a shard are each other's transpose orderings: r2l (ms
rows) sorted by (row, source), l2r (the compact or the global variable
rows, sources the shard's constraints) sorted by (variable, row). Both
come from the partition's CSRs with their edge permutations, built with
the device tensors (``DistGraphTensors.from_partition(..., gen=True)``);
the partition cache does not hold them. The per-shard loops run over the
shards held here: all K in one process, or, with shard k on rank k, this
rank's one, whose owner-side merge takes the parts its exchange brings
from every rank; the parameters' gradients are then this rank's part,
summed over the ranks by ``dist_train_step``. With one shard a device each
shard's thread runs the one-shard layer, and l2r is one autograd node over
the K shards (:class:`_L2ROp` under ``shard_threads.Joint``): each shard's
parts on its device, K1's device form (halo) or the copies of the blocks
between devices (all-gather), each owner's merge; its backward the same
exchanges of the statistics and each shard's ``gen_agg_bwd``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.gen_agg import (gather_backward, gen_agg_bwd, gen_agg_fwd,
                           gen_lse_merge, gen_softmax_agg, padded_width)
from .edge_partition import (CSR, AllGatherVars, HaloGather, _a2a,
                             _a2a_devices, _all_gather_devices, _block_rows,
                             _collective, _gather_devices, all_gather_vars,
                             exchange_var_blocks, halo_gather)
from .shard_threads import Member, joint


def _coo(m: CSR):
    ptr = np.asarray(m.ptr)
    return np.repeat(np.arange(len(ptr) - 1), np.diff(ptr)), m.idx, m.val


def _ptr_of(dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    ptr = torch.zeros(num_dst + 1, dtype=torch.int32, device=dst.device)
    ptr[1:] = torch.cumsum(torch.bincount(dst, minlength=num_dst), 0)
    return ptr


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def _orderings(r, c, v, n_rows: int, n_cols: int) -> dict:
    """A shard's edges (r in [0, n_rows) constraint rows, c in [0, n_cols)
    sources, on the device) as the two orderings: r2l sorted by (r, c) and
    l2r by (c, r), both stable, with the permutations between them."""
    o_r = torch.argsort(r * n_cols + c, stable=True)
    o_l = torch.argsort(c * n_rows + r, stable=True)
    return {"r2l": CSR(_ptr_of(r, n_rows), c[o_r].int(), v[o_r]),
            "l2r": CSR(_ptr_of(c, n_cols), r[o_l].int(), v[o_l]),
            "eperm_r2l": _inverse(o_r)[o_l].int(),
            "eperm_l2r": _inverse(o_l)[o_r].int()}


@dataclasses.dataclass
class DistGenTensors:
    """GEN's CSRs of a partition on its device, for either layout. l2r's
    rows are ``C`` = ns + nh compact rows (halo) or n_pad global rows
    (all-gather)."""
    r2l: list[CSR]             # per shard: ms rows, idx in [0, C)
    l2r: list[CSR]             # per shard: C rows, idx in [0, ms)
    eperm_r2l: list[torch.Tensor]  # in l2r's order: the edge's place in r2l's
    eperm_l2r: list[torch.Tensor]  # in r2l's order: the edge's place in l2r's
    # the owner-side merge: rows L*ns stacked by owner, each listing its
    # parts' rows in the merge's parts (halo: K1's output, L*nh rows stacked
    # by owner, the real slots; all-gather: the K parts of every row)
    merge_ptr: torch.Tensor    # (L*ns+1,) int32
    merge_idx: torch.Tensor    # (n,) int32
    local_edges: torch.Tensor  # (L*ns,) int32, each variable's local edges

    @classmethod
    def from_partition(cls, dg, halo_red, t, own) -> "DistGenTensors":
        """From the host partition ``dg`` (halo layout), its owner-side
        reduce lists ``halo_red`` ((ptr, slot positions) an owner), ``t``,
        which puts a numpy array on the device, and ``own``, the shards
        held here. A shard's edges (its local and halo v2c CSRs) go to the
        device, and the two orderings are stable sorts there, by (row,
        compact column) and by (compact column, row)."""
        ms, ns, nh = dg.ms, dg.ns, dg.nh
        out = {f: [] for f in ("r2l", "l2r", "eperm_r2l", "eperm_l2r")}
        for d in own:
            r1, c1, v1 = _coo(dg.local_v2c[d])
            r2, s2, v2 = _coo(dg.halo_v2c[d])
            for k, v in _orderings(
                    t(np.concatenate([r1, r2])),
                    t(np.concatenate([c1, ns + s2]).astype(np.int64)),
                    t(np.concatenate([v1, v2])), ms, ns + nh).items():
                out[k].append(v)
        red = [halo_red[d] for d in own]
        sizes = [len(i) for _, i in red]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        ptr = np.concatenate([p[:-1] + offs[o] for o, (p, _) in
                              enumerate(red)] + [offs[-1:]])
        idx = np.concatenate([o * nh + i for o, (_, i) in enumerate(red)])
        local = np.concatenate([np.diff(dg.local_c2v[d].ptr) for d in own])
        return cls(**out, merge_ptr=t(ptr.astype(np.int32)),
                   merge_idx=t(idx.astype(np.int32)),
                   local_edges=t(local.astype(np.int32)))

    @classmethod
    def from_full(cls, dg, t, own) -> "DistGenTensors":
        """From the host partition ``dg`` in the all-gather layout (its full
        v2c CSRs), ``t`` and ``own`` as :meth:`from_partition`. The merge
        lists, for each of the L*ns variable rows held here, the shards
        whose edges reach it, in shard order: with every shard here, row v's
        part from shard s is row ``s*n_pad + v`` of the K stacked parts;
        over ranks, row i's from rank p is row ``p*ns + i`` of the
        exchanged blocks. Every shard's edge counts are on the host (every
        rank partitions the whole graph)."""
        ms, n_pad, ns = dg.ms, dg.n_pad, dg.ns
        out = {f: [] for f in ("r2l", "l2r", "eperm_r2l", "eperm_l2r")}
        for d in own:
            r, c, v = _coo(dg.full_v2c[d])
            for k, x in _orderings(t(r), t(np.asarray(c, np.int64)), t(v),
                                   ms, n_pad).items():
                out[k].append(x)
        rows = np.concatenate([np.arange(d * ns, (d + 1) * ns) for d in own])
        has = np.stack([np.diff(m.ptr) > 0 for m in dg.full_c2v])[:, rows]
        row_of, part_of = np.nonzero(has.T)   # by row, then shard
        ptr = np.zeros(len(rows) + 1, np.int32)
        np.cumsum(has.sum(0), out=ptr[1:])
        return cls(**out, merge_ptr=t(ptr),
                   merge_idx=t((part_of * len(rows) + row_of).astype(
                       np.int32)),
                   local_edges=t(np.zeros(len(rows), np.int32)))


class DistGenL2R(torch.autograd.Function):
    """``DistGenL2R.apply(x, w, b, t, dg)`` -> aggr (L*ns, D) fp32 (fp64
    for fp64): the l2r aggregation of a GEN layer over the partition ``dg``
    (with ``dg.gen``), from the projected constraint rows ``x`` (L*ms, D)
    and the edge encoder ``w``, ``b`` and temperature ``t`` in x's dtype,
    with a gradient for all four (module docstring). Halo layout: forward
    L ``gen_agg_fwd``, one K1, one ``gen_lse_merge``; backward one halo
    gather, L ``gen_agg_bwd`` and, for x, L SpMMs. All-gather layout:
    forward L ``gen_agg_fwd`` and one merge (over ranks after the parts'
    exchange); backward (over ranks after an all-gather) L ``gen_agg_bwd``
    and L SpMMs."""

    @staticmethod
    def forward(ctx, x, w, b, t, dg):
        xs = x.split(dg.ms)
        l2r = _l2r_halo if dg.halo else _l2r_full
        aggr, lse = l2r(dg, xs, w, b, t)
        ctx.dg = dg
        ctx.save_for_backward(x, w, b, t, aggr, lse)
        return aggr

    @staticmethod
    def backward(ctx, grad):
        x, w, b, t, aggr, lse = ctx.saved_tensors
        dg = ctx.dg
        # each owner's (g, aggr, lse) where every shard's rows read them
        if dg.halo:
            table = _stat_table(grad, aggr, lse)
            stats = _halo_stats(dg, table, halo_gather(
                table, dg.halo_src, dg.halo_sched, dg.group), x.shape[1])
        else:
            if dg.group is None:
                full = [grad.contiguous(), aggr, lse]
            else:
                full = _split_stats(all_gather_vars(
                    torch.cat([grad, aggr, lse], 1), dg.group))

            def stats(s):
                return full
        return (*_l2r_grads(dg, x, w, b, t, stats, ctx.needs_input_grad[0]),
                None)


def _stat_table(grad, aggr, lse) -> torch.Tensor:
    """(g, aggr, lse) of the variable rows held here side by side, each D
    wide, in rows padded to whole 16-byte pieces (for the halo gather)."""
    d = aggr.shape[1]
    table = aggr.new_empty((aggr.shape[0], padded_width(3 * d, aggr.dtype)))
    for j, v in enumerate((grad, aggr, lse)):
        table[:, j * d:(j + 1) * d] = v
    return table


def _halo_stats(dg, table, slots, d: int):
    """``stats(s)``: shard s's (g, aggr, lse) over its compact rows, each D
    wide, its own rows' from ``table`` and its halo slots' from
    ``slots``."""
    ns = dg.ns

    def stats(s):
        own = table[s * ns:(s + 1) * ns]
        return [torch.cat([own[:, j * d:(j + 1) * d],
                           slots[s, :, j * d:(j + 1) * d]]) for j in range(3)]
    return stats


def _split_stats(table) -> list:
    """(g, aggr, lse) of a (n, 3D) table, each contiguous."""
    d = table.shape[1] // 3
    return [table[:, j * d:(j + 1) * d].contiguous() for j in range(3)]


def _l2r_grads(dg, x, w, b, t, stats, need_x: bool) -> tuple:
    """l2r's backward over the shards held here, each shard's compact (or
    global) rows' statistics from ``stats(s)``: ``gen_agg_bwd`` a shard,
    and for x the SpMM over the transpose ordering. Returns (dx or None,
    dw, db, dt)."""
    gen, k, ms = dg.gen, dg.n_local, dg.ms
    d = x.shape[1]
    xs = x.split(ms)
    dxs, sums = [], None
    for s in range(k):
        g, a, lse_s = stats(s)
        dpre, *part = gen_agg_bwd(*gen.l2r[s], xs[s], w, b, t, g, a, lse_s)
        sums = part if sums is None else \
            [u + v for u, v in zip(sums, part)]
        if need_x:
            dxs.append(gather_backward(gen.r2l[s].ptr, gen.eperm_l2r[s],
                                       dpre, d))
    dw, db, dt = sums
    return (torch.cat(dxs) if dxs else None, dw.to(w.dtype),
            db.to(b.dtype), dt.to(t.dtype))


def _l2r_halo(dg, xs, w, b, t):
    """The halo layout's l2r forward: the parts of every compact row, the
    slot rows' sent to their owners (K1), merged there."""
    loc_aggr, loc_lse, send = _l2r_halo_parts(dg, xs, w, b, t)
    return _l2r_halo_merge(dg, loc_aggr, loc_lse, _a2a(send, dg.group))


def _l2r_halo_parts(dg, xs, w, b, t):
    """``gen_agg_fwd`` a shard over its compact rows: the local rows'
    (aggr, lse) stacked, and the slot rows' side by side in the (L, nh, W)
    buffer K1 sends to their owners."""
    gen, k, ns, nh = dg.gen, dg.n_local, dg.ns, dg.nh
    d = xs[0].shape[1]
    parts = [gen_agg_fwd(*gen.l2r[s], xs[s], w, b, t) for s in range(k)]
    acc = parts[0][0].dtype
    loc_aggr = torch.cat([a[:ns] for a, _ in parts])
    loc_lse = torch.cat([lse[:ns] for _, lse in parts])
    # the slot rows' (aggr, lse), one row each, to the owners
    send = xs[0].new_empty((k, nh, padded_width(2 * d, acc)), dtype=acc)
    for s, (a, lse) in enumerate(parts):
        send[s, :, :d] = a[ns:]
        send[s, :, d:2 * d] = lse[ns:]
    return loc_aggr, loc_lse, send


def _l2r_halo_merge(dg, loc_aggr, loc_lse, back):
    """The owners' merge of their local parts with the slot parts K1
    brought (``back``, (L, nh, W))."""
    gen = dg.gen
    return gen_lse_merge(gen.local_edges, loc_aggr, loc_lse, gen.merge_ptr,
                         gen.merge_idx, back.reshape(-1, back.shape[2]))


def _l2r_full(dg, xs, w, b, t):
    """The all-gather layout's l2r forward: each shard's part of every
    variable row, (aggr, lse) side by side in one (L, n_pad, 2D) buffer;
    over ranks each rank's blocks go to their owners; one merge of the K
    parts of each row held here."""
    parts = _l2r_full_parts(dg, xs, w, b, t)
    if dg.group is not None:
        parts = exchange_var_blocks(parts, dg.group)
    return _l2r_full_merge(dg, parts)


def _l2r_full_parts(dg, xs, w, b, t):
    """``gen_agg_fwd`` a shard over all n_pad variable rows: (L*n_pad, 2D),
    each row's (aggr, lse)."""
    gen, k, n_pad = dg.gen, dg.n_local, dg.n_pad
    d = xs[0].shape[1]
    parts = None
    for s in range(k):
        a, lse = gen_agg_fwd(*gen.l2r[s], xs[s], w, b, t)
        if parts is None:
            parts = a.new_empty((k, n_pad, 2 * d))
        parts[s, :, :d] = a
        parts[s, :, d:] = lse
        del a, lse
    return parts.view(k * n_pad, 2 * d)


def _l2r_full_merge(dg, parts):
    """One merge of the K parts of each row held here. No row has a local
    part, so the merge's local operands are an unread buffer of their
    shape."""
    gen = dg.gen
    unread = parts.new_empty((gen.local_edges.shape[0], parts.shape[1] // 2))
    return gen_lse_merge(gen.local_edges, unread, unread, gen.merge_ptr,
                         gen.merge_idx, parts)


class _L2ROp:
    """:class:`DistGenL2R` with one shard a device: each shard's (x, w, b,
    t) in, its aggr out."""

    @staticmethod
    def forward(threads, dgs, ins):
        def xs(k):
            return ins[k][0].split(dgs[k].ms)

        if dgs[0].halo:
            parts = threads.each(lambda k: _l2r_halo_parts(
                dgs[k], xs(k), *ins[k][1:]))
            back = _a2a_devices([p[2][0] for p in parts], threads)
            res = threads.each(lambda k: _l2r_halo_merge(
                dgs[k], parts[k][0], parts[k][1], back[k][None]))
        else:
            parts = threads.each(lambda k: _l2r_full_parts(
                dgs[k], xs(k), *ins[k][1:]))
            got = threads.each(lambda q: torch.cat(
                _block_rows(threads, parts, q)))
            res = threads.each(lambda k: _l2r_full_merge(dgs[k], got[k]))
        return [a for a, _ in res], [(*ins[k], *res[k])
                                     for k in range(threads.size)]

    @staticmethod
    def backward(threads, dgs, saved, grads, needs):
        d = saved[0][0].shape[1]
        if dgs[0].halo:
            tables = threads.each(lambda k: _stat_table(grads[k], *saved[k][4:]))
            slots = _gather_devices(threads, dgs, tables)
            stats = [_halo_stats(dgs[k], tables[k], slots[k], d)
                     for k in range(threads.size)]
        else:
            full = _all_gather_devices(threads, threads.each(
                lambda k: torch.cat([grads[k], *saved[k][4:]], 1)))
            splits = [_split_stats(f) for f in full]
            stats = [(lambda s, v=v: v) for v in splits]
        return threads.each(lambda k: _l2r_grads(
            dgs[k], *saved[k][:4], stats[k], needs[k][0]))


def _l2r(x, w, b, t, dg):
    """``DistGenL2R.apply(x, w, b, t, dg)``; with one shard a device the
    shards' calls meet and one node over all K runs :class:`_L2ROp`."""
    if isinstance(dg.group, Member):
        return joint(_L2ROp, dg.group, "DistGenL2R", (x, w, b, t), dg)
    return DistGenL2R.apply(x, w, b, t, dg)


def dist_gen_bidir_conv(conv, dg, left, right):
    """A ``BidirGENConv`` over the partition ``dg`` (edge_partition.py:880,
    :960): the module's own projections, encoders and MLPs on all shards'
    rows at once, the two aggregations over the compact halo space or the
    all-gather layout. GEN's input aggregation depends on its parameters
    and is never cached."""
    gen, k, ns = dg.gen, dg.n_local, dg.ns
    r2l, l2r = conv.right2left, conv.left2right
    # r2l: dst = constraints, sources through the halo or all of them
    r_src, x_dst_l = r2l.project(right, left)
    w, b, t = r2l.encoder(r_src.dtype)
    if dg.halo:
        hbuf = _collective(HaloGather, r_src, dg)
        rs = r_src.split(ns)
        srcs = [torch.cat([rs[s], hbuf[s]]) for s in range(k)]
    else:
        srcs = [_collective(AllGatherVars, r_src, dg)] * k
    aggr_c = torch.cat([
        gen_softmax_agg(*gen.r2l[s], srcs[s], w, b, t, gen.l2r[s].ptr,
                        gen.eperm_r2l[s]) for s in range(k)])
    left_new = r2l.update(aggr_c, x_dst_l)
    # l2r: dst = variables, the parts merged at the owners
    l_src, x_dst_r = l2r.project(left, right)
    aggr_v = _l2r(l_src, *l2r.encoder(l_src.dtype), dg)
    return left_new, l2r.update(aggr_v, x_dst_r)
