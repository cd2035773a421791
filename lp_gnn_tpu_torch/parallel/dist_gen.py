"""GEN's two-direction layer over the compact halo space of a partition.

Counterpart of ``lp_gnn_tpu/parallel/edge_partition.py:880
_dist_gen_bidir_halo`` (with ``_dist_gen_softmax_agg_local`` :829). Each
shard's edges address the concatenated space of its own variables and its
halo slots, ``[local (ns); slots (nh)]`` (the JAX package's ``hcol_r``,
``hseg``): local variable j is compact row j, and halo slot ``owner*bh +
rank`` is compact row ``ns + owner*bh + rank``.

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
  ``gen_lse_merge`` merges them with the local part by log-sum-exp: ``lse = logsumexp_p lse_p``, ``aggr = sum_p exp(lse_p - lse)
  aggr_p``, the exact single-card softmax. The JAX layer combines maxes at
  the owners, sends them back, and sums the exps there; the two differ in
  rounding only.
- l2r's backward needs no merge backward: one halo gather brings each
  owner's (g, aggr, lse) back to its slots, and ``gen_agg_bwd`` runs over
  all ``ns + nh`` compact rows with the merged statistics, which recomputes
  each edge's global alpha: the single-card gradient. The sources'
  gradient is the SpMM over the transpose ordering with the edge
  permutation (``ops/gen_agg.py gather_backward``).

The two compact CSRs of a shard are each other's transpose orderings: r2l
(ms rows, sources compact) sorted by (row, compact column), l2r (ns + nh
rows, sources the shard's constraints) sorted by (compact column, row).
Both come from the partition's four CSRs with their edge permutations,
built with the device tensors (``DistGraphTensors.from_partition(...,
gen=True)``); the partition cache does not hold them. The per-shard loops
run over the shards held here: all K in one process, or, with shard k on
rank k, this rank's one, whose owner-side merge takes the parts its K1
brings from every rank; the parameters' gradients are then this rank's
part, summed over the ranks by ``dist_train_step``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.gen_agg import (gather_backward, gen_agg_bwd, gen_agg_fwd,
                           gen_lse_merge, gen_softmax_agg, padded_width)
from .edge_partition import CSR, HaloGather, _a2a, halo_gather


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


@dataclasses.dataclass
class DistGenTensors:
    """GEN's compact CSRs of a partition on its device."""
    r2l: list[CSR]             # per shard: ms rows, idx compact [0, ns+nh)
    l2r: list[CSR]             # per shard: ns+nh compact rows, idx [0, ms)
    eperm_r2l: list[torch.Tensor]  # in l2r's order: the edge's place in r2l's
    eperm_l2r: list[torch.Tensor]  # in r2l's order: the edge's place in l2r's
    # the owner-side merge over K1's output (L*nh rows, stacked by owner):
    # rows L*ns stacked by owner, each listing its real slots' rows
    merge_ptr: torch.Tensor    # (L*ns+1,) int32
    merge_idx: torch.Tensor    # (n,) int32
    local_edges: torch.Tensor  # (L*ns,) int32, each variable's local edges

    @classmethod
    def from_partition(cls, dg, halo_red, t, own) -> "DistGenTensors":
        """From the host partition ``dg``, its owner-side reduce lists
        ``halo_red`` ((ptr, slot positions) an owner), ``t``, which puts
        a numpy array on the device, and ``own``, the shards held here. A
        shard's edges (its local and halo v2c CSRs) go to the device, and
        the two orderings are stable sorts there, by (row, compact column)
        and by (compact column, row)."""
        ms, ns, nh = dg.ms, dg.ns, dg.nh
        out = {f: [] for f in ("r2l", "l2r", "eperm_r2l", "eperm_l2r")}
        for d in own:
            r1, c1, v1 = _coo(dg.local_v2c[d])
            r2, s2, v2 = _coo(dg.halo_v2c[d])
            r = t(np.concatenate([r1, r2]))
            c = t(np.concatenate([c1, ns + s2]).astype(np.int64))
            v = t(np.concatenate([v1, v2]))
            o_r = torch.argsort(r * (ns + nh) + c, stable=True)
            o_l = torch.argsort(c * ms + r, stable=True)
            out["r2l"].append(CSR(_ptr_of(r, ms), c[o_r].int(), v[o_r]))
            out["l2r"].append(CSR(_ptr_of(c, ns + nh), r[o_l].int(), v[o_l]))
            out["eperm_r2l"].append(_inverse(o_r)[o_l].int())
            out["eperm_l2r"].append(_inverse(o_l)[o_r].int())
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


class DistGenL2R(torch.autograd.Function):
    """``DistGenL2R.apply(x, w, b, t, dg)`` -> aggr (L*ns, D) fp32 (fp64
    for fp64): the l2r aggregation of a GEN layer over the partition ``dg``
    (with ``dg.gen``), from the projected constraint rows ``x`` (L*ms, D)
    and the edge encoder ``w``, ``b`` and temperature ``t`` in x's dtype,
    with a gradient for all four (module docstring). Forward: L
    ``gen_agg_fwd``, one K1, one ``gen_lse_merge``; backward: one halo
    gather, L ``gen_agg_bwd`` and, for x, L SpMMs."""

    @staticmethod
    def forward(ctx, x, w, b, t, dg):
        gen, k, ms, ns, nh = dg.gen, dg.n_local, dg.ms, dg.ns, dg.nh
        d = x.shape[1]
        xs = x.split(ms)
        parts = [gen_agg_fwd(*gen.l2r[s], xs[s], w, b, t) for s in range(k)]
        acc = parts[0][0].dtype
        loc_aggr = torch.cat([a[:ns] for a, _ in parts])
        loc_lse = torch.cat([lse[:ns] for _, lse in parts])
        # the slot rows' (aggr, lse), one row each, to the owners
        send = x.new_empty((k, nh, padded_width(2 * d, acc)), dtype=acc)
        for s, (a, lse) in enumerate(parts):
            send[s, :, :d] = a[ns:]
            send[s, :, d:2 * d] = lse[ns:]
        del parts
        back = _a2a(send, dg.group)
        aggr, lse = gen_lse_merge(gen.local_edges, loc_aggr, loc_lse,
                                  gen.merge_ptr, gen.merge_idx,
                                  back.view(k * nh, back.shape[2]))
        ctx.dg = dg
        ctx.save_for_backward(x, w, b, t, aggr, lse)
        return aggr

    @staticmethod
    def backward(ctx, grad):
        x, w, b, t, aggr, lse = ctx.saved_tensors
        dg = ctx.dg
        gen, k, ms, ns = dg.gen, dg.n_local, dg.ms, dg.ns
        d = x.shape[1]
        # each owner's (g, aggr, lse), brought back to its slots
        table = aggr.new_empty((k * ns, padded_width(3 * d, aggr.dtype)))
        for j, v in enumerate((grad, aggr, lse)):
            table[:, j * d:(j + 1) * d] = v
        slots = halo_gather(table, dg.halo_src, dg.halo_sched, dg.group)
        xs = x.split(ms)
        dxs, sums = [], None
        for s in range(k):
            own = table[s * ns:(s + 1) * ns]
            g, a, lse_s = (torch.cat([own[:, j * d:(j + 1) * d],
                                      slots[s, :, j * d:(j + 1) * d]])
                           for j in range(3))
            dpre, *part = gen_agg_bwd(*gen.l2r[s], xs[s], w, b, t, g, a, lse_s)
            sums = part if sums is None else [u + v for u, v in zip(sums, part)]
            if ctx.needs_input_grad[0]:
                dxs.append(gather_backward(gen.r2l[s].ptr, gen.eperm_l2r[s],
                                           dpre, d))
        dw, db, dt = sums
        return (torch.cat(dxs) if dxs else None, dw.to(w.dtype),
                db.to(b.dtype), dt.to(t.dtype), None)


def dist_gen_bidir_conv(conv, dg, left, right):
    """A ``BidirGENConv`` over the partition ``dg`` (edge_partition.py:880):
    the module's own projections, encoders and MLPs on all shards' rows at
    once, the two aggregations over the compact halo space. GEN's input
    aggregation depends on its parameters and is never cached."""
    gen, k, ns = dg.gen, dg.n_local, dg.ns
    r2l, l2r = conv.right2left, conv.left2right
    # r2l: dst = constraints, sources through the halo
    r_src, x_dst_l = r2l.project(right, left)
    w, b, t = r2l.encoder(r_src.dtype)
    hbuf = HaloGather.apply(r_src, dg)
    rs = r_src.split(ns)
    aggr_c = torch.cat([
        gen_softmax_agg(*gen.r2l[s], torch.cat([rs[s], hbuf[s]]), w, b, t,
                        gen.l2r[s].ptr, gen.eperm_r2l[s]) for s in range(k)])
    left_new = r2l.update(aggr_c, x_dst_l)
    # l2r: dst = variables, the parts merged at the owners
    l_src, x_dst_r = l2r.project(left, right)
    aggr_v = DistGenL2R.apply(l_src, *l2r.encoder(l_src.dtype), dg)
    return left_new, l2r.update(aggr_v, x_dst_r)
