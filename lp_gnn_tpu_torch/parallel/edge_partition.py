"""Edge-partitioned GCN_FC prediction with boundary halo exchange.

Counterpart of ``lp_gnn_tpu/parallel/edge_partition.py``, forward only and
for GCN_FC only. Constraint rows are cut into K blocks of ``ms`` rows and
variables into K blocks of ``ns`` (``_shard_sizes`` :161); shard d owns its
row block, every edge of those rows and its variable block. Per
two-direction conv (``_dist_aggs`` :655, halo branch :673-708):

- ``halo_gather``: each shard receives the rows of other shards' variable
  blocks that its edges reference (``halo_send``), in its compact halo
  buffer of K*Bh slots. On one card this is one row gather over a composed
  index, the all-to-all folded into it;
- the constraint side sums its own-block edges (local v2c) and its boundary
  edges against the halo buffer (halo v2c);
- the variable side sums its own-block edges (local c2v), and each shard's
  boundary partials (halo c2v, one per halo slot) go back to their owners
  through the halo all-to-all (K1) and a sorted segment sum over
  ``halo_ids`` (``halo_reduce``).

The JAX package lays each shard's edges out for the TPU's matrix unit
(``blkl_*``, ``blkh_*``, padded to one edge count). The port keeps four CSRs
a shard instead, for its CSR SpMM kernel: local v2c (ms dst rows, ns src),
local c2v (ns, ms), halo v2c (ms, nh = K*Bh) and halo c2v (nh, ms). The cut
points are the JAX package's (``_shard_sizes``, Bh rounded to 8, edges with
``val == 0`` dropped), so ``halo_send``, ``halo_perm``, ``halo_ids`` and
``nnz_s`` equal its own. The fields of other paths (GEN compact indices,
``eperm_*``, the all-gather layouts ``blkr``/``blkc``, ``in_agg_*``) are
left out.

All K shards sit on one device (``mesh.EdgeMesh``) and run one after another
on one stream. The all-gather branch (:709-736), the backward of the halo
pair and the distributed losses wait for ROADMAP.md queue item 7.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import BipartiteGraph
from ..models.layers import add_knowledge, dropout
from ..ops.gather import gather_rows
from ..ops.spmm import spmm_csr
from .halo import halo_all_to_all
from .mesh import EdgeMesh

CSR_KINDS = ("local_v2c", "local_c2v", "halo_v2c", "halo_c2v")


class CSR(NamedTuple):
    """``out[d] = sum_{e in [ptr[d], ptr[d+1])} val[e] * x[idx[e]]``."""
    ptr: np.ndarray | torch.Tensor   # (num_dst+1,) int32
    idx: np.ndarray | torch.Tensor   # (E,) int32
    val: np.ndarray | torch.Tensor   # (E,) float32


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def _shard_sizes(g: BipartiteGraph, n_shards: int) -> tuple[int, int]:
    """Rows and variables a shard owns, from the real node counts, rounded
    to 128 (edge_partition.py:161)."""
    ms = _round_up(-(-int(g.ncons) // n_shards), 128)
    ns = _round_up(-(-int(g.nvars) // n_shards), 128)
    return ms, ns


def _real_edges(g: BipartiteGraph):
    """The edges the partition keeps (``val != 0``, edge_partition.py:231),
    in (row, col) order, as int64 / float32."""
    row = np.asarray(g.row, np.int64)
    col = np.asarray(g.col, np.int64)
    val = np.asarray(g.val, np.float32)
    keep = val != 0
    row, col, val = row[keep], col[keep], val[keep]
    order = np.lexsort((col, row))
    return row[order], col[order], val[order]


def _boundary_keys(row, col, n_shards, ms, ns):
    """Each edge's shard and owner, and one sorted key per distinct
    (requesting shard, owning shard, owned column) of the edges that cross
    shards; ``inv`` maps those edges to their key."""
    d = row // ms
    owner = col // ns
    off = owner != d
    key = (d[off] * n_shards + owner[off]) * ns + (col[off] - owner[off] * ns)
    uk, inv = np.unique(key, return_inverse=True)
    return d, owner, off, uk, inv


def compute_halo_width(g: BipartiteGraph, n_shards: int) -> int:
    """Bh: the largest boundary set over all (requester, owner) pairs,
    rounded to 8 (edge_partition.py:175, :336-337)."""
    ms, ns = _shard_sizes(g, n_shards)
    row, col, _ = _real_edges(g)
    _, _, _, uk, _ = _boundary_keys(row, col, n_shards, ms, ns)
    if len(uk) == 0:
        return _round_up(1, 8)
    cnt = np.bincount(uk // ns, minlength=n_shards * n_shards)
    return _round_up(int(cnt.max()), 8)


def _sorted_csr(dst, src, val, num_dst: int) -> CSR:
    """CSR of (dst, src, val) edges, ordered by (dst, src)."""
    order = np.lexsort((src, dst))
    ptr = np.zeros(num_dst + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=num_dst), out=ptr[1:])
    return CSR(ptr, src[order].astype(np.int32), val[order].astype(np.float32))


@dataclasses.dataclass
class PartitionedGraph:
    """The host-side partition of one graph into ``n_shards`` (numpy)."""
    n_shards: int
    ms: int                    # constraint rows a shard owns
    ns: int                    # variables a shard owns
    bh: int                    # halo slots per (sender, receiver) pair
    c_feas: np.ndarray         # (K, ms, 8) float32, zero rows past ncons
    v_feas: np.ndarray         # (K, ns, 8) float32
    cons_mask: np.ndarray      # (K, ms) bool, real rows
    vars_mask: np.ndarray      # (K, ns) bool
    nnz_s: np.ndarray          # (K,) int32 edges per shard
    # halo_send[d, e]: local variable rows shard d sends to shard e (the
    # boundary set of e's edges in d's block), padded with row 0
    halo_send: np.ndarray      # (K, K, bh) int32
    halo_perm: np.ndarray      # (K, K*bh) int32, stable sort of halo_send[d]
    halo_ids: np.ndarray       # (K, K*bh) int32, halo_send[d] sorted
    local_v2c: list[CSR]       # per shard: ms dst / ns src (own block)
    local_c2v: list[CSR]       # ns dst / ms src
    halo_v2c: list[CSR]        # ms dst / nh src halo slots (owner*bh + rank)
    halo_c2v: list[CSR]        # nh dst / ms src

    @property
    def nh(self) -> int:
        return self.n_shards * self.bh


def partition_graph(g: BipartiteGraph, n_shards: int) -> PartitionedGraph:
    """Host-side row partition of ``g`` into ``n_shards`` with the boundary
    halo lists (edge_partition.py:205 with ``halo=True``, boundary lists
    :304-370)."""
    ms, ns = _shard_sizes(g, n_shards)
    nk = n_shards
    row, col, val = _real_edges(g)
    d_all, owner, off, uk, inv = _boundary_keys(row, col, nk, ms, ns)
    lens = np.bincount(d_all, minlength=nk)
    pair_u = uk // ns
    counts = np.bincount(pair_u, minlength=nk * nk)
    starts = np.concatenate([[0], np.cumsum(counts)])
    bh = _round_up(int(counts.max()) if len(uk) else 1, 8)
    nh = nk * bh

    # halo_send[e, d, rank] = the rank-th column of d's boundary set in e
    halo_send = np.zeros((nk, nk, bh), np.int32)
    rank_u = np.arange(len(uk)) - starts[pair_u]
    halo_send[pair_u % nk, pair_u // nk, rank_u] = uk % ns
    flat = halo_send.reshape(nk, nh)
    halo_perm = np.argsort(flat, axis=1, kind="stable").astype(np.int32)
    halo_ids = np.take_along_axis(flat, halo_perm, axis=1)

    # each boundary edge's halo slot: owner * bh + rank in its boundary set
    slot = np.full(len(row), -1, np.int64)
    slot[off] = owner[off] * bh + (inv - starts[pair_u[inv]])
    ends = np.cumsum(lens)
    csr = {k: [] for k in CSR_KINDS}
    for d in range(nk):
        sl = slice(ends[d] - lens[d], ends[d])
        r = row[sl] - d * ms
        own, bnd = ~off[sl], off[sl]
        c_loc = col[sl][own] - d * ns
        v, s = val[sl], slot[sl][bnd]
        csr["local_v2c"].append(_sorted_csr(r[own], c_loc, v[own], ms))
        csr["local_c2v"].append(_sorted_csr(c_loc, r[own], v[own], ns))
        csr["halo_v2c"].append(_sorted_csr(r[bnd], s, v[bnd], ms))
        csr["halo_c2v"].append(_sorted_csr(s, r[bnd], v[bnd], nh))

    def shard_nodes(x, per):
        out = np.zeros((nk * per,) + x.shape[1:], x.dtype)
        out[:x.shape[0]] = x
        return out.reshape(nk, per, *x.shape[1:])

    return PartitionedGraph(
        n_shards=nk, ms=ms, ns=ns, bh=bh,
        c_feas=shard_nodes(np.asarray(g.c_feas, np.float32), ms),
        v_feas=shard_nodes(np.asarray(g.v_feas, np.float32), ns),
        cons_mask=(np.arange(nk * ms) < g.ncons).reshape(nk, ms),
        vars_mask=(np.arange(nk * ns) < g.nvars).reshape(nk, ns),
        nnz_s=lens.astype(np.int32), halo_send=halo_send,
        halo_perm=halo_perm, halo_ids=halo_ids, **csr)


# ---------------------------------------------------------- partition cache
_CACHE_SUFFIX = ".tpart.npz"   # never the JAX package's .pk pickles
_CACHE_VERSION = 1
_CACHE_ARRAYS = ("c_feas", "v_feas", "cons_mask", "vars_mask", "nnz_s",
                 "halo_send", "halo_perm", "halo_ids")
_CACHE_INTS = ("n_shards", "ms", "ns", "bh")


def _graph_fingerprint(g: BipartiteGraph) -> str:
    """Content fingerprint for the partition cache (edge_partition.py:450):
    shapes, CRC32 of a strided sample of every array the partition embeds,
    and exact sums of the edge arrays."""
    h = 0
    for a in (g.row, g.col, g.val, g.c_feas, g.v_feas):
        flat = np.ascontiguousarray(np.asarray(a)).reshape(-1)
        step = max(flat.shape[0] // 65536, 1)
        h = zlib.crc32(np.ascontiguousarray(flat[::step]).tobytes(), h)
    agg = np.array([np.asarray(g.row, np.int64).sum(),
                    np.asarray(g.col, np.int64).sum()], np.int64)
    vs = np.float64(np.asarray(g.val, np.float64).sum())
    h = zlib.crc32(agg.tobytes() + vs.tobytes(), h)
    return f"{g.ncons}x{g.nvars}x{g.nnz}-{h:08x}"


def _store_partition(path: str, dg: PartitionedGraph) -> None:
    """``np.savez`` of every field (atomic rename)."""
    arrays = {"version": np.int64(_CACHE_VERSION)}
    arrays.update({k: np.int64(getattr(dg, k)) for k in _CACHE_INTS})
    arrays.update({k: getattr(dg, k) for k in _CACHE_ARRAYS})
    for kind in CSR_KINDS:
        for d, m in enumerate(getattr(dg, kind)):
            for field, a in m._asdict().items():
                arrays[f"{kind}.{field}.{d}"] = a
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _load_partition(path: str) -> PartitionedGraph:
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != _CACHE_VERSION:
            raise ValueError(f"{path}: partition cache version "
                             f"{int(z['version'])}, expected {_CACHE_VERSION}")
        ints = {k: int(z[k]) for k in _CACHE_INTS}
        kw = {k: z[k] for k in _CACHE_ARRAYS}
        for kind in CSR_KINDS:
            kw[kind] = [CSR(*(z[f"{kind}.{f}.{d}"] for f in CSR._fields))
                        for d in range(ints["n_shards"])]
    return PartitionedGraph(**ints, **kw)


def cached_partition_graph(g: BipartiteGraph, n_shards: int,
                           cache_dir: str | None = None,
                           fn: str | None = None) -> PartitionedGraph:
    """``partition_graph`` with an on-disk cache (edge_partition.py:538),
    keyed by graph name, shard count and content fingerprint, in the port's
    own ``.tpart.npz`` files beside the dataset's ``processed/`` blobs."""
    if not cache_dir or not fn:
        return partition_graph(g, n_shards)
    path = os.path.join(
        cache_dir, f"{fn}-D{n_shards}-{_graph_fingerprint(g)}{_CACHE_SUFFIX}")
    if os.path.exists(path):
        return _load_partition(path)
    dg = partition_graph(g, n_shards)
    os.makedirs(cache_dir, exist_ok=True)
    _store_partition(path, dg)
    return dg


# ------------------------------------------------------------ device tensors
def compose_halo_src(halo_send: np.ndarray, ns: int) -> np.ndarray:
    """(K, K*bh) int32 with ``[q, p*bh + r] = p*ns + halo_send[p, q, r]``:
    the stacked variable row that lands in slot ``p*bh + r`` of shard q's
    halo buffer, the all-to-all of ``halo_gather`` folded into its index.
    Each (q, p) block ascends in shard p's rows (its padding slots, last,
    point at p's row 0)."""
    k = halo_send.shape[0]
    src = np.arange(k)[:, None, None] * ns + halo_send
    return np.ascontiguousarray(src.transpose(1, 0, 2).reshape(k, -1),
                                np.int32)


def halo_schedule(halo_src: np.ndarray, window: int = 16) -> np.ndarray:
    """The order in which the halo gather walks its composed index: (n, 2)
    int32 ranges (first, rows) of the flat index. Every (receiver, sender)
    block is cut where its rows cross a multiple of ``window`` sender rows
    (and into pieces of at most ``window`` entries), and the pieces are
    listed window by window. The receivers of one window then copy the same
    sender rows side by side, so each is read from device memory once."""
    k, nh = halo_src.shape
    flat = halo_src.reshape(-1)
    n = flat.shape[0]
    win = flat // window
    pos = np.arange(n)
    new = np.ones(n, bool)
    new[1:] = (win[1:] != win[:-1]) | (pos[1:] % (nh // k) == 0)
    starts = np.flatnonzero(new)
    lens = np.diff(np.append(starts, n))
    pieces = -(-lens // window)
    first = np.repeat(starts, pieces) + window * (
        np.arange(pieces.sum()) - np.repeat(np.cumsum(pieces) - pieces, pieces))
    rows = np.minimum(window, np.repeat(starts + lens, pieces) - first)
    order = np.lexsort((first, win[first]))
    return np.stack([first[order], rows[order]], 1).astype(np.int32)


@dataclasses.dataclass
class DistGraphTensors:
    """A partition on its mesh's device: node features stacked shard after
    shard (row ``d*ms + i`` is shard d's row i, which is global row
    ``d*ms + i``), per-shard CSRs, the composed halo index and the
    owner-side reduce CSRs."""
    n_shards: int
    ms: int
    ns: int
    c_feas: torch.Tensor           # (K*ms, 8) float32
    v_feas: torch.Tensor           # (K*ns, 8) float32
    halo_src: torch.Tensor         # (K, K*bh) int32, compose_halo_src
    halo_sched: torch.Tensor       # (n, 2) int32, halo_schedule(halo_src)
    # per shard, the owner-side sorted segment sum of halo_reduce (:636)
    # over its real slots: ns dst rows, ptr from halo_ids, idx = halo_perm,
    # val = 1. The padding slots are left out: their partials are zeros
    # (no edge targets them), and all of them point at local row 0, which
    # would make that row one long serial segment for the kernel.
    halo_red: list[CSR]
    local_v2c: list[CSR]
    local_c2v: list[CSR]
    halo_v2c: list[CSR]
    halo_c2v: list[CSR]

    @classmethod
    def from_partition(cls, dg: PartitionedGraph,
                       mesh: EdgeMesh) -> "DistGraphTensors":
        if dg.n_shards != mesh.n_shards:
            raise ValueError(f"a partition of {dg.n_shards} shards on a mesh "
                             f"of {mesh.n_shards}")
        dev = mesh.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # slot o*bh + r of sender e's halo buffer is real iff some edge of e
        # targets it; it lands at position e*bh + r of owner o's buffer
        real = np.stack([np.diff(m.ptr) > 0 for m in dg.halo_c2v]).reshape(
            dg.n_shards, dg.n_shards, dg.bh)

        def red(o):
            perm = dg.halo_perm[o][real[:, o].reshape(-1)[dg.halo_perm[o]]]
            ptr = np.zeros(dg.ns + 1, np.int32)
            np.cumsum(np.bincount(dg.halo_send[o].reshape(-1)[perm],
                                  minlength=dg.ns), out=ptr[1:])
            return CSR(t(ptr), t(perm), t(np.ones(len(perm), np.float32)))

        src = compose_halo_src(dg.halo_send, dg.ns)
        return cls(
            n_shards=dg.n_shards, ms=dg.ms, ns=dg.ns,
            c_feas=t(dg.c_feas.reshape(-1, dg.c_feas.shape[-1])),
            v_feas=t(dg.v_feas.reshape(-1, dg.v_feas.shape[-1])),
            halo_src=t(src), halo_sched=t(halo_schedule(src)),
            halo_red=[red(d) for d in range(dg.n_shards)],
            **{k: [CSR(*map(t, m)) for m in getattr(dg, k)]
               for k in CSR_KINDS})


# --------------------------------------------------------------- halo pair
def halo_gather(right: torch.Tensor, halo_src: torch.Tensor,
                halo_sched: torch.Tensor) -> torch.Tensor:
    """Collect the remote variable rows each shard's edges reference
    (edge_partition.py:585, forward). ``right`` (K*ns, F) is stacked by
    shard; returns the K halo buffers stacked, (K, K*bh, F), where slot
    ``p*bh + r`` of shard q's buffer holds the r-th row of q's boundary set
    in shard p.

    The JAX package gathers each shard's send rows ``x_p[halo_send[p]]`` and
    exchanges them with an all-to-all (K1). With every shard on one card
    that exchange is a fixed permutation of rows, so it is folded into the
    index (``halo_src``) and one gather writes the receivers' buffers
    directly, bit for bit the same rows. Where ``right`` is larger than
    the card's L2, ``halo_sched`` (:func:`halo_schedule`) orders the work
    so that a sender row several receivers need is read from device memory
    once; a table L2 holds whole is read once in any order, and there the
    schedule's short ranges would only leave lanes idle. Shards on distinct
    cards would bring back the gather-then-K1 route, with peer addresses in
    K1's table (ROADMAP.md, queue item 7)."""
    k = halo_src.shape[0]
    return gather_rows(right, halo_src.view(-1),
                       schedule=pick_halo_schedule(right, halo_sched)).view(
        k, halo_src.shape[1], right.shape[1])


def pick_halo_schedule(right: torch.Tensor,
                       halo_sched: torch.Tensor) -> torch.Tensor | None:
    """``halo_sched`` where ``right`` lies on the card and is larger than
    its L2, else None (rows in order)."""
    if right.is_cuda and right.nbytes > torch.cuda.get_device_properties(
            right.device).L2_cache_size:
        return halo_sched
    return None


def halo_reduce(parts: torch.Tensor, halo_red: list[CSR]) -> list[torch.Tensor]:
    """Route each shard's halo-slot partial sums back to their owners and
    fold them into the owners' (ns, F) blocks (edge_partition.py:624,
    forward): ``parts`` (K, K*bh, F) stacked by shard, one all-to-all (K1)
    of the stacked form, then a sorted segment sum over ``halo_ids`` as a
    CSR SpMM with ``idx = halo_perm`` and ``val = 1``
    (``DistGraphTensors.halo_red``), which skips the padding slots: the
    forward's partials there are zeros, since no edge targets them."""
    back = halo_all_to_all(parts)
    return [spmm_csr(*r, b) for r, b in zip(halo_red, back)]


# ---------------------------------------------------------------- forward
def _dist_aggs(dg: DistGraphTensors, left: torch.Tensor, right: torch.Tensor):
    """Both aggregations of one two-direction conv over the halo exchange
    (edge_partition.py:655, halo branch :673-708). ``left`` (K*ms, F) and
    ``right`` (K*ns, F) are stacked by shard. The local and halo parts add
    in the compute dtype, as there (:703-707)."""
    k, ms, ns = dg.n_shards, dg.ms, dg.ns
    ls, rs = left.split(ms), right.split(ns)
    h = halo_gather(right, dg.halo_src, dg.halo_sched)
    part = left.new_empty((k, dg.halo_src.shape[1], left.shape[1]))
    for d in range(k):
        spmm_csr(*dg.halo_c2v[d], ls[d], out=part[d])
    red = halo_reduce(part, dg.halo_red)
    agg_c = left.new_empty((k * ms, right.shape[1]))
    agg_v = right.new_empty((k * ns, left.shape[1]))
    for d in range(k):
        torch.add(spmm_csr(*dg.local_v2c[d], rs[d]),
                  spmm_csr(*dg.halo_v2c[d], h[d]),
                  out=agg_c[d * ms:(d + 1) * ms])
        torch.add(spmm_csr(*dg.local_c2v[d], ls[d]), red[d],
                  out=agg_v[d * ns:(d + 1) * ns])
    return agg_c, agg_v


def _dist_bidir_conv(conv, dg: DistGraphTensors, left, right):
    """A ``BidirGraphConv`` over the partition (edge_partition.py:739): the
    module's own linears, applied to all shards' rows at once."""
    agg_c, agg_v = _dist_aggs(dg, left, right)
    return conv.right2left(agg_c, left), conv.left2right(agg_v, right)


def dist_gcn_fc_apply(model, dg: DistGraphTensors):
    """GCN_FC forward over a partition (edge_partition.py:757), with the
    weights of the single-device ``GCN_FC`` module ``model``. Returns the
    stacked (K*ms, 3) and (K*ns, 3) fp32 logits."""
    x_left = dg.c_feas.to(model.cdtype)
    x_right = dg.v_feas.to(model.cdtype)
    left, right = _dist_bidir_conv(model.conv1, dg, x_left, x_right)
    left, right = F.relu(left), F.relu(right)
    for conv in model.layers:
        left, right = _dist_bidir_conv(conv, dg, left, right)
        left = dropout(left, model.dp, None, model.training)
        right = dropout(right, model.dp, None, model.training)
        left, right = F.relu(left), F.relu(right)
    left = model.lin_left(left)
    right = model.lin_right(right)
    return add_knowledge(left, right, x_left, x_right)


#: arch name -> distributed forward (edge_partition.py:1043); every one
#: takes the halo exchange, the only partition the port builds. The rest
#: of the zoo's dist forwards wait for ROADMAP.md queue item 7.
DIST_MODELS = {"GCN_FC": dist_gcn_fc_apply}


def dist_apply(model, dg: PartitionedGraph, mesh: EdgeMesh):
    """Full-graph forward of one partitioned graph on ``mesh``
    (edge_partition.py:1207): the partition goes to the mesh's device, then
    the arch's distributed forward runs. Returns the stacked logits
    ((K*ms, 3), (K*ns, 3)); global row i is row i, padding rows last."""
    if model.name not in DIST_MODELS:
        raise NotImplementedError(
            f"edge-partitioned {model.name} is not ported to lp_gnn_tpu_torch "
            "yet (ROADMAP.md, queue item 7: edge partition, the rest); only "
            "GCN_FC is")
    dgt = DistGraphTensors.from_partition(dg, mesh)
    return DIST_MODELS[model.name](model, dgt)
