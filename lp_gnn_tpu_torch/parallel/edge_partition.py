"""Edge-partitioned forwards and training, over a halo exchange or over
all-gather / reduce-scatter.

Counterpart of ``lp_gnn_tpu/parallel/edge_partition.py``: every arch of the
zoo serves and trains over K shards. Constraint rows are cut into K blocks
of ``ms`` rows and variables into K blocks of ``ns`` (``_shard_sizes``
:161); shard d owns its row block, every edge of those rows and its
variable block. A two-direction conv (``_dist_aggs`` :655) takes one of two
branches, as the partition says (``partition_graph(..., halo=)``, :205):

**The halo branch** (``halo=True``, :673-708), which the trainer and
predict take for every arch in ``DIST_HALO_ARCHS``:

- ``halo_gather``: each shard receives the rows of other shards' variable
  blocks that its edges reference (``halo_send``), in its compact halo
  buffer of K*Bh slots. With every shard in one process this is one row
  gather over a composed index, the all-to-all folded into it; with one
  shard a rank, the gather of the send rows and the rank form of K1;
- the constraint side sums its own-block edges (local v2c) and its boundary
  edges against the halo buffer (halo v2c);
- the variable side sums its own-block edges (local c2v), and each shard's
  boundary partials (halo c2v, one per halo slot) go back to their owners
  through the halo all-to-all (K1) and a sorted segment sum over
  ``halo_ids`` (``halo_reduce``).

The two halo directions are each other's transpose, and each is the other's
backward (:585-652): :class:`HaloGather` and :class:`HaloReduce`.

**The all-gather branch** (``halo=False``, the default, :709-736), which
GCNRand takes there and API callers may take for any arch: every shard
reads all ``n_pad = K*ns`` variable rows (``all_gather``,
:class:`AllGatherVars`), sums its rows' edges against them (full v2c), and
writes its partials over all ``n_pad`` variable rows (full c2v), which are
summed over the shards, each owner keeping its block (``psum_scatter``,
:class:`ReduceScatterVars`). The two collectives are each other's
transpose and backward. With every shard in one process the stacked
variable rows are ``right_full`` (no copy) and the reduce-scatter is the
sum of the K partials in shard order; over ranks they are the group's
collectives (:func:`all_gather_vars`, :func:`reduce_scatter_vars`).

Every SpMM of a conv goes through :class:`ShardSpmm` (``SpmmCSR`` over the
shards) or its all-gather forms (:class:`SpmmFromFull`,
:class:`ShardPartials`), whose backward is the same kernel over the
partner CSR (local v2c <-> local c2v, halo v2c <-> halo c2v, full v2c <->
full c2v), so a dist step's gradient is the single-card gradient with no
atomics. GEN's aggregation over either layout lives in
``parallel/dist_gen.py``.

The JAX package lays each shard's edges out for the TPU's matrix unit
(``blkl_*``, ``blkh_*``, ``blkr``/``blkc``, padded to one edge count). The
port keeps CSRs a shard instead, for its CSR SpMM kernel: with halo, local
v2c (ms dst rows, ns src), local c2v (ns, ms), halo v2c (ms, nh = K*Bh) and
halo c2v (nh, ms); without, full v2c (ms, n_pad) and full c2v (n_pad, ms).
The cut points are the JAX package's (``_shard_sizes``, Bh rounded to 8,
edges with ``val == 0`` dropped), so ``halo_send``, ``halo_perm``,
``halo_ids`` and ``nnz_s`` equal its own. GEN's CSRs are built from these
when the device tensors are made (``DistGraphTensors.from_partition(...,
gen=True)``).

The shards held here (``mesh.EdgeMesh``): all K on one device, run one
after another on one stream; over ranks, this rank's one; or all K, one a
device. The per-shard loops run over the shards held here, stacked shard
after shard, and the exchanges take the transport of the layout: for the
halo, the stacked K1 or its rank form over the mesh's group (``_a2a``);
for the all-gather pair, none, or the group's collectives. With every
shard here the psums of the JAX losses are sums over the stacked shards:
the single-card losses of ``train/losses.py`` on the stacked logits with
the partition's masks are the dist losses (:1066-1171). Over ranks the
losses' sums are all-reduced over the group (``psum``) and so are the
parameters' gradients (:1255-1257), which gives every rank the
single-graph loss and gradient. The group is the mesh's: the world for
edge shards on their ranks, a row's edge group on the (dp, edge) grid of
ranks (``mesh.RankGrid``). dp x edge, a rank's block of a batch of
partitions, is ``parallel/combined.py``.

With one shard a device (``EdgeMesh.threads``) the :class:`DistGraphTensors`
of the partition holds the stacked labels, masks and node features on the
lead device and, in ``parts``, each shard's own one-shard tensors on its
device, as a rank would hold them. Each shard's forward runs the rank
path's one-shard forward in a thread of its own (``shard_threads``) over a
replica of the model whose parameters are broadcast from the lead; each
collective is one autograd node over the K shards (``shard_threads.Joint``
with the device ops below: the halo pair's send-row gathers, K1's device
form and the owners' sums; the all-gather pair's copies between devices
and sums in shard order). The logits are concatenated on the lead, where
the stacked path's loss takes them; one ``backward()`` sums the K
replicas' gradients onto the master parameters in shard order.

The arch forwards are the modules' own (``models/gcn.py``):
:class:`DistGraphTensors` applies each conv over the shards
(``apply_conv``), so ``DIST_MODELS`` calls the module, except for GCNRand,
whose logits are drawn over the stacked rows and need no graph.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import zlib
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data.dataset import BipartiteGraph
from ..models.gen import BidirGENConv
from ..models.layers import add_knowledge, shard_rows
from ..ops.gather import gather_rows, gather_rows_plain
from ..ops.gen_agg import padded_width
from ..ops.spmm import spmm_csr, spmm_csr_plain
from .halo import (halo_all_to_all, halo_all_to_all_devices,
                   halo_all_to_all_plain, halo_all_to_all_ranks,
                   halo_all_to_all_ranks_plain)
from .dp import cell_generators, step_generator, sum_over_ranks
from .mesh import EdgeMesh
from .shard_threads import Member, joint, numbered_afresh, replicas

CSR_KINDS = ("local_v2c", "local_c2v", "halo_v2c", "halo_c2v")
FULL_KINDS = ("full_v2c", "full_c2v")   # the all-gather layout's


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


def _sizes(g: BipartiteGraph, n_shards: int, ms: int | None,
           ns: int | None) -> tuple[int, int]:
    """``ms`` and ``ns`` where given (a batch's shared sizes), else
    ``_shard_sizes``; either way they must cover the graph."""
    ms0, ns0 = _shard_sizes(g, n_shards)
    ms, ns = ms or ms0, ns or ns0
    if ms < ms0 or ns < ns0:
        raise ValueError(f"shard sizes ({ms}, {ns}) below the graph's "
                         f"({ms0}, {ns0})")
    return ms, ns


def compute_halo_width(g: BipartiteGraph, n_shards: int,
                       ms: int | None = None, ns: int | None = None) -> int:
    """Bh: the largest boundary set over all (requester, owner) pairs,
    rounded to 8 (edge_partition.py:175, :336-337), for the partition
    with shard sizes ``ms`` and ``ns`` (``_shard_sizes`` by default)."""
    ms, ns = _sizes(g, n_shards, ms, ns)
    row, col, _ = _real_edges(g)
    _, _, _, uk, _ = _boundary_keys(row, col, n_shards, ms, ns)
    if len(uk) == 0:
        return _round_up(1, 8)
    cnt = np.bincount(uk // ns, minlength=n_shards * n_shards)
    return _round_up(int(cnt.max()), 8)


def _ptr(dst, num_dst: int) -> np.ndarray:
    ptr = np.zeros(num_dst + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=num_dst), out=ptr[1:])
    return ptr


def _sorted_csr(dst, src, val, num_dst: int) -> CSR:
    """CSR of (dst, src, val) edges, ordered by (dst, src)."""
    order = np.lexsort((src, dst))
    return CSR(_ptr(dst, num_dst), src[order].astype(np.int32),
               val[order].astype(np.float32))


@dataclasses.dataclass
class PartitionedGraph:
    """The host-side partition of one graph into ``n_shards`` (numpy):
    with halo lists (``halo``), or the all-gather layout."""
    n_shards: int
    ms: int                    # constraint rows a shard owns
    ns: int                    # variables a shard owns
    bh: int                    # halo slots per (sender, receiver) pair; 0
    c_feas: np.ndarray         # (K, ms, 8) float32, zero rows past ncons
    v_feas: np.ndarray         # (K, ns, 8) float32
    y_s: np.ndarray            # (K, ms) int32 labels, 0 past ncons
    y_t: np.ndarray            # (K, ns) int32
    cons_mask: np.ndarray      # (K, ms) bool, real rows
    vars_mask: np.ndarray      # (K, ns) bool
    nnz_s: np.ndarray          # (K,) int32 edges per shard
    # halo_send[d, e]: local variable rows shard d sends to shard e (the
    # boundary set of e's edges in d's block), padded with row 0; the three
    # lists are None in the all-gather layout
    halo_send: np.ndarray | None   # (K, K, bh) int32
    halo_perm: np.ndarray | None   # (K, K*bh) int32, halo_send[d]'s stable sort
    halo_ids: np.ndarray | None    # (K, K*bh) int32, halo_send[d] sorted
    # the halo layout's CSRs, per shard (empty in the all-gather layout)
    local_v2c: list[CSR]       # ms dst / ns src (own block)
    local_c2v: list[CSR]       # ns dst / ms src
    halo_v2c: list[CSR]        # ms dst / nh src halo slots (owner*bh + rank)
    halo_c2v: list[CSR]        # nh dst / ms src
    # the all-gather layout's, per shard (empty in the halo layout)
    full_v2c: list[CSR] = dataclasses.field(default_factory=list)  # ms / n_pad
    full_c2v: list[CSR] = dataclasses.field(default_factory=list)  # n_pad / ms

    @property
    def halo(self) -> bool:
        return self.halo_send is not None

    @property
    def nh(self) -> int:
        return self.n_shards * self.bh

    @property
    def n_pad(self) -> int:
        """The global variable axis, K*ns."""
        return self.n_shards * self.ns


def partition_graph(g: BipartiteGraph, n_shards: int, halo: bool = False,
                    halo_width: int | None = None, ms: int | None = None,
                    ns: int | None = None) -> PartitionedGraph:
    """Host-side row partition of ``g`` into ``n_shards`` (edge_partition.py
    :205). ``halo=True`` builds the boundary halo lists (:304-370) and the
    halo layout's four CSRs a shard; ``halo=False`` (the default, as there)
    builds no halo list, and each shard's two full-width CSRs: full v2c
    (its ``ms`` rows from all ``n_pad = K*ns`` variables) and full c2v (all
    ``n_pad`` variables from its rows), for the all-gather branch. ``ms``,
    ``ns`` and ``halo_width`` (Bh) fix the shard sizes and the halo width
    where a batch shares them (``parallel/combined.py partition_batch``);
    they default to the graph's own (Bh is ignored without halo)."""
    ms, ns = _sizes(g, n_shards, ms, ns)
    nk = n_shards
    row, col, val = _real_edges(g)
    d_all = row // ms
    lens = np.bincount(d_all, minlength=nk)
    ends = np.cumsum(lens)

    def shard_nodes(x, per, dtype):
        x = np.asarray(x, dtype)
        out = np.zeros((nk * per,) + x.shape[1:], dtype)
        out[:x.shape[0]] = x
        return out.reshape(nk, per, *x.shape[1:])

    nodes = dict(
        n_shards=nk, ms=ms, ns=ns,
        c_feas=shard_nodes(g.c_feas, ms, np.float32),
        v_feas=shard_nodes(g.v_feas, ns, np.float32),
        y_s=shard_nodes(g.y_s, ms, np.int32),
        y_t=shard_nodes(g.y_t, ns, np.int32),
        cons_mask=(np.arange(nk * ms) < g.ncons).reshape(nk, ms),
        vars_mask=(np.arange(nk * ns) < g.nvars).reshape(nk, ns),
        nnz_s=lens.astype(np.int32))
    if not halo:
        full = {k: [] for k in FULL_KINDS}
        for d in range(nk):
            sl = slice(ends[d] - lens[d], ends[d])
            r, c, v = row[sl] - d * ms, col[sl], val[sl]
            full["full_v2c"].append(_sorted_csr(r, c, v, ms))
            full["full_c2v"].append(_sorted_csr(c, r, v, nk * ns))
        return PartitionedGraph(
            **nodes, bh=0, halo_send=None, halo_perm=None, halo_ids=None,
            **{k: [] for k in CSR_KINDS}, **full)

    _, owner, off, uk, inv = _boundary_keys(row, col, nk, ms, ns)
    pair_u = uk // ns
    counts = np.bincount(pair_u, minlength=nk * nk)
    starts = np.concatenate([[0], np.cumsum(counts)])
    need = _round_up(int(counts.max()) if len(uk) else 1, 8)
    bh = halo_width or need
    if bh < need:
        raise ValueError(f"halo width {bh} below the {need} slots a pair "
                         "needs")
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
    return PartitionedGraph(**nodes, bh=bh, halo_send=halo_send,
                            halo_perm=halo_perm, halo_ids=halo_ids, **csr)


# ---------------------------------------------------------- partition cache
_CACHE_SUFFIX = ".tpart.npz"   # never the JAX package's .pk pickles
_CACHE_VERSION = 3             # 2: labels y_s, y_t; 3: the all-gather layout
_CACHE_ARRAYS = ("c_feas", "v_feas", "y_s", "y_t", "cons_mask", "vars_mask",
                 "nnz_s")
_CACHE_HALO = ("halo_send", "halo_perm", "halo_ids")   # None: not stored
_CACHE_INTS = ("n_shards", "ms", "ns", "bh")


def _graph_fingerprint(g: BipartiteGraph) -> str:
    """Content fingerprint for the partition cache (edge_partition.py:450):
    shapes, CRC32 of a strided sample of every array the partition embeds,
    and exact sums of the edge arrays."""
    h = 0
    for a in (g.row, g.col, g.val, g.c_feas, g.v_feas, g.y_s, g.y_t):
        flat = np.ascontiguousarray(np.asarray(a)).reshape(-1)
        step = max(flat.shape[0] // 65536, 1)
        h = zlib.crc32(np.ascontiguousarray(flat[::step]).tobytes(), h)
    agg = np.array([np.asarray(g.row, np.int64).sum(),
                    np.asarray(g.col, np.int64).sum()], np.int64)
    vs = np.float64(np.asarray(g.val, np.float64).sum())
    h = zlib.crc32(agg.tobytes() + vs.tobytes(), h)
    return f"{g.ncons}x{g.nvars}x{g.nnz}-{h:08x}"


def _store_partition(path: str, dg: PartitionedGraph) -> None:
    """``np.savez`` of every field into a temporary file of its own beside
    ``path``, then renamed over it (``os.replace``): the ranks of one host,
    or of several over a shared file system, may write one partition at
    once, and a reader sees a whole file or none. A halo list that is None
    and a CSR list that is empty store nothing."""
    arrays = {"version": np.int64(_CACHE_VERSION)}
    arrays.update({k: np.int64(getattr(dg, k)) for k in _CACHE_INTS})
    arrays.update({k: getattr(dg, k) for k in _CACHE_ARRAYS + _CACHE_HALO
                   if getattr(dg, k) is not None})
    for kind in CSR_KINDS + FULL_KINDS:
        for d, m in enumerate(getattr(dg, kind)):
            for field, a in m._asdict().items():
                arrays[f"{kind}.{field}.{d}"] = a
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path), suffix=".tmp")
    try:
        # mkstemp's file is private (0600); the cache takes the mode that
        # open() would give it, so other users of the dataset can read it
        os.fchmod(fd, 0o666 & ~_umask())
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _umask() -> int:
    """This process's umask, read where the system shows it (``os.umask``
    sets it to read it, which the process's other threads would see)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Umask:"):
                    return int(line.split()[1], 8)
    except OSError:
        pass
    mask = os.umask(0o022)
    os.umask(mask)
    return mask


def _load_partition(path: str) -> PartitionedGraph | None:
    """The cached partition, or None where the file is of another
    ``_CACHE_VERSION`` (its caller rebuilds and rewrites it)."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != _CACHE_VERSION:
            return None
        ints = {k: int(z[k]) for k in _CACHE_INTS}
        kw = {k: z[k] for k in _CACHE_ARRAYS}
        kw.update({k: z[k] if k in z.files else None for k in _CACHE_HALO})
        for kind in CSR_KINDS + FULL_KINDS:
            kw[kind] = [CSR(*(z[f"{kind}.{f}.{d}"] for f in CSR._fields))
                        for d in range(ints["n_shards"])
                        if f"{kind}.ptr.{d}" in z.files]
    return PartitionedGraph(**ints, **kw)


def cached_partition_graph(g: BipartiteGraph, n_shards: int,
                           cache_dir: str | None = None,
                           fn: str | None = None,
                           halo: bool = False) -> PartitionedGraph:
    """``partition_graph`` with an on-disk cache (edge_partition.py:538),
    keyed by graph name, shard count, ``halo`` (``-h0`` / ``-h1``, as
    :558-560) and content fingerprint, in the port's own ``.tpart.npz``
    files beside the dataset's ``processed/`` blobs. A file of an older
    cache version is a miss, rebuilt and rewritten."""
    if not cache_dir or not fn:
        return partition_graph(g, n_shards, halo=halo)
    path = os.path.join(cache_dir, f"{fn}-D{n_shards}-h{int(halo)}-"
                        f"{_graph_fingerprint(g)}{_CACHE_SUFFIX}")
    if os.path.exists(path):
        dg = _load_partition(path)
        if dg is not None:
            return dg
    dg = partition_graph(g, n_shards, halo=halo)
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


def _halo_red_host(dg: PartitionedGraph) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per owner o, the owner-side sorted segment sum of halo_reduce (:636)
    over its real slots: (ptr (ns+1), positions in o's received buffer).
    The padding slots are left out: their partials are zeros (no edge
    targets them), and all of them point at local row 0, which would make
    that row one long serial segment for the kernel. Slot o*bh + r of
    sender e's buffer is real iff some edge of e targets it; it lands at
    position e*bh + r of owner o's buffer."""
    k = dg.n_shards
    real = np.stack([np.diff(m.ptr) > 0 for m in dg.halo_c2v]).reshape(
        k, k, dg.bh)
    out = []
    for o in range(k):
        perm = dg.halo_perm[o][real[:, o].reshape(-1)[dg.halo_perm[o]]]
        out.append((_ptr(dg.halo_send[o].reshape(-1)[perm], dg.ns), perm))
    return out


@dataclasses.dataclass
class DistGraphTensors:
    """The shards of a partition that this process holds, on its mesh's
    device: node features, labels and masks stacked shard after shard (with
    every shard here, row ``d*ms + i`` is shard d's row i, which is global
    row ``d*ms + i``; over ranks, this rank's ms rows), per-shard CSRs of
    the partition's layout (the halo layout's four, with the gather index
    of the halo exchange and the owner-side reduce CSRs; or the all-gather
    layout's two), and what its users attach: the input conv's aggregations
    (``attach_dist_input_agg``) and GEN's CSRs (``gen``). With one shard a
    device (``mesh.per_device``) the stacked node tensors lie on the lead
    device and ``parts`` holds each shard's own tensors, on its device,
    over its one-shard mesh (``EdgeMesh.member``)."""
    ms: int
    ns: int
    # L shards held here (K, or 1 over ranks), stacked
    c_feas: torch.Tensor           # (L*ms, 8) float32
    v_feas: torch.Tensor           # (L*ns, 8) float32
    y_s: torch.Tensor              # (L*ms,) int64
    y_t: torch.Tensor              # (L*ns,) int64
    cons_mask: torch.Tensor        # (L*ms,) bool
    vars_mask: torch.Tensor        # (L*ns,) bool
    # the halo layout (None / empty in the all-gather layout). Every shard
    # here: (K, K*bh) compose_halo_src; over ranks: (1, K*bh) this rank's
    # halo_send, the rows it sends, block p to rank p
    halo_src: torch.Tensor | None = None   # int32
    halo_sched: torch.Tensor | None = None  # (n, 2) int32, halo_schedule
    halo_red: list[CSR] = dataclasses.field(default_factory=list)
    local_v2c: list[CSR] = dataclasses.field(default_factory=list)
    local_c2v: list[CSR] = dataclasses.field(default_factory=list)
    halo_v2c: list[CSR] = dataclasses.field(default_factory=list)
    halo_c2v: list[CSR] = dataclasses.field(default_factory=list)
    # the all-gather layout (empty in the halo layout)
    full_v2c: list[CSR] = dataclasses.field(default_factory=list)
    full_c2v: list[CSR] = dataclasses.field(default_factory=list)
    in_agg_c: torch.Tensor | None = None   # (L*ms, 8) in a compute dtype
    in_agg_v: torch.Tensor | None = None   # (L*ns, 8)
    gen: object | None = None              # dist_gen.DistGenTensors
    mesh: EdgeMesh | None = None           # where the shards live
    parts: list = dataclasses.field(default_factory=list)  # one a device

    #: JAX's dist forward takes no remat (edge_partition.py:1007-1034)
    remat = False

    @property
    def halo(self) -> bool:
        """Whether the shards carry the halo layout (else the all-gather
        layout's)."""
        if self.parts:
            return self.parts[0].halo
        return self.halo_src is not None

    @property
    def nh(self) -> int:
        return self.halo_src.shape[1] if self.halo else 0

    @property
    def n_pad(self) -> int:
        """The global variable axis, K*ns."""
        return self.n_shards * self.ns

    @property
    def n_shards(self) -> int:
        """K, all shards of the partition."""
        return self.mesh.n_shards

    @property
    def shards(self) -> tuple[int, ...]:
        """The shards held here, in order: all K, or this rank's one."""
        return self.mesh.shards

    @property
    def group(self):
        """The ranks' process group, or None: every shard here."""
        return self.mesh.group

    @property
    def n_local(self) -> int:
        """The shards held here: K, or 1 over ranks."""
        return len(self.shards)

    @property
    def device(self) -> torch.device:
        return self.c_feas.device

    def apply_conv(self, conv, left: torch.Tensor, right: torch.Tensor,
                   input_conv: bool = False):
        """A model's two-direction ``conv`` over the shards, in place of
        ``GraphTensors.apply_conv``: GEN's over the partition's layout
        (``dist_gen.dist_gen_bidir_conv``), a GraphConv's over the halo
        exchange or the all-gather pair, the input conv reading the cached
        aggregations (``_dist_bidir_conv``)."""
        if isinstance(conv, BidirGENConv):
            from .dist_gen import dist_gen_bidir_conv
            return dist_gen_bidir_conv(conv, self, left, right)
        return _dist_bidir_conv(conv, self, left, right, input_conv)

    @classmethod
    def from_partition(cls, dg: PartitionedGraph, mesh: EdgeMesh,
                       gen: bool = False) -> "DistGraphTensors":
        """The mesh's shards of the host partition ``dg`` (every rank
        partitions the whole graph with the same host code and keeps its
        shard), in the partition's layout. ``gen``: also build GEN's CSRs
        (``dist_gen``)."""
        if dg.n_shards != mesh.n_shards:
            raise ValueError(f"a partition of {dg.n_shards} shards on a mesh "
                             f"of {mesh.n_shards}")
        dev, own = mesh.device, list(mesh.shards)
        parts = [cls.from_partition(dg, mesh.member(k), gen)
                 for k in own] if mesh.per_device else []

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def nodes(a, dtype=None):
            a = a[own]
            return t(a.reshape(-1, *a.shape[2:]).astype(dtype or a.dtype))

        def csrs(kinds):
            return {k: [CSR(*map(t, getattr(dg, k)[d])) for d in own]
                    for k in kinds}

        base = dict(ms=dg.ms, ns=dg.ns, c_feas=nodes(dg.c_feas),
                    v_feas=nodes(dg.v_feas), y_s=nodes(dg.y_s, np.int64),
                    y_t=nodes(dg.y_t, np.int64),
                    cons_mask=nodes(dg.cons_mask),
                    vars_mask=nodes(dg.vars_mask), mesh=mesh)
        if parts:
            return cls(**base, parts=parts)
        if not dg.halo:
            out = cls(**base, **csrs(FULL_KINDS))
            if gen:
                from .dist_gen import DistGenTensors
                out.gen = DistGenTensors.from_full(dg, t, own)
            return out
        red = _halo_red_host(dg)
        if mesh.group is None:
            src = compose_halo_src(dg.halo_send, dg.ns)
        else:
            src = dg.halo_send[own].reshape(1, -1)
        out = cls(
            **base, halo_src=t(src), halo_sched=t(halo_schedule(src)),
            halo_red=[CSR(t(red[d][0]), t(red[d][1]),
                          t(np.ones(len(red[d][1]), np.float32)))
                      for d in own],
            **csrs(CSR_KINDS))
        if gen:
            from .dist_gen import DistGenTensors
            out.gen = DistGenTensors.from_partition(dg, red, t, own)
        return out


# --------------------------------------------------------------- halo pair
def plain_fp64(x: torch.Tensor) -> bool:
    """Whether ``x`` is an fp64 tensor on the CPU: a dtype of the plain
    versions only (for gradcheck), which the kernels' wrappers refuse, so
    the dist path takes the plain versions for it. An fp64 tensor on the
    card goes to the wrapper, which raises."""
    return x.dtype == torch.float64 and x.device.type == "cpu"


def _gather(table: torch.Tensor, idx: torch.Tensor,
            schedule: torch.Tensor | None) -> torch.Tensor:
    if plain_fp64(table):
        return gather_rows_plain(table, idx)
    return gather_rows(table, idx, schedule=schedule)


def _a2a_devices(bufs: list[torch.Tensor], threads) -> list:
    """K1's device form of the K (K*bh, F) buffers of one shard a device,
    on the shards' streams."""
    if plain_fp64(bufs[0]):
        return halo_all_to_all_plain(bufs)
    return halo_all_to_all_devices(bufs, threads.streams)


def _a2a(bufs: torch.Tensor, group=None) -> torch.Tensor:
    """K1 of the (L, K*bh, F) buffers of the L shards held here: the
    stacked form where all K are (``group`` None), else the rank form of
    this rank's one over ``group``."""
    if group is None:
        if plain_fp64(bufs):
            return halo_all_to_all_plain(bufs)
        return halo_all_to_all(bufs)
    if plain_fp64(bufs):
        return halo_all_to_all_ranks_plain(bufs[0], group)[None]
    return halo_all_to_all_ranks(bufs[0], group)[None]


def _spmm(m: CSR, x: torch.Tensor, out: torch.Tensor | None = None):
    if plain_fp64(x):
        ref = spmm_csr_plain(*m, x)
        return ref if out is None else out.copy_(ref)
    return spmm_csr(*m, x, out=out)


def halo_gather(right: torch.Tensor, halo_src: torch.Tensor,
                halo_sched: torch.Tensor, group=None) -> torch.Tensor:
    """Collect the remote variable rows each shard's edges reference
    (edge_partition.py:585, forward). ``right`` (L*ns, F) is stacked by
    shard; returns the L halo buffers stacked, (L, K*bh, F), where slot
    ``p*bh + r`` of shard q's buffer holds the r-th row of q's boundary set
    in shard p.

    The JAX package gathers each shard's send rows ``x_p[halo_send[p]]`` and
    exchanges them with an all-to-all (K1). With every shard in this
    process (``group`` None) that exchange is a fixed permutation of rows,
    so it is folded into the index (``halo_src``, :func:`compose_halo_src`)
    and one gather writes the receivers' buffers directly, bit for bit the
    same rows. Over ranks the JAX route comes back: ``halo_src`` is this
    rank's ``halo_send`` and the gather of its send rows goes through the
    rank form of K1 over ``group``. Where ``right`` is larger than the
    card's L2, ``halo_sched`` (:func:`halo_schedule`) orders the gather so
    that a row several receivers need is read from device memory once; a
    table L2 holds whole is read once in any order, and there the
    schedule's short ranges would only leave lanes idle."""
    out = _send_rows(right, halo_src, halo_sched)
    return out if group is None else _a2a(out, group)


def _send_rows(right: torch.Tensor, halo_src: torch.Tensor,
               halo_sched: torch.Tensor) -> torch.Tensor:
    """The gather of :func:`halo_gather`: (L, K*bh, F) rows of ``right``
    at ``halo_src``."""
    k = halo_src.shape[0]
    return _gather(right, halo_src.view(-1),
                   pick_halo_schedule(right, halo_sched)).view(
        k, halo_src.shape[1], right.shape[1])


def pick_halo_schedule(right: torch.Tensor,
                       halo_sched: torch.Tensor) -> torch.Tensor | None:
    """``halo_sched`` where ``right`` lies on the card and is larger than
    its L2, else None (rows in order)."""
    if right.is_cuda and right.nbytes > torch.cuda.get_device_properties(
            right.device).L2_cache_size:
        return halo_sched
    return None


def _halo_reduce_stacked(parts: torch.Tensor, halo_red: list[CSR],
                         group=None) -> torch.Tensor:
    """(L*ns, F). Rows narrower than whole 16-byte pieces (GEN's conv_out
    aggregates 3 channels) are zero-padded for K1 and the SpMM, which move
    16-byte pieces, and the result is the first F columns."""
    return _owner_sums(_a2a(_padded(parts), group), halo_red, parts.shape[2])


def _padded(parts: torch.Tensor) -> torch.Tensor:
    """``parts`` (L, K*bh, F) with its rows zero-padded to whole 16-byte
    pieces."""
    f = parts.shape[2]
    width = padded_width(f, parts.dtype)
    return F.pad(parts, (0, width - f)) if width != f else parts


def _owner_sums(back: torch.Tensor, halo_red: list[CSR], f: int):
    """The owners' segment sums over K1's output ``back`` (L, K*bh, width):
    (L*ns, f)."""
    ns = halo_red[0].ptr.shape[0] - 1
    out = back.new_empty((len(halo_red) * ns, back.shape[2]))
    for d, (r, b) in enumerate(zip(halo_red, back)):
        _spmm(r, b, out=out[d * ns:(d + 1) * ns])
    return out[:, :f]


def halo_reduce(parts: torch.Tensor, halo_red: list[CSR],
                group=None) -> list[torch.Tensor]:
    """Route each shard's halo-slot partial sums back to their owners and
    fold them into the owners' (ns, F) blocks (edge_partition.py:624,
    forward): ``parts`` (L, K*bh, F) stacked by the shards held here, one
    all-to-all (K1: the stacked form, or over ranks its rank form over
    ``group``), then a sorted segment sum over ``halo_ids`` as a CSR SpMM
    with ``idx = halo_perm`` and ``val = 1``
    (``DistGraphTensors.halo_red``), which skips the padding slots: the
    forward's partials there are zeros, since no edge targets them.
    Returns L views of one stacked (L*ns, F) tensor."""
    ns = halo_red[0].ptr.shape[0] - 1
    return list(_halo_reduce_stacked(parts, halo_red, group).split(ns))


class HaloGather(torch.autograd.Function):
    """``HaloGather.apply(right, dg)``: :func:`halo_gather` of the stacked
    (L*ns, F) ``right`` over the partition ``dg`` (a
    :class:`DistGraphTensors`), with a gradient for ``right``. Its backward
    is :func:`halo_reduce`'s forward (edge_partition.py:612
    ``_halo_gather_bwd``): one K1 launch and the owner-side SpMM, no
    gather. That SpMM skips the padding slots, so the backward is the
    exact transpose for a cotangent that is zero there, which every
    cotangent of the dist path is (no edge reads a padding slot)."""

    @staticmethod
    def forward(ctx, right, dg):
        ctx.dg = dg
        return halo_gather(right, dg.halo_src, dg.halo_sched, dg.group)

    @staticmethod
    def backward(ctx, grad):
        dg = ctx.dg
        return _halo_reduce_stacked(grad.contiguous(), dg.halo_red,
                                    dg.group), None


class HaloReduce(torch.autograd.Function):
    """``HaloReduce.apply(parts, dg)`` -> (L*ns, F): :func:`halo_reduce` of
    the stacked (K, K*bh, F) slot partials, with a gradient for ``parts``.
    Its backward is :func:`halo_gather`'s forward (edge_partition.py:645
    ``_halo_reduce_bwd``): the one gather over the composed index, or over
    ranks the send rows' gather and K1, which also fills the padding
    slots, as the JAX VJP does; no edge reads them."""

    @staticmethod
    def forward(ctx, parts, dg):
        ctx.dg = dg
        return _halo_reduce_stacked(parts, dg.halo_red, dg.group)

    @staticmethod
    def backward(ctx, grad):
        dg = ctx.dg
        return halo_gather(grad.contiguous(), dg.halo_src, dg.halo_sched,
                           dg.group), None


# ------------------------------------------- the pairs, one shard a device
# Each runs every shard's part on its own device and stream
# (``threads.each``): the shards' tensors in, each shard's result out. They
# are the device ops of the joint nodes (``shard_threads.Joint``) that
# stand for the halo pair and the all-gather pair with one shard a device.
def _gather_devices(threads, dgs, xs) -> list:
    """:func:`halo_gather` of each shard's (ns, F) rows: its send rows, then
    K1's device form; (1, K*bh, F) a shard."""
    sends = threads.each(lambda k: _send_rows(
        xs[k].contiguous(), dgs[k].halo_src, dgs[k].halo_sched)[0])
    return [b[None] for b in _a2a_devices(sends, threads)]


def _reduce_devices(threads, dgs, parts) -> list:
    """:func:`halo_reduce` of each shard's (1, K*bh, F) slot partials: K1's
    device form, then the owner's sums; (ns, F) a shard."""
    f = parts[0].shape[2]
    back = _a2a_devices(threads.each(
        lambda k: _padded(parts[k].contiguous())[0]), threads)
    return threads.each(
        lambda k: _owner_sums(back[k][None], dgs[k].halo_red, f))


def _all_gather_devices(threads, xs) -> list:
    """Each shard's (K*ns, F): every shard's (ns, F) rows, block p from
    shard p (a copy between devices)."""
    return threads.each(lambda q: torch.cat(
        [threads.move(x, p, q) for p, x in enumerate(xs)]))


def _block_rows(threads, xs, q: int) -> list:
    """Block q of each shard's (K*n, F) rows, as shard q reads them."""
    n = xs[0].shape[0] // threads.size
    return [threads.move(x[q * n:(q + 1) * n], p, q) for p, x in enumerate(xs)]


def _reduce_scatter_devices(threads, xs) -> list:
    """Each shard q's (ns, F): the sum over the shards p of block q of
    p's (K*ns, F) partials, in shard order (``_sum_in_order``, the adds of
    the stacked route)."""
    return threads.each(lambda q: _sum_in_order(_block_rows(threads, xs, q)))


class _HaloGatherOp:
    """:class:`HaloGather` with one shard a device."""

    @staticmethod
    def forward(threads, dgs, ins):
        return _gather_devices(threads, dgs, [x for x, in ins]), ()

    @staticmethod
    def backward(threads, dgs, saved, grads, needs):
        return [(g,) for g in _reduce_devices(threads, dgs, grads)]


class _HaloReduceOp:
    """:class:`HaloReduce` with one shard a device."""

    @staticmethod
    def forward(threads, dgs, ins):
        return _reduce_devices(threads, dgs, [x for x, in ins]), ()

    @staticmethod
    def backward(threads, dgs, saved, grads, needs):
        return [(g,) for g in _gather_devices(threads, dgs, grads)]


class _AllGatherOp:
    """:class:`AllGatherVars` with one shard a device."""

    @staticmethod
    def forward(threads, dgs, ins):
        return _all_gather_devices(threads, [x for x, in ins]), ()

    @staticmethod
    def backward(threads, dgs, saved, grads, needs):
        return [(g,) for g in _reduce_scatter_devices(threads, grads)]


class _ReduceScatterOp:
    """:class:`ReduceScatterVars` with one shard a device: each shard's
    (1, K*ns, F) partials in, its (ns, F) rows out."""

    @staticmethod
    def forward(threads, dgs, ins):
        return _reduce_scatter_devices(threads, [x[0] for x, in ins]), ()

    @staticmethod
    def backward(threads, dgs, saved, grads, needs):
        return [(f.expand(1, *f.shape),)
                for f in _all_gather_devices(threads, grads)]


def _collective(fn, x: torch.Tensor, dg: "DistGraphTensors"):
    """``fn.apply(x, dg)`` for one of the pairs' autograd functions; with
    one shard a device (``dg.group`` a ``shard_threads.Member``) the
    shards' calls meet and one node over all K runs its device op."""
    if isinstance(dg.group, Member):
        return joint(_DEVICE_OPS[fn], dg.group, fn.__name__, (x,), dg)
    return fn.apply(x, dg)


# ---------------------------------------------------------------- forward
def _shard_spmm(m: list[CSR], xs) -> torch.Tensor:
    """Shard d's CSR ``m[d]`` over its input ``xs[d]``, one launch a
    shard, each written into its slice of one (L, n_out, F) output."""
    out = xs[0].new_empty((len(m), m[0].ptr.shape[0] - 1, xs[0].shape[1]))
    for d, md in enumerate(m):
        _spmm(md, xs[d], out=out[d])
    return out


def _stacked(out: torch.Tensor) -> torch.Tensor:
    """An (L, n, F) output as the (L*n, F) rows stacked by shard."""
    return out.view(-1, out.shape[2])


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel takes it: contiguous, 16-byte aligned rows."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


class ShardSpmm(torch.autograd.Function):
    """``ShardSpmm.apply(x, m, t)``: ``SpmmCSR`` over the shards. Shard d's
    CSR ``m[d]`` is applied to shard d's block of the stacked ``x``, and
    the results are stacked, with no copy; the backward is the same over
    the partner orderings ``t`` of the same edges (local v2c <-> local c2v,
    halo v2c <-> halo c2v), one launch a shard."""

    @staticmethod
    def forward(ctx, x, m, t):
        ctx.t = t
        return _stacked(_shard_spmm(m, x.tensor_split(len(m))))

    @staticmethod
    def backward(ctx, grad):
        t = ctx.t
        return _stacked(_shard_spmm(t, _aligned(grad).tensor_split(len(t)))), \
            None, None


# ------------------------------------------------------- the all-gather pair
def _on_host(group) -> bool:
    """Whether ``group``'s collectives move host tensors: gloo's (the CPU,
    or ranks that share a card, which NCCL refuses) are staged through
    host copies, as ``gather_logits`` stages its gather; NCCL's run on the
    card."""
    return dist.get_backend(group) == "gloo"


def all_gather_vars(x: torch.Tensor, group=None) -> torch.Tensor:
    """``right_full`` (edge_partition.py:728 ``all_gather``): the (K*ns, F)
    variable rows of all K shards from the (L*ns, F) rows held here. With
    every shard here (``group`` None) that is ``x`` itself; over ranks the
    group's all-gather, rank p's rows at block p."""
    if group is None:
        return x
    k = dist.get_world_size(group)
    if _on_host(group):
        xc = x.detach().cpu().contiguous()
        parts = [torch.empty_like(xc) for _ in range(k)]
        dist.all_gather(parts, xc, group=group)
        return torch.cat(parts).to(x.device)
    out = x.new_empty((k * x.shape[0], x.shape[1]))
    dist.all_gather_into_tensor(out, x.detach().contiguous(), group=group)
    return out


def exchange_var_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """Over ranks, this rank's (K*ns, F) rows over the global variable axis
    split into K blocks of ns, block p to rank p: the (K*ns, F) rows back,
    block p from rank p (each the sender's rows of this rank's block), by
    ``all_to_all_single``."""
    if _on_host(group):
        xc = x.detach().cpu().contiguous()
        out = torch.empty_like(xc)
        dist.all_to_all_single(out, xc, group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.detach().contiguous(), group=group)
    return out


def _sum_in_order(parts) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right, each add rounded to
    the parts' dtype: the shard order of ``psum_scatter``'s sum."""
    out = parts[0]
    if len(parts) > 1:
        out = out + parts[1]
        for p in parts[2:]:
            out += p
    return out


def reduce_scatter_vars(parts: torch.Tensor, group=None) -> torch.Tensor:
    """``psum_scatter`` of the partials (edge_partition.py:735): ``parts``
    (L, K*ns, F), each shard's partial sums over the whole variable axis,
    to the (L*ns, F) rows of the variable blocks held here, each the sum
    of the K shards' partials, in shard order and in the partials' dtype.
    With every shard here that is the sum of the K partials, stacked by
    owner. Over ranks the transport is an exchange of blocks
    (:func:`exchange_var_blocks`; gloo has no reduce-scatter) and the K
    received blocks are summed here in rank order: the same adds in the
    same order as the stacked route, so its rows bit for bit."""
    if group is None:
        return _sum_in_order(parts)
    k = dist.get_world_size(group)
    got = exchange_var_blocks(parts[0], group)
    return _sum_in_order(got.view(k, -1, got.shape[1]))


class AllGatherVars(torch.autograd.Function):
    """``AllGatherVars.apply(x, dg)`` -> (K*ns, F): :func:`all_gather_vars`
    of the (L*ns, F) rows held here over the partition ``dg``'s mesh, with
    a gradient for ``x``: :func:`reduce_scatter_vars` of the cotangent, as
    ``all_gather``'s transpose is ``psum_scatter``. With every shard here
    the forward is ``x`` itself and the backward the identity (the K
    shards' contributions to ``right_full``'s gradient are summed, in
    shard order, by :class:`SpmmFromFull`, its consumer)."""

    @staticmethod
    def forward(ctx, x, dg):
        ctx.group = dg.group
        return all_gather_vars(x, dg.group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_vars(grad.contiguous()[None], ctx.group), None


class ReduceScatterVars(torch.autograd.Function):
    """``ReduceScatterVars.apply(parts, dg)`` -> (L*ns, F):
    :func:`reduce_scatter_vars` of the (L, K*ns, F) partials, with a
    gradient for ``parts``: the cotangent's :func:`all_gather_vars`, the
    same (K*ns, F) rows for each of the L partials (expanded, not
    copied)."""

    @staticmethod
    def forward(ctx, parts, dg):
        ctx.group, ctx.n = dg.group, parts.shape[0]
        return reduce_scatter_vars(parts, dg.group)

    @staticmethod
    def backward(ctx, grad):
        full = all_gather_vars(grad.contiguous(), ctx.group)
        return full.expand(ctx.n, *full.shape), None


class SpmmFromFull(torch.autograd.Function):
    """``SpmmFromFull.apply(full, m, t)`` -> (L*ms, F): shard d's full v2c
    CSR ``m[d]`` over all (K*ns, F) variable rows ``full``, one launch a
    shard, each written into its rows of one stacked output; the backward
    is the partner CSRs ``t[d]`` (full c2v) over each shard's rows of the
    cotangent, one launch a shard, and the L partials summed in shard order
    (the gradient of ``full``, which every shard read)."""

    @staticmethod
    def forward(ctx, full, m, t):
        ctx.t = t
        return _stacked(_shard_spmm(m, [full] * len(m)))

    @staticmethod
    def backward(ctx, grad):
        t = ctx.t
        parts = _shard_spmm(t, _aligned(grad).tensor_split(len(t)))
        return _sum_in_order(parts), None, None


class ShardPartials(torch.autograd.Function):
    """``ShardPartials.apply(x, m, t)`` -> (L, K*ns, F): shard d's full c2v
    CSR ``m[d]`` over shard d's rows of the stacked ``x``, each written into
    its slice of one buffer (the partials the reduce-scatter sums); the
    backward is the partner CSRs ``t[d]`` (full v2c) over each slice of the
    cotangent, one launch a shard, into one stacked (L*ms, F) output. The
    cotangent :class:`ReduceScatterVars` gives is one (K*ns, F) tensor
    expanded over L: each slice is read in place."""

    @staticmethod
    def forward(ctx, x, m, t):
        ctx.t = t
        return _shard_spmm(m, x.tensor_split(len(m)))

    @staticmethod
    def backward(ctx, grad):
        return _stacked(_shard_spmm(ctx.t, [_aligned(g) for g in grad])), \
            None, None


_DEVICE_OPS = {HaloGather: _HaloGatherOp, HaloReduce: _HaloReduceOp,
               AllGatherVars: _AllGatherOp, ReduceScatterVars: _ReduceScatterOp}


def _dist_aggs(dg: DistGraphTensors, left: torch.Tensor, right: torch.Tensor):
    """Both aggregations of one two-direction conv over the partition's
    layout (edge_partition.py:655), differentiable in ``left`` (L*ms, F)
    and ``right`` (L*ns, F), both stacked by the shards held here. The
    halo branch (:673-708): the local and halo parts add in the compute
    dtype, as there (:703-707). The all-gather branch (:709-736): every
    shard's rows against ``right_full``, and its partials over the whole
    variable axis reduce-scattered (:func:`_dist_aggs_full`)."""
    if not dg.halo:
        return _dist_aggs_full(dg, left, right)
    k, nh = dg.n_local, dg.nh
    h = _collective(HaloGather, right, dg).view(k * nh, right.shape[1])
    part = ShardSpmm.apply(left, dg.halo_c2v, dg.halo_v2c)
    red = _collective(HaloReduce, part.view(k, nh, left.shape[1]), dg)
    agg_c = ShardSpmm.apply(right, dg.local_v2c, dg.local_c2v) + \
        ShardSpmm.apply(h, dg.halo_v2c, dg.halo_c2v)
    agg_v = ShardSpmm.apply(left, dg.local_c2v, dg.local_v2c) + red
    return agg_c, agg_v


def _dist_aggs_full(dg: DistGraphTensors, left: torch.Tensor,
                    right: torch.Tensor):
    """The all-gather branch (edge_partition.py:709-736): ``agg_c`` one
    SpMM a shard over full v2c against ``right_full``
    (:class:`AllGatherVars`), ``agg_v`` the reduce-scatter
    (:class:`ReduceScatterVars`) of one SpMM a shard over full c2v. 2L
    launches a conv and 2L in its backward, no exchange kernel."""
    full = _collective(AllGatherVars, right, dg)
    agg_c = SpmmFromFull.apply(full, dg.full_v2c, dg.full_c2v)
    parts = ShardPartials.apply(left, dg.full_c2v, dg.full_v2c)
    return agg_c, _collective(ReduceScatterVars, parts, dg)


def attach_dist_input_agg(dg: DistGraphTensors,
                          dtype: torch.dtype) -> DistGraphTensors:
    """``dg`` with the input conv's two aggregations computed once, in the
    model's compute ``dtype`` (edge_partition.py:1184, the dist analog of
    ``ops/spmm.py attach_input_agg``): the raw features are constants of the
    graph and every kernel is deterministic, so the input conv of every
    later step reads the same bits it would compute, and skips a gather, a
    K1 and 5 SpMMs a shard each forward, and as many in its backward. With
    one shard a device each shard's run in its thread."""
    if dg.parts:
        return dataclasses.replace(dg, parts=dg.mesh.threads.run(
            lambda k: attach_dist_input_agg(dg.parts[k], dtype)))
    with torch.no_grad():
        agg_c, agg_v = _dist_aggs(dg, dg.c_feas.to(dtype), dg.v_feas.to(dtype))
    return dataclasses.replace(dg, in_agg_c=agg_c, in_agg_v=agg_v)


def _dist_bidir_conv(conv, dg: DistGraphTensors, left, right,
                     input_conv: bool = False):
    """A ``BidirGraphConv`` over the partition (edge_partition.py:739): the
    module's own linears, applied to all shards' rows at once. The input
    conv reads the aggregations ``attach_dist_input_agg`` cached, where
    they are of its inputs' dtype (the ``aggs=`` short-cut)."""
    if input_conv and dg.in_agg_c is not None and \
            dg.in_agg_c.dtype == right.dtype and dg.in_agg_v.dtype == left.dtype:
        agg_c, agg_v = dg.in_agg_c, dg.in_agg_v
    else:
        agg_c, agg_v = _dist_aggs(dg, left, right)
    return conv.right2left(agg_c, left), conv.left2right(agg_v, right)


def dist_gcn_rand_apply(model, dg: DistGraphTensors,
                        generator: torch.Generator | None = None, reps=None):
    """The random-logit control over a partition (edge_partition.py:816):
    U[0, 1) logits for the stacked rows of all K shards through the
    knowledge mask, no exchange; from one generator seeded 0 when none is
    given, as the single-card model. Over ranks each rank draws them all
    and keeps its shard's rows, the stacked path's; with one shard a device
    the lead draws them, as the stacked path (``reps``, the replicas of a
    forward with one shard a device, are not read: no parameter is)."""
    if generator is None:
        generator = torch.Generator(device=dg.device).manual_seed(0)
    k, d0 = dg.n_shards, dg.shards[0]
    left = torch.rand((k * dg.ms, 3), generator=generator, device=dg.device)
    right = torch.rand((k * dg.ns, 3), generator=generator, device=dg.device)
    n = dg.n_local
    return add_knowledge(left[d0 * dg.ms:(d0 + n) * dg.ms],
                         right[d0 * dg.ns:(d0 + n) * dg.ns],
                         dg.c_feas, dg.v_feas)


def module_forward(model, dg: DistGraphTensors,
                   generator: torch.Generator | None = None, reps=None):
    """The arch's own forward over a partition (edge_partition.py:757,
    :791, :1007): ``dg.apply_conv`` runs each conv over the shards, with
    the module's weights, and dropout (training mode) draws its masks from
    ``generator`` over the stacked rows; a narrow Linear (the heads) runs
    one GEMM a shard, as a rank would (``models/layers.py shard_rows``).
    Returns the stacked (L*ms, 3) and (L*ns, 3) fp32 logits. With one
    shard a device, each shard's forward in its thread
    (:func:`_forward_on_devices`), over ``reps`` where given."""
    if model.softmax_aggregation and (dg.parts or [dg])[0].gen is None:
        raise ValueError(f"a dist {model.name} forward needs GEN's compact "
                         "CSRs: DistGraphTensors.from_partition(..., "
                         "gen=True)")
    if dg.parts:
        return _forward_on_devices(model, dg, generator, reps)
    if dg.group is not None and model.training:
        # over ranks the shards' masks differ, as JAX folds the shard index
        # into its key (edge_partition.py:771-774)
        generator = step_generator(generator, dg.shards[0])
    with shard_rows(dg.n_local):
        return model(dg, generator=generator)


def _forward_on_devices(model, dg: DistGraphTensors,
                        generator: torch.Generator | None = None, reps=None):
    """The forward with one shard a device: shard k's thread runs a replica
    of ``model`` (its parameters broadcast from the lead,
    ``shard_threads.replicas``; ``reps``, one a shard, where the caller
    made them, as a device grid's step does for all its rows at once) over
    shard k's tensors, the rank path's one-shard forward; in training mode
    its dropout draws from a generator on its device seeded with one draw
    of ``generator`` plus k, as the rank path folds the shard index in
    (``dp.cell_generators``). The K shards' logits are concatenated on the
    lead, in shard order: the stacked logits."""
    threads = dg.mesh.threads
    if reps is None:
        reps = replicas(model, threads)
    gens = cell_generators(generator if model.training else None,
                           threads.devices)
    outs = threads.run(lambda k: reps[k](dg.parts[k], generator=gens[k]))
    lead = dg.device
    logits = []
    for xs in zip(*outs):
        for x in xs:
            if x.is_cuda:   # read on this thread's stream below
                x.record_stream(torch.cuda.current_stream(x.device))
        logits.append(torch.cat([x.to(lead) for x in xs]))
    return tuple(logits)


#: arch name -> distributed forward (edge_partition.py:1043)
DIST_MODELS = {
    "GCN_FC": module_forward,
    "GCN": module_forward,
    "GCNRand": dist_gcn_rand_apply,
    "GCNDeeper": module_forward,
    "GENDeeper": module_forward,
}

#: the archs whose forward takes the halo exchange (edge_partition.py
#: :1057): every one but GCNRand, which sends nothing. The trainer and
#: predict partition with ``halo=`` membership here (trainer.py:368,
#: predict.py:106), so GCNRand takes the all-gather partition there.
DIST_HALO_ARCHS = frozenset(DIST_MODELS) - {"GCNRand"}


def dist_tensors(model, dg: PartitionedGraph, mesh: EdgeMesh,
                 input_agg: bool = False) -> DistGraphTensors:
    """The partition on the mesh's device with what ``model`` reads: GEN's
    compact CSRs where its convs aggregate by softmax, and with ``input_agg`` the input conv's
    cached aggregations where the model's input conv uses them (not GEN's,
    whose aggregation depends on its parameters; not GCNRand's)."""
    dgt = DistGraphTensors.from_partition(
        dg, mesh, gen=model.softmax_aggregation)
    if input_agg and model.reads_input_agg:
        dgt = attach_dist_input_agg(dgt, model.cdtype)
    return dgt


def dist_forward(model, dgt: DistGraphTensors,
                 generator: torch.Generator | None = None, reps=None):
    """The arch's distributed forward over device tensors: the stacked
    logits of the shards held here ((L*ms, 3), (L*ns, 3)); with all K here,
    global row i is row i, padding rows last. ``reps``: with one shard a
    device, the shards' replicas of ``model`` (made anew by default)."""
    return DIST_MODELS[model.name](model, dgt, generator, reps)


def dist_apply(model, dg: PartitionedGraph, mesh: EdgeMesh,
               generator: torch.Generator | None = None):
    """Full-graph forward of one partitioned graph on ``mesh``
    (edge_partition.py:1207): the mesh's shards go to its device, then the
    arch's distributed forward runs; the logits of the shards held here
    (``gather_logits`` brings the ranks' to one)."""
    return dist_forward(model, dist_tensors(model, dg, mesh), generator)


def dist_train_step(model, optimizer, dg: DistGraphTensors, loss_fn,
                    generator: torch.Generator | None = None):
    """One step over a partitioned graph (edge_partition.py:1230
    make_dist_train_step): the dist forward in training mode, the loss over
    the stacked logits with the partition's masks (the dist loss: the
    shards' sums are the psums), backward through the halo pair and the
    SpMMs' partner orderings, the optimizer's update. With every shard on
    one device there is no psum whose transpose the JAX step's 1/D scaling
    undoes. Over ranks the loss's sums are all-reduced over the group
    (``psum``, whose backward passes the cotangent as it is: each rank's
    gradient is its shards' part of the single-graph gradient, with no 1/D
    to undo) and the parameters' gradients summed over the group
    (:1255-1257, ``dp.sum_over_ranks``) before the update. As in the JAX
    trainer, no per-step accuracy. Returns the loss before the update, a
    0-d tensor on the device (the whole graph's on every rank)."""
    model.train()
    kw = {} if dg.group is None else {"psum": psum_over(dg.group)}

    def forward():
        lc, lv = dist_forward(model, dg, generator)
        return loss_fn(lc, lv, dg.y_s, dg.y_t, dg.cons_mask, dg.vars_mask,
                       **kw)

    # with one shard a device, in a thread of its own, so that the
    # backward sums in one order (shard_threads.numbered_afresh)
    loss = numbered_afresh(forward) if dg.parts else forward()
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:   # GCNRand's logits depend on no parameter
        loss.backward()
        if dg.group is not None:
            sum_over_ranks(model, dg.group)
    optimizer.step()
    return loss.detach()


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``, whose backward passes
    the cotangent on as it is: every rank computes the same loss from the
    sums, so each rank's backward takes the part of the gradient that
    flows through its own summands."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_over(group):
    """The losses' ``psum`` over ``group`` (``train/losses.py``)."""
    return lambda x: _AllReduceSum.apply(x, group)


def gather_logits(lc: torch.Tensor, lv: torch.Tensor, mesh: EdgeMesh):
    """The stacked fp32 logits of all K shards on the group's rank 0, from
    each rank's (ms, 3) and (ns, 3) (a gather: of host copies over gloo, of
    the card's over NCCL), and (None, None) on the other ranks; the logits
    as they are where every shard is here (with one shard a device, the
    forward concatenated them on the lead)."""
    if mesh.group is None:
        return lc, lv
    root = dist.get_global_rank(mesh.group, 0)
    me = dist.get_rank(mesh.group)
    on = "cpu" if dist.get_backend(mesh.group) == "gloo" else lc.device
    out = []
    for x in (lc, lv):
        x = x.detach().float().to(on).contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.n_shards)] \
            if me == 0 else None
        dist.gather(x, parts, dst=root, group=mesh.group)
        out.append(torch.cat(parts) if me == 0 else None)
    return tuple(out)
