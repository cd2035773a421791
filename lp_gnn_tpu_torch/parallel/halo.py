"""The halo all-to-all (K1): each shard's boundary block to its peer.

Counterpart of ``lp_gnn_tpu/parallel/edge_partition.py:572 _halo_a2a`` and
of the TPU kernel it selects, ``lp_gnn_tpu/parallel/pallas_halo.py:69
pallas_all_to_all`` (``_a2a_kernel`` :39): K per-shard halo buffers of
(K*Bh, F) rows in, K out, with ``out[q][p*Bh:(p+1)*Bh] =
in[p][q*Bh:(q+1)*Bh]``, the tiled ``lax.all_to_all`` over the ``edge`` axis.

Two transports, one kernel source (``ops/csrc/halo_a2a.cu``); the edge
mesh says which runs, there is no switch and no fallback between them:

- All K shards in one process, on one device: :func:`halo_all_to_all`
  moves all K*K blocks in one launch, or raises, on CUDA tensors; on CPU
  tensors it runs :func:`halo_all_to_all_plain`. It takes the K buffers
  stacked in one (K, K*Bh, F) tensor, as the reduce direction of the
  edge-partitioned forward holds them, or as a list of K tensors.
  :class:`HaloAllToAll` gives the stacked form a gradient: the exchange is
  its own transpose. The gather direction runs no all-to-all there: the
  exchange is a fixed permutation of rows, folded into the gather's index
  (``edge_partition.halo_gather``).
- One shard a process, rank k of a process group holding shard k:
  :func:`halo_all_to_all_ranks` launches the rank form on CUDA tensors, the
  TPU kernel's remote copy: each rank writes its K blocks straight into the
  ranks' receive windows, cudaMalloc'ed by each rank and mapped into the
  others through CUDA IPC (the same stores reach a window on this card or
  on a peer card over NVLink), with a barrier before the launch and a
  stream synchronise and a swap of the ranks' error codes after it in
  place of the TPU kernel's semaphores; a second launch of the kernel
  copies the rank's own window out. One window a group and device, grown
  to the largest exchange. On CPU tensors it runs
  :func:`halo_all_to_all_ranks_plain`,
  ``all_to_all_single`` over the group (gloo). :class:`HaloAllToAllRanks`
  gives it a gradient, the same exchange. Under a (dp, edge) grid of ranks
  (``mesh.RankGrid``) each row's edge group exchanges over a window of its
  own: a rank belongs to one row, and its window is keyed by that group.
  Shards on several devices of one process are not ported (ROADMAP.md,
  queue item 7c's rest).
"""
from __future__ import annotations

import atexit
import ctypes
import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from ..ops import _build
from ..ops._build import launch_on

MAX_SHARDS = 64   # the kernel's pointer table (csrc/halo_a2a.cu)
_DTYPES = (torch.float32, torch.bfloat16)
# the K buffers of one exchange: one stacked (K, K*Bh, F) tensor, or K tensors
Halo = torch.Tensor | Sequence[torch.Tensor]


def halo_all_to_all_plain(bufs: Halo) -> Halo:
    """Plain PyTorch version: K*K block copies, in the form given (a list of
    K buffers, or one stacked (K, K*Bh, F) tensor)."""
    k = len(bufs)
    bh = bufs[0].shape[0] // k
    if isinstance(bufs, torch.Tensor):
        outs = torch.empty_like(bufs)
    else:
        outs = [torch.empty_like(b) for b in bufs]
    for q in range(k):
        for p in range(k):
            outs[q][p * bh:(p + 1) * bh] = bufs[p][q * bh:(q + 1) * bh]
    return outs


def _lib():
    fn = _build.load("halo_a2a").lp_halo_a2a
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_stacked():
    fn = _build.load("halo_a2a").lp_halo_a2a_stacked
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_common(k, shape, dtype, contiguous, grad):
    if len(shape) != 2:
        raise ValueError(f"halo buffers must be 2-D (K*Bh, F), got {tuple(shape)}")
    if shape[0] % k:
        raise ValueError(f"{shape[0]} rows do not split into {k} equal blocks")
    if dtype not in _DTYPES:
        raise TypeError(f"halo buffers must all be fp32 or all bf16, got {dtype}")
    if not contiguous:
        raise ValueError("halo buffers must be contiguous")
    if grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "halo_all_to_all is forward-only: HaloAllToAll.apply gives the "
            "stacked form its backward (the same exchange). Run under "
            "torch.no_grad().")


def _check(bufs: Sequence[torch.Tensor]) -> None:
    if not bufs:
        raise ValueError("halo_all_to_all needs one buffer per shard")
    b0 = bufs[0]
    dev, shape, dtype = b0.device, b0.shape, b0.dtype
    if any(b.device != dev for b in bufs):
        devs = {b.device for b in bufs}
        raise NotImplementedError(
            f"halo buffers on distinct devices {sorted(map(str, devs))} in "
            "one process: several cards in one process (peer pointers in "
            "K1's table) are not ported yet (ROADMAP.md, queue item 7c's "
            "rest); one shard a rank is halo_all_to_all_ranks")
    if any(b.shape != shape for b in bufs):
        raise ValueError("halo buffers of one exchange must share one shape, got "
                         f"{sorted({tuple(b.shape) for b in bufs})}")
    if any(b.dtype != dtype for b in bufs):
        raise TypeError("halo buffers must all be fp32 or all bf16, got "
                        f"{sorted({str(b.dtype) for b in bufs})}")
    _check_common(len(bufs), shape, dtype,
                  all(b.is_contiguous() for b in bufs),
                  any(b.requires_grad for b in bufs))


def _check_launch(k, block_bytes, src_aligned) -> None:
    if k > MAX_SHARDS:
        raise ValueError(f"halo_all_to_all kernel takes at most {MAX_SHARDS} "
                         f"shards, got {k}")
    if block_bytes % 16 or not src_aligned:
        raise ValueError(
            "halo_all_to_all kernel needs 16-byte aligned buffers and blocks "
            f"of a multiple of 16 bytes, got {block_bytes}-byte blocks")


def _launch(dev, k, block_bytes, src_aligned, fn, *args) -> None:
    _check_launch(k, block_bytes, src_aligned)
    rc = launch_on(dev, fn, *args)
    if rc != 0:
        raise RuntimeError(f"halo_all_to_all kernel launch failed: CUDA error {rc}")
    halo_all_to_all.launches += 1


def halo_all_to_all(bufs: Halo) -> Halo:
    """``out[q][p*Bh:(p+1)*Bh] = bufs[p][q*Bh:(q+1)*Bh]`` over K halo buffers
    of (K*Bh, F) rows, fp32 or bf16, on one device.

    Two forms, one kernel. Stacked: ``bufs`` is one contiguous (K, K*Bh, F)
    tensor and the result is another; the checks look at that one tensor
    and the kernel builds its pointer table itself. List: ``bufs`` is K
    buffers and the result K views of one new (K, K*Bh, F) tensor. On the
    card K is at most 64, every buffer 16-byte aligned and a block (Bh*F
    elements) a multiple of 16 bytes; the wrapper raises otherwise."""
    stacked = isinstance(bufs, torch.Tensor)
    if stacked:
        if bufs.dim() != 3:
            raise ValueError("a stacked halo exchange takes one (K, K*Bh, F) "
                             f"tensor, got shape {tuple(bufs.shape)}")
        k = bufs.shape[0]
        _check_common(k, bufs.shape[1:], bufs.dtype, bufs.is_contiguous(),
                      bufs.requires_grad)
        b0 = bufs
    else:
        _check(bufs)
        k, b0 = len(bufs), bufs[0]
    dev = b0.device
    if dev.type == "cpu":
        return halo_all_to_all_plain(bufs)
    if dev.type != "cuda":
        raise ValueError(f"halo_all_to_all runs on cuda or cpu, not {dev}")
    rows, f = b0.shape[-2:]
    out = torch.empty((k, rows, f), dtype=b0.dtype, device=dev)
    buf_bytes = rows * f * b0.element_size()
    block_bytes = buf_bytes // k
    if block_bytes:
        if stacked:
            _launch(dev, k, block_bytes, bufs.data_ptr() % 16 == 0,
                    _lib_stacked(), bufs.data_ptr(), out.data_ptr(), k,
                    buf_bytes, block_bytes)
        else:
            src = [b.data_ptr() for b in bufs]
            table = ctypes.c_void_p * k
            base = out.data_ptr()
            _launch(dev, k, block_bytes, not any(a % 16 for a in src), _lib(),
                    table(*src),
                    table(*range(base, base + k * buf_bytes, buf_bytes)), k,
                    block_bytes)
    return out if stacked else list(out.unbind(0))


halo_all_to_all.launches = 0   # kernel launches since the last reset


class HaloAllToAll(torch.autograd.Function):
    """``HaloAllToAll.apply(bufs)``: :func:`halo_all_to_all` of one stacked
    (K, K*Bh, F) tensor with a gradient. The exchange maps block (p -> q)
    to (q -> p), so it is its own transpose: the backward is one more
    stacked launch, on the gradient."""

    @staticmethod
    def forward(ctx, bufs):
        return halo_all_to_all(bufs)

    @staticmethod
    def backward(ctx, grad):
        return halo_all_to_all(grad.contiguous())


# ------------------------------------------------------------ the rank form
def _group_shape(group) -> tuple[int, int]:
    """(K, me): the group's size and this process's rank in it."""
    if not dist.is_initialized():
        raise RuntimeError("halo_all_to_all_ranks needs a process group "
                           "(parallel/mesh.py init_distributed)")
    return dist.get_world_size(group), dist.get_rank(group)


def halo_all_to_all_ranks_plain(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Plain version of the rank form, on CPU tensors over gloo:
    ``all_to_all_single`` of this rank's (K*Bh, F) buffer, whose block p
    goes to rank p, into a new buffer whose block p comes from rank p."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf.contiguous(), group=group)
    return out


def _rank_lib(name: str):
    lib = _build.load("halo_a2a")
    fn = getattr(lib, name)
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = {
            "lp_halo_a2a_rank": [vp, pp, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong, vp],
            "lp_halo_ipc_handle_bytes": [],
            "lp_halo_window_alloc": [ctypes.c_longlong, pp, vp],
            "lp_halo_window_open": [vp, pp],
            "lp_halo_window_close": [vp],
            "lp_halo_window_free": [vp]}[name]
        fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass
class _Window:
    """The receive window of every rank of a group, ``nbytes`` each, as
    this rank reaches them: ``ptrs[p]`` rank p's (``ptrs[me]`` its own
    allocation, the others IPC mappings), ``table`` the same as the
    kernel's pointer array."""
    me: int
    nbytes: int
    ptrs: list[int]
    table: object
    group: object


# (group, device index) -> the one window of the group's ranks on that
# device. Every exchange of up to its bytes uses it (from its start); a
# larger one replaces it by a window of its own size, made by all ranks
# together (the same exchanges in the same order on every rank), so the
# windows hold the largest exchange so far, not one window a graph size.
_WINDOWS: dict[tuple, _Window] = {}


def window_bytes() -> int:
    """The bytes of this process's own receive windows: cudaMalloc'ed
    outside torch's caching allocator, so ``torch.cuda.memory_allocated``
    leaves them out."""
    return sum(w.nbytes for w in _WINDOWS.values())


def _make_window(nbytes: int, group, dev: torch.device) -> _Window:
    """Allocate this rank's window, swap the IPC handles over the group and
    open the peers' windows. Every rank learns whether every rank
    succeeded, so a failure raises on all of them (none waits at the next
    barrier)."""
    k, me = _group_shape(group)
    nh = _rank_lib("lp_halo_ipc_handle_bytes")()
    own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(nh)
    with torch.cuda.device(dev):
        rc = _rank_lib("lp_halo_window_alloc")(nbytes, ctypes.byref(own),
                                               handle)
        handles: list = [None] * k
        dist.all_gather_object(handles, (rc, handle.raw), group=group)
        ptrs, err = [0] * k, ""
        if any(r != 0 for r, _ in handles):
            err = ("cudaMalloc / cudaIpcGetMemHandle failed: CUDA errors by "
                   f"rank {[r for r, _ in handles]}")
        else:
            ptrs[me] = own.value
            for p in range(k):
                if p == me:
                    continue
                peer = ctypes.c_void_p()
                rc = _rank_lib("lp_halo_window_open")(handles[p][1],
                                                      ctypes.byref(peer))
                if rc != 0:
                    err = (f"cudaIpcOpenMemHandle of rank {p}'s window "
                           f"failed: CUDA error {rc}")
                    break
                ptrs[p] = peer.value
        errs: list = [None] * k
        dist.all_gather_object(errs, err, group=group)
        if any(errs):
            for p, a in enumerate(ptrs):
                if a and p != me:
                    _rank_lib("lp_halo_window_close")(a)
            if own.value:
                _rank_lib("lp_halo_window_free")(own.value)
            raise RuntimeError(
                "halo_all_to_all_ranks: the receive windows could not be "
                f"set up ({nbytes} bytes a rank): " + "; ".join(
                    f"rank {p}: {e}" for p, e in enumerate(errs) if e))
    return _Window(me, nbytes, ptrs, (ctypes.c_void_p * k)(*ptrs), group)


def _drop_window(key: tuple) -> None:
    """Unmap the peers' windows of ``key``, wait for every rank of its
    group to have done so (while the group lives), and free this rank's
    own."""
    w = _WINDOWS.pop(key)
    with torch.cuda.device(key[1]):
        torch.cuda.synchronize()
        for p, a in enumerate(w.ptrs):
            if p != w.me:
                _rank_lib("lp_halo_window_close")(a)
        if dist.is_initialized():
            dist.barrier(group=w.group)
        _rank_lib("lp_halo_window_free")(w.ptrs[w.me])


def _window(nbytes: int, group, dev: torch.device) -> _Window:
    """The window of ``group`` on ``dev``, grown to ``nbytes`` where it is
    smaller (by every rank at once)."""
    key = (dist.group.WORLD if group is None else group, dev.index)
    w = _WINDOWS.get(key)
    if w is None or w.nbytes < nbytes:
        if w is not None:
            _drop_window(key)
        w = _WINDOWS[key] = _make_window(nbytes, group, dev)
    return w


def release_windows() -> None:
    """Drop every window: called before the group is destroyed, and at
    exit."""
    for key in list(_WINDOWS):
        _drop_window(key)


atexit.register(release_windows)


def _rank_write(buf: torch.Tensor, table, me: int, k: int) -> int:
    """The rank form's launch: block p of ``buf`` to block ``me`` of the
    window at ``table[p]``, on the current stream, counted where it
    launched. Returns the CUDA error (0: launched)."""
    block_bytes = buf.nbytes // k
    _check_launch(k, block_bytes, buf.data_ptr() % 16 == 0)
    rc = launch_on(buf.device, _rank_lib("lp_halo_a2a_rank"), buf.data_ptr(),
                   table, me, k, block_bytes)
    if rc == 0:
        halo_all_to_all_ranks.launches += 1
    return rc


def _copy_out(win: _Window, out: torch.Tensor) -> int:
    """The exchange's second launch: the first ``out.nbytes`` of this
    rank's own window into ``out``, by the same kernel (the list form, one
    block of K*Bh rows), counted where it launched. Returns the CUDA
    error."""
    one = ctypes.c_void_p * 1
    rc = launch_on(out.device, _lib(), one(win.ptrs[win.me]),
                   one(out.data_ptr()), 1, out.nbytes)
    if rc == 0:
        halo_all_to_all_ranks.launches += 1
    return rc


def _agree(rc: int, group, dev: torch.device) -> None:
    """Every rank's error code to every rank, over the group: it waits for
    all of them as a barrier does, and raises on every rank where any is
    not 0, so that no rank waits for one that failed."""
    k, _ = _group_shape(group)
    on = dev if dist.get_backend(group) == "nccl" else torch.device("cpu")
    # an all-gather, not an all-reduce: gloo's ring all-reduce takes twice
    # its rounds
    rcs = [torch.zeros(1, dtype=torch.int32, device=on) for _ in range(k)]
    dist.all_gather(rcs, torch.tensor([rc], dtype=torch.int32, device=on),
                    group=group)
    codes = [int(r) for r in rcs]
    if any(codes):
        raise RuntimeError("halo_all_to_all_ranks kernel launch failed: "
                           f"CUDA errors by rank {codes}")


def halo_all_to_all_ranks(buf: torch.Tensor, group=None) -> torch.Tensor:
    """The rank form of K1 over the K ranks of ``group`` (the default group
    if None): this rank's (K*Bh, F) buffer, block p for rank p, in; a new
    (K*Bh, F) buffer, block p from rank p, out. fp32 or bf16.

    On CUDA tensors two launches of one kernel, both counted: a stream
    synchronise and a barrier over the group (no rank still reads its
    window: each read is the copy out of an earlier exchange, on its rank's
    stream), ``lp_halo_a2a_rank`` writing this rank's K blocks into the K
    windows, a stream synchronise, the ranks' error codes swapped over the
    group (every rank's writes landed, or every rank raises), then the own
    window copied into the result, which later work on the stream reads in
    order. The group's window grows to the exchange, by every rank at
    once, where it is smaller. It raises where the kernel or the windows
    fail; on CPU tensors it runs :func:`halo_all_to_all_ranks_plain`. Every
    rank of the group must make the same exchanges, of the same shapes, in
    the same order."""
    k, me = _group_shape(group)
    if buf.dim() != 2:
        raise ValueError("the rank form takes this rank's (K*Bh, F) buffer, "
                         f"got shape {tuple(buf.shape)}")
    _check_common(k, buf.shape, buf.dtype, buf.is_contiguous(),
                  buf.requires_grad)
    dev = buf.device
    if dev.type == "cpu":
        return halo_all_to_all_ranks_plain(buf, group)
    if dev.type != "cuda":
        raise ValueError(f"halo_all_to_all_ranks runs on cuda or cpu, not {dev}")
    out = torch.empty_like(buf)
    if buf.nbytes == 0:
        return out
    _check_launch(k, buf.nbytes // k, buf.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev)
    stream.synchronize()
    win = _window(buf.nbytes, group, dev)
    dist.barrier(group=group)
    rc = _rank_write(buf, win.table, me, k)
    if rc == 0:
        try:
            stream.synchronize()
        except RuntimeError:   # an error of the launch, raised on the peers too
            rc = -1
    _agree(rc, group, dev)
    rc = _copy_out(win, out)
    if rc != 0:
        raise RuntimeError(
            f"halo_all_to_all_ranks copy-out launch failed: CUDA error {rc}")
    return out


# the rank form's launches since the last reset: two an exchange (the write
# and the copy-out)
halo_all_to_all_ranks.launches = 0


class HaloAllToAllRanks(torch.autograd.Function):
    """``HaloAllToAllRanks.apply(buf, group)``: :func:`halo_all_to_all_ranks`
    with a gradient. Block (p -> q) maps to (q -> p), so the backward is the
    same exchange of the gradient, made by every rank. The edge-partitioned
    path does not call it: there ``HaloGather`` and ``HaloReduce``
    (``edge_partition.py``) are each other's backward, as in the JAX
    package; this is the exchange alone with its gradient, as
    :class:`HaloAllToAll` is for the stacked form."""

    @staticmethod
    def forward(ctx, buf, group=None):
        ctx.group = group
        return halo_all_to_all_ranks(buf, group)

    @staticmethod
    def backward(ctx, grad):
        return halo_all_to_all_ranks(grad.contiguous(), ctx.group), None
